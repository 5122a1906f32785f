"""The native (C++) runtime of the eager negotiated plane."""
