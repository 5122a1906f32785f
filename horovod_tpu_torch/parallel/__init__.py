"""Attention dispatch (the ring and the other parallel modes are later slices)."""
