"""Runtime core: init, topology, configuration, exceptions."""
