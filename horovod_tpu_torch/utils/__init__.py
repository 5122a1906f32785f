"""Helpers around the port's training path (port of horovod_tpu/utils/)."""
