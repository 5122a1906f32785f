"""Elastic training: state objects with commit/restore/sync and the retry
loop (port of horovod_tpu/elastic/; upstream horovod/common/elastic.py:26-175)."""

from .state import State, ObjectState, TpuState, run
