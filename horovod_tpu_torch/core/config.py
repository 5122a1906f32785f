"""Environment-variable knobs read by the port's training path.

The reference accepts both the original ``HOROVOD_*`` names and
``HVD_TPU_*`` overrides, the ``HVD_TPU_`` name winning when both are set
(horovod_tpu/core/config.py).  The port keeps those names; this slice reads
only the launcher topology (``RANK``, ``SIZE``, ``LOCAL_RANK``, ...).  The
attention switch ``HVD_TPU_FLASH`` is not one of them: the reference reads
it under that one name (parallel/ring_attention.py), and so does the port.
"""

from __future__ import annotations

import os
from typing import Optional

_PREFIXES = ("HVD_TPU_", "HOROVOD_")

# Launcher -> worker topology contract (reference gloo_run.py:64-75).
RANK = "RANK"
SIZE = "SIZE"
LOCAL_RANK = "LOCAL_RANK"
LOCAL_SIZE = "LOCAL_SIZE"
CROSS_RANK = "CROSS_RANK"
CROSS_SIZE = "CROSS_SIZE"


def get_env(name: str, default: Optional[str] = None) -> Optional[str]:
    """Read a knob, preferring HVD_TPU_* over HOROVOD_*."""
    for prefix in _PREFIXES:
        val = os.environ.get(prefix + name)
        if val is not None:
            return val
    return default


def get_int(name: str) -> Optional[int]:
    """An integer knob, or None when unset or not an integer."""
    val = get_env(name)
    if val is None:
        return None
    try:
        return int(val)
    except ValueError:
        return None
