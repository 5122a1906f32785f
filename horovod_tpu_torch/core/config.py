"""Environment-variable knobs read by the port's training path.

The reference accepts both the original ``HOROVOD_*`` names and
``HVD_TPU_*`` overrides, the ``HVD_TPU_`` name winning when both are set
(horovod_tpu/core/config.py).  The port keeps those names for the launcher
topology (``RANK``, ``SIZE``, ``LOCAL_RANK``, ...) and the wire knobs
(``COMPRESSION``, ``QUANT_BLOCK``).  The attention switch ``HVD_TPU_FLASH`` is not one of them: the reference reads
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

# Wire format of direct collective calls, and elements per quantization
# scale (reference config.py:503-514).
COMPRESSION = "COMPRESSION"
QUANT_BLOCK = "QUANT_BLOCK"
COMPRESSION_NAMES = ("none", "fp16", "bf16", "int8", "int4")
DEFAULT_QUANT_BLOCK = 256


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


def compression() -> str:
    """The session wire format: an unknown name becomes ``none`` (a typo'd
    knob must not kill a job)."""
    name = (get_env(COMPRESSION, "none") or "none").strip().lower()
    return name if name in COMPRESSION_NAMES else "none"


def quant_block() -> int:
    """Elements per quantization scale: at least 2 and even (int4 packs
    pairs)."""
    block = get_int(QUANT_BLOCK)
    block = max(2, DEFAULT_QUANT_BLOCK if block is None else block)
    return block - block % 2
