"""Environment-variable knobs read by the port's training path.

The reference accepts both the original ``HOROVOD_*`` names and
``HVD_TPU_*`` overrides, the ``HVD_TPU_`` name winning when both are set
(horovod_tpu/core/config.py).  The port keeps those names for the launcher
topology (``RANK``, ``SIZE``, ``LOCAL_RANK``, ...) and the wire knobs
(``COMPRESSION``, ``QUANT_BLOCK``), the overlap scheduler's
(``OVERLAP``, ``OVERLAP_BUCKET_BYTES``), ZeRO's (``ZERO_STAGE``,
``ZERO_PREFETCH``, ``ZERO_QUANT_GATHER``) and the input pipeline's
(``DATA_PREFETCH``, ``DATA_QUEUE_DEPTH``, ``DATA_STALL_TIMEOUT_SECONDS``,
and the stall warning ``STALL_CHECK_TIME_SECONDS``), the default mesh's
``MESH_AXES`` and the hierarchical schedule's ``HIERARCHICAL_ALLREDUCE`` /
``HIERARCHICAL_ALLGATHER``, with the reference's defaults and clamps
(config.py:296-320, :475-524).  The attention switch ``HVD_TPU_FLASH`` is
not one of them: the reference reads it under that one name
(parallel/ring_attention.py), and so does the port.
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

# Backward-overlap bucketed gradient scheduler (ops/overlap.py): the
# session default for optimizers called without ``overlap=``, and the
# bucket size when overlap is on.
OVERLAP = "OVERLAP"
OVERLAP_BUCKET_BYTES = "OVERLAP_BUCKET_BYTES"
DEFAULT_OVERLAP_BUCKET_BYTES = 8 * 1024 * 1024

# ZeRO weight-update sharding (optimizers.ZeroShardedOptimizer): the
# default stage, the bucketed stage-3 forward gather (off = one gather of
# every parameter), and the opt-in quantized stage-3 gather.
ZERO_STAGE = "ZERO_STAGE"
ZERO_PREFETCH = "ZERO_PREFETCH"
ZERO_QUANT_GATHER = "ZERO_QUANT_GATHER"


# Input pipeline (data/): background prefetch on/off, prefetch queue
# depth, the hard stall ceiling (0 = warn only) and the stall warning.
DATA_PREFETCH = "DATA_PREFETCH"
DATA_QUEUE_DEPTH = "DATA_QUEUE_DEPTH"
DATA_STALL_TIMEOUT_SECONDS = "DATA_STALL_TIMEOUT_SECONDS"
STALL_CHECK_TIME_SECONDS = "STALL_CHECK_TIME_SECONDS"

# The default mesh (``core.basics.mesh()``): "data:8,model:4".
MESH_AXES = "MESH_AXES"

# Flat vs hierarchical schedule of the scheduled collectives
# (``ops.xla_collectives.choose_schedule``).  The boolean is the knob's
# value; the pin is None while the knob is unset and the value once it is
# set (reference config.py:42-48, :480-489).
HIERARCHICAL_ALLREDUCE = "HIERARCHICAL_ALLREDUCE"
HIERARCHICAL_ALLGATHER = "HIERARCHICAL_ALLGATHER"


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


def get_float(name: str, default: float) -> float:
    """A float knob, or ``default`` when unset or not a number."""
    val = get_env(name)
    if val is None:
        return default
    try:
        return float(val)
    except ValueError:
        return default


def get_bool(name: str, default: bool = False) -> bool:
    """A boolean knob: 1/true/yes/on (any case) is true; unset is
    ``default``."""
    val = get_env(name)
    if val is None:
        return default
    return val.strip().lower() in ("1", "true", "yes", "on")


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


def overlap() -> bool:
    return get_bool(OVERLAP, False)


def overlap_bucket_bytes() -> int:
    """Bucket size in bytes, at least 1 KiB: a zero or garbage size would
    put every leaf alone in a bucket."""
    val = get_int(OVERLAP_BUCKET_BYTES)
    return max(1024, DEFAULT_OVERLAP_BUCKET_BYTES if val is None else val)


def zero_stage() -> int:
    """The ZeRO stage, clamped to 1..3: a typo'd knob must not run
    unsharded (0) or invent a stage 4."""
    val = get_int(ZERO_STAGE)
    return min(3, max(1, 1 if val is None else val))


def zero_prefetch() -> bool:
    return get_bool(ZERO_PREFETCH, True)


def zero_quant_gather() -> bool:
    return get_bool(ZERO_QUANT_GATHER, False)


def data_prefetch() -> bool:
    return get_bool(DATA_PREFETCH, True)


def data_queue_depth() -> int:
    """Prefetch queue depth, at least 1 (2 = double buffering)."""
    val = get_int(DATA_QUEUE_DEPTH)
    return max(1, 2 if val is None else val)


def data_stall_timeout_seconds() -> float:
    return get_float(DATA_STALL_TIMEOUT_SECONDS, 0.0)


def stall_warning_seconds() -> float:
    return get_float(STALL_CHECK_TIME_SECONDS, 60.0)


def mesh_axes() -> str:
    return get_env(MESH_AXES, "") or ""


_HIERARCHICAL = {"allreduce": HIERARCHICAL_ALLREDUCE,
                 "allgather": HIERARCHICAL_ALLGATHER}


def hierarchical(kind: str) -> bool:
    """``HIERARCHICAL_ALLREDUCE`` (kind "allreduce") or
    ``HIERARCHICAL_ALLGATHER`` ("allgather")."""
    return get_bool(_HIERARCHICAL[kind])


def hierarchical_pin(kind: str) -> Optional[bool]:
    """None while the knob is unset, else its value: the knob's presence,
    not its value, is what pins a schedule."""
    if get_env(_HIERARCHICAL[kind]) is None:
        return None
    return hierarchical(kind)
