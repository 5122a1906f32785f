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
``MESH_AXES``, the hierarchical schedule's ``HIERARCHICAL_ALLREDUCE`` /
``HIERARCHICAL_ALLGATHER``, the native controller's
(``ControllerConfig``) and the serving plane's (``SERVING_*``, ``SPEC_K``,
``TRACE_*``, ``SLO_*``), with the reference's defaults and clamps
(config.py:296-320, :475-524).  The attention switch ``HVD_TPU_FLASH`` is
not one of them: the reference reads it under that one name
(parallel/ring_attention.py), and so does the port.
"""

from __future__ import annotations

import dataclasses
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

# The native controller of the eager negotiated plane (native/,
# ops/eager.py), with the reference's names and defaults (config.py:16-54,
# :250-292, :448-494): the coordinator's address and this process's
# place, the fusion threshold (64 MiB), the background cycle (1 ms), the
# response cache's capacity (1024), the timeline file and its cycle marks,
# the stall inspector (the warning window is STALL_CHECK_TIME_SECONDS
# above), the init-time schedule probe of ops/dispatch.py, and the
# autotuner's switch, which the port refuses until it has the tuner.
CONTROLLER_ADDR = "CONTROLLER_ADDR"
CONTROLLER_RANK = "CONTROLLER_RANK"
CONTROLLER_SIZE = "CONTROLLER_SIZE"
FUSION_THRESHOLD = "FUSION_THRESHOLD"
CYCLE_TIME = "CYCLE_TIME"
CACHE_CAPACITY = "CACHE_CAPACITY"
TIMELINE = "TIMELINE"
TIMELINE_MARK_CYCLES = "TIMELINE_MARK_CYCLES"
STALL_CHECK_DISABLE = "STALL_CHECK_DISABLE"
STALL_SHUTDOWN_TIME_SECONDS = "STALL_SHUTDOWN_TIME_SECONDS"
SCHEDULE_PROBE = "SCHEDULE_PROBE"
SCHEDULE_PROBE_SEED = "SCHEDULE_PROBE_SEED"
SCHEDULE_PROBE_REPS = "SCHEDULE_PROBE_REPS"
AUTOTUNE = "AUTOTUNE"

# The serving plane (serving/), with the reference's names, defaults and
# clamps (config.py:152-178, :397-424, :578-610): the request plane's
# port, address and HMAC secret, the decode slots and KV page geometry
# (max_len 0 = the model's seq_len), the default output cap, the bounded
# admission queue, the checkpoint watch cadence, the radix prefix cache,
# chunked prefill (0 = the whole prompt), page-reservation aging, the
# replica-wide TTFT target, speculative draft tokens a round (0 = off),
# and request tracing's sample rate and trace-id seed; the SLO tracker's
# attainment target, window and burn threshold.
SERVING_PORT = "SERVING_PORT"
SERVING_ADDR = "SERVING_ADDR"
SERVING_SECRET = "SERVING_SECRET"
SERVING_SLOTS = "SERVING_SLOTS"
SERVING_PAGE_TOKENS = "SERVING_PAGE_TOKENS"
SERVING_MAX_LEN = "SERVING_MAX_LEN"
SERVING_MAX_NEW_TOKENS = "SERVING_MAX_NEW_TOKENS"
SERVING_QUEUE_CAP = "SERVING_QUEUE_CAP"
SERVING_SWAP_POLL_S = "SERVING_SWAP_POLL_S"
SERVING_PREFIX_CACHE = "SERVING_PREFIX_CACHE"
SERVING_PREFILL_CHUNK = "SERVING_PREFILL_CHUNK"
SERVING_AGING_S = "SERVING_AGING_S"
SERVING_SLO_TTFT_S = "SERVING_SLO_TTFT_S"
SPEC_K = "SPEC_K"
TRACE_SAMPLE = "TRACE_SAMPLE"
TRACE_SEED = "TRACE_SEED"
SLO_TARGET = "SLO_TARGET"
SLO_WINDOW_S = "SLO_WINDOW_S"
SLO_BURN_THRESHOLD = "SLO_BURN_THRESHOLD"


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


@dataclasses.dataclass
class ControllerConfig:
    """The native controller's knobs as ``from_env`` reads them."""
    fusion_threshold_bytes: int = 64 * 1024 * 1024
    cycle_time_ms: float = 1.0
    cache_capacity: int = 1024
    timeline_filename: str = ""
    timeline_mark_cycles: bool = False
    stall_check_disable: bool = False
    stall_warning_time_seconds: float = 60.0
    stall_shutdown_time_seconds: float = 0.0
    schedule_probe: bool = True
    schedule_probe_seed: int = 0
    schedule_probe_reps: int = 2
    hierarchical_allreduce: bool = False
    hierarchical_allgather: bool = False
    hierarchical_allreduce_pin: Optional[bool] = None
    hierarchical_allgather_pin: Optional[bool] = None
    compression: str = "none"
    autotune: bool = False

    @classmethod
    def from_env(cls) -> "ControllerConfig":
        d = cls()

        def integer(name, default):
            val = get_int(name)
            return default if val is None else val

        return cls(
            fusion_threshold_bytes=integer(FUSION_THRESHOLD,
                                           d.fusion_threshold_bytes),
            cycle_time_ms=get_float(CYCLE_TIME, d.cycle_time_ms),
            cache_capacity=integer(CACHE_CAPACITY, d.cache_capacity),
            timeline_filename=get_env(TIMELINE, "") or "",
            timeline_mark_cycles=get_bool(TIMELINE_MARK_CYCLES),
            stall_check_disable=get_bool(STALL_CHECK_DISABLE),
            stall_warning_time_seconds=stall_warning_seconds(),
            stall_shutdown_time_seconds=get_float(
                STALL_SHUTDOWN_TIME_SECONDS, d.stall_shutdown_time_seconds),
            schedule_probe=get_bool(SCHEDULE_PROBE, d.schedule_probe),
            schedule_probe_seed=integer(SCHEDULE_PROBE_SEED,
                                        d.schedule_probe_seed),
            schedule_probe_reps=max(1, integer(SCHEDULE_PROBE_REPS,
                                               d.schedule_probe_reps)),
            hierarchical_allreduce=hierarchical("allreduce"),
            hierarchical_allgather=hierarchical("allgather"),
            hierarchical_allreduce_pin=hierarchical_pin("allreduce"),
            hierarchical_allgather_pin=hierarchical_pin("allgather"),
            compression=compression(),
            autotune=get_bool(AUTOTUNE))


def _integer(name: str, default: int) -> int:
    val = get_int(name)
    return default if val is None else val


def serving_port() -> int:
    return _integer(SERVING_PORT, 28643)


def serving_addr() -> Optional[str]:
    return get_env(SERVING_ADDR)


def serving_secret() -> Optional[str]:
    return get_env(SERVING_SECRET)


def serving_slots() -> int:
    return max(1, _integer(SERVING_SLOTS, 8))


def serving_page_tokens() -> int:
    return max(1, _integer(SERVING_PAGE_TOKENS, 16))


def serving_max_len() -> int:
    """The context a slot holds; 0 = the model's seq_len."""
    return max(0, _integer(SERVING_MAX_LEN, 0))


def serving_max_new_tokens() -> int:
    return max(1, _integer(SERVING_MAX_NEW_TOKENS, 64))


def serving_queue_cap() -> int:
    """At least 1: a cap of 0 would shed every request at ingress."""
    return max(1, _integer(SERVING_QUEUE_CAP, 64))


def serving_swap_poll_s() -> float:
    return max(0.05, get_float(SERVING_SWAP_POLL_S, 2.0))


def serving_prefix_cache() -> bool:
    return get_bool(SERVING_PREFIX_CACHE, True)


def serving_prefill_chunk() -> int:
    """Prompt tokens prefilled an iteration; 0 = the whole prompt."""
    return max(0, _integer(SERVING_PREFILL_CHUNK, 0))


def serving_aging_s() -> float:
    return max(0.0, get_float(SERVING_AGING_S, 0.0))


def serving_slo_ttft_s() -> float:
    return max(0.0, get_float(SERVING_SLO_TTFT_S, 0.0))


def spec_k() -> int:
    """Draft tokens a speculative round, 0 (off) to 32."""
    return min(32, max(0, _integer(SPEC_K, 0)))


def trace_sample() -> float:
    return min(1.0, max(0.0, get_float(TRACE_SAMPLE, 0.01)))


def trace_seed() -> int:
    return _integer(TRACE_SEED, 0)


def slo_target() -> float:
    return min(0.9999, max(0.5, get_float(SLO_TARGET, 0.99)))


def slo_window_s() -> float:
    return max(1.0, get_float(SLO_WINDOW_S, 300.0))


def slo_burn_threshold() -> float:
    return max(0.01, get_float(SLO_BURN_THRESHOLD, 1.0))
