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
``TRACE_*``, ``SLO_*``), and the telemetry plane's (``LOG_*``,
``METRICS_*``, ``ATTRIBUTION*``, ``PEAK_TFLOPS``, ``PERF_DRIFT*``,
``FLIGHT_*``), the fleet service's (``FLEET_*``), the recovery
tier's and the wire fabric's (``RECOVERY``, ``RECOVERY_STRIDE``,
``CHAOS_*``, ``NET_*``, ``CHAOS_NET_*``), and elastic training's (``ELASTIC``,
``ASYNC_COMMIT``), with the reference's defaults and clamps
(config.py:37, :78-136, :193-200, :296-372, :438-443, :475-531).  The
attention switch ``HVD_TPU_FLASH`` is not one of them: the reference
reads it under that one name (parallel/ring_attention.py), and so does
the port.
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
# autotuner's (autotune.py): its switch, CSV log, discarded warm-up
# windows, step-counted windows (0 = timed), sample budget and GP noise,
# then the closed loop's tuning memory (on/off and the gateway-less
# store's directory) and drift-triggered re-tune (on/off, windows an
# episode, the rollback gate in percent), as reference config.py:21-36
# names them.
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
AUTOTUNE_LOG = "AUTOTUNE_LOG"
AUTOTUNE_WARMUP_SAMPLES = "AUTOTUNE_WARMUP_SAMPLES"
AUTOTUNE_STEPS_PER_SAMPLE = "AUTOTUNE_STEPS_PER_SAMPLE"
AUTOTUNE_BAYES_OPT_MAX_SAMPLES = "AUTOTUNE_BAYES_OPT_MAX_SAMPLES"
AUTOTUNE_GAUSSIAN_PROCESS_NOISE = "AUTOTUNE_GAUSSIAN_PROCESS_NOISE"
AUTOTUNE_MEMORY = "AUTOTUNE_MEMORY"
AUTOTUNE_MEMORY_DIR = "AUTOTUNE_MEMORY_DIR"
AUTOTUNE_RETUNE = "AUTOTUNE_RETUNE"
AUTOTUNE_RETUNE_WINDOWS = "AUTOTUNE_RETUNE_WINDOWS"
AUTOTUNE_ROLLBACK_PCT = "AUTOTUNE_ROLLBACK_PCT"

# The serving plane (serving/), with the reference's names, defaults and
# clamps (config.py:152-178, :397-424, :578-610): the request plane's
# port, address and HMAC secret, the decode slots and KV page geometry
# (max_len 0 = the model's seq_len), the default output cap, the bounded
# admission queue, the checkpoint watch cadence, the radix prefix cache,
# chunked prefill (0 = the whole prompt), page-reservation aging, the
# replica-wide TTFT target, the autoscaler's switch, queued requests a
# replica and cooldown between resizes (the switch is parsed as the
# reference parses it, config.py:405, :591, and read nowhere, as there),
# the KV-migration wire (0 = fp32,
# 8 or 4; anything else reads as 8), speculative draft tokens a round (0 =
# off), and request tracing's sample rate and trace-id seed; the SLO tracker's
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
SERVING_TARGET_QUEUE = "SERVING_TARGET_QUEUE"
SERVING_SCALE_COOLDOWN_S = "SERVING_SCALE_COOLDOWN_S"
SERVING_MIGRATE_BITS = "SERVING_MIGRATE_BITS"
SPEC_K = "SPEC_K"
TRACE_SAMPLE = "TRACE_SAMPLE"
TRACE_SEED = "TRACE_SEED"
SLO_TARGET = "SLO_TARGET"
SLO_WINDOW_S = "SLO_WINDOW_S"
SLO_BURN_THRESHOLD = "SLO_BURN_THRESHOLD"

# Logging (utils/logging.py): trace|debug|info|warning|error|fatal, and
# whether to drop the timestamp.
LOG_LEVEL = "LOG_LEVEL"
LOG_HIDE_TIME = "LOG_HIDE_TIME"

# The telemetry plane (metrics/, debug/flight.py), with the reference's
# names and defaults (config.py:78-111, :326-362): the cross-rank sync
# cadence (0 = never) and the Prometheus port (0 = off); the straggler
# detector's factor, noise floor and patience; the host-sharded tree sync
# (``metrics/observer.py``): on/off, outlier evidence a host, the
# exchange deadline and the laggard-snapshot grace; JSONL retention;
# per-step attribution, its JSONL trail and the MFU peak override
# (TFLOP/s, 0 = detected); the drift detector and the regression
# report's event-correlation window; the
# flight recorder, its debug endpoint's port (0 = ephemeral) and the
# coordinator's stall -> hang-report escalation.
METRICS_SYNC_STEPS = "METRICS_SYNC_STEPS"
METRICS_PORT = "METRICS_PORT"
METRICS_STRAGGLER_FACTOR = "METRICS_STRAGGLER_FACTOR"
METRICS_STRAGGLER_MIN_SECONDS = "METRICS_STRAGGLER_MIN_SECONDS"
METRICS_STRAGGLER_PATIENCE = "METRICS_STRAGGLER_PATIENCE"
METRICS_TREE = "METRICS_TREE"
METRICS_TOPK = "METRICS_TOPK"
METRICS_TREE_TIMEOUT_S = "METRICS_TREE_TIMEOUT_S"
METRICS_TREE_GRACE_S = "METRICS_TREE_GRACE_S"
METRICS_RETAIN_FILES = "METRICS_RETAIN_FILES"
ATTRIBUTION = "ATTRIBUTION"
ATTRIBUTION_JSONL = "ATTRIBUTION_JSONL"
PEAK_TFLOPS = "PEAK_TFLOPS"
PERF_DRIFT = "PERF_DRIFT"
PERF_DRIFT_WARMUP = "PERF_DRIFT_WARMUP"
PERF_DRIFT_THRESHOLD = "PERF_DRIFT_THRESHOLD"
PERF_DRIFT_MIN_PCT = "PERF_DRIFT_MIN_PCT"
PERF_DRIFT_COOLDOWN = "PERF_DRIFT_COOLDOWN"
PERF_DRIFT_LOOKBACK_S = "PERF_DRIFT_LOOKBACK_S"
FLIGHT_DISABLE = "FLIGHT_DISABLE"
FLIGHT_CAPACITY = "FLIGHT_CAPACITY"
FLIGHT_DIR = "FLIGHT_DIR"
FLIGHT_PORT = "FLIGHT_PORT"
FLIGHT_LAST_EVENTS = "FLIGHT_LAST_EVENTS"
FLIGHT_ESCALATE = "FLIGHT_ESCALATE"
# The fleet service (fleet/), with the reference's names (config.py:
# 139-153): the gateway's port, the address clients and host observers
# reach it at, its HMAC secret, its durable queue's directory, the
# scheduler's cadence, a tenant's slot quota (0 = unlimited), priority
# preemption and the commit wait before a preemption is forced; the job
# a worker belongs to, the host observer's push cadence (0 = off) and
# the samples the gateway keeps a job.
FLEET_PORT = "FLEET_PORT"
FLEET_ADDR = "FLEET_ADDR"
FLEET_SECRET = "FLEET_SECRET"
FLEET_DIR = "FLEET_DIR"
FLEET_TICK_S = "FLEET_TICK_S"
FLEET_QUOTA_SLOTS = "FLEET_QUOTA_SLOTS"
FLEET_PREEMPTION = "FLEET_PREEMPTION"
FLEET_PREEMPT_GRACE_S = "FLEET_PREEMPT_GRACE_S"
FLEET_JOB_ID = "FLEET_JOB_ID"
FLEET_OBSERVE_PUSH_S = "FLEET_OBSERVE_PUSH_S"
FLEET_OBSERVE_RETAIN = "FLEET_OBSERVE_RETAIN"

# Peer-to-peer hot recovery (recovery/) and its seeded fault injection
# (recovery/chaos.py), with the reference's names and defaults
# (config.py:112-125, :364-372, :559-561): buddy replication on, the buddy
# ring's shift (0 = the local world size), the chaos schedule's seed, its
# "rank@step,..." kills, its "<point>[@step]" commit-window crash, the
# slow-peer latency and the ranks whose buddy copies tear.  The chaos
# layer is inert unless one CHAOS_* knob is set.
RECOVERY = "RECOVERY"
RECOVERY_STRIDE = "RECOVERY_STRIDE"
# Elastic training (elastic/, runner/elastic_driver.py), with the
# reference's names and defaults (config.py:56, :115, :373, :495): the
# driver's mark on the workers it spawns, and the background disk
# committer of ``TpuState``.
ELASTIC = "ELASTIC"
ASYNC_COMMIT = "ASYNC_COMMIT"
CHAOS_SEED = "CHAOS_SEED"
CHAOS_KILL_STEPS = "CHAOS_KILL_STEPS"
CHAOS_COMMIT_CRASH = "CHAOS_COMMIT_CRASH"
CHAOS_SLOW_PEER_MS = "CHAOS_SLOW_PEER_MS"
CHAOS_TORN_RANKS = "CHAOS_TORN_RANKS"
# The slowdown drills of the drift diagnosis (reference config.py:124-125):
# extra host latency a batch of the input pipeline (data/prefetch.py) and
# before each eager collective (ops/collective.py).
CHAOS_INPUT_DELAY_MS = "CHAOS_INPUT_DELAY_MS"
CHAOS_COMM_DELAY_MS = "CHAOS_COMM_DELAY_MS"

# The self-healing wire fabric (net/, native/src/net.cc), with the
# reference's names and defaults (config.py:126-136, :193-200, :438-443,
# :630-639).  The native ladder's knobs and the CHAOS_NET_* knobs are
# parsed in C by the runtime as well; the HTTP planes read the attempts
# per request, the backoff's base and the CHAOS_NET_* schedule here.
NET_RESILIENCE = "NET_RESILIENCE"
NET_PROBE_MS = "NET_PROBE_MS"
NET_RECONNECT_S = "NET_RECONNECT_S"
NET_OP_DEADLINE_S = "NET_OP_DEADLINE_S"
NET_MAX_RENEG = "NET_MAX_RENEG"
NET_RENEGOTIATE = "NET_RENEGOTIATE"
NET_HTTP_RETRIES = "NET_HTTP_RETRIES"
NET_HTTP_BACKOFF_MS = "NET_HTTP_BACKOFF_MS"
CHAOS_NET_SEED = "CHAOS_NET_SEED"
CHAOS_NET_DROP_PCT = "CHAOS_NET_DROP_PCT"
CHAOS_NET_RESET_PCT = "CHAOS_NET_RESET_PCT"
CHAOS_NET_DELAY_MS = "CHAOS_NET_DELAY_MS"
CHAOS_NET_TRUNCATE = "CHAOS_NET_TRUNCATE"
CHAOS_NET_BLACKHOLE = "CHAOS_NET_BLACKHOLE"


@dataclasses.dataclass(frozen=True)
class TelemetryDefaults:
    """The telemetry knobs' defaults (reference ``Config``,
    config.py:326-362), read by the modules that consume each knob (the
    straggler detector keeps its defaults beside its reads, as the
    reference's does)."""
    metrics_sync_steps: int = 0
    metrics_port: int = 0
    metrics_retain_files: int = 3
    attribution: bool = True
    peak_tflops: float = 0.0
    perf_drift: bool = True
    perf_drift_warmup: int = 30
    perf_drift_threshold: float = 8.0
    perf_drift_min_pct: float = 10.0
    perf_drift_cooldown: int = 50
    perf_drift_lookback_s: float = 120.0
    flight_disable: bool = False
    flight_capacity: int = 4096
    flight_port: int = 0
    flight_last_events: int = 20
    flight_escalate: bool = True
    metrics_tree: bool = False
    metrics_topk: int = 4
    metrics_tree_timeout_s: float = 10.0
    metrics_tree_grace_s: float = 2.0
    fleet_observe_push_s: float = 0.0


TELEMETRY = TelemetryDefaults()


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
    overlap: bool = False
    overlap_bucket_bytes: int = DEFAULT_OVERLAP_BUCKET_BYTES
    autotune: bool = False
    autotune_log: str = ""
    autotune_warmup_samples: int = 3
    autotune_steps_per_sample: int = 0
    autotune_bayes_opt_max_samples: int = 20
    autotune_gaussian_process_noise: float = 0.8

    @classmethod
    def from_env(cls) -> "ControllerConfig":
        d = cls()

        def integer(name, default):
            val = get_int(name)
            return default if val is None else val

        tune = get_bool(AUTOTUNE)
        # A tuned job starts from a 128 MiB threshold unless one is set
        # (reference config.py:640-641).
        fusion = integer(FUSION_THRESHOLD, d.fusion_threshold_bytes)
        if tune and get_env(FUSION_THRESHOLD) is None:
            fusion = 128 * 1024 * 1024
        return cls(
            fusion_threshold_bytes=fusion,
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
            overlap=overlap(),
            overlap_bucket_bytes=overlap_bucket_bytes(),
            autotune=tune,
            autotune_log=get_env(AUTOTUNE_LOG, "") or "",
            autotune_warmup_samples=integer(AUTOTUNE_WARMUP_SAMPLES,
                                            d.autotune_warmup_samples),
            autotune_steps_per_sample=integer(AUTOTUNE_STEPS_PER_SAMPLE,
                                              d.autotune_steps_per_sample),
            autotune_bayes_opt_max_samples=integer(
                AUTOTUNE_BAYES_OPT_MAX_SAMPLES,
                d.autotune_bayes_opt_max_samples),
            autotune_gaussian_process_noise=get_float(
                AUTOTUNE_GAUSSIAN_PROCESS_NOISE,
                d.autotune_gaussian_process_noise))


@dataclasses.dataclass(frozen=True)
class LoopDefaults:
    """The tuner's closed-loop defaults (reference ``Config``,
    config.py:270-274), read where the loop reads them (autotune.py,
    fleet/tuning.py), unclamped as there."""
    autotune_memory: bool = True
    autotune_memory_dir: str = "./autotune_memory"
    autotune_retune: bool = True
    autotune_retune_windows: int = 6
    autotune_rollback_pct: float = 5.0


LOOP = LoopDefaults()


def autotune_memory() -> bool:
    return get_bool(AUTOTUNE_MEMORY, LOOP.autotune_memory)


def autotune_memory_dir() -> str:
    return get_env(AUTOTUNE_MEMORY_DIR, LOOP.autotune_memory_dir) \
        or LOOP.autotune_memory_dir


def autotune_retune() -> bool:
    return get_bool(AUTOTUNE_RETUNE, LOOP.autotune_retune)


def autotune_retune_windows() -> int:
    return get_int_or(AUTOTUNE_RETUNE_WINDOWS, LOOP.autotune_retune_windows)


def autotune_rollback_pct() -> float:
    return get_float(AUTOTUNE_ROLLBACK_PCT, LOOP.autotune_rollback_pct)


def get_int_or(name: str, default: int) -> int:
    """An integer knob, or ``default`` when unset or not an integer (the
    reference's ``get_int``)."""
    val = get_int(name)
    return default if val is None else val


def serving_port() -> int:
    return get_int_or(SERVING_PORT, 28643)


def serving_addr() -> Optional[str]:
    return get_env(SERVING_ADDR)


def serving_secret() -> Optional[str]:
    return get_env(SERVING_SECRET)


def serving_slots() -> int:
    return max(1, get_int_or(SERVING_SLOTS, 8))


def serving_page_tokens() -> int:
    return max(1, get_int_or(SERVING_PAGE_TOKENS, 16))


def serving_max_len() -> int:
    """The context a slot holds; 0 = the model's seq_len."""
    return max(0, get_int_or(SERVING_MAX_LEN, 0))


def serving_max_new_tokens() -> int:
    return max(1, get_int_or(SERVING_MAX_NEW_TOKENS, 64))


def serving_queue_cap() -> int:
    """At least 1: a cap of 0 would shed every request at ingress."""
    return max(1, get_int_or(SERVING_QUEUE_CAP, 64))


def serving_swap_poll_s() -> float:
    return max(0.05, get_float(SERVING_SWAP_POLL_S, 2.0))


def serving_prefix_cache() -> bool:
    return get_bool(SERVING_PREFIX_CACHE, True)


def serving_prefill_chunk() -> int:
    """Prompt tokens prefilled an iteration; 0 = the whole prompt."""
    return max(0, get_int_or(SERVING_PREFILL_CHUNK, 0))


def serving_aging_s() -> float:
    return max(0.0, get_float(SERVING_AGING_S, 0.0))


def serving_slo_ttft_s() -> float:
    return max(0.0, get_float(SERVING_SLO_TTFT_S, 0.0))


def spec_k() -> int:
    """Draft tokens a speculative round, 0 (off) to 32."""
    return min(32, max(0, get_int_or(SPEC_K, 0)))


def trace_sample() -> float:
    return min(1.0, max(0.0, get_float(TRACE_SAMPLE, 0.01)))


def trace_seed() -> int:
    return get_int_or(TRACE_SEED, 0)


def serving_target_queue() -> float:
    return max(0.5, get_float(SERVING_TARGET_QUEUE, 4.0))


def serving_scale_cooldown_s() -> float:
    return max(0.0, get_float(SERVING_SCALE_COOLDOWN_S, 10.0))


def serving_migrate_bits() -> int:
    """The KV-migration wire: 0 (fp32), 8 or 4; anything else is 8."""
    bits = get_int_or(SERVING_MIGRATE_BITS, 8)
    return bits if bits in (0, 4, 8) else 8


def slo_target() -> float:
    return min(0.9999, max(0.5, get_float(SLO_TARGET, 0.99)))


def slo_window_s() -> float:
    return max(1.0, get_float(SLO_WINDOW_S, 300.0))


def slo_burn_threshold() -> float:
    return max(0.01, get_float(SLO_BURN_THRESHOLD, 1.0))


# ---------------------------------------------------------------------------
# the telemetry plane
# ---------------------------------------------------------------------------

def metrics_sync_steps() -> int:
    return max(0, get_int_or(METRICS_SYNC_STEPS, TELEMETRY.metrics_sync_steps))


def metrics_port() -> int:
    return get_int_or(METRICS_PORT, TELEMETRY.metrics_port)


def metrics_tree() -> bool:
    return get_bool(METRICS_TREE, TELEMETRY.metrics_tree)


def metrics_topk() -> int:
    """Outlier evidence a host digest keeps (at least 0)."""
    return max(get_int_or(METRICS_TOPK, TELEMETRY.metrics_topk), 0)


def metrics_tree_timeout_s() -> float:
    """The inter-host exchange's deadline (at least 0.5 s)."""
    return max(get_float(METRICS_TREE_TIMEOUT_S,
                         TELEMETRY.metrics_tree_timeout_s), 0.5)


def metrics_tree_grace_s() -> float:
    """How long an observer waits for laggard local snapshots before it
    seals a round partial (at least 0.1 s)."""
    return max(get_float(METRICS_TREE_GRACE_S,
                         TELEMETRY.metrics_tree_grace_s), 0.1)


@dataclasses.dataclass(frozen=True)
class FleetDefaults:
    """The fleet service's defaults (reference ``Config``,
    config.py:385-392)."""
    fleet_port: int = 28642
    fleet_dir: str = "./fleet_state"
    fleet_tick_s: float = 0.5
    fleet_quota_slots: int = 0
    fleet_preemption: bool = True
    fleet_preempt_grace_s: float = 30.0
    fleet_observe_retain: int = 512


FLEET = FleetDefaults()


def fleet_port() -> int:
    return get_int_or(FLEET_PORT, FLEET.fleet_port)


def fleet_dir() -> str:
    return get_env(FLEET_DIR, FLEET.fleet_dir) or FLEET.fleet_dir


def fleet_secret() -> Optional[str]:
    return get_env(FLEET_SECRET)


def fleet_tick_s() -> float:
    """The scheduler's cadence as the gateway reads it (unclamped, as the
    reference's scheduler reads it)."""
    return get_float(FLEET_TICK_S, FLEET.fleet_tick_s)


def fleet_quota_slots() -> int:
    return get_int_or(FLEET_QUOTA_SLOTS, FLEET.fleet_quota_slots)


def fleet_preemption() -> bool:
    return get_bool(FLEET_PREEMPTION, FLEET.fleet_preemption)


def fleet_preempt_grace_s() -> float:
    return get_float(FLEET_PREEMPT_GRACE_S, FLEET.fleet_preempt_grace_s)


def fleet_observe_retain() -> int:
    return get_int_or(FLEET_OBSERVE_RETAIN, FLEET.fleet_observe_retain)


def fleet_addr() -> Optional[str]:
    return get_env(FLEET_ADDR)


def fleet_job_id() -> Optional[str]:
    return get_env(FLEET_JOB_ID)


def fleet_observe_push_s() -> float:
    return max(0.0, get_float(FLEET_OBSERVE_PUSH_S,
                              TELEMETRY.fleet_observe_push_s))


def flight_disable() -> bool:
    return get_bool(FLIGHT_DISABLE, TELEMETRY.flight_disable)


def flight_port() -> int:
    return get_int_or(FLIGHT_PORT, TELEMETRY.flight_port)


def flight_escalate() -> bool:
    return get_bool(FLIGHT_ESCALATE, TELEMETRY.flight_escalate)


def flight_dir() -> str:
    return get_env(FLIGHT_DIR, ".") or "."


def perf_drift_lookback_s() -> float:
    """The regression report's look-back before a drift's onset, read as
    the reference's report reads it (unclamped)."""
    return get_float(PERF_DRIFT_LOOKBACK_S, TELEMETRY.perf_drift_lookback_s)


# ---------------------------------------------------------------------------
# peer recovery and the wire fabric
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RecoveryDefaults:
    """The defaults of the recovery, HTTP-retry and elastic knobs read
    here (reference ``Config``, config.py:293, :364-373, :441-443); the
    native ladder reads its own copy of the operation deadline
    (``native/src/net.cc``)."""
    recovery: bool = True
    recovery_stride: int = 0
    net_http_retries: int = 3
    net_http_backoff_ms: float = 50.0
    net_op_deadline_s: float = 60.0
    elastic: bool = False
    async_commit: bool = False


RECOVERY_DEFAULTS = RecoveryDefaults()


def recovery() -> bool:
    """Buddy replication at commit and the peer restore before the disk."""
    return get_bool(RECOVERY, RECOVERY_DEFAULTS.recovery)


def recovery_stride() -> int:
    """The buddy ring's shift; 0 = the local world size."""
    return max(0, get_int_or(RECOVERY_STRIDE,
                             RECOVERY_DEFAULTS.recovery_stride))


def net_http_retries() -> int:
    """Attempts per HTTP request, at least 1."""
    return max(1, get_int_or(NET_HTTP_RETRIES,
                             RECOVERY_DEFAULTS.net_http_retries))


def net_http_backoff_ms() -> float:
    return get_float(NET_HTTP_BACKOFF_MS,
                     RECOVERY_DEFAULTS.net_http_backoff_ms)


def net_op_deadline_s() -> float:
    """The per-operation deadline of the wire fabric; an elastic world's
    process-group timeout (core/failure.py)."""
    return get_float(NET_OP_DEADLINE_S, RECOVERY_DEFAULTS.net_op_deadline_s)


def elastic() -> bool:
    return get_bool(ELASTIC, RECOVERY_DEFAULTS.elastic)


def async_commit() -> bool:
    return get_bool(ASYNC_COMMIT, RECOVERY_DEFAULTS.async_commit)
