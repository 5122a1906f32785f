"""``hvd.metrics`` — runtime telemetry, cross-rank aggregation and
straggler health (port of horovod_tpu/metrics/__init__.py).

* :mod:`.registry` — thread-safe Counters / Gauges / fixed-bucket
  Histograms; every subsystem records here (``hvd.metrics.registry()``).
* :mod:`.aggregate` — ``step_end()`` per training step; on the
  ``HVD_TPU_METRICS_SYNC_STEPS`` cadence, allgathers compact per-rank
  snapshots so every rank holds a fleet view (off by default).
* :mod:`.health` — straggler detection over the aggregated step-time and
  data-wait distributions, and a ``blacklist_hint()``.
* :mod:`.exporters` — Prometheus text format at ``/metrics`` (started by
  ``init()`` when ``HVD_TPU_METRICS_PORT`` is set) and a rotating JSONL
  sink.
* :mod:`.attribution` — every ``step_end`` decomposes the step's wall
  time into compute / exposed comm / hidden comm / input / checkpoint /
  pipeline bubble / host gap (``hvd_step_attribution_seconds
  {component}``) and grades live MFU (``set_step_flops`` →
  ``hvd_mfu_ratio`` against the card's peak).
* :mod:`.digest` — the mergeable digest algebra and its read side.
* :mod:`.observer` — the per-host observer of the host-sharded sync
  (``HVD_TPU_METRICS_TREE``): ranks hand their snapshots to their host's
  observer, hosts exchange O(hosts) digests through the rendezvous KV,
  and ``/observe/*`` serves the digests and one host's flight dumps.
* :mod:`.baseline` — EWMA/CUSUM drift detection over step time and
  component shares; a sustained regression emits a ``perf.drift`` flight
  event.

Instrumented: the collectives (ops/bytes/latency per kind, on CUDA the
latency from CUDA events), the negotiated plane (fusion batch size,
response-cache hit rate, staged and wire bytes), the overlap queues, the
dispatch probe, the input pipeline (data-wait spans, stalls), the
checkpoint engine (save/restore durations and bytes), the pipeline
schedule's bubble, and the serving plane (``hvd_serving_*``,
``hvd_slo_*``).
"""

from .registry import (
    Counter, Gauge, Histogram, MetricsRegistry,
    DEFAULT_BYTE_BUCKETS, DEFAULT_TIME_BUCKETS,
    enabled, registry, set_enabled,
)
from .aggregate import (
    Aggregator, aggregator, fleet_digest, fleet_snapshot, step_end,
    sync,
)
from .digest import (
    QuantileSketch, digest_mfu, digest_shares, digest_step_quantiles,
    merge_all, merge_digests, snapshot_digest,
)
from .health import (
    RankHealth, StragglerDetector, blacklist_hint, detector,
    straggler_report,
)
from .exporters import (
    JsonlSink, MetricsServer, render_prometheus, serve, stop_serving,
)
# NB: the engine accessor `attribution()` is deliberately NOT re-exported
# here — binding it onto the package would shadow the
# `metrics.attribution` SUBMODULE.  Reach it via the submodule:
# `from horovod_tpu_torch.metrics.attribution import attribution`.
from .attribution import (
    COMPONENTS, WALL_COMPONENTS, StepAttribution, compute_span,
    last_attribution, note_pipeline_bubble, peak_flops, set_step_flops,
)
from .baseline import (
    DriftDetector, DriftEvent, drift_detector, last_drift_event,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_BYTE_BUCKETS", "DEFAULT_TIME_BUCKETS",
    "enabled", "registry", "set_enabled",
    "Aggregator", "aggregator", "fleet_digest", "fleet_snapshot",
    "step_end", "sync",
    "QuantileSketch", "digest_mfu", "digest_shares",
    "digest_step_quantiles", "merge_all", "merge_digests",
    "snapshot_digest",
    "RankHealth", "StragglerDetector", "blacklist_hint", "detector",
    "straggler_report",
    "JsonlSink", "MetricsServer", "render_prometheus", "serve",
    "stop_serving",
    "COMPONENTS", "WALL_COMPONENTS", "StepAttribution", "compute_span",
    "last_attribution", "note_pipeline_bubble", "peak_flops",
    "set_step_flops",
    "DriftDetector", "DriftEvent", "drift_detector", "last_drift_event",
]
