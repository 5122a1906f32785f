"""Per-step time attribution and live MFU (port of
horovod_tpu/metrics/attribution.py).

``metrics.step_end()`` closes a record that decomposes the step's wall
time into where it went:

* ``input`` — blocking input-pipeline wait (``hvd_data_wait_*``, the
  spans ``utils/profiler.data_wait`` and the prefetch consumer record).
* ``comm_exposed`` — wire time the step paid: the collectives' latency
  (``hvd_collective_latency_seconds``) plus the overlap queues' measured
  submit+blocked seconds, minus the overlap-submitted share that landed
  in both (``hvd_overlap_fallback_latency_seconds_total``).  On a CUDA
  tensor a collective's latency is the device time the compute stream
  was held by it, read from a pair of CUDA events
  (``ops/collective.py``); the pairs are drained here, at each close,
  once ``compute_span`` has synchronised.
* ``comm_hidden`` — wire time the overlap queues hid behind compute.
  Informational: not part of the wall-time decomposition.
* ``checkpoint`` — blocking save/restore/commit seconds
  (``hvd_checkpoint_blocking_seconds_total``).
* ``pipeline_bubble`` — the pipeline schedule's fill/drain idle seconds
  (``parallel/pipeline.note_bubble``), carved out of compute.
* ``compute`` — the device-step span when the loop brackets it with
  :func:`compute_span`, which synchronises the current CUDA stream before
  it closes (the reference's span "dispatches and waits on the training
  computation"; without the wait it would time only the launches); else
  the residual after the measured components.  Because of that wait the
  span also holds the CUDA-event time of the collectives issued inside
  it, which ``comm_exposed`` already counts: that time is taken out of
  the span, so each second is counted once.
* ``host`` — the unattributed host gap, non-zero only when compute is
  measured.

Exported as ``hvd_step_attribution_seconds{component}`` (last step) and
``hvd_step_attribution_seconds_total{component}`` (cumulative), plus an
optional per-step JSONL trail (``HVD_TPU_ATTRIBUTION_JSONL``).

**Live MFU**: :func:`set_step_flops` declares the model FLOPs one step
executes on this GPU (``models.transformer.train_flops_per_seq`` times
the batch); every ``step_end`` grades ``hvd_mfu_ratio = flops /
(step_time * peak)`` against :func:`peak_flops`: ``HVD_TPU_PEAK_TFLOPS``
when set, else the detected card's dense bf16 peak by name (H100 SXM,
"NVIDIA H100 80GB HBM3": 989.4 TFLOP/s; H100 PCIe: 756), else None (no
MFU).

Disable with ``HVD_TPU_ATTRIBUTION=0`` or :func:`set_enabled`.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

from ..core import config as _config
from .registry import registry as _registry

# The decomposition components, in the order reports print them.
# "comm_hidden" is informational (overlapped wire time, not wall time);
# the others partition the step's wall clock.  WALL_COMPONENTS is
# the single home — the drift detector (baseline.py) and the straggler
# cause attribution (health.py) import it, so a future component is
# considered everywhere or nowhere.  "pipeline_bubble" is the schedule
# fill/drain idle share of a pipeline-parallel step (reported by
# parallel/pipeline.note_bubble via hvd_pipeline_bubble_seconds_total);
# it is carved OUT of the measured compute span — the device is live
# but idling, and a bubble that grows with a geometry change should
# drift as its own component, not hide inside compute.
COMPONENTS = ("compute", "comm_exposed", "comm_hidden", "input",
              "checkpoint", "pipeline_bubble", "host")
WALL_COMPONENTS = ("compute", "comm_exposed", "input", "checkpoint",
                   "pipeline_bubble", "host")

_enabled: Optional[bool] = None


def enabled() -> bool:
    global _enabled
    if _enabled is None:
        _enabled = _config.get_bool(_config.ATTRIBUTION,
                                    _config.TELEMETRY.attribution)
    return _enabled


def set_enabled(flag: Optional[bool]) -> None:
    """Toggle attribution (None = re-read the env knob)."""
    global _enabled
    _enabled = None if flag is None else bool(flag)


# ---------------------------------------------------------------------------
# card peak resolution (HVD_TPU_PEAK_TFLOPS -> detected card -> None)
# ---------------------------------------------------------------------------

# Dense bf16 FLOP/s by device-name substring (NVIDIA's spec sheets), most
# specific first: "NVIDIA H100 80GB HBM3" is the SXM card.  An unknown card
# gives None, as an unknown chip does in the reference.
PEAK_FLOPS_BY_NAME = (
    ("h100 pcie", 756e12),
    ("h100 80gb hbm3", 989.4e12),
    ("h100 sxm", 989.4e12),
)

_peak: Optional[float] = None
_peak_known = False


def peak_for_name(name: str) -> Optional[float]:
    """The dense bf16 peak of a card named ``name``, or None."""
    name = name.lower()
    for key, peak in PEAK_FLOPS_BY_NAME:
        if key in name:
            return peak
    return None


def peak_flops() -> Optional[float]:
    """The FLOP/s ceiling ``hvd_mfu_ratio`` grades against.

    ``HVD_TPU_PEAK_TFLOPS`` (TFLOP/s) wins when set — the calibration
    knob.  Otherwise the peak of ``torch.cuda.get_device_name()``; None
    without a CUDA device or on an unknown card (MFU is then not
    computed).  Cached after the first resolution (this runs at every
    ``close_step``); :func:`reset_peak_cache` re-reads the knob."""
    global _peak, _peak_known
    if _peak_known:
        return _peak
    tf = _config.get_float(_config.PEAK_TFLOPS,
                           _config.TELEMETRY.peak_tflops)
    if tf > 0:
        _peak = tf * 1e12
    else:
        _peak = None
        try:
            import torch
            if torch.cuda.is_available():
                _peak = peak_for_name(torch.cuda.get_device_name())
        except Exception:  # noqa: BLE001 — observability never breaks
            _peak = None
    _peak_known = True
    return _peak


def reset_peak_cache() -> None:
    global _peak, _peak_known
    _peak = None
    _peak_known = False


# Source drains: callables run before each read of the source counters.
# ``ops/collective.py`` registers the one that observes the latency of
# completed CUDA-event pairs.
_drains: List = []

# Open compute spans (any thread: autograd runs gradient hooks, and so
# their collectives, on its own threads).
_spans_open = 0
_spans_lock = threading.Lock()


def in_compute_span() -> bool:
    """Whether a :func:`compute_span` is open in this process."""
    return _spans_open > 0


def add_source_drain(fn) -> None:
    """Run ``fn()`` before every read of the source counters (once per
    ``fn``)."""
    if fn not in _drains:
        _drains.append(fn)


def _device_sync() -> None:
    """Wait for the current CUDA stream when CUDA is in use."""
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()


# ---------------------------------------------------------------------------
# the attribution engine
# ---------------------------------------------------------------------------

def _family_read(reg, name: str, histogram: bool = False):
    """(sum, resets-generation) of a family's children — read-only,
    never creates the family.  The generation lets close_step tell a
    mid-step counter reset (epoch-boundary reset_data_wait_stats, a
    registry reset) from a genuine zero delta.

    Reads the slots directly instead of the locked properties: this
    runs every step_end across six families, GIL-atomic attribute reads
    are safe for a monitoring consumer, and the child locks are pure
    overhead here (bench.py --bench attribution prices this path)."""
    total, gen = 0.0, 0
    for child in reg.children_of(name):
        total += child._sum if histogram else child._value
        gen += getattr(child, "_resets", 0)
    return total, gen


class StepAttribution:
    """Window-marked delta reader over the subsystem counters.

    One instance per process (:func:`attribution`); separate instances
    exist only in tests.  ``close_step`` is called by
    ``Aggregator.step_end`` with the step's wall time; everything else
    is bookkeeping for the cross-rank snapshot (windowed component sums
    ride the aggregation wire so stragglers are attributed *by
    component*, metrics/health.py)."""

    def __init__(self, reg=None):
        self._reg = reg or _registry()
        self._lock = threading.Lock()
        self._marks: Optional[Dict[str, float]] = None
        self._compute_total = 0.0          # compute_span accumulations
        self._comm_in_span = 0.0           # of it, collectives' CUDA time
        self._flops_per_step = 0.0
        self._last: Optional[dict] = None
        # Windowed (since last advance_window) sums for the aggregation
        # snapshot; "steps"/"flops"/"wall" ride along so consumers can
        # form per-step means and MFU over the SAME step set.
        self._win: Dict[str, float] = {}
        self._win_steps = 0
        self._win_flops = 0.0
        self._win_wall = 0.0
        self._sink = None
        self._sink_failed = False
        self._gauges: Dict[str, object] = {}
        self._totals: Dict[str, object] = {}
        self._mfu_gauge = None
        self._flops_gauge = None
        self._bubble = None

    # -- inputs ------------------------------------------------------------

    def set_step_flops(self, flops: float) -> None:
        """Declare the model FLOPs ONE training step executes on this
        GPU (batch x per-element FLOPs).  Sticky until changed."""
        with self._lock:
            self._flops_per_step = max(0.0, float(flops))

    def note_compute(self, seconds: float) -> None:
        """Report measured device-compute seconds (the alternative to
        :func:`compute_span` for loops that already time the step)."""
        if seconds > 0:
            with self._lock:
                self._compute_total += float(seconds)

    def note_comm_in_span(self, seconds: float) -> None:
        """Report the CUDA-event seconds of a collective issued inside a
        compute span: the span's wait holds them too, and they come out
        of ``compute`` (``comm_exposed`` counts them)."""
        if seconds > 0:
            with self._lock:
                self._comm_in_span += float(seconds)

    def note_pipeline_bubble(self, seconds: float) -> None:
        """Credit measured pipeline-bubble seconds (schedule fill/drain
        idle inside the compute span) to the source counter the
        decomposition reads.  Callers: ``parallel/pipeline.note_bubble``
        with ``bubble_fraction(...) * span``."""
        if seconds > 0:
            if self._bubble is None:
                self._bubble = self._reg.counter(
                    "hvd_pipeline_bubble_seconds_total",
                    "Pipeline-schedule bubble (fill/drain idle) seconds")
            self._bubble.inc(float(seconds))

    @contextlib.contextmanager
    def compute_span(self):
        """Bracket the device-blocking part of the step — the call that
        dispatches and waits on the training computation.  On CUDA the
        span synchronises the current stream before it closes, so it
        times the device work and not only its launches.  With the span
        present, ``compute`` is measured and ``host`` becomes a real
        unattributed gap instead of zero."""
        global _spans_open
        with _spans_lock:
            _spans_open += 1
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _device_sync()
            self.note_compute(time.perf_counter() - t0)
            with _spans_lock:
                _spans_open -= 1

    # -- source reads ------------------------------------------------------

    def _read_sources(self) -> Dict[str, float]:
        for drain in _drains:
            drain()
        reg = self._reg
        with self._lock:
            out = {"compute": self._compute_total,
                   "comm_in_span": self._comm_in_span}
        gen = 0
        for key, fam, hist in (
                ("input", "hvd_data_wait_seconds_total", False),
                ("comm_lat", "hvd_collective_latency_seconds", True),
                ("ovl_exposed",
                 "hvd_overlap_comm_exposed_seconds_total", False),
                ("ovl_fallback",
                 "hvd_overlap_fallback_latency_seconds_total", False),
                ("ovl_hidden",
                 "hvd_overlap_comm_hidden_seconds_total", False),
                ("checkpoint",
                 "hvd_checkpoint_blocking_seconds_total", False),
                ("pipeline_bubble",
                 "hvd_pipeline_bubble_seconds_total", False)):
            out[key], g = _family_read(reg, fam, histogram=hist)
            gen += g
        out["_gen"] = gen
        return out

    # -- the per-step close ------------------------------------------------

    def close_step(self, step: int, dur_s: float,
                   sync_exports: bool = True) -> Optional[dict]:
        """Decompose one step of ``dur_s`` wall seconds; update gauges,
        window sums and the JSONL trail; return the record."""
        if dur_s is None or dur_s <= 0:
            return None
        cur = self._read_sources()
        with self._lock:
            marks, self._marks = self._marks, cur
        if marks is None:
            # First close: no window to diff yet — anchor and move on.
            return None
        if cur.get("_gen", 0) != marks.get("_gen", 0) or any(
                cur[k] < marks.get(k, 0.0) for k in cur if k != "_gen"):
            # A source counter was reset inside this step (epoch-
            # boundary reset_data_wait_stats(), a registry reset): the
            # window straddles the discontinuity and any decomposition
            # would misattribute the vanished seconds to compute — skip
            # this one record, freshly anchored, rather than lie.
            return None
        d = {k: max(cur[k] - marks.get(k, 0.0), 0.0)
             for k in cur if k != "_gen"}

        ovl_exposed = d["ovl_exposed"]
        # Overlap's sync-fallback submits land in the latency histogram
        # too; its native/device async submits do NOT.  Subtract exactly
        # the fallback share (measured at the submit site,
        # ops/collective.overlap_submit_scope) so overlap-managed wire
        # time counts once without erasing genuine non-overlap latency.
        comm_exposed = max(d["comm_lat"] - d["ovl_fallback"], 0.0) \
            + ovl_exposed
        comm_hidden = d["ovl_hidden"]
        input_s = d["input"]
        ckpt_s = d["checkpoint"]
        measured = d["compute"] > 0.0
        compute_meas = max(d["compute"] - d["comm_in_span"], 0.0)
        # The bubble is reported as a share of the pipeline span, which
        # lives INSIDE the compute span — split it out so schedule idle
        # and useful compute drift independently.  Clamp to the measured
        # compute when both are present (a bubble cannot exceed the span
        # it was carved from).
        bubble_s = d["pipeline_bubble"]
        if measured:
            bubble_s = min(bubble_s, compute_meas)

        attributed = input_s + ckpt_s + comm_exposed + bubble_s
        if measured:
            compute_s = compute_meas - bubble_s
            host_s = dur_s - attributed - compute_s
        else:
            compute_s = max(dur_s - attributed, 0.0)
            host_s = 0.0
        if host_s < 0.0 or attributed + compute_s > dur_s:
            # Over-attribution (e.g. a background thread's seconds
            # leaking into a blocking counter, or timer skew) — on the
            # measured-compute path host goes negative, on the residual
            # path compute clamps to 0 with the rest still exceeding
            # the step: either way, normalize the wall components onto
            # the step so shares stay sane.
            total = attributed + compute_s
            if total > 0:
                scale = dur_s / total
                input_s *= scale
                ckpt_s *= scale
                comm_exposed *= scale
                bubble_s *= scale
                compute_s *= scale
            host_s = 0.0

        comps = {"compute": compute_s, "comm_exposed": comm_exposed,
                 "comm_hidden": comm_hidden, "input": input_s,
                 "checkpoint": ckpt_s, "pipeline_bubble": bubble_s,
                 "host": host_s}
        shares = {k: (comps[k] / dur_s) for k in WALL_COMPONENTS}

        with self._lock:
            flops = self._flops_per_step
            self._win_steps += 1
            self._win_flops += flops
            self._win_wall += dur_s
            for k, v in comps.items():
                self._win[k] = self._win.get(k, 0.0) + v
        peak = peak_flops() if flops > 0 else None
        mfu = (flops / (dur_s * peak)) if peak else None

        record = {"step": int(step), "dur_s": dur_s,
                  "components": comps, "shares": shares,
                  "flops": flops, "mfu": mfu}
        with self._lock:
            self._last = record
        if sync_exports:
            self._export(record)
        return record

    def _export(self, record: dict) -> None:
        reg = self._reg
        if not self._gauges:
            for k in COMPONENTS:
                self._gauges[k] = reg.gauge(
                    "hvd_step_attribution_seconds",
                    "Last step's wall-time decomposition (comm_hidden "
                    "is informational overlapped wire time, not wall)",
                    component=k)
                self._totals[k] = reg.counter(
                    "hvd_step_attribution_seconds_total",
                    "Cumulative attributed seconds by component",
                    component=k)
            self._mfu_gauge = reg.gauge(
                "hvd_mfu_ratio",
                "Model FLOPs utilization of the last step "
                "(set_step_flops / peak_flops; see HVD_TPU_PEAK_TFLOPS)")
            self._flops_gauge = reg.gauge(
                "hvd_step_model_flops",
                "Declared model FLOPs per step (set_step_flops)")
        for k, v in record["components"].items():
            self._gauges[k].set(v)
            self._totals[k].inc(max(v, 0.0))
        if record["flops"] > 0:
            self._flops_gauge.set(record["flops"])
        if record["mfu"] is not None:
            self._mfu_gauge.set(record["mfu"])
        self._write_jsonl(record)

    def _write_jsonl(self, record: dict) -> None:
        # The path knob is read ONCE, at the first close (an env read
        # per step is measurable at the <1% budget); :meth:`reset`
        # clears the latch, so a knob set later takes effect at the
        # next engine reset.
        if self._sink is None and not self._sink_failed:
            path = _config.get_env("ATTRIBUTION_JSONL", "") or ""
            if not path:
                self._sink_failed = True
                return
            try:
                from .exporters import JsonlSink
                self._sink = JsonlSink(path)
            except Exception:  # noqa: BLE001 — telemetry never kills
                self._sink_failed = True
                return
        if self._sink is not None:
            try:
                self._sink.write(record)
            except Exception:  # noqa: BLE001
                self._sink_failed = True
                self._sink = None

    # -- read side / windows ----------------------------------------------

    def last_record(self) -> Optional[dict]:
        with self._lock:
            return dict(self._last) if self._last is not None else None

    def window_components(self) -> Dict[str, float]:
        """Component seconds accumulated since the last
        :meth:`advance_window` — the cross-rank snapshot payload."""
        with self._lock:
            out = dict(self._win)
            out["steps"] = float(self._win_steps)
            out["flops"] = self._win_flops
            out["wall"] = self._win_wall
            return out

    def window_shares(self) -> Optional[Dict[str, float]]:
        """Normalized wall-component shares of the CURRENT window —
        component seconds divided by the window's wall seconds, the
        multi-step view of a single record's ``shares``.  This is the
        structured signal the autotuner consumes (autotune.py): one
        sample window spans many steps, so the tuner wants the window
        mean, not whichever step happened to close last.  None before
        any record landed in the window."""
        with self._lock:
            wall = self._win_wall
            if wall <= 0.0:
                return None
            return {k: self._win.get(k, 0.0) / wall
                    for k in WALL_COMPONENTS}

    def advance_window(self) -> None:
        with self._lock:
            self._win = {}
            self._win_steps = 0
            self._win_flops = 0.0
            self._win_wall = 0.0

    def reanchor(self) -> None:
        """Re-anchor the delta marks at the counters' CURRENT values and
        open a fresh window — the elastic-reset hook: restore-time
        checkpoint/comm seconds spent *between* training runs must not
        be attributed to the first post-reset step."""
        cur = self._read_sources()
        with self._lock:
            self._marks = cur
            self._win = {}
            self._win_steps = 0
            self._win_flops = 0.0
            self._win_wall = 0.0

    def reset(self) -> None:
        with self._lock:
            self._marks = None
            self._compute_total = 0.0
            self._comm_in_span = 0.0
            self._flops_per_step = 0.0
            self._last = None
            self._win = {}
            self._win_steps = 0
            self._win_flops = 0.0
            self._win_wall = 0.0
            # Re-read the JSONL knob at the next close: a path set (or
            # fixed) after the first step should not stay latched off.
            self._sink = None
            self._sink_failed = False


_attribution: Optional[StepAttribution] = None
_attribution_lock = threading.Lock()


def attribution() -> StepAttribution:
    """The process-global attribution engine."""
    global _attribution
    with _attribution_lock:
        if _attribution is None:
            _attribution = StepAttribution()
        return _attribution


# Module-level conveniences (the ``hvd.metrics`` surface).

def set_step_flops(flops: float) -> None:
    """``hvd.metrics.set_step_flops(batch * flops_per_element)`` — the
    live-MFU input.  Model helpers compute the per-element figure:
    ``models.transformer.train_flops_per_seq``."""
    attribution().set_step_flops(flops)


def compute_span():
    """``with hvd.metrics.compute_span(): loss = train_step(batch)`` —
    marks the device-blocking span so the ``host`` gap is measurable."""
    return attribution().compute_span()


def last_attribution() -> Optional[dict]:
    """The most recent step's attribution record (None before the
    second ``step_end``)."""
    return attribution().last_record()


def note_pipeline_bubble(seconds: float) -> None:
    """Credit measured pipeline-bubble seconds to the ``pipeline_bubble``
    wall component (see ``parallel/pipeline.note_bubble``, which computes
    ``bubble_fraction(n_stages, n_micro) * span``)."""
    attribution().note_pipeline_bubble(seconds)


def window_shares() -> Optional[dict]:
    """Normalized wall-component shares of the current attribution
    window (None before any record) — the autotuner's per-window
    signal."""
    return attribution().window_shares()
