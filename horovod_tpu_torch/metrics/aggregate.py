"""Cross-rank metric aggregation: per-rank snapshots → a fleet view (port
of horovod_tpu/metrics/aggregate.py).

Per-rank registries answer "what happened on THIS process"; "which rank
is slow and why" needs every rank's numbers side by side.  This module
allgathers compact per-rank snapshots over the port's
``allgather_object`` on an opt-in cadence:

    ``HVD_TPU_METRICS_SYNC_STEPS`` = N  →  every N-th ``step_end()``
    runs one :meth:`Aggregator.sync`.  Default 0 = never.

``step_end`` is the one hook a training loop calls per step; it feeds
``hvd_steps_total`` and the ``hvd_step_time_seconds`` histogram, closes
the step's attribution record and updates the drift detector.  Every
rank steps in lockstep, so a step-count cadence is a safe collective
schedule.

The wire snapshot is small: rank id, windowed step-time and data-wait
sums/counts (deltas since the previous sync), the window's step-time
sketch and attribution sums, plus the flat counter/gauge scalars.  Every
rank holds the assembled fleet view (:meth:`fleet`) and runs the
straggler detector over it (:mod:`.health`).

Under ``HVD_TPU_METRICS_TREE`` the sync is hierarchical instead
(:meth:`Aggregator.sync_tree`): each rank hands its snapshot to its
host's observer (``observer.py``), the hosts exchange O(hosts) digests
through the rendezvous KV, and every rank reads the merged fleet digest
back.  No collective runs on that path.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from . import attribution as _attr
from . import baseline as _baseline
from .health import detector as _detector
from .registry import registry as _registry

_STEP_TIME_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 15.0, 60.0)


def _sync_cadence() -> int:
    from ..core.state import global_state
    if global_state.initialized:
        return global_state.metrics_sync_steps
    from ..core.config import metrics_sync_steps
    return metrics_sync_steps()


def _tree_enabled() -> bool:
    """The hierarchical (host-sharded) sync path — see metrics/digest.py
    and metrics/observer.py.  Off by default: small worlds lose nothing
    to the flat allgather, and the knob must agree on every rank (it is
    env-driven, exported by the launcher) or half a fleet would wait on
    observers that never hear from the other half."""
    from ..core.state import global_state
    if global_state.initialized:
        return global_state.metrics_tree
    from ..core.config import metrics_tree
    return metrics_tree()


def _data_wait_totals() -> tuple:
    """(total_s, count, reset_generation) of data-wait spans from the
    registry (the migrated ``utils/profiler.data_wait_stats`` storage).
    The generation lets window marks detect a mid-window
    ``reset_data_wait_stats()`` even when the count climbs back past
    its mark."""
    reg = _registry()
    count = reg.counter("hvd_data_wait_spans_total",
                        "Number of input-pipeline wait spans")
    return (reg.counter("hvd_data_wait_seconds_total",
                        "Cumulative input-pipeline wait").value,
            count.value, count.resets)


class Aggregator:
    """Step accounting + cadence-driven cross-rank sync."""

    def __init__(self):
        self._lock = threading.Lock()
        self._step = 0
        self._step_sum = 0.0
        self._step_count = 0
        # Window marks: values at the last sync, subtracted to report
        # deltas instead of lifetime totals.
        self._mark_step_sum = 0.0
        self._mark_step_count = 0
        self._mark_wait_sum = 0.0
        self._mark_wait_count = 0
        self._mark_wait_gen = 0
        self._last_step_ts: Optional[float] = None
        self._fleet: Optional[List[dict]] = None
        self._fleet_step = -1
        # Tree-mode state: the per-window step-time sketch that rides
        # the snapshot (metrics/digest.py), the sync round index
        # observers align on, and the last merged fleet digest.
        from .digest import QuantileSketch
        self._win_sketch = QuantileSketch()
        self._sync_round = 0
        self._fleet_digest: Optional[dict] = None
        # Idempotency latch: the last explicitly-indexed step_end(step=)
        # absorbed.  A user loop and an elastic commit hook both closing
        # the same step index must count it once (double-counting halves
        # every derived step time and desyncs the sync cadence).
        self._last_explicit_step: Optional[int] = None
        self._metrics = None

    def _step_metrics(self):
        """The step counter and histogram, looked up once (the reference
        looks them up each step; the registry holds the same families)."""
        if self._metrics is None:
            reg = _registry()
            self._metrics = (
                reg.counter("hvd_steps_total", "Training steps observed"),
                reg.histogram("hvd_step_time_seconds",
                              "Training step wall time",
                              buckets=_STEP_TIME_BUCKETS))
        return self._metrics

    # -- per-step hook -----------------------------------------------------

    def step_end(self, step_time_s: Optional[float] = None,
                 step: Optional[int] = None) -> None:
        """Record one training step.  ``step_time_s`` omitted → derived
        from the wall clock between consecutive calls (first call only
        counts the step, it has no interval yet).  Runs a cross-rank
        sync when the cadence divides the step index.

        ``step`` (optional) is the caller's own step index, making the
        call IDEMPOTENT per index: a repeat close of the same index
        (user loop + an elastic-commit hook firing in the same step) is
        absorbed, so step counting, the derived wall interval, the
        attribution window and the sync cadence each see the step once.
        Closing the step also drives the performance observatory: the
        per-step attribution record (metrics/attribution.py) and the
        drift detector (metrics/baseline.py), unless disabled."""
        now = time.perf_counter()
        with self._lock:
            if step is not None:
                s = int(step)
                if self._last_explicit_step is not None and \
                        s <= self._last_explicit_step:
                    # Duplicate close of an already-counted index —
                    # including a LAGGING one (a hook closing step N
                    # after the loop already closed N+1 would otherwise
                    # count a phantom near-zero step into the histogram
                    # and the drift baseline).  Explicit indices only
                    # move forward within a run; reset() clears the
                    # latch for the next run.
                    return
                self._last_explicit_step = s
            if step_time_s is None and self._last_step_ts is not None:
                step_time_s = now - self._last_step_ts
            self._last_step_ts = now
            self._step += 1
            cur_step = self._step
            if step_time_s is not None:
                self._step_sum += step_time_s
                self._step_count += 1
                self._win_sketch.add(step_time_s)
        steps, step_hist = self._step_metrics()
        steps.inc()
        if step_time_s is not None:
            step_hist.observe(step_time_s)
            if _attr.enabled():
                record = _attr.attribution().close_step(
                    step if step is not None else cur_step, step_time_s)
                if record is not None and _baseline.drift_enabled():
                    _baseline.drift_detector().update(
                        record["step"], step_time_s,
                        shares=record.get("shares"))
        cadence = _sync_cadence()
        if cadence > 0 and cur_step % cadence == 0:
            self.sync()

    # -- cross-rank sync ---------------------------------------------------

    def local_snapshot(self) -> dict:
        """The compact wire snapshot for this rank: windowed deltas plus
        the flat scalar view of the registry.  A data-wait counter that
        was reset underneath the marks (``reset_data_wait_stats()``
        mid-window, detected via its reset generation) contributes
        everything since the reset — never a negative delta."""
        from ..core.state import global_state
        wait_sum, wait_count, wait_gen = _data_wait_totals()
        with self._lock:
            if wait_gen != self._mark_wait_gen:
                dw_sum, dw_count = wait_sum, wait_count
            else:
                dw_sum = wait_sum - self._mark_wait_sum
                dw_count = wait_count - self._mark_wait_count
            snap = {
                "rank": int(global_state.rank),
                "step": self._step,
                "step_time_sum": self._step_sum - self._mark_step_sum,
                "step_count": self._step_count - self._mark_step_count,
                "data_wait_sum": dw_sum,
                "data_wait_count": dw_count,
                # The window's per-step time sketch: what the host
                # digest merges so fleet p50/p95 survive aggregation
                # (metrics/digest.py).  Bounded — log-bucket counts.
                "sketch": self._win_sketch.to_dict(),
            }
        if _attr.enabled():
            # Windowed per-component seconds + declared FLOPs: the
            # straggler detector attributes a flagged rank BY COMPONENT
            # from these (health.py), and sync() grades fleet-wide MFU.
            snap["attr"] = _attr.attribution().window_components()
        snap["scalars"] = _registry().scalars()
        return snap

    def _advance_window(self) -> None:
        wait_sum, wait_count, wait_gen = _data_wait_totals()
        from .digest import QuantileSketch
        with self._lock:
            self._mark_step_sum = self._step_sum
            self._mark_step_count = self._step_count
            self._mark_wait_sum = wait_sum
            self._mark_wait_count = wait_count
            self._mark_wait_gen = wait_gen
            self._win_sketch = QuantileSketch()
        if _attr.enabled():
            _attr.attribution().advance_window()

    def sync(self) -> List[dict]:
        """Allgather every rank's snapshot; evaluate rank health.  A
        collective — every rank must call it at the same step (the
        cadence in ``step_end`` guarantees this for SPMD loops, and an
        elastic reset re-zeroes every member's step counter so rejoined
        worlds stay aligned — see elastic/state.py ``_reset``).

        Under ``HVD_TPU_METRICS_TREE`` the sync is hierarchical
        instead: intra-host merge through the per-host observer, one
        O(hosts) digest exchange, and the merged fleet digest back —
        see :meth:`sync_tree`.  The return value is then the digest's
        bounded outlier evidence (the per-rank entries that survived
        aggregation), not one entry per rank."""
        if _tree_enabled():
            return self.sync_tree()
        t0 = time.perf_counter()
        snap = self.local_snapshot()
        from ..core.state import global_state
        if global_state.initialized and (
                global_state.size > 1
                or global_state.controller is not None):
            from ..optimizers import allgather_object
            gathered = allgather_object(snap, name="hvd.metrics.sync")
        else:
            gathered = [snap]
        self._advance_window()
        # Warnings from one rank only — the report itself (and the
        # blacklist hint) is identical everywhere, the allgather is
        # symmetric.
        _detector().evaluate(
            gathered, warn=global_state.rank == 0)
        reg = _registry()
        self._fleet_mfu_gauges(gathered, reg)
        reg.counter("hvd_metrics_syncs_total",
                    "Cross-rank metric aggregations").inc()
        reg.gauge("hvd_metrics_sync_seconds",
                  "Duration of the last metrics aggregation "
                  "(gather + health scoring)").set(
            time.perf_counter() - t0)
        with self._lock:
            self._fleet = gathered
            self._fleet_step = snap["step"]
        return gathered

    def sync_tree(self) -> List[dict]:
        """The hierarchical sync round: snapshot → host observer →
        O(hosts) exchange → merged fleet digest.  No collective runs;
        an unreachable observer degrades to a local-only digest (named
        as partial) rather than blocking the step.  Health and the
        fleet MFU gauges evaluate from the digest; the bounded outlier
        entries stand in for the flat path's per-rank list."""
        t0 = time.perf_counter()
        from . import digest as _dig
        from . import observer as _observer
        snap = self.local_snapshot()
        with self._lock:
            self._sync_round += 1
            round_idx = self._sync_round
        fleet_digest = _observer.rank_sync(snap, round_idx)
        self._advance_window()
        from ..core.state import global_state
        if fleet_digest is None:
            # No observer reachable (single process, or the host's
            # serving slot died): a digest of this rank alone — the
            # read surfaces stay coherent and the degradation is
            # visible (ranks=1, hosts empty).
            kinds = None
            try:
                kinds = _registry().scalar_kinds()
            except Exception:  # noqa: BLE001
                pass
            expected = [snap["rank"]]
            if global_state.initialized and global_state.size > 1:
                # The most-degraded mode must SAY so: every other rank
                # is unreported here, and the unreported gauges would
                # otherwise read a clean 0/0 while the fleet view
                # silently covered one rank.
                expected = list(range(global_state.size))
            fleet_digest = _dig.snapshot_digest(
                [snap], host="", top_k=_observer.top_k(),
                expected_ranks=expected,
                scalar_kinds=kinds, peak=_attr.peak_flops())
            fleet_digest["round"] = round_idx
        reg = _registry()
        fresh = int(fleet_digest.get("round", -1)) == round_idx
        if fresh:
            _detector().evaluate_digest(
                fleet_digest, warn=global_state.rank == 0)
        else:
            # The observer served a PREVIOUS round's digest (this
            # round's exchange missed its deadline).  Keep it for the
            # read surfaces, but feeding it to the stateful evaluator
            # again would double-count straggler streaks — one
            # transient flagged round must not fabricate a
            # blacklist_hint.
            reg.counter(
                "hvd_metrics_tree_stale_rounds_total",
                "Tree syncs that served a previous round's digest "
                "(exchange deadline missed)").inc()
        mfu = _dig.digest_mfu(fleet_digest)
        if mfu is not None:
            reg.gauge("hvd_mfu_fleet_min",
                      "Lowest per-rank MFU in the last aggregation "
                      "window").set(mfu["min"])
            reg.gauge("hvd_mfu_fleet_mean",
                      "Mean per-rank MFU in the last aggregation "
                      "window").set(mfu["mean"])
        reg.counter("hvd_metrics_syncs_total",
                    "Cross-rank metric aggregations").inc()
        reg.gauge("hvd_metrics_sync_seconds",
                  "Duration of the last metrics aggregation "
                  "(gather + health scoring)").set(
            time.perf_counter() - t0)
        outliers = [dict(s) for s in fleet_digest.get("outliers") or []]
        with self._lock:
            self._fleet = outliers
            self._fleet_step = snap["step"]
            self._fleet_digest = fleet_digest
        return outliers

    @staticmethod
    def _fleet_mfu_gauges(gathered: List[dict], reg) -> None:
        """Cross-rank MFU: per-rank windowed ``flops_sum / step_time``
        against the chip peak → fleet min/mean gauges, so one
        low-utilization rank is visible without scraping every rank."""
        peak = _attr.peak_flops()
        if not peak:
            return
        ratios = []
        for snap in gathered:
            attr = snap.get("attr") or {}
            # The attribution window's own wall-time sum: flops
            # accumulate only on record-producing closes (the anchoring
            # close and reset-skipped steps contribute neither), so
            # dividing by the aggregate step_time_sum — which counts
            # every timed step — would bias MFU low after every
            # reanchor.  Older snapshots without "wall" fall back.
            flops = attr.get("flops", 0.0)
            t = attr.get("wall", 0.0) or snap.get("step_time_sum", 0.0)
            if flops > 0 and t > 0:
                ratios.append(flops / (t * peak))
        if not ratios:
            return
        reg.gauge("hvd_mfu_fleet_min",
                  "Lowest per-rank MFU in the last aggregation window"
                  ).set(min(ratios))
        reg.gauge("hvd_mfu_fleet_mean",
                  "Mean per-rank MFU in the last aggregation window"
                  ).set(sum(ratios) / len(ratios))

    # -- read side ---------------------------------------------------------

    def fleet(self) -> Optional[List[dict]]:
        """Per-rank snapshots from the most recent sync (None before the
        first)."""
        with self._lock:
            return list(self._fleet) if self._fleet is not None else None

    def fleet_scalars(self) -> Dict[int, Dict[str, float]]:
        """{rank: flat scalars} from the last sync — the queryable fleet
        surface ("sum hvd_collective_bytes_total over ranks").  Under
        the tree path only the digest's outlier ranks appear here; the
        fleet-wide totals live in :meth:`fleet_digest`'s merged
        counters (exact — counters sum)."""
        fleet = self.fleet() or []
        return {int(s["rank"]): dict(s.get("scalars", {})) for s in fleet}

    def fleet_digest(self) -> Optional[dict]:
        """The merged fleet digest from the most recent tree-mode sync
        (None before the first, and always None on the flat path)."""
        with self._lock:
            return dict(self._fleet_digest) \
                if self._fleet_digest is not None else None

    def reset(self) -> None:
        """Zero the step counter and open a fresh window anchored at the
        data-wait counters' CURRENT values (they are lifetime counters
        and survive an elastic reset on surviving workers)."""
        wait_sum, wait_count, wait_gen = _data_wait_totals()
        with self._lock:
            self._step = 0
            self._step_sum = 0.0
            self._step_count = 0
            self._mark_step_sum = 0.0
            self._mark_step_count = 0
            self._mark_wait_sum = wait_sum
            self._mark_wait_count = wait_count
            self._mark_wait_gen = wait_gen
            self._last_step_ts = None
            self._fleet = None
            self._fleet_step = -1
            self._last_explicit_step = None
            from .digest import QuantileSketch
            self._win_sketch = QuantileSketch()
            self._sync_round = 0
            self._fleet_digest = None
        # The tree plane's round clock restarts with this aggregator:
        # the host's observer (when this process hosts one) re-zeroes
        # its sealed-round guard, and the observer-address cache is
        # dropped (an elastic round can reseat local rank 0).
        from . import observer as _observer
        ob = _observer.current_observer()
        if ob is not None:
            ob.reset_rounds()
        _observer.reset_addr_cache()
        if _attr.enabled():
            # Re-anchor the attribution marks at the counters' current
            # values (the elastic run() loop re-anchors AGAIN after the
            # post-reset state.sync(), which is what keeps restore work
            # done between runs off the first post-reset step).  The
            # drift detector deliberately survives the reset —
            # "steps/sec regressed after an elastic round" is exactly
            # the drift it exists to catch.
            _attr.attribution().reanchor()


_aggregator: Optional[Aggregator] = None
_aggregator_lock = threading.Lock()


def aggregator() -> Aggregator:
    global _aggregator
    with _aggregator_lock:
        if _aggregator is None:
            _aggregator = Aggregator()
        return _aggregator


def step_end(step_time_s: Optional[float] = None,
             step: Optional[int] = None) -> None:
    """Module-level convenience: ``hvd.metrics.step_end()`` once per
    training step.  Pass ``step=`` (your loop's own index) to make
    duplicate closes of the same step idempotent."""
    aggregator().step_end(step_time_s, step=step)


def sync() -> List[dict]:
    return aggregator().sync()


def fleet_snapshot() -> Optional[List[dict]]:
    return aggregator().fleet()


def fleet_digest() -> Optional[dict]:
    """The last tree-mode fleet digest (None on the flat path)."""
    return aggregator().fleet_digest()
