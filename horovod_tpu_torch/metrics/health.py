"""Straggler / rank-health detection from aggregated fleet snapshots
(port of horovod_tpu/metrics/health.py).

"Which rank is slow and why" is the question fleet-scale training lives
or dies on (the reference shipped its timeline as a first-class product
for exactly this, arXiv:1802.05799).  This module answers it from the
cross-rank aggregation (:mod:`.aggregate`): each sync round carries every
rank's windowed mean step time and mean data-wait; the detector scores
each rank against the fleet median and attributes the slowdown.

Scoring (robust by construction — a single straggler cannot drag the
baseline it is compared against):

* ``score(r) = mean_step_time(r) / median over ranks``
* flagged when ``score >= factor`` (``HVD_TPU_METRICS_STRAGGLER_FACTOR``,
  default 1.5) AND the absolute excess clears a noise floor
  (``HVD_TPU_METRICS_STRAGGLER_MIN_SECONDS``, default 1 ms).
* cause: ``input`` when the rank's data-wait explains most of its excess
  over the median (input pipeline, not compute/network), else
  ``compute`` — the input-wait vs compute split of Awan et al.
  (arXiv:1810.11112) applied per rank.

A rank flagged in ``HVD_TPU_METRICS_STRAGGLER_PATIENCE`` *consecutive*
evaluations lands in :meth:`StragglerDetector.blacklist_hint` — the hook
an elastic driver (``runner/elastic_driver.py`` ``health_hook=``) or
operator tooling consumes; one noisy window never condemns a host.

Every evaluation also:

* emits a ``log.warning`` per flagged rank (rank 0 only, to keep logs
  fleet-readable),
* drops a ``hvd.straggler.rank<N>`` marker through the profiler (an NVTX
  range, and a ``torch.profiler`` span while one records),
* updates ``hvd_straggler_*`` gauges/counters in the registry so the
  Prometheus surface can alert on it.
"""

from __future__ import annotations

import dataclasses
import statistics
import threading
from typing import Dict, List, Optional, Sequence

from .registry import registry as _registry


def _cfg_float(name: str, default: float) -> float:
    from ..core.config import get_float
    return get_float(name, default)


def _cfg_int(name: str, default: int) -> int:
    from ..core.config import get_int_or
    return get_int_or(name, default)


@dataclasses.dataclass
class RankHealth:
    """One rank's verdict for one evaluation window."""

    rank: int
    step_time_mean: float        # seconds, windowed
    data_wait_mean: float        # seconds, windowed
    score: float                 # step_time_mean / fleet median
    flagged: bool
    cause: str                   # component name | "input" | "compute" | ""
    steps: int                   # window sample count
    # Per-step component means (attribution window, when the rank's
    # snapshot carried one) — the by-component straggler evidence.
    components: Optional[Dict[str, float]] = None


# Wall components a straggler can be attributed to (comm_hidden is
# informational overlapped wire time and never *costs* a step) —
# single-homed in attribution.py with the drift detector's list.
from .attribution import WALL_COMPONENTS as _CAUSE_COMPONENTS


def _component_means(entry: dict) -> Optional[Dict[str, float]]:
    """Per-step component means from a snapshot's windowed ``attr``
    sums, or None when the snapshot predates (or disabled) the
    attribution plane."""
    attr = entry.get("attr")
    if not attr:
        return None
    steps = float(attr.get("steps", 0.0))
    if steps <= 0:
        return None
    return {k: float(attr.get(k, 0.0)) / steps for k in _CAUSE_COMPONENTS}


def _fleet_component_medians(
        per_rank: Sequence[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for k in _CAUSE_COMPONENTS:
        vals = [c.get(k, 0.0) for c in per_rank]
        if not vals:
            continue
        out[k] = statistics.median(vals)
    return out


class StragglerDetector:
    def __init__(self, factor: Optional[float] = None,
                 min_seconds: Optional[float] = None,
                 patience: Optional[int] = None):
        self.factor = factor if factor is not None else \
            _cfg_float("METRICS_STRAGGLER_FACTOR", 1.5)
        self.min_seconds = min_seconds if min_seconds is not None else \
            _cfg_float("METRICS_STRAGGLER_MIN_SECONDS", 1e-3)
        self.patience = patience if patience is not None else \
            _cfg_int("METRICS_STRAGGLER_PATIENCE", 2)
        self._lock = threading.Lock()
        self._consecutive: Dict[int, int] = {}
        self._last_report: List[RankHealth] = []

    # -- pure scoring ------------------------------------------------------

    def score_ranks(self, per_rank: Sequence[dict]) -> List[RankHealth]:
        """Score windowed per-rank stats.  ``per_rank`` entries:
        ``{"rank", "step_time_sum", "step_count", "data_wait_sum"[,
        "data_wait_count", "attr"]}`` (the aggregate wire shape).  Ranks
        with an empty window score 1.0 and are never flagged (no
        evidence).

        Cause attribution prefers the attribution plane: when snapshots
        carry per-component window sums (``attr``,
        metrics/attribution.py), a flagged rank's cause is the wall
        component with the largest excess over the fleet's median
        per-component mean — "rank 3 is 2.1x slower and it's the
        checkpoint component", not just "slower".  Snapshots without
        ``attr`` fall back to the original data-wait heuristic."""
        stats = []
        for entry in per_rank:
            n = int(entry.get("step_count", 0))
            mean = (float(entry.get("step_time_sum", 0.0)) / n) if n else 0.0
            wait = (float(entry.get("data_wait_sum", 0.0)) / n) if n else 0.0
            stats.append((int(entry["rank"]), mean, wait, n,
                          _component_means(entry)))
        with_data = [m for _, m, _, n, _c in stats if n > 0]
        if not with_data:
            return [RankHealth(r, m, w, 1.0, False, "", n, c)
                    for r, m, w, n, c in stats]
        median = statistics.median(with_data)
        comp_medians = _fleet_component_medians(
            [c for _, _, _, n, c in stats if n > 0 and c])
        out = []
        for r, mean, wait, n, comps in stats:
            if n == 0 or median <= 0.0:
                out.append(RankHealth(r, mean, wait, 1.0, False, "", n,
                                      comps))
                continue
            score = mean / median
            excess = mean - median
            flagged = score >= self.factor and excess >= self.min_seconds
            cause = ""
            if flagged:
                cause = self._attribute_cause(comps, comp_medians,
                                              wait, excess)
            out.append(RankHealth(r, mean, wait, score, flagged, cause, n,
                                  comps))
        return out

    @staticmethod
    def _attribute_cause(comps: Optional[Dict[str, float]],
                         comp_medians: Dict[str, float],
                         wait: float, excess: float) -> str:
        if comps:
            best, best_excess = None, 0.0
            for name, mean in comps.items():
                ce = mean - comp_medians.get(name, 0.0)
                if ce > best_excess:
                    best, best_excess = name, ce
            if best is not None and best_excess >= 0.25 * excess:
                return best
        # Attribution absent (or no single component explains the
        # slowdown): the original input-vs-compute split.
        return "input" if wait >= 0.5 * excess else "compute"

    def score_digest(self, digest: dict) -> List[RankHealth]:
        """Score a merged fleet digest (metrics/digest.py) — the tree
        path's analog of :meth:`score_ranks`.

        The baseline median and per-component medians come from the
        digest's quantile sketches (within the sketch's ~2.5% bound of
        the flat path's exact medians); the per-rank verdicts cover the
        **outlier evidence** the digest carried raw — each host's top-K
        slowest ranks, preserved through merges up to the fleet ceiling
        (``digest.FLEET_OUTLIER_CAP``), i.e. exactly the candidates a
        straggler flag could name.  A rank absent from the outlier list
        is faster than its host's top-K slowest and can never clear the
        flag factor, so the verdict set matches the flat path on the
        same fleet (golden-tested parity,
        ``tests/test_observe_plane.py``) — unless more than the ceiling
        are sick at once, at which point per-rank flags stop being the
        interesting signal."""
        from . import digest as _digest
        median = _digest.digest_median_step(digest)
        comp_medians = _digest.digest_component_medians(digest)
        out = []
        for entry in digest.get("outliers") or []:
            n = int(entry.get("step_count", 0))
            mean = (float(entry.get("step_time_sum", 0.0)) / n) if n else 0.0
            wait = (float(entry.get("data_wait_sum", 0.0)) / n) if n else 0.0
            comps = _component_means(entry)
            if n == 0 or not median or median <= 0.0:
                out.append(RankHealth(int(entry["rank"]), mean, wait, 1.0,
                                      False, "", n, comps))
                continue
            score = mean / median
            excess = mean - median
            flagged = score >= self.factor and excess >= self.min_seconds
            cause = ""
            if flagged:
                cause = self._attribute_cause(comps, comp_medians,
                                              wait, excess)
            out.append(RankHealth(int(entry["rank"]), mean, wait, score,
                                  flagged, cause, n, comps))
        return out

    # -- stateful evaluation ----------------------------------------------

    def evaluate(self, per_rank: Sequence[dict],
                 warn: bool = True) -> List[RankHealth]:
        """Score + update consecutive-flag streaks, emit warnings,
        timeline markers and registry metrics.  Returns the report."""
        report = self.score_ranks(per_rank)
        return self._absorb(report, warn=warn)

    def evaluate_digest(self, digest: dict,
                        warn: bool = True) -> List[RankHealth]:
        """The tree path's evaluation: score the digest's outlier
        evidence, warn about hosts whose digests never arrived (a
        partial round is NAMED, never silently averaged away), and
        update the same streak/registry surfaces as the flat path."""
        report = self.score_digest(digest)
        failed = digest.get("failed_hosts") or []
        missing = digest.get("missing") or []
        if warn and (failed or missing):
            from ..utils import logging as log
            log.warning(
                "metrics tree: partial aggregation round — unreported "
                "hosts %s, unreported ranks %s (their digests/snapshots "
                "missed the round; verdicts below cover reporters only)",
                failed or "[]", missing or "[]")
        # Set UNCONDITIONALLY: a complete round must clear the gauges,
        # or one transient partial round would alert forever.
        _registry().gauge(
            "hvd_metrics_tree_unreported_hosts",
            "Hosts whose digest missed the last tree sync round"
        ).set(len(failed))
        _registry().gauge(
            "hvd_metrics_tree_unreported_ranks",
            "Ranks whose snapshot missed the last tree sync round"
        ).set(len(missing))
        return self._absorb(report, warn=warn)

    def _absorb(self, report: List[RankHealth],
                warn: bool = True) -> List[RankHealth]:
        reg = _registry()
        flagged = [h for h in report if h.flagged]
        with self._lock:
            seen = {h.rank for h in report}
            for h in report:
                if h.flagged:
                    self._consecutive[h.rank] = \
                        self._consecutive.get(h.rank, 0) + 1
                else:
                    self._consecutive.pop(h.rank, None)
            # Ranks that left the world take their streaks with them.
            for r in [r for r in self._consecutive if r not in seen]:
                self._consecutive.pop(r, None)
            self._last_report = report
        reg.gauge(
            "hvd_straggler_ranks",
            "Ranks flagged as stragglers in the last evaluation"
        ).set(len(flagged))
        for h in flagged:
            reg.counter(
                "hvd_straggler_flags_total",
                "Straggler flags per rank", rank=str(h.rank),
                cause=h.cause).inc()
            self._timeline_marker(h)
            if warn:
                from ..utils import logging as log
                log.warning(
                    "straggler: rank %d step time %.1f ms = %.2fx fleet "
                    "median (%s-bound, data-wait %.1f ms/step, %d-step "
                    "window)", h.rank, h.step_time_mean * 1e3, h.score,
                    h.cause, h.data_wait_mean * 1e3, h.steps)
        return report

    @staticmethod
    def _timeline_marker(h: RankHealth) -> None:
        # A zero-length profiler span: a named marker on the trace next
        # to the window it describes.
        try:
            from ..utils.profiler import op_range
            with op_range(f"hvd.straggler.rank{h.rank}"
                          f"#score={h.score:.2f},cause={h.cause}"):
                pass
        except Exception:  # noqa: BLE001 — observability never breaks
            pass

    def last_report(self) -> List[RankHealth]:
        with self._lock:
            return list(self._last_report)

    def blacklist_hint(self) -> List[int]:
        """Ranks flagged in >= ``patience`` consecutive evaluations —
        the hint surface the elastic driver's ``health_hook`` consumes
        (mapped rank→hostname by the caller, which knows the slot
        assignment)."""
        with self._lock:
            return sorted(r for r, n in self._consecutive.items()
                          if n >= self.patience)

    def reset(self) -> None:
        with self._lock:
            self._consecutive.clear()
            self._last_report = []


_detector: Optional[StragglerDetector] = None
_detector_lock = threading.Lock()


def detector() -> StragglerDetector:
    """Process-global detector (thresholds frozen at first use)."""
    global _detector
    with _detector_lock:
        if _detector is None:
            _detector = StragglerDetector()
        return _detector


def straggler_report() -> List[RankHealth]:
    return detector().last_report()


def blacklist_hint() -> List[int]:
    return detector().blacklist_hint()
