"""Mergeable telemetry digests (port of horovod_tpu/metrics/digest.py).

The closed algebra under the reference's hierarchical metrics plane: a
merge of per-rank snapshots that is associative and commutative, so a
host can pre-reduce its ranks and the fleet exchange once per host.

* **counters sum** (histogram ``_sum``/``_count`` scalars behave like
  counters);
* **gauges keep (min, max, last)** — "last" resolved to the
  highest-rank contributor so the merge stays commutative;
* **step-time and per-component attribution become fixed-size quantile
  sketches** (:class:`QuantileSketch`, a log-bucket histogram with a
  bounded bucket index range);
* **top-K outlier evidence rides along raw**, so straggler attribution
  by component survives aggregation.

The host observers (``observer.py``) merge with it, and the read side
(quantiles, shares, MFU) grades the fleet digest.  Pure python, stdlib
only.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

DIGEST_VERSION = 1

# Default per-host outlier budget (HVD_TPU_METRICS_TOPK overrides via
# the aggregation layer; the algebra itself takes it as an argument).
DEFAULT_TOP_K = 4

# Components whose per-rank per-step means are sketched for the fleet
# median baseline — single-homed with the attribution plane.
from .attribution import WALL_COMPONENTS as _WALL_COMPONENTS


class QuantileSketch:
    """Fixed-size log-bucket quantile sketch over positive seconds.

    Values map to buckets ``i = ceil(log_gamma(v / MIN_VALUE))`` clamped
    to ``[0, MAX_INDEX]``; a bucket's representative is the geometric
    midpoint ``MIN_VALUE * gamma^(i - 0.5)``.  With ``gamma = 1.05`` the
    relative quantile error is bounded by ``sqrt(gamma) - 1`` (~2.5%)
    inside the covered range [1 us, ~1e5 s] — far below the straggler
    detector's 1.5x flag factor, which is what makes flat-vs-tree
    verdict parity hold (golden-tested).  Storage is a sparse
    index→count dict with at most ``MAX_INDEX + 1`` distinct entries —
    fixed-size regardless of how many observations merged in.

    ``merge`` is elementwise bucket-count addition plus exact
    (min, max, sum, count) combination: associative and commutative by
    construction.
    """

    GAMMA = 1.05
    MIN_VALUE = 1e-6
    MAX_INDEX = 520  # covers MIN_VALUE * GAMMA^520 ~= 1.1e5 seconds

    __slots__ = ("buckets", "count", "sum", "min", "max")

    def __init__(self):
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    # -- building ----------------------------------------------------------

    def _index(self, value: float) -> int:
        if value <= self.MIN_VALUE:
            return 0
        i = int(math.ceil(math.log(value / self.MIN_VALUE)
                          / math.log(self.GAMMA)))
        return min(max(i, 0), self.MAX_INDEX)

    def add(self, value: float, count: int = 1) -> None:
        if count <= 0:
            return
        v = float(value)
        if not math.isfinite(v) or v < 0:
            return
        i = self._index(v)
        self.buckets[i] = self.buckets.get(i, 0) + count
        self.count += count
        self.sum += v * count
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        for i, c in other.buckets.items():
            self.buckets[i] = self.buckets.get(i, 0) + c
        self.count += other.count
        self.sum += other.sum
        for bound, pick in (("min", min), ("max", max)):
            theirs = getattr(other, bound)
            if theirs is not None:
                mine = getattr(self, bound)
                setattr(self, bound,
                        theirs if mine is None else pick(mine, theirs))
        return self

    # -- reading -----------------------------------------------------------

    def _representative(self, index: int) -> float:
        if index <= 0:
            return self.MIN_VALUE
        return self.MIN_VALUE * self.GAMMA ** (index - 0.5)

    def _value_at_rank(self, k: int) -> float:
        """The k-th smallest value's bucket representative (1-indexed),
        clamped into the exact [min, max] envelope so a one-bucket
        sketch answers exactly."""
        seen = 0
        value = self._representative(max(self.buckets))
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if seen >= k:
                value = self._representative(i)
                break
        lo = self.min if self.min is not None else value
        hi = self.max if self.max is not None else value
        return min(max(value, lo), hi)

    def quantile(self, q: float) -> Optional[float]:
        """The value at quantile ``q`` in [0, 1] (None when empty)."""
        if self.count == 0:
            return None
        return self._value_at_rank(max(1, int(math.ceil(q * self.count))))

    def median(self) -> Optional[float]:
        """``statistics.median`` semantics (midpoint of the two middle
        values on even counts), within the bucket error.  The straggler
        baseline uses THIS, not ``quantile(0.5)``: the lower-median a
        plain rank query returns sits a whole inter-rank gap below the
        flat path's interpolated median on small even fleets, which is
        enough to flip a verdict near the flag factor."""
        if self.count == 0:
            return None
        if self.count % 2:
            return self._value_at_rank((self.count + 1) // 2)
        return (self._value_at_rank(self.count // 2)
                + self._value_at_rank(self.count // 2 + 1)) / 2.0

    def mean(self) -> Optional[float]:
        return (self.sum / self.count) if self.count else None

    # -- wire --------------------------------------------------------------

    def to_dict(self) -> dict:
        return {"b": {str(i): c for i, c in sorted(self.buckets.items())},
                "count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max}

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "QuantileSketch":
        s = cls()
        if not d:
            return s
        s.buckets = {int(i): int(c) for i, c in (d.get("b") or {}).items()}
        s.count = int(d.get("count", 0))
        s.sum = float(d.get("sum", 0.0))
        s.min = d.get("min")
        s.max = d.get("max")
        if s.min is not None:
            s.min = float(s.min)
        if s.max is not None:
            s.max = float(s.max)
        return s

    @classmethod
    def of(cls, values: Sequence[float]) -> "QuantileSketch":
        s = cls()
        for v in values:
            s.add(v)
        return s


# ---------------------------------------------------------------------------
# snapshot -> digest
# ---------------------------------------------------------------------------

def _rank_mean(snap: dict) -> Optional[float]:
    n = int(snap.get("step_count", 0))
    if n <= 0:
        return None
    return float(snap.get("step_time_sum", 0.0)) / n


def _rank_mfu(snap: dict, peak: Optional[float]) -> Optional[float]:
    if not peak:
        return None
    attr = snap.get("attr") or {}
    flops = float(attr.get("flops", 0.0))
    t = float(attr.get("wall", 0.0)) or float(snap.get("step_time_sum", 0.0))
    if flops > 0 and t > 0:
        return flops / (t * peak)
    return None


def _outlier_sort_key(snap: dict):
    # Deterministic: slowest mean first, rank id as the tiebreak —
    # what makes top-K selection associative under merge.
    mean = _rank_mean(snap)
    return (-(mean if mean is not None else -1.0), int(snap.get("rank", 0)))


_OUTLIER_FIELDS = ("rank", "step", "step_time_sum", "step_count",
                   "data_wait_sum", "data_wait_count", "attr")


def _outlier_entry(snap: dict) -> dict:
    """The bounded straggler evidence a digest carries raw: everything
    the health scorer needs (window sums + per-component attribution),
    WITHOUT the full scalar map — one outlier with ~70 metric families
    attached would cost more wire than the whole merged digest, and the
    merged counters/gauges already carry the fleet's scalar view."""
    return {k: snap[k] for k in _OUTLIER_FIELDS if k in snap}


def snapshot_digest(snaps: Sequence[dict], host: str = "",
                    top_k: int = DEFAULT_TOP_K,
                    expected_ranks: Optional[Sequence[int]] = None,
                    scalar_kinds: Optional[Dict[str, str]] = None,
                    peak: Optional[float] = None) -> dict:
    """One host's per-rank snapshots (the :meth:`Aggregator.
    local_snapshot` wire shape) → a mergeable host digest.

    ``expected_ranks`` names the ranks that *should* have reported;
    absentees land in ``missing`` so a crashed local rank is named, not
    silently averaged away.  ``scalar_kinds`` (from
    ``registry().scalar_kinds()``) steers the counter-vs-gauge merge
    rule for the flat scalars; without it every scalar is treated as a
    counter (summed), which is correct for the ``*_total``/histogram
    families the fleet surfaces actually query.
    """
    reported = sorted({int(s["rank"]) for s in snaps})
    missing = []
    if expected_ranks is not None:
        missing = sorted(set(int(r) for r in expected_ranks)
                         - set(reported))

    window = {"step_time_sum": 0.0, "step_count": 0,
              "data_wait_sum": 0.0, "data_wait_count": 0}
    rank_means = QuantileSketch()
    steps = QuantileSketch()
    mfu = QuantileSketch()
    attr_means: Dict[str, QuantileSketch] = {
        k: QuantileSketch() for k in _WALL_COMPONENTS}
    attr_sums: Dict[str, float] = {}
    attr_steps = 0.0
    attr_flops = 0.0
    attr_wall = 0.0
    counters: Dict[str, float] = {}
    gauges: Dict[str, list] = {}

    for snap in snaps:
        window["step_time_sum"] += float(snap.get("step_time_sum", 0.0))
        window["step_count"] += int(snap.get("step_count", 0))
        window["data_wait_sum"] += float(snap.get("data_wait_sum", 0.0))
        window["data_wait_count"] += int(snap.get("data_wait_count", 0))
        mean = _rank_mean(snap)
        if mean is not None:
            rank_means.add(mean)
        sk = snap.get("sketch")
        if sk:
            steps.merge(QuantileSketch.from_dict(sk))
        elif mean is not None:
            # Older snapshots without a per-step sketch: the window mean
            # weighted by its step count approximates the distribution.
            steps.add(mean, count=int(snap.get("step_count", 0)))
        ratio = _rank_mfu(snap, peak)
        if ratio is not None:
            mfu.add(ratio)
        attr = snap.get("attr")
        if attr:
            n = float(attr.get("steps", 0.0))
            attr_steps += n
            attr_flops += float(attr.get("flops", 0.0))
            attr_wall += float(attr.get("wall", 0.0))
            for k in _WALL_COMPONENTS:
                v = float(attr.get(k, 0.0))
                attr_sums[k] = attr_sums.get(k, 0.0) + v
                if n > 0:
                    attr_means[k].add(v / n)
        rank = int(snap.get("rank", 0))
        for key, value in (snap.get("scalars") or {}).items():
            kind = (scalar_kinds or {}).get(key, "counter")
            v = float(value)
            if kind == "gauge":
                cur = gauges.get(key)
                if cur is None:
                    gauges[key] = [v, v, v, rank]
                else:
                    cur[0] = min(cur[0], v)
                    cur[1] = max(cur[1], v)
                    if rank >= cur[3]:
                        cur[2], cur[3] = v, rank
            else:
                counters[key] = counters.get(key, 0.0) + v

    outliers = [_outlier_entry(s) for s in
                sorted(snaps, key=_outlier_sort_key)[:max(int(top_k), 0)]]
    return {
        "v": DIGEST_VERSION,
        "hosts": [host] if host else [],
        "failed_hosts": [],
        "ranks": len(reported),
        "step": max((int(s.get("step", 0)) for s in snaps), default=0),
        "missing": missing,
        "window": window,
        "rank_means": rank_means.to_dict(),
        "steps": steps.to_dict(),
        "mfu": mfu.to_dict(),
        "attr": {"sums": attr_sums, "steps": attr_steps,
                 "flops": attr_flops, "wall": attr_wall,
                 "means": {k: s.to_dict()
                           for k, s in attr_means.items() if s.count}},
        "outliers": [dict(s) for s in outliers],
        "counters": counters,
        "gauges": gauges,
        "top_k": max(int(top_k), 0),
        "outlier_cap": max(int(top_k), 0),
    }


# ---------------------------------------------------------------------------
# digest x digest -> digest
# ---------------------------------------------------------------------------

def _merge_sketch_field(a: dict, b: dict, key: str) -> dict:
    s = QuantileSketch.from_dict(a.get(key))
    s.merge(QuantileSketch.from_dict(b.get(key)))
    return s.to_dict()


# Fleet-level ceiling on merged outlier evidence.  Each HOST contributes
# up to its own top-K (outlier_cap below sums the contributions, so a
# merge never drops a host's evidence until the ceiling); the ceiling
# bounds the fleet digest's wire size when many hosts are sick at once.
# 64 concurrent stragglers is already "the median itself has moved" —
# past that, per-rank evidence stops being the interesting signal.
FLEET_OUTLIER_CAP = 64


def merge_digests(a: dict, b: dict) -> dict:
    """The closed merge: host digest x host digest → fleet digest.
    Associative and commutative (golden-tested); inputs are not
    mutated.

    Outlier evidence keeps PER-HOST top-K semantics: the merged list is
    the union of both sides' entries (each side already bounded by its
    own cap), truncated only at :data:`FLEET_OUTLIER_CAP` — so with
    several concurrent stragglers on different hosts, every one of them
    survives the merge and flat-vs-tree verdict parity holds up to the
    ceiling."""
    top_k = max(int(a.get("top_k", DEFAULT_TOP_K)),
                int(b.get("top_k", DEFAULT_TOP_K)))
    cap = min(int(a.get("outlier_cap", a.get("top_k", DEFAULT_TOP_K)))
              + int(b.get("outlier_cap", b.get("top_k", DEFAULT_TOP_K))),
              FLEET_OUTLIER_CAP)
    window = {
        k: a["window"].get(k, 0) + b["window"].get(k, 0)
        for k in ("step_time_sum", "step_count",
                  "data_wait_sum", "data_wait_count")}
    attr_a, attr_b = a.get("attr") or {}, b.get("attr") or {}
    sums: Dict[str, float] = dict(attr_a.get("sums") or {})
    for k, v in (attr_b.get("sums") or {}).items():
        sums[k] = sums.get(k, 0.0) + float(v)
    means: Dict[str, dict] = {}
    for k in set(attr_a.get("means") or {}) | set(attr_b.get("means") or {}):
        s = QuantileSketch.from_dict((attr_a.get("means") or {}).get(k))
        s.merge(QuantileSketch.from_dict((attr_b.get("means") or {}).get(k)))
        means[k] = s.to_dict()
    counters: Dict[str, float] = dict(a.get("counters") or {})
    for k, v in (b.get("counters") or {}).items():
        counters[k] = counters.get(k, 0.0) + float(v)
    gauges: Dict[str, list] = {k: list(v)
                               for k, v in (a.get("gauges") or {}).items()}
    for k, v in (b.get("gauges") or {}).items():
        cur = gauges.get(k)
        if cur is None:
            gauges[k] = list(v)
        else:
            cur[0] = min(cur[0], v[0])
            cur[1] = max(cur[1], v[1])
            if v[3] >= cur[3]:
                cur[2], cur[3] = v[2], v[3]
    outliers = sorted(
        list(a.get("outliers") or []) + list(b.get("outliers") or []),
        key=_outlier_sort_key)[:cap]
    out = {
        "v": DIGEST_VERSION,
        "hosts": sorted(set(a.get("hosts") or []) | set(b.get("hosts") or [])),
        "failed_hosts": sorted(set(a.get("failed_hosts") or [])
                               | set(b.get("failed_hosts") or [])),
        "ranks": int(a.get("ranks", 0)) + int(b.get("ranks", 0)),
        "step": max(int(a.get("step", 0)), int(b.get("step", 0))),
        "missing": sorted(set(a.get("missing") or [])
                          | set(b.get("missing") or [])),
        "window": window,
        "rank_means": _merge_sketch_field(a, b, "rank_means"),
        "steps": _merge_sketch_field(a, b, "steps"),
        "mfu": _merge_sketch_field(a, b, "mfu"),
        "attr": {"sums": sums,
                 "steps": float(attr_a.get("steps", 0.0))
                 + float(attr_b.get("steps", 0.0)),
                 "flops": float(attr_a.get("flops", 0.0))
                 + float(attr_b.get("flops", 0.0)),
                 "wall": float(attr_a.get("wall", 0.0))
                 + float(attr_b.get("wall", 0.0)),
                 "means": means},
        "outliers": outliers,
        "counters": counters,
        "gauges": gauges,
        "top_k": top_k,
        "outlier_cap": cap,
    }
    if "round" in a or "round" in b:
        out["round"] = max(int(a.get("round", -1)),
                           int(b.get("round", -1)))
    return out


def merge_all(digests: Sequence[dict]) -> Optional[dict]:
    out = None
    for d in digests:
        out = dict(d) if out is None else merge_digests(out, d)
    return out


# ---------------------------------------------------------------------------
# digest read side
# ---------------------------------------------------------------------------

def digest_median_step(digest: dict) -> Optional[float]:
    """The fleet's median per-rank mean step time, from the sketch —
    the straggler baseline (``statistics.median`` semantics, within
    the sketch's ~2.5% bound of the flat path's exact median)."""
    return QuantileSketch.from_dict(digest.get("rank_means")).median()


def digest_component_medians(digest: dict) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for k, d in ((digest.get("attr") or {}).get("means") or {}).items():
        q = QuantileSketch.from_dict(d).median()
        if q is not None:
            out[k] = q
    return out


def digest_mfu(digest: dict) -> Optional[dict]:
    """{"min", "mean", "ranks"} from the merged per-rank MFU sketch —
    min and mean are EXACT (the sketch tracks both outside the
    buckets); None when no rank carried flops."""
    s = QuantileSketch.from_dict(digest.get("mfu"))
    if not s.count:
        return None
    return {"min": s.min, "mean": s.mean(), "ranks": s.count}


def digest_step_quantiles(digest: dict) -> Optional[dict]:
    """p50/p95/max over every step in the window, fleet-wide (the
    gateway timeline's per-sample shape)."""
    s = QuantileSketch.from_dict(digest.get("steps"))
    if not s.count:
        return None
    return {"p50": s.quantile(0.5), "p95": s.quantile(0.95),
            "max": s.max, "mean": s.mean(), "count": s.count}


def digest_shares(digest: dict) -> Optional[Dict[str, float]]:
    """Fleet-wide wall-component shares from the summed attribution
    window (exact — sums are counters)."""
    attr = digest.get("attr") or {}
    wall = float(attr.get("wall", 0.0))
    if wall <= 0:
        return None
    return {k: float((attr.get("sums") or {}).get(k, 0.0)) / wall
            for k in _WALL_COMPONENTS}
