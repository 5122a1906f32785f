"""Thread-safe, allocation-light metric primitives and their registry
(port of horovod_tpu/metrics/registry.py, byte for byte in behaviour).

Three Prometheus-shaped primitives (Counter, Gauge, fixed-bucket
Histogram) behind a process-global registry: the storage layer every
instrumented subsystem of the port records into.

Design constraints, in priority order:

1. **Hot-path cheap**: one ``inc``/``observe`` is a flag check, one lock
   acquire and a float add — no allocation, no string formatting.
   Instrumented call sites cache the child metric object so the
   name→family lookup happens once.
2. **Thread-safe**: collectives record from the native background
   thread, data-wait spans from the prefetch consumer, exporters read
   from an HTTP thread.  Per-metric locks keep writers independent.
3. **No heavy imports**: importing this module pulls stdlib only, so
   every subsystem can instrument without dragging in torch or numpy.

Disable switch: ``HVD_TPU_METRICS_DISABLE=1`` (or ``set_enabled(False)``)
turns every record call into a near-no-op — the switch
``chip_smoke.py`` phase 14 measures the telemetry's host cost against.
"""

from __future__ import annotations

import bisect
import math
import os
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Latency-shaped default buckets (seconds): collectives span ~100us eager
# rings to multi-second fused pod launches; checkpoint saves reach minutes.
DEFAULT_TIME_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 15.0, 60.0)

# Payload-shaped buckets (bytes): 1 KB .. 1 GB by powers of ~8.
DEFAULT_BYTE_BUCKETS = (
    1 << 10, 1 << 13, 1 << 16, 1 << 19, 1 << 22, 1 << 25, 1 << 28, 1 << 30)

_enabled = os.environ.get("HVD_TPU_METRICS_DISABLE", "") != "1"


def set_enabled(flag: bool) -> None:
    """Globally enable/disable recording (reading stays available)."""
    global _enabled
    _enabled = bool(flag)


def enabled() -> bool:
    return _enabled


class Counter:
    """Monotonic accumulator.  ``inc`` with a negative amount raises —
    a decreasing counter corrupts every rate() computed from it.
    ``resets`` counts explicit reset() calls, so delta consumers (the
    cross-rank aggregator's window marks) can tell "restarted and
    climbed back" from "never reset"."""

    __slots__ = ("name", "labels", "_value", "_resets", "_lock")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._resets = 0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if not _enabled:
            return
        if amount < 0:
            raise ValueError(
                f"counter {self.name} cannot decrease (inc({amount}))")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    @property
    def resets(self) -> int:
        with self._lock:
            return self._resets

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0
            self._resets += 1


class Gauge:
    """Point-in-time value (set/inc/dec)."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        if not _enabled:
            return
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if not _enabled:
            return
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Histogram:
    """Fixed-bucket histogram: ``observe`` is a bisect + two adds.

    Buckets are upper bounds (``le`` semantics, Prometheus exposition
    format); an implicit ``+Inf`` bucket catches the tail.  Bucket
    boundaries are frozen at creation — no per-observation allocation.
    """

    __slots__ = ("name", "labels", "buckets", "_counts", "_sum", "_count",
                 "_exemplars", "_lock")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 buckets: Sequence[float]):
        self.name = name
        self.labels = labels
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError(f"histogram {name}: at least one bucket")
        if any(math.isnan(b) for b in bs):
            raise ValueError(f"histogram {name}: NaN bucket bound")
        self.buckets = bs
        self._counts = [0] * (len(bs) + 1)  # last slot = +Inf
        self._sum = 0.0
        self._count = 0
        self._exemplars: Optional[Dict[int, Tuple[float, str]]] = None
        self._lock = threading.Lock()

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        if not _enabled:
            return
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if exemplar is not None:
                # Last-writer-wins per bucket: exemplars are trace-id
                # breadcrumbs (OpenMetrics semantics), not statistics —
                # the freshest reference is the debuggable one.
                if self._exemplars is None:
                    self._exemplars = {}
                self._exemplars[i] = (value, exemplar)

    def exemplars(self) -> Dict[str, Dict[str, object]]:
        """{le label: {"value": observed, "ref": exemplar}} for every
        bucket that has one.  ``le`` follows the exposition format
        (bucket upper bound, ``+Inf`` for the tail)."""
        with self._lock:
            ex = dict(self._exemplars) if self._exemplars else {}
        out: Dict[str, Dict[str, object]] = {}
        for i, (value, ref) in sorted(ex.items()):
            le = "+Inf" if i >= len(self.buckets) else repr(self.buckets[i])
            out[le] = {"value": value, "ref": ref}
        return out

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def cumulative_counts(self) -> List[int]:
        """Per-``le``-bound cumulative counts, +Inf last (the exposition
        format's bucket series)."""
        with self._lock:
            counts = list(self._counts)
        out, total = [], 0
        for c in counts:
            total += c
            out.append(total)
        return out

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0
            self._count = 0
            self._exemplars = None


_KIND_OF = {Counter: "counter", Gauge: "gauge", Histogram: "histogram"}


class _Family:
    """One metric name: kind + help + the children keyed by label set."""

    def __init__(self, name: str, kind: str, help: str,
                 buckets: Optional[Sequence[float]]):
        self.name = name
        self.kind = kind
        self.help = help
        self.buckets = tuple(buckets) if buckets is not None else None
        self.children: Dict[Tuple[Tuple[str, str], ...], object] = {}


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"invalid label name {k!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Get-or-create registry of metric families.

    ``counter``/``gauge``/``histogram`` return the child for the given
    label set, creating family and child on first use.  Re-registering a
    name with a different kind (or different histogram buckets) raises —
    silent divergence would corrupt the exposition.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _get(self, name: str, kind: str, help: str,
             buckets: Optional[Sequence[float]],
             labels: Dict[str, str]):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, help, buckets)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name} already registered as {fam.kind}, "
                    f"requested {kind}")
            elif kind == "histogram" and buckets is not None and \
                    fam.buckets != tuple(buckets):
                raise ValueError(
                    f"histogram {name} already registered with buckets "
                    f"{fam.buckets}, requested {tuple(buckets)}")
            child = fam.children.get(key)
            if child is None:
                if kind == "counter":
                    child = Counter(name, key)
                elif kind == "gauge":
                    child = Gauge(name, key)
                else:
                    child = Histogram(name, key,
                                      fam.buckets or DEFAULT_TIME_BUCKETS)
                fam.children[key] = child
            return child

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(name, "counter", help, None, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(name, "gauge", help, None, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None,
                  **labels) -> Histogram:
        return self._get(name, "histogram", help, buckets, labels)

    def families(self) -> List[_Family]:
        """Stable (name-sorted) view for exporters.  The family objects
        are LIVE — iterate their ``children`` dicts via :meth:`collect`
        instead, or a concurrent instrument creation (``_get`` inserting
        a child mid-scrape) raises ``RuntimeError: dictionary changed
        size during iteration``."""
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]

    def collect(self) -> List[Tuple[_Family, List[Tuple[tuple, object]]]]:
        """Point-in-time ``[(family, [(label_key, child), ...])]`` with
        every children list copied UNDER the registry lock — the one
        safe way to iterate series while other threads create
        instruments (exporters scrape from HTTP threads; collectives
        register children from the native background thread).  The child
        objects themselves are thread-safe to read."""
        with self._lock:
            return [(fam, sorted(fam.children.items()))
                    for fam in (self._families[n]
                                for n in sorted(self._families))]

    def children_of(self, name: str) -> List[object]:
        """Read-only: the live children of family ``name`` (label-key
        order), or ``[]`` when the family does not exist yet.  Never
        creates the family — callers that must not pre-empt another
        subsystem's registration (e.g. histogram bucket choices) read
        through this."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return []
            return [fam.children[k] for k in sorted(fam.children)]

    def snapshot(self) -> Dict[str, dict]:
        """Full point-in-time read: {name: {kind, help, series: [...]}}.
        Histogram series carry cumulative bucket counts + sum + count."""
        out: Dict[str, dict] = {}
        for fam, children in self.collect():
            series = []
            for key, child in children:
                entry: dict = {"labels": dict(key)}
                if fam.kind == "histogram":
                    entry["buckets"] = list(child.buckets)
                    entry["counts"] = child.cumulative_counts()
                    entry["sum"] = child.sum
                    entry["count"] = child.count
                else:
                    entry["value"] = child.value
                series.append(entry)
            out[fam.name] = {"kind": fam.kind, "help": fam.help,
                             "series": series}
        return out

    def scalars(self) -> Dict[str, float]:
        """Compact flat view of counters/gauges (histograms reduced to
        ``name_sum``/``name_count``) — the cross-rank snapshot wire
        format.  Keys: ``name`` or ``name{k=v,...}``."""
        out: Dict[str, float] = {}
        for fam, children in self.collect():
            for key, child in children:
                suffix = "" if not key else \
                    "{" + ",".join(f"{k}={v}" for k, v in key) + "}"
                if fam.kind == "histogram":
                    out[fam.name + "_sum" + suffix] = child.sum
                    out[fam.name + "_count" + suffix] = float(child.count)
                else:
                    out[fam.name + suffix] = child.value
        return out

    def scalar_kinds(self) -> Dict[str, str]:
        """{flat scalar key: "counter" | "gauge"} for every key
        :meth:`scalars` emits — the digest merge rule's steering table
        (metrics/digest.py): counters (and histogram ``_sum``/``_count``
        reductions, which are monotone like counters) merge by sum,
        gauges keep (min, max, last)."""
        out: Dict[str, str] = {}
        for fam, children in self.collect():
            for key, _child in children:
                suffix = "" if not key else \
                    "{" + ",".join(f"{k}={v}" for k, v in key) + "}"
                if fam.kind == "histogram":
                    out[fam.name + "_sum" + suffix] = "counter"
                    out[fam.name + "_count" + suffix] = "counter"
                else:
                    out[fam.name + suffix] = fam.kind
        return out

    def reset(self) -> None:
        """Zero every metric (families and children stay registered —
        cached child references at call sites remain valid)."""
        for _fam, children in self.collect():
            for _key, child in children:
                child.reset()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global registry every subsystem instruments into."""
    return _REGISTRY
