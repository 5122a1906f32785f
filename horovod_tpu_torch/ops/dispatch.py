"""Topology-probed per-payload collective schedule dispatch (port of
horovod_tpu/ops/dispatch.py).

The native runtime carries flat-ring and two-phase hierarchical
schedules; which one a response runs is stamped by the coordinator from
a per-(op kind, payload bucket) :class:`DispatchTable`:

* at ``init()`` with a controller, a short seeded probe times a few
  payload sizes under {flat, hierarchical} over the runtime's host plane
  (only where a hierarchy can run: every host holds the same number of
  ranks, more than one and fewer than the world);
* rank 0 builds the table from the medians (:func:`build_table`),
  broadcasts it so every rank annotates identically, and installs it on
  the coordinator (``hvd_native_set_schedule_table``);
* every later response is stamped with the table's choice for its final
  fused payload size, and ``ops.xla_collectives.choose_schedule`` reads
  the same table for the port's own scheduled collectives.

Explicit ``HVD_TPU_HIERARCHICAL_ALLREDUCE``/``_ALLGATHER`` stay pins: the
op kind skips its probe and the whole payload range uses the pinned
schedule.  The reference's autotuner refines the table by whole buckets
(``DispatchTable.shifted``), and so does the port's (``autotune.py``
through ``NativeController._apply_tuned``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ..debug import flight as _flight

# Payload buckets (upper bounds, bytes; the last bucket is unbounded).
# Log-spaced around the regimes the eager sweep showed distinct
# behavior in: latency-bound small ops, the shm-slot midrange, and the
# bandwidth-bound large payloads where the leader exchange pays off.
PAYLOAD_BUCKET_BOUNDS: Tuple[int, ...] = (
    16 << 10, 128 << 10, 1 << 20, 8 << 20, 64 << 20)
N_BUCKETS = len(PAYLOAD_BUCKET_BOUNDS) + 1

BUCKET_LABELS: Tuple[str, ...] = tuple(
    [f"le_{b >> 10}K" if b < (1 << 20) else f"le_{b >> 20}M"
     for b in PAYLOAD_BUCKET_BOUNDS] +
    [f"gt_{PAYLOAD_BUCKET_BOUNDS[-1] >> 20}M"])

# Geometric bucket centers (log-space nearest-probe assignment).
_BUCKET_CENTERS: Tuple[float, ...] = tuple(
    float(np.sqrt((PAYLOAD_BUCKET_BOUNDS[i - 1] if i else 1) *
                  PAYLOAD_BUCKET_BOUNDS[i]))
    for i in range(len(PAYLOAD_BUCKET_BOUNDS))
) + (float(PAYLOAD_BUCKET_BOUNDS[-1]) * 2.0,)

# Op kinds with a flat/hierarchical choice; codes match the native
# ScheduleKind enum (controller.h).
KINDS: Tuple[str, ...] = ("allreduce", "allgather")
KIND_CODES: Dict[str, int] = {"allreduce": 0, "allgather": 1}

SCHEDULES: Tuple[str, ...] = ("flat", "hier")

# Probe plan: payload bytes per op kind.  For allgather the probe sizes
# the PER-RANK contribution so the TOTAL gathered payload (what the
# coordinator's table keys on) lands in distinct buckets at world 4-8.
PROBE_PAYLOADS: Dict[str, Tuple[int, ...]] = {
    "allreduce": (64 << 10, 1 << 20, 8 << 20),
    "allgather": (32 << 10, 512 << 10),
}

_INT64_MAX = (1 << 63) - 1


def bucket_of(nbytes: int) -> int:
    """Payload bucket index for ``nbytes`` (0-based)."""
    for i, b in enumerate(PAYLOAD_BUCKET_BOUNDS):
        if nbytes <= b:
            return i
    return len(PAYLOAD_BUCKET_BOUNDS)


class DispatchTable(NamedTuple):
    """Per-(op kind, payload bucket) schedule choice.

    ``allreduce``/``allgather`` hold one schedule name ("flat"/"hier")
    per payload bucket; ``source`` records where the table came from
    ("probe", "pin", "config", "default", "autotune").  Hashable and
    value-semantic, so tables compare in tests."""

    allreduce: Tuple[str, ...]
    allgather: Tuple[str, ...]
    source: str = "default"

    def schedules(self, kind: str) -> Tuple[str, ...]:
        if kind not in KINDS:
            raise KeyError(kind)
        return getattr(self, kind)

    def choose(self, kind: str, nbytes: int) -> str:
        """The schedule this table dispatches for one payload."""
        return self.schedules(kind)[bucket_of(int(nbytes))]

    def crossover_bytes(self, kind: str) -> Optional[int]:
        """Upper bound of the last bucket before the first schedule
        change (None when the whole range uses one schedule)."""
        v = self.schedules(kind)
        for i in range(1, len(v)):
            if v[i] != v[0]:
                return PAYLOAD_BUCKET_BOUNDS[i - 1]
        return None

    def shifted(self, shifts: Dict[str, int]) -> "DispatchTable":
        """Bounded refinement: bucket ``i`` adopts the base choice of
        bucket ``i + shift`` (clamped), which moves every crossover
        boundary by one bucket per unit of shift — shift +1 applies the
        larger-payload choice one bucket earlier, -1 one bucket later.
        Zero shifts return an equal table."""
        out = {}
        for kind in KINDS:
            s = int(shifts.get(kind, 0))
            v = self.schedules(kind)
            out[kind] = tuple(
                v[min(max(i + s, 0), len(v) - 1)] for i in range(len(v)))
        return DispatchTable(out["allreduce"], out["allgather"],
                             source="autotune" if any(
                                 shifts.get(k, 0) for k in KINDS)
                             else self.source)

    def to_native(self, kind: str) -> Tuple[List[int], List[int]]:
        """(max_bytes, hierarchical) arrays for
        ``hvd_native_set_schedule_table``: one segment per bucket, last
        segment unbounded."""
        bounds = list(PAYLOAD_BUCKET_BOUNDS) + [_INT64_MAX]
        choices = [1 if s == "hier" else 0 for s in self.schedules(kind)]
        return bounds, choices

    def encode(self) -> np.ndarray:
        """int8 vector [allreduce buckets..., allgather buckets...]
        (0 flat / 1 hier) — the payload broadcast from rank 0 so every
        rank holds the identical table."""
        vals = [1 if s == "hier" else 0
                for kind in KINDS for s in self.schedules(kind)]
        return np.asarray(vals, dtype=np.int8)

    @classmethod
    def decode(cls, arr, source: str = "probe") -> "DispatchTable":
        flat = [int(v) for v in np.asarray(arr).reshape(-1)]
        if len(flat) != len(KINDS) * N_BUCKETS:
            raise ValueError(
                f"dispatch table payload has {len(flat)} entries, "
                f"expected {len(KINDS) * N_BUCKETS}")
        vecs = []
        for k in range(len(KINDS)):
            seg = flat[k * N_BUCKETS:(k + 1) * N_BUCKETS]
            vecs.append(tuple("hier" if v else "flat" for v in seg))
        return cls(vecs[0], vecs[1], source=source)


def constant_table(choices: Dict[str, bool],
                   source: str = "config") -> DispatchTable:
    """Whole-range table: each kind's buckets all use one schedule."""
    vecs = {k: ("hier" if choices.get(k, False) else "flat",) * N_BUCKETS
            for k in KINDS}
    return DispatchTable(vecs["allreduce"], vecs["allgather"],
                         source=source)


class ProbeMeasurement(NamedTuple):
    kind: str
    schedule: str
    nbytes: int      # the payload size the dispatch table keys on
    seconds: float   # median of the timed reps


def build_table(measurements: List[ProbeMeasurement],
                pins: Optional[Dict[str, Optional[bool]]] = None,
                fallback: Optional[Dict[str, bool]] = None,
                source: str = "probe") -> DispatchTable:
    """Pure table construction from probe medians (golden-tested;
    determinism lives here, not in the wall clock).

    Per probed size the cheaper schedule wins; each grid bucket adopts
    the winner of the log-space nearest probed size.  Pinned kinds get
    the pinned constant; kinds with neither measurements nor a pin fall
    back to the legacy global booleans."""
    pins = pins or {}
    fallback = fallback or {}
    by_kind: Dict[str, Dict[int, Dict[str, float]]] = {}
    for m in measurements:
        by_kind.setdefault(m.kind, {}).setdefault(
            m.nbytes, {})[m.schedule] = m.seconds
    vecs: Dict[str, Tuple[str, ...]] = {}
    for kind in KINDS:
        pin = pins.get(kind)
        if pin is not None:
            vecs[kind] = (("hier" if pin else "flat"),) * N_BUCKETS
            continue
        sizes = {n: arms for n, arms in by_kind.get(kind, {}).items()
                 if len(arms) == len(SCHEDULES)}
        if not sizes:
            vecs[kind] = (("hier" if fallback.get(kind, False)
                           else "flat"),) * N_BUCKETS
            continue
        winners = {n: min(arms, key=lambda s: (arms[s], s))
                   for n, arms in sizes.items()}
        probed = sorted(winners)
        vec = []
        for center in _BUCKET_CENTERS:
            nearest = min(probed, key=lambda n: abs(
                np.log2(max(n, 1)) - np.log2(center)))
            vec.append(winners[nearest])
        vecs[kind] = tuple(vec)
    return DispatchTable(vecs["allreduce"], vecs["allgather"],
                         source=source)


# ---------------------------------------------------------------------------
# probe execution (collective — every rank runs the identical op sequence)
# ---------------------------------------------------------------------------

def _native_runner(controller) -> Callable:
    """Default probe op runner over the native controller (in-place
    allreduce — no output staging copy — and the plain allgather)."""
    def run(kind: str, arr: np.ndarray, name: str) -> None:
        if kind == "allreduce":
            h = controller.allreduce_async_(arr, arr, op=1, name=name)
            controller.wait(h)
        elif kind == "allgather":
            controller.allgather(arr, name=name)
        else:
            raise ValueError(kind)
    return run


def _pin_whole_range(controller, kind: str, hier: bool) -> None:
    """Point the coordinator's table at one schedule for the probe arm
    (rank 0 only — workers adopt the per-response stamp)."""
    if controller.rank() == 0:
        controller.set_schedule_table(kind, [_INT64_MAX],
                                      [1 if hier else 0])


def run_probe(controller, kinds: Tuple[str, ...],
              seed: int = 0, reps: int = 2,
              payloads: Optional[Dict[str, Tuple[int, ...]]] = None,
              runner: Optional[Callable] = None,
              timer: Callable[[], float] = time.perf_counter,
              ) -> List[ProbeMeasurement]:
    """Time each probed (kind, schedule, payload) arm.

    The op sequence — arms, payload draws, names — is a pure function of
    the arguments, so every rank enqueues the identical collective
    sequence (the controller's name-based negotiation requires it); the
    payload CONTENTS are drawn from ``seed``.  Only rank 0's timings
    decide (its wall time spans the slowest rank by the collective's
    nature); every rank still measures so the probe can be asserted
    symmetric in tests."""
    payloads = payloads or PROBE_PAYLOADS
    runner = runner or _native_runner(controller)
    rng = np.random.RandomState(seed)
    world = max(int(controller.size()), 1)
    out: List[ProbeMeasurement] = []
    for kind in kinds:
        for sched in SCHEDULES:
            _pin_whole_range(controller, kind, sched == "hier")
            # One negotiated round fences the table swap before the
            # first timed op of the arm.
            controller.barrier()
            for nbytes in payloads[kind]:
                arr = rng.randn(max(nbytes // 4, 1)).astype(np.float32)
                base = f"hvd.dispatch.probe.{kind}.{sched}.{nbytes}"
                runner(kind, arr, f"{base}.warm")
                controller.barrier()
                times = []
                for i in range(max(reps, 1)):
                    t0 = timer()
                    runner(kind, arr, f"{base}.{i}")
                    times.append(timer() - t0)
                # The table keys on the payload the COORDINATOR sees:
                # allgather responses carry the full gathered result.
                table_bytes = nbytes * world if kind == "allgather" \
                    else nbytes
                out.append(ProbeMeasurement(
                    kind, sched, table_bytes,
                    float(np.median(times))))
    controller.barrier()
    return out


# ---------------------------------------------------------------------------
# active table (module state: annotation mirror + metrics + flight)
# ---------------------------------------------------------------------------

_active: Optional[DispatchTable] = None
_gauges = None


def _dispatch_metrics():
    global _gauges
    if _gauges is None:
        from ..metrics.registry import registry
        reg = registry()
        _gauges = (
            reg.counter("hvd_schedule_probes_total",
                        "Topology probes run (once per init on probed "
                        "topologies)"),
            reg.gauge("hvd_schedule_probe_seconds",
                      "Wall time of the most recent topology probe"),
            reg,
        )
    return _gauges


def set_active(table: DispatchTable, reason: str = "install") -> None:
    """Publish ``table`` as this process's annotation mirror and record
    it: a gauge per (kind, bucket) and the ``dispatch.table`` flight
    event.  Does NOT touch the native coordinator: ``install()`` owns
    that."""
    global _active
    _active = table
    reg = _dispatch_metrics()[2]
    for kind in KINDS:
        for i, sched in enumerate(table.schedules(kind)):
            reg.gauge("hvd_schedule_dispatch",
                      "Dispatch-table schedule per (op kind, payload "
                      "bucket): 0 = flat, 1 = hierarchical",
                      kind=kind, bucket=BUCKET_LABELS[i]).set(
                          1.0 if sched == "hier" else 0.0)
    _flight.record("dispatch.table", None, source=table.source,
                   reason=reason,
                   allreduce=",".join(table.allreduce),
                   allgather=",".join(table.allgather))


def active_table() -> Optional[DispatchTable]:
    return _active


def annotate(kind: str, nbytes) -> Optional[str]:
    """This process's expected schedule for one payload (None when no
    table is active or the kind has no flat/hier choice).  Advisory —
    the authoritative choice is the coordinator's response-stream stamp;
    the mirror is the probe-broadcast table, which rank 0's tuner may
    have refined by a bucket since."""
    t = _active
    if t is None or nbytes is None or kind not in KINDS:
        return None
    return t.choose(kind, int(nbytes))


def reset() -> None:
    """Test hook: drop the active table."""
    global _active
    _active = None


def install(table: DispatchTable, controller=None,
            reason: str = "install") -> None:
    """Adopt ``table``: the annotation mirror on this rank, the native
    coordinator's tables through the controller (which no-ops the native
    install off rank 0)."""
    set_active(table, reason=reason)
    if controller is None:
        return
    adopt = getattr(controller, "adopt_dispatch_table", None)
    if adopt is not None:
        adopt(table)
    elif controller.rank() == 0:
        # Duck-typed controllers (tests, bench stubs) without the
        # adopt hook still get the native install on the coordinator.
        for kind in KINDS:
            bounds, choices = table.to_native(kind)
            controller.set_schedule_table(kind, bounds, choices)


# ---------------------------------------------------------------------------
# init-time bootstrap
# ---------------------------------------------------------------------------

def bootstrap(controller, cfg, local_size: int,
              payloads: Optional[Dict[str, Tuple[int, ...]]] = None,
              ) -> Optional[DispatchTable]:
    """Probe-and-install, called once per ``init()`` on controller jobs.

    Decision inputs (probe on/off, pins, world, local_size, and any
    ``payloads`` override) are all rank-consistent by the launcher's env
    contract, so every rank takes the same branch and enqueues the same
    probe sequence — the same invariant every negotiated collective
    already relies on.  ``payloads`` widens the default probe plan when
    the caller knows its real payload range (init() keeps the cheap
    defaults — buckets beyond the largest probed size inherit its
    winner)."""
    if not getattr(cfg, "schedule_probe", True):
        # HVD_TPU_SCHEDULE_PROBE=0: the global booleans seeded at
        # set_topology stay authoritative and no table exists — the
        # escape hatch back to the pre-dispatch behavior.
        return None
    pins = {"allreduce": getattr(cfg, "hierarchical_allreduce_pin", None),
            "allgather": getattr(cfg, "hierarchical_allgather_pin", None)}
    world = int(controller.size())
    if world <= 1:
        set_active(constant_table({k: False for k in KINDS},
                                  source="default"), reason="bootstrap")
        return _active
    if all(p is not None for p in pins.values()):
        # Fully pinned: no probe, no collectives — the constant table
        # is derivable from (rank-consistent) env alone.
        table = constant_table({k: bool(pins[k]) for k in KINDS},
                               source="pin")
        install(table, controller=controller, reason="bootstrap")
        return table
    # Topology agreement: whether a hierarchy exists to probe depends
    # on every rank's local_size, and per-rank arithmetic is NOT
    # globally consistent on heterogeneous host layouts (hosts 3+2+1:
    # the 2-slot ranks see 2*cross==world, the others do not — half the
    # fleet would enter the probe and strand the rest).  One tiny
    # allgather gives every rank the identical local-size vector, so
    # the decision below is a pure function of identical data.
    sizes = np.asarray(controller.allgather(
        np.asarray([int(local_size)], dtype=np.int32),
        name="hvd.dispatch.topo")).reshape(-1)
    L = int(sizes[0]) if sizes.size else 1
    homogeneous = bool(sizes.size) and bool((sizes == L).all())
    hier_possible = homogeneous and 1 < L < world and world % L == 0
    if not hier_possible:
        # The native layer degenerates hierarchical to flat on these
        # topologies; the mirror records the EFFECTIVE schedule so
        # annotation never claims a phase structure that cannot run.
        set_active(constant_table({k: False for k in KINDS},
                                  source="default"), reason="bootstrap")
        return _active
    t0 = time.perf_counter()
    probe_kinds = tuple(k for k in KINDS if pins[k] is None)
    # Probe traffic is pinned-arm measurement: the autotuner must not
    # score it or burn warmup windows on it.
    pause = getattr(controller, "autotune_paused", None)
    with (pause() if pause is not None else contextlib.nullcontext()):
        ms = run_probe(controller, probe_kinds,
                       seed=getattr(cfg, "schedule_probe_seed", 0),
                       reps=getattr(cfg, "schedule_probe_reps", 2),
                       payloads=payloads)
    if controller.rank() == 0:
        enc = build_table(ms, pins=pins).encode()
    else:
        enc = np.zeros(len(KINDS) * N_BUCKETS, dtype=np.int8)
    # Root's table to everyone: rank 0's timings decide, every rank
    # annotates from the identical copy.
    enc = controller.broadcast(enc, root_rank=0,
                               name="hvd.dispatch.table.bcast")
    table = DispatchTable.decode(np.asarray(enc), source="probe")
    install(table, controller=controller, reason="probe")
    dur = time.perf_counter() - t0
    counters = _dispatch_metrics()
    counters[0].inc()
    counters[1].set(dur)
    _flight.record("dispatch.probe", None, seconds=round(dur, 4),
                   arms=len(ms), world=world, local_size=local_size,
                   seed=getattr(cfg, "schedule_probe_seed", 0))
    return table
