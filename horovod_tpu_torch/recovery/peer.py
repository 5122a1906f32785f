"""Commit-time replication and restore-time peer reassembly (port of
horovod_tpu/recovery/peer.py).

Replication (:func:`replicate`, at a commit): the host values that
``checkpoint.zero.extract_zero_state`` copied for the disk shards, the
bytes ``write_shard`` encodes, are placed twice: the owner's copy in the
local :mod:`store`, the buddy copy with its holder, pushed over HTTP to
the holder's replica endpoint published in the rendezvous KV
(``transport``).  Each rank is its own process here, so a holder is
another process's store unless one process holds both ranks.  Entries
seal (:func:`seal_commit`) only once the owner's commit landed, so the
peer tier inherits the engine's manifest-last invariant.

Peer restore (:func:`peer_restore`, tried before the disk manifest):
every member of the new world contributes its sealed entries over
``allgather_object``, the collective plane the job already speaks.  The
merged view must cover every rank of the old world at one (step, world,
fingerprint) with a valid checksum; anything less (a buddy pair lost
together, a torn copy, empty stores after a relaunch) raises
:class:`PeerRestoreUnavailable`, and the caller falls back to the disk.
Reassembly is the checkpoint engine's: an in-memory
``checkpoint.engine.RestoredStep`` over the gathered shards, resharded
N→M by the same arithmetic and rebuilt into ``like`` by
``checkpoint.zero.rebuild_restored``, so a peer restore is bit-identical
to restoring the same step from the disk, onto the device ``like`` lives
on.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..debug import flight as _flight
from ..utils import logging as log
from . import buddy as B
# Direct-name imports: the package exports a ``store()`` accessor that
# shadows the submodule attribute.
from .store import ReplicaEntry, payload_checksum, verify_entry
from .store import store as _rstore


class PeerRestoreUnavailable(Exception):
    """The in-memory tier cannot cover the requested state; fall back to
    the disk manifest (or a fresh start)."""


@dataclasses.dataclass
class RecoveryReport:
    """What the last restore decision did, for the metrics, the flight
    recorder and hang reports."""

    path: str                 # "peer" | "disk" | "none"
    key: str = ""
    step: Optional[int] = None
    world_from: Optional[int] = None
    world_to: Optional[int] = None
    bytes_moved: int = 0
    seconds: float = 0.0
    reason: str = ""          # why this path (e.g. the peer miss's cause)
    wall: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


_report_lock = threading.Lock()
_last_report: Optional[RecoveryReport] = None


def record_report(report: RecoveryReport) -> RecoveryReport:
    global _last_report
    with _report_lock:
        _last_report = report
    return report


def last_report() -> Optional[RecoveryReport]:
    with _report_lock:
        return _last_report


def _registry():
    from ..metrics.registry import registry
    return registry()


def _stride() -> int:
    """The buddy ring's shift: ``HVD_TPU_RECOVERY_STRIDE``, else the
    local world size (a buddy on another host), 1 when unknown."""
    from ..core import config
    from ..core.state import global_state
    s = config.recovery_stride()
    if s > 0:
        return s
    return max(1, int(global_state.local_size or 1))


# ---------------------------------------------------------------------------
# Commit-time replication
# ---------------------------------------------------------------------------

def replicate(key: str, step: int, ext, extra: Optional[dict] = None,
              stride: Optional[int] = None, push: bool = True) -> int:
    """Place one commit's payloads (an ``ExtractedState``) in the replica
    tier: own copies here, buddy copies with their holders (pushed over
    HTTP unless this process holds the holder's rank).  Returns the
    bytes replicated; the entries are pending until
    :func:`seal_commit`.  The store keeps the extracted host arrays
    themselves: no second copy."""
    from ..checkpoint import manifest as M
    from ..checkpoint.zero import fingerprint_extra

    stride = _stride() if stride is None else int(stride)
    manifest = M.Manifest(step=int(step), world_size=ext.world,
                          leaves=ext.specs,
                          extra=fingerprint_extra(ext, extra))
    mjson = manifest.to_json()
    st = _rstore()
    reg = _registry()
    total = 0
    remote_pushed = 0
    for rank, values in sorted(ext.rank_values.items()):
        arrays = {spec.key: v for spec, v in zip(ext.specs, values)
                  if v is not None}
        entry = ReplicaEntry(
            key=key, rank=int(rank), step=int(step), world=ext.world,
            fingerprint=ext.fingerprint, manifest_json=mjson,
            arrays=arrays, checksum=payload_checksum(arrays))
        st.put_own(entry)
        total += entry.nbytes()
        holder = B.replica_holder(rank, ext.world, stride)
        if holder is None:
            continue
        if holder in ext.rank_values:
            # This process holds the holder's rank too: its store is the
            # holder's.
            st.put_held(entry)
        elif push:
            from . import transport as T
            addr = T.lookup_addr(holder)
            if addr is not None and T.push_replica(addr, entry):
                remote_pushed += 1
            else:
                reg.counter("hvd_recovery_push_failures_total",
                            "Replica pushes that never reached the "
                            "buddy").inc()
                log.warning(
                    "recovery: replica push rank %d -> holder %d failed"
                    " (peer tier degraded for this rank at step %d)",
                    rank, holder, step)
    reg.counter("hvd_recovery_replications_total",
                "Commit-time replica placements").inc()
    reg.counter("hvd_recovery_replica_bytes_total",
                "Bytes placed in the replica tier").inc(total)
    reg.gauge("hvd_recovery_store_bytes",
              "Resident bytes in the local replica store").set(
        st.total_bytes())
    _flight.record("recovery.replicate", key, step=int(step),
                   world=ext.world, bytes=total, stride=stride,
                   remote_pushed=remote_pushed)
    return total


def seal_commit(key: str, step: int, ext=None,
                stride: Optional[int] = None, push: bool = True) -> None:
    """The two-phase marker: the owner's commit landed.  Promotes the
    pending entries here and at the remote holders of ``ext``'s
    ranks."""
    _rstore().seal(key, int(step))
    if ext is None or not push:
        return
    stride = _stride() if stride is None else int(stride)
    from . import transport as T
    for rank in sorted(ext.rank_values):
        holder = B.replica_holder(rank, ext.world, stride)
        if holder is None or holder in ext.rank_values:
            continue
        addr = T.lookup_addr(holder)
        if addr is not None:
            T.push_seal(addr, key, int(step))


# ---------------------------------------------------------------------------
# Restore-time peer reassembly
# ---------------------------------------------------------------------------

def _gather_entries(key: str) -> List[ReplicaEntry]:
    """Every member's sealed contribution over the current world, in two
    gathers to keep the wire near one copy of the state: the owners'
    payloads first (every member needs every shard to rebuild the flat
    buffers), then buddy copies only for (step, world, fingerprint, rank)
    positions no surviving owner covered.  Both gathers run on every
    member and filter on the same first result, so the members stay
    collective-consistent.  Owner copies never crossed a transfer, so
    preferring them also avoids torn copies."""
    from ..optimizers import allgather_object
    own_local = _rstore().contribution(key, role="own")
    gathered = allgather_object(own_local, name="recovery.peer.gather")
    own = [e for contrib in gathered for e in contrib]
    covered = {(e.step, e.world, e.fingerprint, e.rank) for e in own}
    held_local = [e for e in _rstore().contribution(key, role="held")
                  if (e.step, e.world, e.fingerprint, e.rank)
                  not in covered]
    gathered_held = allgather_object(held_local,
                                     name="recovery.peer.gather_held")
    return own + [e for contrib in gathered_held for e in contrib]


def _coverage(entries: List[ReplicaEntry], reg) -> Tuple[
        Dict[Tuple[int, int, str], Dict[int, ReplicaEntry]], int]:
    """Valid entries grouped by (step, world, fingerprint), the first
    copy of a rank winning (owner copies come first); and the number of
    torn copies found."""
    groups: Dict[Tuple[int, int, str], Dict[int, ReplicaEntry]] = {}
    torn = 0
    for e in entries:
        if not verify_entry(e):
            torn += 1
            reg.counter("hvd_recovery_torn_replicas_total",
                        "Replica copies failing checksum verification"
                        ).inc()
            log.warning(
                "recovery: torn replica detected (key=%s rank=%d "
                "step=%d) — copy excluded from coverage", e.key, e.rank,
                e.step)
            continue
        g = groups.setdefault((e.step, e.world, e.fingerprint), {})
        g.setdefault(e.rank, e)
    return groups, torn


def _miss_reason(entries, groups, step, foreign, torn) -> str:
    if not entries:
        reason = "no sealed replicas in fleet memory (fresh relaunch or " \
                 "replication disabled)"
        if foreign:
            reason += f"; {foreign} foreign-run entries ignored"
        return reason
    newest = max(groups, key=lambda g: g[0], default=None)
    want = int(step) if step is not None else \
        (newest[0] if newest else -1)
    missing = []
    for g, ranks in groups.items():
        if g[0] == want:
            missing = sorted(set(range(g[1])) - set(ranks))
            break
    reason = (f"coverage gap at step {want}: missing old-world ranks "
              f"{missing} (buddy pair lost together)" if missing else
              f"no replica group covers step {want}")
    if torn:
        reason += f"; {torn} torn cop{'y' if torn == 1 else 'ies'} excluded"
    return reason


def peer_restore(key: str, like, step: Optional[int] = None):
    """Rebuild ``like``'s state for the current world from the fleet's
    replica memory: its ZeRO states and tensors in place (on their
    devices), as ``checkpoint.zero.restore_zero_state`` restores a disk
    step.  ``step`` pins the commit; None takes the newest fully covered
    one.  Returns ``(state, manifest_extra, report)`` or raises
    :class:`PeerRestoreUnavailable` with the coverage reason.

    Collective: every member of the current world calls it, with the
    same ``step``.  The world is ``like``'s ZeRO axis (the runtime's
    when it holds none), as the disk restore's."""
    from ..checkpoint import engine as E
    from ..checkpoint import manifest as M
    from ..checkpoint import zero as Z

    reg = _registry()
    t0 = time.perf_counter()
    _flight.record("recovery.restore.begin", key,
                   step=step if step is None else int(step))
    entries = _gather_entries(key)
    world_new = Z._axis_of(like)[0]

    # Replicas of another run sharing this store are a miss, not an
    # error: filter on the target's world-size-invariant fingerprint
    # before voting, the disk engine's cross-run guard, with its
    # HVD_TPU_CKPT_ALLOW_FOREIGN escape hatch.
    target_fp = M.spec_fingerprint(
        [leaf.spec for group, _ in Z._plan(like, max(1, world_new))
         for leaf in group])
    foreign = 0
    if not Z._foreign_allowed():
        matched = [e for e in entries if e.fingerprint == target_fp]
        foreign = len(entries) - len(matched)
        entries = matched
    groups, torn = _coverage(entries, reg)

    covered = {g: ranks for g, ranks in groups.items()
               if set(ranks) >= set(range(g[1]))}
    chosen = None
    if step is not None:
        chosen = next((g for g in covered if g[0] == int(step)), None)
    elif covered:
        chosen = max(covered, key=lambda g: g[0])
    if chosen is None:
        reason = _miss_reason(entries, groups, step, foreign, torn)
        reg.counter("hvd_recovery_restores_total",
                    "Recovery restore decisions by path",
                    path="peer_miss").inc()
        _flight.record("recovery.restore.miss", key, reason=reason)
        raise PeerRestoreUnavailable(reason)

    ranks = covered[chosen]
    step_c, world_old, _fp = chosen
    manifest = M.Manifest.from_json(ranks[0].manifest_json)
    shards = [ranks[r].arrays for r in range(world_old)]
    restored = E.RestoredStep(manifest, shards, world_new)
    state = Z.rebuild_restored(restored, like,
                               source=f"the peer tier's step {step_c}")
    bytes_moved = sum(ranks[r].nbytes() for r in range(world_old))
    dt = time.perf_counter() - t0
    report = record_report(RecoveryReport(
        path="peer", key=key, step=step_c, world_from=world_old,
        world_to=world_new, bytes_moved=bytes_moved, seconds=dt,
        reason="full coverage in fleet memory", wall=time.time()))
    reg.counter("hvd_recovery_restores_total",
                "Recovery restore decisions by path", path="peer").inc()
    reg.counter("hvd_recovery_restore_bytes_total",
                "Bytes reassembled from the replica tier").inc(
        bytes_moved)
    reg.gauge("hvd_recovery_restore_seconds",
              "Duration of the last recovery restore").set(dt)
    _flight.record("recovery.restore.done", key, path="peer",
                   step=step_c, world_from=world_old,
                   world_to=world_new, bytes=bytes_moved)
    log.info("recovery: peer-restored %s step %d (world %d -> %d, "
             "%.1f MB in %.3f s)", key, step_c, world_old, world_new,
             bytes_moved / 1e6, dt)
    return state, dict(manifest.extra), report
