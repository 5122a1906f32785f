"""Elastic state objects and the ``run`` retry loop (port of
horovod_tpu/elastic/state.py).

Capability parity with upstream Horovod (horovod/common/elastic.py:26-175):

* ``State.commit()`` — snapshot to host memory + check for host updates.
* ``State.restore()`` — roll back to the last committed snapshot after a
  ``HorovodInternalError``.
* ``State.sync()`` — broadcast state from the elected root to (re)joining
  workers.
* ``run(train_fn)`` — wraps a training function so collective failures
  restore state and re-rendezvous, and host-set changes re-rendezvous
  without restore (``HostsUpdatedInterrupt``).  ``sync()`` runs after
  every reset regardless of the interrupt's skip hint (see ``run``).

The reset is the upstream ``shutdown(); init()``: ``init()`` of an elastic
worker forms the torch world of the driver's next round (``core/basics``).
The state's trees are the port's: a module or its ``state_dict``, and the
optimizers (``ZeroShardedOptimizer`` at any stage, ``DistributedOptimizer``,
a plain ``torch.optim`` optimizer) or trees holding them beside tensors, as
``checkpoint.extract_zero_state`` takes them.  Live objects are restored
in place: the training step that holds them keeps working.
"""

from __future__ import annotations

import copy
import functools
import queue
import threading
from typing import Any, Callable, Dict, Optional

import torch

from ..core import failure as _failure
from ..core.exceptions import HorovodInternalError, HostsUpdatedInterrupt
from ..core.state import global_state
from ..debug import flight as _flight
from ..utils import logging as log


def _elastic_counter(name: str, help: str, **labels):
    """Elastic lifecycle events in the metrics registry."""
    from ..metrics.registry import registry
    return registry().counter(name, help, **labels)


def _multi() -> bool:
    return global_state.initialized and global_state.size > 1


class State:
    """Base elastic state with commit/restore/sync and host-update checks."""

    def __init__(self, **kwargs):
        self._host_messages: "queue.Queue" = queue.Queue()
        self._last_updated_timestamp = 0
        self._reset_callbacks = []
        # Commit seniority for sync-root election (elect_sync_root): a
        # freshly (re)spawned worker carries 0, survivors the number of
        # commits their state has seen.
        self._sync_generation = 0
        for k, v in kwargs.items():
            setattr(self, k, v)

    def register_reset_callbacks(self, callbacks):
        self._reset_callbacks.extend(callbacks)

    def on_reset(self):
        self._host_messages = queue.Queue()
        self.reset()
        for cb in self._reset_callbacks:
            cb()

    def on_hosts_updated(self, timestamp, update_res):
        self._host_messages.put((timestamp, update_res))

    def commit(self):
        # A world marked failed (core/failure.py) must not commit what
        # its aborted collectives left behind.
        _failure.check()
        self.save()
        self._sync_generation += 1
        _flight.record("elastic.commit", None,
                       generation=self._sync_generation)
        _elastic_counter("hvd_elastic_commits_total",
                         "Elastic state commits").inc()
        notification_manager.announce_commit(self._sync_generation)
        notification_manager.poll()
        self.check_host_updates()

    def elect_sync_root(self) -> int:
        """Agree on which rank's state seeds ``sync()``: the lowest rank
        holding the highest commit generation, so that a freshly
        respawned process seated at rank 0 of a new round cannot
        overwrite every survivor's committed state with its initial
        one."""
        from ..optimizers import allgather_object
        gens = allgather_object(int(self._sync_generation),
                                name="elastic.sync.generation")
        self._elected_generation = max(gens)
        return int(max(range(len(gens)), key=lambda r: (gens[r], -r)))

    def adopt_sync_generation(self):
        """Call once sync's broadcasts COMPLETE: only then does this
        worker hold the root's state and deserve its seniority."""
        g = getattr(self, "_elected_generation", None)
        if g is not None:
            self._sync_generation = max(self._sync_generation, g)
            self._elected_generation = None

    def check_host_updates(self):
        """Raise HostsUpdatedInterrupt if the host set changed since the last
        commit (upstream common/elastic.py:60-96)."""
        updated = False
        skip_sync = True
        while not self._host_messages.empty():
            timestamp, update_res = self._host_messages.get()
            if timestamp > self._last_updated_timestamp:
                self._last_updated_timestamp = timestamp
                updated = True
                # update_res True means only additions (no state lost).
                skip_sync = skip_sync and bool(update_res)
        if updated:
            raise HostsUpdatedInterrupt(skip_sync=skip_sync)

    # Subclass interface ---------------------------------------------------
    def save(self):
        raise NotImplementedError

    def restore(self):
        raise NotImplementedError

    def sync(self):
        raise NotImplementedError

    def reset(self):
        pass


class ObjectState(State):
    """Elastic state backed by arbitrary picklable attributes (upstream
    common/elastic.py ObjectState): everything passed as kwargs is
    committed/restored/synced by value."""

    def __init__(self, bcast_object: Optional[Callable] = None, **kwargs):
        if bcast_object is None:
            from ..optimizers import broadcast_object
            bcast_object = broadcast_object
        self._bcast_object = bcast_object
        self._saved_state = dict(kwargs)
        super().__init__(**kwargs)

    def save(self):
        new_state = {}
        for k in self._saved_state:
            new_state[k] = copy.deepcopy(getattr(self, k))
        self._saved_state = new_state

    def restore(self):
        for k, v in self._saved_state.items():
            setattr(self, k, copy.deepcopy(v))

    def sync(self, root: Optional[int] = None):
        _flight.record("elastic.sync", None, root=root)
        if self._saved_state:
            if root is None:
                root = self.elect_sync_root()
            synced = self._bcast_object(self._saved_state, root_rank=root)
            self._saved_state = synced
            self.restore()
        self.adopt_sync_generation()


def _has_zero_sharded(tree) -> bool:
    from ..checkpoint.zero import has_zero_leaves
    return has_zero_leaves(tree)


def _is_data_iterator(x) -> bool:
    """Duck-typed checkpointable-iterator protocol (``data.DataLoader``
    and friends): live objects with threads cannot ride the deepcopy
    snapshot path; their ``state_dict()`` does instead."""
    return (not isinstance(x, (dict, list, tuple, torch.nn.Module))
            and not _is_optimizer(x)
            and callable(getattr(x, "state_dict", None))
            and callable(getattr(x, "load_state_dict", None)))


def _is_optimizer(x) -> bool:
    from ..optimizers import DistributedOptimizer, ZeroShardedOptimizer
    return isinstance(x, (torch.optim.Optimizer, DistributedOptimizer,
                          ZeroShardedOptimizer))


def _to_cpu(obj):
    """A host copy of a (nested) state: tensors cloned to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return copy.deepcopy(obj)


def _tensors_of(tree) -> Dict[str, torch.Tensor]:
    """The tensors of a module or a (nested) dict of tensors, by key."""
    if isinstance(tree, torch.nn.Module):
        return dict(tree.state_dict())
    out = {}
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            out[str(k)] = v
        elif isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in _tensors_of(v).items()})
    return out


def _snapshot(tree):
    """Host snapshot of a non-ZeRO tree: a module's or a dict's tensors,
    or an optimizer's ``state_dict``."""
    if _is_optimizer(tree):
        return _to_cpu(tree.state_dict())
    return {k: _to_cpu(v) for k, v in _tensors_of(tree).items()}


def _load_snapshot(tree, snap) -> None:
    """Put a host snapshot back into the live ``tree``, in place."""
    if _is_optimizer(tree):
        tree.load_state_dict(copy.deepcopy(snap))
        return
    with torch.no_grad():
        for k, t in _tensors_of(tree).items():
            t.copy_(snap[k])


def _restore_extracted(tree, ext):
    """Rebuild ``tree``'s ZeRO state in place from this rank's own
    extracted payload (same world: only its own shard is read)."""
    from ..checkpoint import engine as E
    from ..checkpoint import manifest as M
    from ..checkpoint import zero as Z
    (index,) = ext.rank_values
    own = {spec.key: v for spec, v in zip(ext.specs, ext.rank_values[index])
           if v is not None}
    manifest = M.Manifest(step=0, world_size=ext.world, leaves=ext.specs,
                          extra=Z.fingerprint_extra(ext))
    restored = E.RestoredStep(manifest, [own] * ext.world, ext.world)
    return Z.rebuild_restored(restored, tree,
                              source="the last committed snapshot")


def _broadcast_tree(tree, root: int) -> None:
    """Broadcast a non-ZeRO tree from ``root`` in place: tensors through
    ``broadcast_parameters``, an optimizer's state as one object (a
    respawned member's optimizer may hold no state yet)."""
    from ..optimizers import broadcast_object, broadcast_parameters
    if _is_optimizer(tree):
        sd = broadcast_object(
            _to_cpu(tree.state_dict()) if global_state.rank == root
            else None, root_rank=root)
        tree.load_state_dict(sd)
        return
    tensors = _tensors_of(tree)
    if tensors:
        broadcast_parameters([tensors[k] for k in sorted(tensors)],
                             root_rank=root)


def _reshard_zero(tree) -> None:
    """Re-deal every ZeRO optimizer in ``tree`` over the current world
    (``ZeroShardedOptimizer.reshard``): the restore that follows fills
    shards of the new world's size."""
    from ..checkpoint import zero as Z
    for _, leaf in Z._flatten(tree):
        opt = leaf.optimizer if isinstance(leaf, Z.ShardedParams) else leaf
        if isinstance(opt, Z._zero_type()):
            opt.reshard()


def _broadcast_plain_leaves(tree, root: int) -> None:
    """The tensors living beside the ZeRO states of ``tree``, broadcast
    from ``root``: what a rejoining worker needs when no tier restores
    the tree.  A tensor off the world's device (a step counter on the
    host) travels through it."""
    from ..checkpoint import zero as Z
    from ..ops import collective as C
    dev = global_state.device
    with torch.no_grad():
        for _, leaf in Z._flatten(tree):
            if not isinstance(leaf, torch.Tensor):
                continue
            if leaf.device == dev:
                C.broadcast_(leaf, root)
            else:
                leaf.copy_(C.broadcast_(leaf.to(dev), root))


# Dedicated engine-step directory for iterator state when a TpuState
# carries data iterators but no ZeRO-sharded trees (with ZeRO trees the
# state rides those steps' manifests instead).
_DATA_DIR_KEY = "data_iters"


class _AsyncCommitter:
    """One-deep background disk flush: ``submit`` hands the previous
    step's ``save_extracted`` to a daemon thread and returns; ``wait``
    joins it and re-raises its failure.  The NEXT ``commit()`` waits
    first, so disk durability leaves the hot path but a flush can never
    overlap the next step's writes to the same directory."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None

    def submit(self, fn: Callable[[], Any]) -> None:
        self.wait()

        def _run():
            try:
                # The flush overlaps compute by design: its engine I/O is
                # not the training step's checkpoint component.
                from ..checkpoint.engine import background_io
                with background_io():
                    fn()
            except BaseException as e:  # noqa: BLE001 — surfaced at wait()
                self._exc = e

        self._thread = threading.Thread(
            target=_run, name="hvd-tpu-async-commit", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        exc, self._exc = self._exc, None
        if exc is not None:
            raise exc

    @property
    def pending(self) -> bool:
        return self._thread is not None


class TpuState(ObjectState):
    """Elastic state for torch training (the reference's ``TpuState``;
    the analog of upstream TorchState, torch/elastic/state.py:27-80).

    ``params`` is a module or its ``state_dict``; ``opt_state`` an
    optimizer (``ZeroShardedOptimizer``, ``DistributedOptimizer``, a plain
    ``torch.optim`` optimizer) or a tree of dicts, lists and tuples
    holding them beside tensors (``{"model": model.state_dict(), "opt":
    zero_optimizer}``).  Committed trees are snapshotted to host memory
    and restored in place; replicated ones are broadcast from the elected
    root on ``sync()``.

    ZeRO-sharded state is rank-DISTINCT, so it cannot ride the sync
    broadcast.  Pass ``checkpoint_dir`` and the sharded trees get a
    durable lifecycle through ``checkpoint``: ``commit()`` writes every
    rank's shard plus a rank-0 manifest under
    ``<checkpoint_dir>/<tree_key>/``, and ``sync()`` after a reset
    restores the committed step, *resharding* the flat moment buffers
    when the elastic world resized.  Tensors in the same tree (the
    model's weights, a step counter) ride along as replicated leaves.
    Use a fresh ``checkpoint_dir`` per training run: the engine's run
    fingerprint refuses cross-run saves/restores
    (``HVD_TPU_CKPT_ALLOW_FOREIGN=1`` overrides).

    Checkpointable data iterators (``data.DataLoader``: anything with
    ``state_dict``/``load_state_dict``) passed as kwargs get the
    iterator lifecycle: ``commit()`` snapshots their state (and, with a
    ``checkpoint_dir``, persists it in the engine manifest beside the
    ZeRO shards), ``restore()`` rolls them back, and ``sync()``
    broadcasts the committed position; each loader then reshards its
    remaining epoch to the new world, with no duplicated and no dropped
    samples.

    Peer-to-peer hot recovery (``peer_recovery``, default
    ``HVD_TPU_RECOVERY`` = on): ``commit()`` also places each rank's
    committed shard in the in-memory replica tier (its own copy locally,
    a buddy copy with ``recovery.replica_holder(rank)``), and ``sync()``
    tries to reassemble the state from fleet memory BEFORE reading the
    disk manifest.  It works with no ``checkpoint_dir`` at all
    (disk-free restarts), at the durability of the surviving processes'
    memory.  ``sync()`` records which path won (``peer`` / ``disk`` /
    ``none``) in the metrics, the flight recorder and
    ``recovery.last_report()``.

    Async snapshot commit (``async_commit``, default
    ``HVD_TPU_ASYNC_COMMIT`` = off; world 1 only — a multi-rank save
    barriers on a collective that cannot run on a background thread):
    ``commit()`` extracts the host payload and hands replication and the
    disk write to a background committer; the commit barrier moves to
    the NEXT ``commit()``/``sync()``.

    The reference's ``checkpoint_mesh`` has no counterpart: a ZeRO
    optimizer carries its own axis."""

    def __init__(self, params=None, opt_state=None, checkpoint_dir=None,
                 checkpoint_keep: int = 3,
                 peer_recovery: Optional[bool] = None,
                 async_commit: Optional[bool] = None, **kwargs):
        from ..core import config as _cfg
        self._peer_explicit = peer_recovery is not None
        self._peer_recovery = (_cfg.recovery() if peer_recovery is None
                               else bool(peer_recovery))
        self._async_commit = (_cfg.async_commit() if async_commit is None
                              else bool(async_commit))
        self._committer = _AsyncCommitter()
        # (key, step) pairs whose async flush died before the replica
        # seal: pruned from _ckpt_committed_step at the next barrier.
        self._ckpt_failed = set()
        self._tree_keys = []
        self._data_keys = [k for k, v in kwargs.items()
                           if _is_data_iterator(v)]
        data_objs = {k: kwargs.pop(k) for k in self._data_keys}
        self._saved_data = {k: v.state_dict() for k, v in data_objs.items()}
        self._checkpoint_dir = checkpoint_dir
        self._checkpoint_keep = checkpoint_keep
        self._ckpt_next_step = {}
        # Step of the last FULLY committed checkpoint per tree key: engine
        # manifest on disk AND the in-memory snapshot both done.  sync()
        # restores this step, not blindly the newest on disk: a crash
        # after the engine commit but before the snapshot leaves a disk
        # step one ahead of the rolled-back params.
        self._ckpt_committed_step = {}
        # Host snapshots of the committed trees: a ZeRO tree's extracted
        # payload, else its tensors / optimizer state_dict on the CPU.
        self._host = {}
        self._copies = {}
        trees = {}
        if params is not None:
            self._tree_keys.append("params")
            trees["params"] = params
        if opt_state is not None:
            self._tree_keys.append("opt_state")
            trees["opt_state"] = opt_state
        super().__init__(**kwargs)
        for k, v in {**trees, **data_objs}.items():
            setattr(self, k, v)
        # Closed-loop tuning memory (autotune.announce_model): the
        # state's trees ARE the model identity — announce their leaf-spec
        # fingerprint so an autotuned job warm-starts from (and freezes
        # back into) the tuned-config store.  Best-effort, and a no-op on
        # every process without an active tuner (everyone but rank 0 of
        # an --autotune job).
        try:
            from .. import autotune as _autotune
            if _autotune.active_manager() is not None:
                trees = {k: getattr(self, k) for k in self._tree_keys}
                if trees:
                    _autotune.announce_model(trees)
        except Exception:  # noqa: BLE001 — memory never blocks training
            pass

    def _zero_dir(self, key: str):
        import os
        return os.path.join(self._checkpoint_dir, key)

    def _next_ckpt_step(self, key: str) -> int:
        # Monotonic across full job relaunches: seeded from the newest
        # committed step on disk (not the sync generation, which resets to
        # 0 on relaunch).  Ranks agree without a collective: seeding
        # happens at sync(), when every member reads the same committed
        # disk state, and between syncs the counters advance in lockstep.
        if key not in self._ckpt_next_step:
            latest = None
            if self._checkpoint_dir is not None:
                from ..checkpoint import latest_step
                latest = latest_step(self._zero_dir(key))
            self._ckpt_next_step[key] = 0 if latest is None else latest + 1
        return self._ckpt_next_step[key]

    def _async_effective(self) -> bool:
        # A multi-rank save_extracted barriers on a collective; running it
        # on a background thread would interleave with training
        # collectives.  Degrade to the synchronous write.
        return self._async_commit and not _multi()

    def _prune_failed_steps(self):
        """Drop committed-step records whose async flush failed before
        any tier held the step."""
        while self._ckpt_failed:
            k, s = self._ckpt_failed.pop()
            if self._ckpt_committed_step.get(k) == s:
                self._ckpt_committed_step.pop(k)

    def _seal_replicas(self, saved_steps: Dict[str, int], exts: dict):
        if not self._peer_recovery:
            return
        from .. import recovery
        for k, step in saved_steps.items():
            if k in exts:
                recovery.seal_commit(k, step, ext=exts[k])

    def commit(self):
        _failure.check()
        saved_steps = {}
        exts = {}
        # Iterator state is captured ONCE here and stamped into every
        # manifest this commit writes: the committed step pairs the
        # optimizer moments with the input position.
        data_states = {k: getattr(self, k).state_dict()
                       for k in self._data_keys}
        extra = None
        if data_states:
            from ..checkpoint import DATA_ITERS_KEY
            extra = {DATA_ITERS_KEY: data_states}
        zero_keys = [k for k in self._tree_keys
                     if _has_zero_sharded(getattr(self, k))]
        if zero_keys:
            # Async commit barrier: the previous step's background flush
            # must land (and surface its failure) before this step writes
            # the same directories.
            try:
                self._committer.wait()
            finally:
                self._prune_failed_steps()
        # Every tree's copy to the host first, then the world's check: the
        # copies wait behind the step's collectives (the beacon holds them
        # to the deadline), and an aborted one left garbage in them
        # (core/failure.py).
        _failure.beacon()
        copies = self._host_copies()
        _failure.verify()
        if zero_keys:
            from ..checkpoint import save_extracted
            from ..recovery.chaos import chaos
            use_async = self._async_effective()
            for k in zero_keys:
                ext = copies[k]
                if self._checkpoint_dir is None and not self._peer_recovery:
                    continue
                step = self._next_ckpt_step(k)
                root = (None if self._checkpoint_dir is None
                        else self._zero_dir(k))
                keep = self._checkpoint_keep

                def _flush(k=k, ext=ext, step=step, root=root,
                           sealing=use_async):
                    """Replication + disk write + (async mode) seal: the
                    durability tail of one commit, inline or on the
                    committer thread.  An async failure BEFORE the seal
                    marks the step failed so the committed-step record
                    cannot pin a step that exists in no tier."""
                    try:
                        if self._peer_recovery:
                            from .. import recovery
                            recovery.replicate(k, step, ext, extra=extra)
                        # Chaos drill: the replica is placed (unsealed)
                        # but the step is not yet committed anywhere.
                        chaos().maybe_crash("after_replicate", step)
                        if root is None and self._peer_recovery and \
                                _multi():
                            # Disk-free: the disk path's pre-commit
                            # barrier is what keeps one rank from sealing
                            # step N+1 while a slower one has not yet
                            # replicated it.
                            from ..ops import collective as C
                            C.barrier()
                        if sealing and self._peer_recovery:
                            # Async mode seals BEFORE the disk write: the
                            # replica tier's record must not depend on
                            # the disk flush succeeding.
                            from .. import recovery
                            recovery.seal_commit(k, step, ext=ext)
                    except BaseException:
                        if sealing:
                            self._ckpt_failed.add((k, step))
                        raise
                    if root is not None:
                        save_extracted(root, ext, step, keep=keep,
                                       extra=extra)

                if use_async:
                    self._committer.submit(_flush)
                else:
                    _flush()
                    exts[k] = ext  # sealed after the snapshot
                self._ckpt_next_step[k] = step + 1
                saved_steps[k] = step
        if self._checkpoint_dir is not None and data_states \
                and not saved_steps:
            # No ZeRO tree to ride: iterator state gets its own (tiny)
            # engine step, same durability protocol.
            step = self._next_ckpt_step(_DATA_DIR_KEY)
            self._commit_data_step(step, data_states)
            self._ckpt_next_step[_DATA_DIR_KEY] = step + 1
            saved_steps[_DATA_DIR_KEY] = step
        self._copies = copies   # save() takes them
        try:
            super().commit()
        except HostsUpdatedInterrupt:
            # The base commit raises AFTER save() snapshotted: the step IS
            # fully committed; the interrupt only re-runs rendezvous.
            self._ckpt_committed_step.update(saved_steps)
            self._seal_replicas(saved_steps, exts)
            raise
        finally:
            self._copies = {}
        self._ckpt_committed_step.update(saved_steps)
        self._seal_replicas(saved_steps, exts)

    def _read_data_iters_from_disk(self, chosen: dict):
        """The committed iterator-state payload: from the chosen (or
        newest committed) step of a ZeRO tree's manifest when one
        exists, else from the dedicated iterator-state directory."""
        if self._checkpoint_dir is None:
            return None
        from ..checkpoint import is_committed, restore_data_state
        keys = [k for k in self._tree_keys
                if _has_zero_sharded(getattr(self, k))]
        keys.append(_DATA_DIR_KEY)
        for k in keys:
            d = self._zero_dir(k)
            step = chosen.get(k)
            if step is not None and not is_committed(d, step):
                step = None
            try:
                state = restore_data_state(d, step=step)
            except (OSError, ValueError, KeyError):
                continue
            if state:
                return state
        return None

    def _commit_data_step(self, step: int, data_states: dict) -> None:
        """Rank 0 writes the dedicated iterator-state step; a barrier
        makes it durable before anyone moves on."""
        from ..checkpoint import save_data_state
        if not _multi() or global_state.rank == 0:
            save_data_state(self._zero_dir(_DATA_DIR_KEY), data_states,
                            step=step, keep=self._checkpoint_keep)
        if _multi():
            from ..ops import collective as C
            C.barrier()

    def _host_copies(self) -> dict:
        """Every tree on the host: a ZeRO tree's extracted payload, else
        its tensors / optimizer state_dict on the CPU."""
        from ..checkpoint import extract_zero_state
        return {k: extract_zero_state(tree) if _has_zero_sharded(tree)
                else _snapshot(tree)
                for k, tree in ((k, getattr(self, k))
                                for k in self._tree_keys)}

    def save(self):
        # Device -> host snapshot, so that a reset cannot lose it: the
        # copies commit() took and checked, or fresh ones outside it.
        copies, self._copies = self._copies or self._host_copies(), {}
        self._host.update(copies)
        for k in self._data_keys:
            self._saved_data[k] = getattr(self, k).state_dict()
        super().save()

    def restore(self):
        super().restore()
        for k in self._tree_keys:
            host = self._host.get(k)
            if host is None:
                continue
            tree = getattr(self, k)
            if _has_zero_sharded(tree):
                setattr(self, k, _restore_extracted(tree, host))
            else:
                _load_snapshot(tree, host)
        for k in self._data_keys:
            getattr(self, k).load_state_dict(
                copy.deepcopy(self._saved_data[k]))

    def _record_recovery_path(self, path: str, key: str,
                              step: Optional[int], reason: str):
        """Fold a non-peer restore decision into the surface peer
        restores use (metrics + flight + last_report)."""
        import time
        from .. import recovery
        from ..metrics.registry import registry
        registry().counter("hvd_recovery_restores_total",
                           "Recovery restore decisions by path",
                           path=path).inc()
        recovery.record_report(recovery.RecoveryReport(
            path=path, key=key, step=step, reason=reason,
            wall=time.time()))
        _flight.record("recovery.restore.done", key, path=path,
                       step=step)

    def _sync_zero(self, k: str, tree, chosen: dict, root: int):
        """Restore one ZeRO tree after a reset: the peer tier, else the
        disk manifest, else the replicated leaves from the root.
        Returns the rebuilt tree and the peer restore's manifest extra."""
        if self._peer_recovery:
            from .. import recovery
            try:
                new_tree, pextra, _rep = recovery.peer_restore(
                    k, tree, step=chosen.get(k))
                return new_tree, pextra
            except recovery.PeerRestoreUnavailable as e:
                log.info("recovery: peer restore unavailable for %s (%s); "
                         "falling back to the disk manifest", k, e)
        if self._checkpoint_dir is not None:
            from ..checkpoint import (is_committed, latest_step,
                                      restore_zero_state)
            step = chosen.get(k)
            if step is not None and not is_committed(self._zero_dir(k),
                                                     step):
                step = None   # recorded step GC'd or torn: fall back
            if step is None:
                step = latest_step(self._zero_dir(k))
            if step is not None:
                tree = restore_zero_state(self._zero_dir(k), tree,
                                          step=step)
                if self._peer_recovery:
                    self._record_recovery_path(
                        "disk", k, step, "peer coverage unavailable; disk "
                        "manifest restored")
                return tree, None
            if self._peer_recovery:
                self._record_recovery_path(
                    "none", k, None, "no peer coverage and no committed "
                    "disk step (pre-first-commit or lost state)")
        else:
            if self._peer_recovery:
                self._record_recovery_path(
                    "none", k, None, "no peer coverage and no "
                    "checkpoint_dir (disk-free mode, pre-first-commit or "
                    "fleet memory lost)")
            log.warning(
                "TpuState.%s holds ZeRO-sharded state and neither the "
                "peer tier nor a checkpoint_dir can restore it; a world "
                "resize will NOT restore these moments", k)
        # No committed step: the ZeRO state stays local (identical init
        # before the first commit), but the tensors beside it must still
        # reach rejoining workers.
        if _multi():
            _broadcast_plain_leaves(tree, root)
        return tree, None

    def sync(self, root: Optional[int] = None):
        _flight.record("elastic.sync", None, root=root)
        if root is None:
            root = self.elect_sync_root()
        # A pending async flush must land before this sync trusts disk
        # state.  Its failure degrades rather than killing the round.
        try:
            self._committer.wait()
        except Exception as e:  # noqa: BLE001 — surfaced, not fatal here
            log.warning(
                "async checkpoint flush failed (%r); the disk tier may lag "
                "the replica tier this round, and if the failure preceded "
                "the replica seal this sync restores the previous "
                "committed step", e)
        finally:
            self._prune_failed_steps()
        # Membership changed: every member re-seeds its commit-step
        # counters from the same committed disk state.
        self._ckpt_next_step.clear()
        # Agree on WHICH step to restore: the root survivor's record of
        # the last fully committed step (disk + snapshot).
        chosen = dict(self._ckpt_committed_step)
        if _multi():
            from ..optimizers import broadcast_object
            chosen = broadcast_object(chosen, root_rank=root)
            self._ckpt_committed_step = dict(chosen)
        if self._checkpoint_dir is None:
            # Disk-free mode: seed the cleared counters from the agreed
            # record, so that every member keeps committing at the same,
            # still-monotonic steps.
            for k, s in chosen.items():
                self._ckpt_next_step[k] = int(s) + 1
        peer_extra = None
        for k in self._tree_keys:
            tree = getattr(self, k)
            if _has_zero_sharded(tree):
                _reshard_zero(tree)
                tree, pextra = self._sync_zero(k, tree, chosen, root)
                setattr(self, k, tree)
                if peer_extra is None and pextra:
                    peer_extra = pextra
            elif _multi():
                _broadcast_tree(tree, root)
        # Data iterators: seed the committed position from the peer
        # restore's or the disk's manifest, then let the root's view win;
        # loading re-seats each loader in the current topology.
        if self._data_keys:
            from ..checkpoint import DATA_ITERS_KEY
            disk = (peer_extra or {}).get(DATA_ITERS_KEY) or \
                self._read_data_iters_from_disk(chosen)
            for k, v in (disk or {}).items():
                if k in self._data_keys:
                    self._saved_data[k] = v
            if _multi():
                from ..optimizers import broadcast_object
                self._saved_data = broadcast_object(self._saved_data,
                                                    root_rank=root)
            for k in self._data_keys:
                getattr(self, k).load_state_dict(
                    copy.deepcopy(self._saved_data[k]))
        # The plain-object part.
        if self._saved_state and _multi():
            from ..optimizers import broadcast_object
            synced = broadcast_object(
                {k: getattr(self, k) for k in self._saved_state},
                root_rank=root)
            for k, v in synced.items():
                setattr(self, k, v)
        # Persist the synced state into the restorable snapshots BEFORE
        # claiming the root's seniority.
        self.save()
        self.adopt_sync_generation()


def _reset():
    """The world reset: tear down and re-init the runtime, so that a new
    rendezvous round can change the world (upstream
    tensorflow/elastic.py:64-66 does shutdown()+init())."""
    from ..core import basics
    _flight.record("elastic.reset", None)
    device = global_state.device
    basics.shutdown()
    basics.init(device=device)
    # Re-zero the metrics aggregator's step counter: its sync cadence is
    # a collective schedule keyed on the LOCAL step count, and a new
    # round mixes survivors (counter mid-flight) with fresh spawns
    # (counter 0).
    from ..metrics.aggregate import aggregator
    aggregator().reset()


def run(func: Callable) -> Callable:
    """Decorator running ``func(state, ...)`` under the elastic retry loop
    (upstream common/elastic.py:151-175).

    As in the reference, ``sync()`` runs after EVERY reset, regardless of
    the interrupt's ``skip_sync`` hint: sync is a collective, and workers
    can reach the same round through different paths (commit-time
    interrupt, collective failure, fresh spawn), each with a different
    hint; honoring it would deadlock the round."""

    @functools.wraps(func)
    def wrapper(state: State, *args, **kwargs):
        notification_manager.init()
        notification_manager.register_listener(state)
        import time as _time
        from ..metrics.registry import registry as _mreg
        sync_gauge = _mreg().gauge(
            "hvd_elastic_sync_seconds",
            "Duration of the last elastic state sync")
        try:
            while True:
                t0 = _time.perf_counter()
                state.sync()
                _elastic_counter("hvd_elastic_syncs_total",
                                 "Elastic state syncs").inc()
                sync_gauge.set(_time.perf_counter() - t0)
                # The sync's restore and broadcasts happened BETWEEN
                # steps: re-anchor the attribution marks after it, so
                # those seconds are never charged to the first step of
                # the new round.
                from ..metrics.attribution import (
                    attribution as _attr_engine, enabled as _attr_enabled)
                if _attr_enabled():
                    _attr_engine().reanchor()
                try:
                    return func(state, *args, **kwargs)
                except HorovodInternalError as e:
                    log.warning("collective failure (%s); restoring last "
                                "committed state and re-initializing", e)
                    _flight.record("elastic.restore", None, cause="failure")
                    _elastic_counter(
                        "hvd_elastic_resets_total",
                        "Elastic retry-loop resets by cause",
                        cause="failure").inc()
                    state.restore()
                except HostsUpdatedInterrupt:
                    log.info("host set updated; re-initializing")
                    _elastic_counter(
                        "hvd_elastic_resets_total",
                        "Elastic retry-loop resets by cause",
                        cause="hosts_updated").inc()
                _reset()
                state.on_reset()
        finally:
            notification_manager.remove_listener(state)

    return wrapper


class WorkerNotificationManager:
    """Surfaces host-update events from the elastic driver to registered
    State objects (upstream runner/elastic/worker.py's notification
    service).  Pull-based: ``poll()``, called from ``State.commit()``,
    checks the rendezvous KV's host-event key; the upstream push RPC also
    only takes effect at commit."""

    def __init__(self):
        self._listeners = []
        self._enabled = False
        self._last_ts = 0.0

    def init(self):
        import os
        self._enabled = bool(os.environ.get("HVD_TPU_RENDEZVOUS_ADDR")
                             and os.environ.get("HVD_TPU_ELASTIC_SLOT"))

    def register_listener(self, state: State):
        self._listeners.append(state)

    def remove_listener(self, state: State):
        if state in self._listeners:
            self._listeners.remove(state)

    def announce_commit(self, generation: int):
        """Publish this job's commit generation to the launcher's
        rendezvous KV (``elastic/commit``), the evidence
        ``ElasticDriver.last_commit()`` gives a scheduler for
        checkpoint-mediated preemption.  Fleet-managed jobs only
        (``HVD_TPU_FLEET_JOB_ID``), rank 0 only; a publish failure is
        absorbed: telemetry never kills training."""
        if not self._enabled:
            return
        import json
        import os
        import time
        if not os.environ.get("HVD_TPU_FLEET_JOB_ID"):
            return
        if global_state.initialized and global_state.rank != 0:
            return
        addr = os.environ.get("HVD_TPU_RENDEZVOUS_ADDR")
        if not addr:
            return
        from ..runner.rendezvous import http_put
        try:
            http_put(addr, "elastic", "commit", json.dumps({
                "ts": time.time(), "generation": int(generation),
                "slot": os.environ.get("HVD_TPU_ELASTIC_SLOT", ""),
            }).encode(), timeout=5)
        except Exception:  # noqa: BLE001 — an announcement, not a barrier
            pass

    def poll(self):
        if not self._enabled:
            return
        from ..runner.worker import poll_host_event
        event = poll_host_event(self._last_ts)
        if event is not None:
            self._last_ts = event["ts"]
            # Stale events (for a round this worker already joined via the
            # failure path) must not trigger another interrupt: it would
            # block waiting for a round the driver never publishes.
            if event.get("round", 1 << 30) <= global_state.elastic_round:
                return
            self.handle_hosts_updated(event["ts"],
                                      bool(event.get("added_only")))

    def handle_hosts_updated(self, timestamp, update_res):
        for listener in self._listeners:
            listener.on_hosts_updated(timestamp, update_res)


notification_manager = WorkerNotificationManager()
