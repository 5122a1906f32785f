"""Peer-failure detection on the device plane (the port's own design).

In the reference an elastic worker learns of a dead peer from the native
controller's TCP mesh, which raises ``HorovodInternalError`` in the op
that waits on it; every collective of an elastic reference job goes
through that controller.  The port's flagship steps do not: the ZeRO
step's reduce-scatters and all-gathers are raw ``torch.distributed``
collectives, and an NCCL collective whose peer died waits on the card
until NCCL's watchdog fires, which by default tears the process down and
takes its replica store with it.  So an elastic worker's world has
guards of its own:

* the operation deadline is ``HVD_TPU_NET_OP_DEADLINE_S`` (the
  reference's per-operation deadline of the native ladder, 60 s).  A
  gloo world takes it as its timeout, at which a gloo collective raises.
  NCCL's own watchdog does not free a survivor: on four H100s under
  torch 2.11, with the deadline as the timeout and clean-up-only error
  handling (``TORCH_NCCL_ASYNC_ERROR_HANDLING=2``), it reported one
  timed-out collective a minute while the survivors stayed blocked, also
  after the world watch's abort (PERF.md).  So an NCCL world's timeout
  is twice the deadline, and the port holds the deadline itself: after
  each guarded collective on the card, and before a commit's copies, it
  records an event on the card's stream (a beacon), and the world watch
  fails the world when a beacon is still pending past the deadline (a
  peer that hangs alive holds the collective, and no round is
  published);
* the world watch, a thread of the worker, checks the beacons and polls
  the rendezvous KV's ``elastic/current_round`` every 0.1 s.  When the
  driver publishes a round past this worker's after a failure or a
  shrink (a round whose host event is not a pure growth), the watch
  marks the world failed and aborts its NCCL communicators: a survivor
  blocked on the dead
  peer's collective returns within a poll of the driver's exit
  detection, far inside the deadline;
* a member that marks its world failed publishes the verdict on the KV
  (``elastic/world_failed_<round>``), and every watch polls that key
  beside the round: a member whose own beacons and collectives give no
  sign (four H100s: rank 0 of a hang drill still waited for the next
  round, 15 s after its peers' deadline; PERF.md) fails with the first;
* marking the world failed also interrupts the native controller's
  waits, so that a negotiated op on a dead peer ends at the watch's
  verdict rather than after the net ladder's reconnect budget, and its
  shutdown then skips the ranks' consensus, which a peer hung alive
  would hold for 30 s;
* :func:`guard` wraps the port's collectives (``ops/collective.py``'s
  ops and handles, the ZeRO buckets of ``ops/overlap.py``): a backend
  error (gloo's "connection closed by peer", an aborted NCCL
  communicator, a timeout) marks the world failed and raises
  ``HorovodInternalError``, and once the world is marked every later
  collective and ``State.commit()`` raise it before touching the wire.
  A collective on a broken gloo pair can wait forever, and an aborted
  NCCL collective leaves garbage in its outputs: neither is ever issued
  or committed after the mark;
* :func:`verify`, after ``TpuState.commit()`` has copied the step's
  state to the host and before it replicates or writes any of it, runs
  one small allreduce on each group of the world with the deadline as
  its wait: a communicator that was aborted refuses it, a hung peer
  times it out, and either marks the world failed.  So no aborted
  collective's output is ever committed, whether or not a round was
  published.

All of this holds only in an elastic world (:func:`watching`): in any
other job a backend error comes out of :func:`guard` unchanged, and
nothing is marked or aborted.  A failed world's communicators are
aborted once, when it is marked; ``shutdown()`` then destroys them.
"""

from __future__ import annotations

import contextlib
import functools
import collections
import json
import os
import threading
import time
from typing import Optional

from .exceptions import HorovodInternalError

# The watch's poll of the KV: the elastic worker's poll interval
# (runner/worker.fetch_assignment).
WATCH_INTERVAL_S = 0.1

_lock = threading.Lock()
_failed: Optional[str] = None
_watch: Optional["_Watch"] = None
# (time recorded, event) of the beacons on the card's stream, oldest first.
_beacons: collections.deque = collections.deque()


def failed() -> Optional[str]:
    """Why this process's world is broken, or None."""
    return _failed


def world_options(backend: str) -> dict:
    """``init_process_group`` options of an elastic world.  On gloo the
    operation deadline is its timeout: a gloo collective raises at it.
    On NCCL twice the deadline, so that NCCL's watchdog never races the
    beacons' abort at the deadline; and NCCL's clean-up-only error
    handling for the groups made after it (unless the environment chose
    a mode), so that its watchdog does not end the process."""
    import datetime
    from . import config
    deadline = config.net_op_deadline_s()
    if backend == "nccl":
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "2")
        deadline *= 2
    return {"timeout": datetime.timedelta(seconds=deadline)}


def _groups():
    from .state import global_state
    import torch.distributed as dist
    groups = [global_state.controller_group, global_state.local_group,
              global_state.cross_group]
    if dist.is_initialized():
        groups.append(dist.group.WORLD)
    return [g for g in groups if g is not None]


def abort_groups() -> None:
    """Abort every NCCL communicator of this process's world, so that a
    collective blocked on a dead or hung peer returns.  Gloo groups need
    none: a dead peer's closed socket fails their collectives, a hung
    one's times out.

    The communicators are aborted together, each on a thread of its own:
    an abort frees its communicator's buffers, which waits for the card,
    where the collective of a communicator not yet aborted still spins on
    the hung peer.  One after the other, the first abort held the next
    for as long as NCCL's own watchdog took to abort the spinning one
    (four H100s, torch 2.11: 80 s past the deadline; PERF.md)."""
    import torch
    aborts = []
    for group in _groups():
        try:
            backend = group._get_backend(torch.device("cuda"))
        except (RuntimeError, ValueError, AttributeError):
            continue   # no NCCL backend in this group
        abort = getattr(backend, "abort", None) or \
            getattr(backend, "_abort", None)
        if abort is not None:
            aborts.append(abort)
    threads = [threading.Thread(target=abort, name="hvd-tpu-abort",
                                daemon=True) for abort in aborts]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def mark_failed(reason: str, publish: bool = True) -> None:
    """Record the world as broken (once), tell its other members
    (``publish``) and abort its communicators."""
    global _failed
    with _lock:
        if _failed is not None:
            return
        _failed = reason
    from ..debug import flight
    from ..utils import logging as log
    flight.record("elastic.world_failed", None, reason=reason)
    log.warning("elastic: world failed (%s); aborting its collectives",
                reason)
    watch = _watch
    if publish and watch is not None:
        watch.publish(reason)
    from .state import global_state
    ctl = global_state.controller
    if ctl is not None:
        ctl.interrupt_waits(f"the elastic world failed: {reason}")
    abort_groups()


def check() -> None:
    """Raise ``HorovodInternalError`` once the world is marked failed."""
    if _failed is not None:
        raise HorovodInternalError(f"the elastic world failed: {_failed}")


def _backend_failure(e: BaseException) -> bool:
    import torch.distributed as dist
    if isinstance(e, getattr(dist, "DistError", ())):
        return True
    text = str(e)
    return isinstance(e, RuntimeError) and any(s in text for s in (
        "Connection closed by peer", "Connection reset by peer",
        "Broken pipe", "communicator was aborted", "NCCL error",
        "Timed out", "timed out"))


def beacon() -> None:
    """Record an event on the card's stream of an elastic world, which
    the world watch expects reached within the operation deadline: the
    stream has waited by now on every collective issued before."""
    from .state import global_state
    dev = global_state.device
    if _watch is None or dev is None or dev.type != "cuda":
        return
    import torch
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(dev))
    _beacons.append((time.monotonic(), event))


def overdue(deadline_s: float) -> bool:
    """Whether the oldest pending beacon is older than ``deadline_s``
    (those reached are dropped)."""
    while _beacons and _beacons[0][1].query():
        _beacons.popleft()
    return bool(_beacons) and \
        time.monotonic() - _beacons[0][0] > deadline_s


@contextlib.contextmanager
def guard():
    """Raise ``HorovodInternalError`` for a failed elastic world around
    one collective: before it, and for a backend error out of it.
    Outside an elastic world, errors pass through unchanged."""
    check()
    try:
        yield
        beacon()
    except HorovodInternalError:
        raise
    except Exception as e:
        if not watching() or (_failed is None and not _backend_failure(e)):
            raise
        mark_failed(f"{type(e).__name__}: {str(e)[:200]}")
        raise HorovodInternalError(
            f"a collective failed on a broken world: {e}") from e


def _world_groups():
    """The groups the training step's collectives run on (the world and
    its two-level groups), without the executor's, whose negotiated ops
    a background thread may be running."""
    from .state import global_state
    import torch.distributed as dist
    return [g for g in (dist.group.WORLD, global_state.local_group,
                        global_state.cross_group) if g is not None]


def verify() -> None:
    """Raise ``HorovodInternalError`` unless the elastic world is whole:
    every rank of it reached this call, and no collective of it was
    aborted.  One allreduce of a 1 on each group, waited for at most the
    operation deadline, must give the group's size.  Every rank of the
    world calls it at the same point (``TpuState.commit()``)."""
    check()
    if not watching():
        return
    import datetime
    import torch
    import torch.distributed as dist
    from . import config
    from .state import global_state
    if not dist.is_initialized():
        return
    wait = datetime.timedelta(seconds=config.net_op_deadline_s())
    for group in _world_groups():
        dev = global_state.device if dist.get_backend(group) == "nccl" \
            else torch.device("cpu")
        n = dist.get_world_size(group)
        try:
            one = torch.ones((), dtype=torch.int32, device=dev)
            dist.all_reduce(one, group=group, async_op=True).wait(wait)
            got = int(one)
        except Exception as e:
            mark_failed(f"the commit's check of the world failed: "
                        f"{type(e).__name__}: {str(e)[:200]}")
            raise HorovodInternalError(
                f"the elastic world failed before the commit: {e}") from e
        if got != n:
            mark_failed(f"the commit's check of the world summed {got} "
                        f"over {n} ranks")
        check()


def guarded(fn):
    """:func:`guard` around every call of ``fn``."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with guard():
            return fn(*args, **kwargs)
    return wrapper


def _failed_key(round_: int) -> str:
    return f"world_failed_{int(round_)}"


class _Watch(threading.Thread):
    """Polls ``elastic/current_round`` and ``elastic/world_failed_<round>``;
    marks the world failed when a round past ``round`` is published for
    anything but a growth, or when another member failed it."""

    def __init__(self, rdv_addr: str, round_: int):
        super().__init__(name="hvd-tpu-elastic-watch", daemon=True)
        self.rdv_addr = rdv_addr
        self.round = int(round_)
        self.stopped = threading.Event()

    def publish(self, reason: str) -> None:
        """The verdict on the KV, for the other members' watches."""
        from ..runner.rendezvous import http_put
        try:
            http_put(self.rdv_addr, "elastic", _failed_key(self.round),
                     reason.encode(), timeout=2)
        except PermissionError:
            pass   # a KV of another secret: each member finds its own

    def _growth(self, rnd: int) -> bool:
        from ..runner.rendezvous import http_get
        blob = http_get(self.rdv_addr, "elastic", "host_event", timeout=2)
        if blob is None:
            return False
        event = json.loads(blob.decode())
        return bool(event.get("added_only")) and \
            int(event.get("round", -1)) == rnd

    def run(self) -> None:
        from .. import net
        from . import config
        from ..runner.rendezvous import http_get
        single = net.Policy(attempts=1, seed=0)
        deadline = config.net_op_deadline_s()
        grown = self.round
        while not self.stopped.wait(WATCH_INTERVAL_S):
            if overdue(deadline):
                mark_failed(f"the card has not reached a collective within "
                            f"the operation deadline ({deadline:g} s)")
                return
            told = http_get(self.rdv_addr, "elastic",
                            _failed_key(self.round), timeout=2,
                            policy=single)
            if told is not None:
                mark_failed(f"a member of round {self.round} failed the "
                            f"world: {told.decode()}", publish=False)
                return
            blob = http_get(self.rdv_addr, "elastic", "current_round",
                            timeout=2, policy=single)
            if blob is None:
                continue
            rnd = int(blob.decode())
            if rnd <= grown:
                continue
            if self._growth(rnd):
                # Only hosts were added: every peer of this round lives,
                # and the interrupt comes at the next commit.
                grown = rnd
                continue
            if not self.stopped.is_set():
                mark_failed(f"round {rnd} was published while this worker "
                            f"trains in round {self.round}")
            return


def start_watch(round_: int) -> None:
    """Start the world watch of an elastic worker's new world (and clear
    the mark of its previous one)."""
    global _failed, _watch
    stop_watch()
    _failed = None
    addr = os.environ.get("HVD_TPU_RENDEZVOUS_ADDR")
    if addr:
        _watch = _Watch(addr, round_)
        _watch.start()


def watching() -> bool:
    """Whether this process runs the world watch of an elastic world."""
    return _watch is not None


def stop_watch() -> None:
    global _watch
    w, _watch = _watch, None
    _beacons.clear()
    if w is not None:
        w.stopped.set()
        if w is not threading.current_thread():
            w.join(timeout=5)


def reset() -> None:
    """Forget the mark (a new world)."""
    global _failed
    _failed = None
