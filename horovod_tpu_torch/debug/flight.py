"""Per-rank flight recorder: a fixed-size ring buffer of structured events
(port of horovod_tpu/debug/flight.py).

The post-mortem half of observability: ``metrics`` answers "how fast is
the fleet right now", this module "what was rank 3 doing when it stopped
submitting".  Every subsystem that can block a step appends one small
event here (collective enqueue/done, data waits and stalls, checkpoint
commits, serving admissions), so a SIGUSR1 dump can reconstruct each
rank's last seconds without any of the instrumentation sitting on a
per-element path.

Design constraints:

* **Lock-light.**  The buffer is a ``collections.deque(maxlen=N)``:
  ``append`` is atomic under the GIL, so writers never contend on a lock
  and never allocate beyond the event tuple itself.  The sequence counter
  rides ``itertools.count`` (same atomicity).  ``snapshot()`` copies the
  deque in one C-level call.
* **Two clocks per event.**  ``t_mono`` (monotonic: durations survive
  wall-clock steps) and ``t_wall`` (wall: cross-rank alignment).  The
  coordinator clock-offset estimate (:func:`estimate_clock_offset`) rides
  the rendezvous HTTP channel (the KV server's ``debug/time`` key).

Knobs (``HVD_TPU_FLIGHT_*`` / ``HOROVOD_FLIGHT_*``): ``FLIGHT_DISABLE``,
``FLIGHT_CAPACITY`` (default 4096 events), ``FLIGHT_DIR`` (dump
directory, default cwd), ``FLIGHT_LAST_EVENTS`` (events per rank quoted
in hang reports, default 20).
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional

from ..core import config as _config

DUMP_VERSION = 1


class FlightRecorder:
    """Fixed-capacity ring buffer of ``(seq, t_mono, t_wall, kind, name,
    fields)`` tuples.  One instance per process (see :func:`recorder`);
    separate instances exist only in tests."""

    def __init__(self, capacity: Optional[int] = None,
                 enabled: Optional[bool] = None):
        # Defaults come from config.TELEMETRY (the one documented knob
        # table), not a second literal here that could drift.
        if capacity is None:
            capacity = _config.get_int_or(_config.FLIGHT_CAPACITY,
                                          _config.TELEMETRY.flight_capacity)
        if enabled is None:
            enabled = not _config.flight_disable()
        self.capacity = max(int(capacity), 1)
        self.enabled = bool(enabled)
        self._events: "collections.deque" = collections.deque(
            maxlen=self.capacity)
        self._seq = itertools.count()
        # Identity + clock metadata stamped into dumps; set_* keep this
        # current as init()/the native controller learn the topology.
        self.rank: Optional[int] = None
        self.world: Optional[int] = None
        self.clock: Dict[str, Any] = {}
        self.meta: Dict[str, Any] = {}

    # -- write path (hot-ish: every instrumented op calls this) -----------
    def record(self, kind: str, name: Optional[str] = None,
               **fields) -> None:
        if not self.enabled:
            return
        self._events.append((next(self._seq), time.monotonic(),
                             time.time(), kind, name, fields or None))

    # -- read path ---------------------------------------------------------
    def snapshot(self, last: Optional[int] = None) -> List[dict]:
        """Events as dicts, oldest first.  ``last`` keeps only the most
        recent N."""
        events = list(self._events)  # one C-level copy; GIL-atomic
        if last is not None:
            events = events[-last:]
        out = []
        for seq, t_mono, t_wall, kind, name, fields in events:
            ev = {"seq": seq, "t_mono": t_mono, "t_wall": t_wall,
                  "kind": kind, "name": name}
            if fields:
                ev.update(fields)
            out.append(ev)
        return out

    def clear(self) -> None:
        self._events.clear()

    def __len__(self) -> int:
        return len(self._events)

    # -- identity / clock --------------------------------------------------
    def set_identity(self, rank: Optional[int] = None,
                     world: Optional[int] = None) -> None:
        if rank is not None:
            self.rank = int(rank)
        if world is not None:
            self.world = int(world)

    def set_clock(self, offset_s: float, rtt_s: float = 0.0,
                  method: str = "rendezvous") -> None:
        """Record this process's wall-clock offset relative to the
        coordinator reference: ``offset = local_wall - reference_wall``,
        so an event's aligned timestamp is ``t_wall - offset``."""
        self.clock = {"offset_s": float(offset_s), "rtt_s": float(rtt_s),
                      "method": method}

    def dump_obj(self, last: Optional[int] = None) -> dict:
        rank, world = self.rank, self.world
        if rank is None:
            from ..core.state import global_state
            if global_state.initialized:
                rank = global_state.rank
                world = global_state.size
        return {
            "version": DUMP_VERSION,
            "rank": rank,
            "world": world,
            "host": socket.gethostname(),
            "pid": os.getpid(),
            "clock": dict(self.clock),
            "meta": dict(self.meta),
            "events": self.snapshot(last=last),
        }

    def dump(self, path: Optional[str] = None,
             last: Optional[int] = None) -> str:
        """Write the dump JSON; returns the path written.  Default path:
        ``<HVD_TPU_FLIGHT_DIR>/flight_rank<r>.json`` (atomic tmp+rename
        so a reader never sees a torn file)."""
        obj = self.dump_obj(last=last)
        if path is None:
            d = _config.get_env(_config.FLIGHT_DIR, ".") or "."
            os.makedirs(d, exist_ok=True)
            r = obj["rank"] if obj["rank"] is not None else os.getpid()
            path = os.path.join(d, f"flight_rank{r}.json")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(obj, f, indent=1)
        os.replace(tmp, path)
        return path


_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def recorder() -> FlightRecorder:
    """The process-wide recorder (created on first use)."""
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
    return _recorder


def record(kind: str, name: Optional[str] = None, **fields) -> None:
    """Module-level fast path used by the instrumentation hooks: one
    singleton lookup, then the recorder's own append (the event-tuple
    shape lives in exactly one place — snapshot() unpacks it)."""
    r = _recorder
    if r is None:
        r = recorder()
    r.record(kind, name, **fields)


def set_enabled(enabled: bool) -> None:
    recorder().enabled = bool(enabled)


def set_identity(rank: Optional[int] = None,
                 world: Optional[int] = None) -> None:
    recorder().set_identity(rank=rank, world=world)


def set_meta(key: str, value) -> None:
    recorder().meta[key] = value


def dump(path: Optional[str] = None, last: Optional[int] = None) -> str:
    """``hvd.debug.dump()``: write this rank's flight dump, return the
    path."""
    return recorder().dump(path=path, last=last)


def snapshot(last: Optional[int] = None) -> List[dict]:
    return recorder().snapshot(last=last)


def last_events_limit() -> int:
    return max(1, _config.get_int_or(_config.FLIGHT_LAST_EVENTS,
                                     _config.TELEMETRY.flight_last_events))


# ---------------------------------------------------------------------------
# Coordinator clock-offset estimate, piggybacked on the rendezvous channel
# ---------------------------------------------------------------------------

def estimate_clock_offset(addr: Optional[str] = None, samples: int = 5,
                          timeout: float = 2.0) -> Optional[dict]:
    """Estimate ``local_wall - coordinator_wall`` against the rendezvous
    server's ``debug/time`` key (``addr``, else
    ``HVD_TPU_RENDEZVOUS_ADDR``), one signed GET a sample, NTP-style: the
    server's time against the request's midpoint, the sample with the
    smallest round trip winning.  Returns ``{"offset_s", "rtt_s",
    "method"}``, also stored on the recorder, or None when no server
    answered."""
    addr = addr or os.environ.get("HVD_TPU_RENDEZVOUS_ADDR")
    if not addr:
        return None
    from ..runner.rendezvous import http_get
    best = None
    for _ in range(max(1, samples)):
        t0 = time.time()
        body = http_get(addr, "debug", "time", timeout=timeout)
        t1 = time.time()
        if body is None:
            continue
        try:
            server = float(body)
        except ValueError:
            continue
        rtt = t1 - t0
        offset = (t0 + t1) / 2.0 - server
        if best is None or rtt < best[1]:
            best = (offset, rtt)
    if best is None:
        return None
    recorder().set_clock(best[0], rtt_s=best[1], method="rendezvous")
    return dict(recorder().clock)


# ---------------------------------------------------------------------------
# SIGUSR1 dump trigger
# ---------------------------------------------------------------------------

_signal_installed = False


def install_signal_handler(signum=None) -> bool:
    """SIGUSR1 → flight dump to ``HVD_TPU_FLIGHT_DIR`` + all-thread
    stacks (faulthandler) to stderr.  Main-thread only (signal module
    restriction); idempotent; returns True when installed.  Unlike the
    reference's, it keeps a handler the process already has for the
    signal (returns False): the reference package's own in a process
    that loads both, or the application's."""
    global _signal_installed
    if _signal_installed:
        return True
    import signal
    if threading.current_thread() is not threading.main_thread():
        return False
    if signum is None:
        signum = signal.SIGUSR1
    if signal.getsignal(signum) not in (signal.SIG_DFL, None):
        return False

    def _on_dump_signal(sig, frame):
        try:
            path = dump()
            import faulthandler
            import sys
            sys.stderr.write(f"[hvd_tpu debug] flight dump: {path}\n")
            faulthandler.dump_traceback(all_threads=True)
        except Exception:  # noqa: BLE001 — a dump must never kill training
            pass

    signal.signal(signum, _on_dump_signal)
    _signal_installed = True
    return True
