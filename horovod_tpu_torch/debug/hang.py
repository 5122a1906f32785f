"""Distributed hang diagnosis (port of horovod_tpu/debug/hang.py):
automatic escalation from the native stall inspector to a fleet-wide
post-mortem.

The native controller *detects* desynchronized-rank stalls (a tensor
submitted by some-but-not-all ranks past the warning window,
``native/src/controller.cc``).  This module closes the loop: a
coordinator-side watchdog thread polls the ``hvd_native_stalled_json``
snapshot (``NativeController.stalled()``), and the moment a stall
crosses the warning window it

1. fetches the flight dump of every reachable rank (addresses published
   under ``debug/flight_addr_<rank>`` on the rendezvous KV by
   ``debug/http.serve_and_publish``),
2. attributes each *missing* rank's state from its last flight events —
   input-bound (stuck waiting on the data pipeline), checkpoint-bound
   (inside a checkpoint save/restore), blocked-in-collective, or
   compute-bound (no recent hvd activity: the rank is busy, or dead,
   outside the framework), and
3. writes ``hang_report_<step>.json`` naming the stuck collective, the
   missing ranks, and each missing rank's last N events.

The report is what the first responder needs before deciding whether to
evict a host (elastic blacklist), raise the data-stall timeout, or go
read one rank's ``/debug/stacks``.  Where per-host observers are
published (``HVD_TPU_METRICS_TREE``, ``metrics/observer.py``) the dumps
come one request per host, and the report's ``hosts`` section names each
host's fan-in; ranks no observer answered for are fetched one by one.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from ..core import config as _config
from ..utils import logging as log
from . import flight as _flight

_REQUEST_TYPE_NAMES = {0: "allreduce", 1: "allgather", 2: "broadcast",
                       3: "alltoall", 4: "join", 5: "barrier"}


def attribute(events: List[dict]) -> str:
    """Classify what a rank was doing from its most recent flight events
    (newest last).  Pure function — golden-tested."""
    if not events:
        return "compute-bound (no flight events; rank busy or dead "\
               "outside hvd)"
    # Walk newest-first: the most recent signal wins.
    ckpt_completions = 0  # commits/dones seen later than the begin at hand
    for ev in reversed(events):
        kind = ev.get("kind", "")
        if kind.startswith("checkpoint."):
            if kind.endswith(".begin"):
                if ckpt_completions == 0:
                    # A begin with no completion after it: the rank is
                    # still inside the save/restore (shard writes, the
                    # commit barrier).
                    return "checkpoint-bound"
                ckpt_completions -= 1
            else:
                ckpt_completions += 1
            continue
        if kind in ("data.stall_warning", "data.stall_timeout",
                    "data.producer_dead", "data.wait"):
            return "input-bound"
        if kind == "collective.enqueue":
            # Newest collective event is an enqueue with no completion:
            # the rank IS inside the collective machinery (likely a
            # different tensor than the stuck one, or a late arrival).
            return "blocked-in-collective"
        if kind in ("collective.done", "collective", "negotiate.execute",
                    "collective.error"):
            break
    return "compute-bound (last hvd activity completed normally)"


def build_hang_report(stalled: List[dict],
                      rank_dumps: Dict[int, Optional[dict]],
                      world: int, step: int,
                      last_n: Optional[int] = None,
                      host_status: Optional[Dict[str, str]] = None) -> dict:
    """Assemble the report object from the stall snapshot + per-rank
    dumps (None value = unreachable rank).  Pure function.

    ``host_status`` (tree-fanned collection, ``_collect_dumps``) maps
    each per-host observer to how its fan-in went — ``"ok"``,
    ``"unreachable"``, or ``"fallback:<reason>"`` — so a report built
    from a partial round NAMES which host's evidence is missing
    instead of just showing its ranks as unreachable."""
    last_n = last_n or _flight.last_events_limit()
    missing_union = sorted({r for s in stalled for r in s.get("missing", [])})
    ranks = {}
    for r in range(world):
        dumpd = rank_dumps.get(r)
        entry: dict = {"missing": r in missing_union,
                       "reachable": dumpd is not None}
        if dumpd is not None:
            events = dumpd.get("events", [])[-last_n:]
            entry["attribution"] = attribute(events)
            entry["last_events"] = events
            entry["clock"] = dumpd.get("clock", {})
            entry["host"] = dumpd.get("host")
            # Serving replicas publish their in-flight requests (and
            # trace ids) in the recorder meta (engine._publish_slots):
            # a wedged serving loop's report NAMES what it was holding,
            # and each trace id is a merge --trace away from the
            # request's own timeline.
            slots = (dumpd.get("meta") or {}).get("serving_slots")
            if slots:
                entry["serving_in_flight"] = slots
        elif r in missing_union:
            entry["attribution"] = \
                "unknown (rank unreachable: process dead or debug " \
                "endpoint not serving)"
        ranks[str(r)] = entry
    return {
        "version": _flight.DUMP_VERSION,
        "step": step,
        "generated_wall": time.time(),
        "world": world,
        "stalled": [dict(s, type_name=_REQUEST_TYPE_NAMES.get(
            s.get("type"), str(s.get("type")))) for s in stalled],
        "missing_ranks": missing_union,
        "hosts": dict(host_status) if host_status else None,
        "ranks": ranks,
        # The last recovery decision on THIS process (path peer/disk/
        # none, bytes, latency): a hang right after an elastic reset
        # reads differently when the report shows hot recovery already
        # succeeded — or that it fell back to disk and is still
        # restoring.  None when no restore has run.
        "recovery": _last_recovery(),
        # The wire fabric's escalation-ladder state: a stall with
        # ``retrying`` True is "retrying, deadline not yet reached" —
        # the collective is mid reconnect-and-resume and will either
        # heal or escalate on its own — while ``retrying`` False with a
        # stall is a genuinely wedged rank (evict, don't wait).
        "net": _net_status(),
    }


def _last_recovery() -> Optional[dict]:
    try:
        from ..recovery import last_report
        report = last_report()
        return None if report is None else report.to_dict()
    except Exception:  # noqa: BLE001 — diagnosis best-effort
        return None


def _net_status() -> Optional[dict]:
    try:
        from .. import net as _net
        return _net.status()
    except Exception:  # noqa: BLE001 — diagnosis best-effort
        return None


class StallWatchdog:
    """Coordinator-side escalation thread.  Polls the native stall
    inspector; on the first poll where a stall is visible, collects
    per-rank flight dumps and writes one hang report per distinct stall
    set (re-arming once the stall clears, so a later, different hang
    produces a fresh report)."""

    def __init__(self, controller, report_dir: Optional[str] = None,
                 rdv_addr: Optional[str] = None,
                 interval_s: Optional[float] = None,
                 fetch_timeout_s: float = 3.0):
        self._ctl = controller
        self._dir = report_dir or _config.flight_dir()
        self._rdv = rdv_addr or os.environ.get("HVD_TPU_RENDEZVOUS_ADDR")
        if interval_s is None:
            warn = _config.stall_warning_seconds()
            interval_s = min(max(warn / 2.0, 0.25), 5.0)
        self._interval = float(interval_s)
        self._fetch_timeout = float(fetch_timeout_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._reported_keys: set = set()
        self._armed = True
        self.reports_written: List[str] = []
        self._report_seq = 0
        self.last_host_status: Dict[str, str] = {}

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "StallWatchdog":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._loop, name="hvd-tpu-flight-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self, join_timeout_s: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=join_timeout_s)
        self._thread = None

    # -- escalation --------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                stalled = self._ctl.stalled()
            except Exception:  # noqa: BLE001 — controller torn down
                return
            if not stalled:
                self._armed = True
                continue
            key = tuple(sorted(
                (s.get("name", ""), tuple(s.get("missing", [])))
                for s in stalled))
            if not self._armed or key in self._reported_keys:
                continue
            self._reported_keys.add(key)
            self._armed = False
            try:
                path = self._write_report(stalled)
                log.warning(
                    "stall escalation: wrote hang report %s (stuck: %s; "
                    "missing ranks %s)", path,
                    ",".join(s.get("name", "?") for s in stalled),
                    sorted({r for s in stalled
                            for r in s.get("missing", [])}))
            except Exception as e:  # noqa: BLE001 — diagnosis best-effort
                log.warning("stall escalation failed: %r", e)

    def _collect_dumps(self, world: int) -> Dict[int, Optional[dict]]:
        dumps, self.last_host_status = self._collect_dumps_status(world)
        return dumps

    def _collect_dumps_status(self, world: int):
        """(rank dumps, per-host fan-in status).  When per-host
        observers published (HVD_TPU_METRICS_TREE — metrics/observer.py)
        the fetch is ONE request per host returning all its ranks'
        dumps; hosts whose observer fails fall back to per-rank fetches
        for the uncovered ranks and are named in the report's ``hosts``
        section.  Without observers it is the flat per-rank fan-out."""
        host_status: Dict[str, str] = {}
        covered: Dict[int, Optional[dict]] = {}
        if self._rdv:
            covered, host_status = self._collect_via_observers()
        missing = [r for r in range(world) if r not in covered]
        covered.update(self._collect_per_rank(missing))
        return {r: covered.get(r) for r in range(world)}, host_status

    def _collect_via_observers(self):
        # One request per host through the published observers
        # (metrics/observer.py).  Ranks an observer could not answer
        # for — observer down, or a sibling that timed out inside the
        # observer's fan-in — are NOT marked covered, so the per-rank
        # path still retries them with this watchdog's own timeout.
        from ..metrics.observer import collect_fleet_dumps
        return collect_fleet_dumps(self._rdv,
                                   timeout=self._fetch_timeout)

    def _collect_per_rank(self, ranks: List[int]) -> Dict[int, Optional[dict]]:
        from concurrent.futures import ThreadPoolExecutor
        from . import http as _http
        if not ranks:
            return {}
        my_rank = self._ctl.rank()

        def fetch(r: int) -> Optional[dict]:
            if r == my_rank:
                return _flight.recorder().dump_obj(
                    last=_flight.last_events_limit())
            addr = None
            if self._rdv:
                from ..runner.rendezvous import http_get
                raw = http_get(self._rdv, "debug",
                               _http.flight_addr_key(r),
                               timeout=self._fetch_timeout)
                addr = raw.decode() if raw else None
            return _http.fetch_flight_dump(
                addr, timeout=self._fetch_timeout) if addr else None

        # Parallel fetches: sequential blocking GETs would make the
        # report take minutes on a wide slice with several dead ranks
        # (each unreachable rank costs up to 2x fetch_timeout) and quote
        # stale evidence by the time it lands.
        with ThreadPoolExecutor(
                max_workers=min(len(ranks), 16),
                thread_name_prefix="hvd-tpu-flight-fetch") as pool:
            results = list(pool.map(fetch, ranks))
        return dict(zip(ranks, results))

    def _step(self) -> int:
        """Report step index: the training step when the metrics
        aggregator tracks one, else a per-watchdog sequence number."""
        try:
            from ..metrics.aggregate import aggregator
            step = int(getattr(aggregator(), "_step", 0) or 0)
            if step > 0:
                return step
        except Exception:  # noqa: BLE001
            pass
        self._report_seq += 1
        return self._report_seq

    def _write_report(self, stalled: List[dict]) -> str:
        world = self._ctl.size()
        dumps, host_status = self._collect_dumps_status(world)
        report = build_hang_report(stalled, dumps, world=world,
                                   step=self._step(),
                                   host_status=host_status)
        os.makedirs(self._dir, exist_ok=True)
        path = os.path.join(self._dir,
                            f"hang_report_{report['step']}.json")
        # A second, different hang within the same step must not
        # os.replace the first report away — uniquify on collision.
        n = 1
        while os.path.exists(path):
            path = os.path.join(
                self._dir, f"hang_report_{report['step']}_{n}.json")
            n += 1
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=1)
        os.replace(tmp, path)
        self.reports_written.append(path)
        return path


_watchdog: Optional[StallWatchdog] = None
_watchdog_lock = threading.Lock()


def start_stall_watchdog(controller, **kwargs) -> StallWatchdog:
    """Start (or return) the process-wide escalation watchdog.  Called
    by ``init()`` on the coordinator rank of launcher-run jobs."""
    global _watchdog
    with _watchdog_lock:
        if _watchdog is None:
            _watchdog = StallWatchdog(controller, **kwargs).start()
        return _watchdog


def stop_stall_watchdog() -> None:
    global _watchdog
    with _watchdog_lock:
        w, _watchdog = _watchdog, None
    if w is not None:
        w.stop()
