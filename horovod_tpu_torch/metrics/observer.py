"""The per-host observer — local merge point of the host-sharded
telemetry plane (port of horovod_tpu/metrics/observer.py).

One observer runs per host, inside the local-rank-0 process, on the
same ``BackgroundHTTPServer`` scaffold as the rendezvous KV and the
metrics endpoint (``runner/rendezvous.py``; the metrics port is
rank-gated to local rank 0 too, so the observer lives where the host's
one serving slot is).  Per sync round it:

1. **collects** its local ranks' snapshots — the observer's own rank
   submits in-process, siblings PUT ``/observe/snapshot`` over
   loopback;
2. **merges** them into one host digest (:mod:`.digest` — counters
   sum, gauges (min,max,last), step times and component attribution as
   quantile sketches, top-K outlier evidence raw);
3. **exchanges once per host**: publishes the host digest under
   ``observe/digest_<cross_rank>`` on the rendezvous KV; the root
   observer (cross-rank 0) gathers the O(hosts) digests, merges the
   fleet digest — hosts that miss the round land in ``failed_hosts``,
   named, never silently averaged — and publishes it back under
   ``observe/fleet``;
4. **serves** the results to its local ranks (``GET /observe/fleet``)
   and to fleet tooling (``GET /observe/digest``, plus
   ``GET /observe/dumps`` — every local rank's flight dump in ONE
   response, the fan-in the hang watchdog and ``debug/merge`` use
   instead of per-rank fetches);
5. optionally **pushes** each round's host digest to the fleet
   gateway's timeline store (``fleet/observe.py``) on the
   ``HVD_TPU_FLEET_OBSERVE_PUSH_S`` cadence, filed under
   ``HVD_TPU_FLEET_JOB_ID`` (which the fleet scheduler gives its jobs'
   workers) at ``HVD_TPU_FLEET_ADDR`` — each push counted in
   ``hvd_observe_pushes_total``.

No collective runs on this path: a rank whose observer is unreachable
degrades to a local-only digest (``Aggregator.sync_tree``), never to the
flat allgather, which half a fleet would wait on forever.

All endpoints are HMAC-gated with the launch secret under the
rendezvous KV scheme (scope ``observe``); without a secret they run
unsigned, like every other loopback/test surface.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from ..core import config as _config
from ..utils import logging as log
from . import digest as _digest
from .registry import registry as _registry

_FLEET_KEY = "fleet"


def host_digest_key(cross_rank: int) -> str:
    return f"digest_{int(cross_rank)}"


def observer_addr_key(cross_rank: int) -> str:
    return f"addr_{int(cross_rank)}"


def top_k() -> int:
    return _config.metrics_topk()


class HostObserver:
    """Local merge + inter-host exchange for one host.

    ``local_ranks`` are the GLOBAL rank ids expected on this host per
    round; ``cross_rank``/``cross_size`` index the host among hosts.
    Without a rendezvous address (single host, unit tests) the exchange
    collapses: the fleet digest IS the host digest.
    """

    def __init__(self, host: str, local_ranks: List[int],
                 cross_rank: int = 0, cross_size: int = 1,
                 rdv_addr: Optional[str] = None, port: int = 0,
                 job_id: Optional[str] = None,
                 gateway_addr: Optional[str] = None,
                 push_interval_s: float = 0.0):
        self.host = host
        self.local_ranks = sorted(int(r) for r in local_ranks)
        self.cross_rank = int(cross_rank)
        self.cross_size = int(cross_size)
        self.rdv_addr = rdv_addr
        self.job_id = job_id
        self.gateway_addr = gateway_addr
        self.push_interval_s = float(push_interval_s)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._snaps: Dict[int, Dict[int, dict]] = {}   # round -> rank -> snap
        self._first_seen: Dict[int, float] = {}        # round -> wall
        self._sealed_max = 0                           # highest sealed round
        self._host_digests: Dict[int, dict] = {}
        self._fleet_digests: Dict[int, dict] = {}
        self._latest_host: Optional[dict] = None
        self._latest_fleet: Optional[dict] = None
        self._latest_round = 0
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._server: Optional["_ObserverServer"] = None
        self._port = int(port)
        self.addr: Optional[str] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "HostObserver":
        from ..runner.rendezvous import BackgroundHTTPServer
        self._server = _ObserverServer(("0.0.0.0", self._port), self)
        self._impl = BackgroundHTTPServer(self._server)
        self._impl.start()
        from ..runner.rendezvous import advertised_host
        self.addr = f"{advertised_host()}:{self._impl.port}"
        if self.rdv_addr:
            from ..runner.rendezvous import http_put
            http_put(self.rdv_addr, "observe",
                     observer_addr_key(self.cross_rank), self.addr.encode())
        t = threading.Thread(target=self._exchange_loop,
                             name="hvd-tpu-observer", daemon=True)
        t.start()
        self._threads.append(t)
        if self.push_interval_s > 0 and self.gateway_addr and self.job_id:
            p = threading.Thread(target=self._push_loop,
                                 name="hvd-tpu-observer-push", daemon=True)
            p.start()
            self._threads.append(p)
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        if self._server is not None:
            self._impl.stop()
            self._server = None
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []
        if self.rdv_addr and self.addr:
            # Unpublish: a stale address after an elastic shrink would
            # make every tree-fanned collection probe the departed host
            # (and its timeout) forever.
            from ..runner.rendezvous import http_delete
            try:
                http_delete(self.rdv_addr, "observe",
                            observer_addr_key(self.cross_rank),
                            timeout=2.0)
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
            self.addr = None

    @property
    def port(self) -> int:
        return self._impl.port if self._server is not None else 0

    def reset_rounds(self) -> None:
        """Re-zero the round clock — the elastic-reset hook
        (``Aggregator.reset`` calls this on the host's observer): the
        post-reset world restarts sync rounds at 1, and without the
        reset every new snapshot would be dropped as "late" against the
        pre-reset ``_sealed_max`` while stale pre-reset fleet digests
        kept answering ``fleet_digest(min_round=1)``.  A sibling rank
        whose push races ahead of this reset loses at most one round —
        named missing, like any laggard."""
        with self._cv:
            self._snaps.clear()
            self._first_seen.clear()
            self._sealed_max = 0
            self._host_digests.clear()
            self._fleet_digests.clear()
            self._latest_host = None
            self._latest_fleet = None
            self._latest_round = 0
            self._cv.notify_all()

    # -- snapshot intake ---------------------------------------------------

    def submit_snapshot(self, round_idx: int, snap: dict) -> None:
        """One rank's snapshot for one sync round (in-process for the
        observer's own rank, the HTTP handler for siblings).  A
        snapshot for an already-sealed round is DROPPED: the push rides
        the retrying wire ladder, and a delayed retry landing after its
        round sealed would otherwise re-open the round, re-seal it from
        one straggling snapshot and republish a stale, mostly-missing
        digest over the current one."""
        r = int(round_idx)
        with self._cv:
            if r <= self._sealed_max:
                _registry().counter(
                    "hvd_observe_late_snapshots_total",
                    "Rank snapshots that arrived after their sync "
                    "round sealed (dropped)").inc()
                return
            bucket = self._snaps.setdefault(r, {})
            bucket[int(snap.get("rank", -1))] = snap
            self._first_seen.setdefault(r, time.monotonic())
            # Bounded memory: only the three most recent open rounds.
            for old in sorted(self._snaps):
                if old < r - 2:
                    self._snaps.pop(old, None)
                    self._first_seen.pop(old, None)
            self._cv.notify_all()

    # -- digest build + exchange -------------------------------------------

    def _seal_round(self, r: int, snaps: Dict[int, dict]) -> dict:
        kinds = None
        try:
            kinds = _registry().scalar_kinds()
        except Exception:  # noqa: BLE001 — observability never breaks
            pass
        from .attribution import peak_flops
        d = _digest.snapshot_digest(
            list(snaps.values()), host=self.host, top_k=top_k(),
            expected_ranks=self.local_ranks, scalar_kinds=kinds,
            peak=peak_flops())
        d["round"] = r
        return d

    def _exchange_loop(self) -> None:
        while not self._stop.is_set():
            with self._cv:
                ready = self._ready_round_locked()
                if ready is None:
                    self._cv.wait(timeout=0.2)
                    ready = self._ready_round_locked()
                if ready is None:
                    continue
                r = ready
                snaps = self._snaps.pop(r)
                self._first_seen.pop(r, None)
                self._sealed_max = max(self._sealed_max, r)
                # Rounds older than the one just sealed can only seal
                # staler: drop them outright (their ranks were counted
                # missing in round r's digest already).
                for old in [k for k in self._snaps if k < r]:
                    self._snaps.pop(old, None)
                    self._first_seen.pop(old, None)
            try:
                host_digest = self._seal_round(r, snaps)
                with self._cv:
                    self._host_digests[r] = host_digest
                    self._latest_host = host_digest
                    for old in sorted(self._host_digests):
                        if old < r - 8:
                            self._host_digests.pop(old, None)
                fleet = self._exchange(r, host_digest)
                with self._cv:
                    if fleet is not None:
                        self._fleet_digests[r] = fleet
                        self._latest_fleet = fleet
                        self._latest_round = max(self._latest_round, r)
                        for old in sorted(self._fleet_digests):
                            if old < r - 8:
                                self._fleet_digests.pop(old, None)
                    self._cv.notify_all()
            except Exception as e:  # noqa: BLE001 — never kill training
                log.warning("observer: round %d exchange failed: %r", r, e)

    def _ready_round_locked(self) -> Optional[int]:
        for r in sorted(self._snaps):
            bucket = self._snaps[r]
            if len(bucket) >= len(self.local_ranks):
                return r
            first = self._first_seen.get(r, 0.0)
            # The grace: how long laggard local snapshots may take
            # before the round seals partial, the missing ranks named.
            if first and time.monotonic() - first >= \
                    _config.metrics_tree_grace_s():
                return r
        return None

    def _exchange(self, r: int, host_digest: dict) -> Optional[dict]:
        """Inter-host: one digest out, one fleet digest back.  O(hosts)
        values through the KV per round — the whole point."""
        if not self.rdv_addr or self.cross_size <= 1:
            return host_digest
        from ..runner.rendezvous import http_get, http_put
        payload = json.dumps(host_digest).encode()
        http_put(self.rdv_addr, "observe",
                 host_digest_key(self.cross_rank), payload)
        deadline = time.monotonic() + _config.metrics_tree_timeout_s()
        if self.cross_rank == 0:
            # Round-robin over the hosts still missing until the ONE
            # shared deadline: a dead host must cost the round its own
            # absence only — a serial per-host wait would burn the
            # whole budget on the first dead host and mark every host
            # polled after it failed with zero fetch attempts.
            merged = host_digest
            pending = set(range(1, self.cross_size))
            while pending and time.monotonic() < deadline \
                    and not self._stop.is_set():
                for c in sorted(pending):
                    raw = http_get(self.rdv_addr, "observe",
                                   host_digest_key(c), timeout=3.0)
                    d = None
                    if raw:
                        try:
                            d = json.loads(raw.decode())
                        except ValueError:
                            d = None
                    # Exact round match: rounds are lockstep (the sync
                    # cadence is SPMD), so a HIGHER round here can only
                    # be a stale pre-elastic-reset value — accepting it
                    # would merge two worlds.
                    if d is not None and int(d.get("round", -1)) == r:
                        merged = _digest.merge_digests(merged, d)
                        pending.discard(c)
                if pending:
                    self._stop.wait(0.05)
            if pending:
                merged = dict(merged)
                merged["failed_hosts"] = sorted(
                    set(merged.get("failed_hosts") or [])
                    | {self._failed_host_name(c) for c in pending})
            merged["round"] = r
            http_put(self.rdv_addr, "observe", _FLEET_KEY,
                     json.dumps(merged).encode())
            return merged
        while time.monotonic() < deadline and not self._stop.is_set():
            raw = http_get(self.rdv_addr, "observe", _FLEET_KEY,
                           timeout=3.0)
            if raw:
                try:
                    d = json.loads(raw.decode())
                except ValueError:
                    d = None
                # Exact match, same reasoning as the root's gather: a
                # higher round is pre-reset leftovers, not the future.
                if d is not None and int(d.get("round", -1)) == r:
                    return d
            self._stop.wait(0.05)
        log.warning("observer: fleet digest for round %d never arrived "
                    "(root host down?); serving the host digest", r)
        return host_digest

    def _failed_host_name(self, cross_rank: int) -> str:
        """Name an absent host by its published observer address when
        one exists (the address leads with ``advertised_host()`` — the
        real host name under HVD_TPU_FLIGHT_HOST), so failed_hosts
        correlates with the digests' ``hosts`` naming instead of a
        synthetic index nothing else uses."""
        addr = None
        try:
            addr = observer_addr_for(cross_rank, rdv_addr=self.rdv_addr,
                                     timeout=1.0)
        except Exception:  # noqa: BLE001 — naming is best-effort
            pass
        return f"host{cross_rank}" + (f"@{addr}" if addr else "")

    # -- read side ---------------------------------------------------------

    def host_digest(self) -> Optional[dict]:
        with self._lock:
            return self._latest_host

    def fleet_digest(self, min_round: int = 0,
                     wait_s: float = 0.0) -> Optional[dict]:
        deadline = time.monotonic() + max(wait_s, 0.0)
        with self._cv:
            while True:
                if self._latest_fleet is not None and \
                        self._latest_round >= min_round:
                    return self._latest_fleet
                left = deadline - time.monotonic()
                if left <= 0:
                    return self._latest_fleet
                self._cv.wait(timeout=min(left, 0.2))

    # -- tree-fanned debug collection --------------------------------------

    def collect_dumps(self, timeout_s: float = 3.0
                      ) -> Dict[int, Optional[dict]]:
        """Every local rank's flight dump, fetched over loopback (the
        observer's own process answers in-process) — one host-level
        fan-in instead of the watchdog's per-rank fan-out."""
        from concurrent.futures import ThreadPoolExecutor
        from ..debug import flight as _flight
        from ..debug import http as _dhttp

        my_rank = _flight.recorder().rank

        def fetch(rank: int) -> Optional[dict]:
            if rank == my_rank:
                return _flight.recorder().dump_obj(
                    last=_flight.last_events_limit())
            addr = None
            if self.rdv_addr:
                from ..runner.rendezvous import http_get
                raw = http_get(self.rdv_addr, "debug",
                               _dhttp.flight_addr_key(rank),
                               timeout=timeout_s)
                addr = raw.decode() if raw else None
            return _dhttp.fetch_flight_dump(
                addr, timeout=timeout_s) if addr else None

        with ThreadPoolExecutor(
                max_workers=min(max(len(self.local_ranks), 1), 8),
                thread_name_prefix="hvd-tpu-observer-dumps") as pool:
            results = list(pool.map(fetch, self.local_ranks))
        return dict(zip(self.local_ranks, results))


    # -- gateway push ------------------------------------------------------

    def _push_loop(self) -> None:
        """Push the newest host digest to the fleet gateway each cadence,
        once a round (reference observer.py:419-434); best-effort."""
        from ..fleet.client import push_observation
        last_pushed = -1
        while not self._stop.wait(self.push_interval_s):
            with self._lock:
                d = self._latest_host
            if d is None or int(d.get("round", -1)) == last_pushed:
                continue
            try:
                push_observation(self.job_id, d, addr=self.gateway_addr)
                last_pushed = int(d.get("round", -1))
                _registry().counter(
                    "hvd_observe_pushes_total",
                    "Host digests pushed to the fleet gateway").inc()
            except Exception as e:  # noqa: BLE001 — push is best-effort
                log.debug("observer: gateway push failed: %r", e)


# ---------------------------------------------------------------------------
# HTTP plane
# ---------------------------------------------------------------------------

class _ObserverHandler(BaseHTTPRequestHandler):
    server_version = "hvd_tpu_observer"

    def log_message(self, fmt, *args):  # silence request logging
        pass

    def _authorized(self, method: str, key: str, body: bytes = b"") -> bool:
        from ..runner.rendezvous import request_authorized
        return request_authorized(self.headers, method, "observe", key,
                                  body)

    def _send(self, code: int, body: bytes,
              ctype: str = "application/json") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        ob = self.server.observer  # type: ignore[attr-defined]
        code, body, ctype = handle_observe_get(ob, self.path, self.headers)
        self._send(code, body, ctype)

    def do_PUT(self):
        ob = self.server.observer  # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0]
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        if path != "/observe/snapshot":
            return self._send(404, b'{"error": "not found"}')
        if not self._authorized("PUT", "snapshot", body):
            return self._send(403, b'{"error": "bad signature"}')
        try:
            payload = json.loads(body.decode())
            ob.submit_snapshot(int(payload["round"]), payload["snap"])
        except (ValueError, KeyError, TypeError) as e:
            return self._send(400, json.dumps(
                {"error": f"malformed snapshot: {e}"}).encode())
        self._send(200, b'{"ok": true}')

    do_POST = do_PUT


def handle_observe_get(ob: Optional["HostObserver"], path: str,
                       headers) -> tuple:
    """Shared GET routing for ``/observe/*`` — used by the observer's
    own server AND mounted on the metrics port (exporters.py), so one
    host port answers either way.  Returns (code, body, ctype)."""
    from ..runner.rendezvous import request_authorized
    path, _, query = path.partition("?")
    if ob is None:
        return 404, b'{"error": "no host observer running"}', \
            "application/json"
    if path == "/observe/digest":
        if not request_authorized(headers, "GET", "observe", "digest"):
            return 403, b'{"error": "bad signature"}', "application/json"
        d = ob.host_digest()
        if d is None:
            return 404, b'{"error": "no digest yet"}', "application/json"
        return 200, json.dumps(d).encode(), "application/json"
    if path == "/observe/fleet":
        if not request_authorized(headers, "GET", "observe", "fleet"):
            return 403, b'{"error": "bad signature"}', "application/json"
        min_round, wait_s = 0, 0.0
        for part in query.split("&"):
            if part.startswith("round="):
                try:
                    min_round = int(part[6:])
                except ValueError:
                    pass
            elif part.startswith("wait_s="):
                try:
                    wait_s = min(float(part[7:]),
                                 _config.metrics_tree_timeout_s())
                except ValueError:
                    pass
        d = ob.fleet_digest(min_round=min_round, wait_s=wait_s)
        if d is None:
            return 404, b'{"error": "no fleet digest yet"}', \
                "application/json"
        return 200, json.dumps(d).encode(), "application/json"
    if path == "/observe/dumps":
        if not request_authorized(headers, "GET", "observe", "dumps"):
            return 403, b'{"error": "bad signature"}', "application/json"
        dumps = ob.collect_dumps()
        return 200, json.dumps(
            {"host": ob.host,
             "ranks": {str(r): d for r, d in dumps.items()}}).encode(), \
            "application/json"
    if path == "/healthz":
        return 200, b"ok", "text/plain"
    return 404, b'{"error": "not found"}', "application/json"


class _ObserverServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr, observer: HostObserver):
        super().__init__(addr, _ObserverHandler)
        self.observer = observer


# ---------------------------------------------------------------------------
# process-global wiring (init() + the rank-side sync client)
# ---------------------------------------------------------------------------

_observer: Optional[HostObserver] = None
_observer_lock = threading.Lock()


def current_observer() -> Optional[HostObserver]:
    return _observer


def start_host_observer(**overrides) -> Optional[HostObserver]:
    """Start (or return) this host's observer — called by ``init()`` on
    local rank 0 when ``HVD_TPU_METRICS_TREE`` is on.  Identity
    defaults come from ``global_state``; tests override explicitly."""
    global _observer
    with _observer_lock:
        if _observer is not None:
            return _observer
        from ..core.state import global_state
        if not overrides and not global_state.initialized:
            return None
        host = overrides.pop("host", None) or os.environ.get(
            "HVD_TPU_FLIGHT_HOST") or f"host{global_state.cross_rank}"
        local_ranks = overrides.pop("local_ranks", None)
        if local_ranks is None:
            base = global_state.rank - global_state.local_rank
            local_ranks = list(range(base, base + global_state.local_size))
        ob = HostObserver(
            host=host, local_ranks=local_ranks,
            cross_rank=overrides.pop("cross_rank",
                                     global_state.cross_rank),
            cross_size=overrides.pop("cross_size",
                                     global_state.cross_size),
            rdv_addr=overrides.pop(
                "rdv_addr", os.environ.get("HVD_TPU_RENDEZVOUS_ADDR")),
            job_id=overrides.pop("job_id", _config.fleet_job_id()),
            gateway_addr=overrides.pop("gateway_addr",
                                       _config.fleet_addr()),
            push_interval_s=overrides.pop(
                "push_interval_s", _config.fleet_observe_push_s()),
            **overrides)
        _observer = ob.start()
        return _observer


def stop_host_observer() -> None:
    global _observer
    with _observer_lock:
        ob, _observer = _observer, None
    if ob is not None:
        ob.stop()


_addr_cache: Dict[int, str] = {}


def observer_addr_for(cross_rank: int, rdv_addr: Optional[str] = None,
                      timeout: float = 3.0,
                      cached: bool = True) -> Optional[str]:
    """Resolve a host's observer address from the rendezvous KV.
    Cached by default — without the cache every rank's every sync round
    would pay one KV GET, quietly re-growing the O(world) chatter the
    tree removed."""
    if cached and cross_rank in _addr_cache:
        return _addr_cache[cross_rank]
    rdv_addr = rdv_addr or os.environ.get("HVD_TPU_RENDEZVOUS_ADDR")
    if not rdv_addr:
        return None
    from ..runner.rendezvous import http_get
    raw = http_get(rdv_addr, "observe", observer_addr_key(cross_rank),
                   timeout=timeout)
    if raw:
        _addr_cache[int(cross_rank)] = raw.decode()
        return _addr_cache[int(cross_rank)]
    return None


def reset_addr_cache() -> None:
    _addr_cache.clear()


def _observe_request(addr: str, path: str, key: str,
                     body: Optional[bytes] = None, method: str = "GET",
                     timeout: float = 5.0) -> Optional[bytes]:
    import urllib.error
    import urllib.request
    from .. import net as _net
    from ..runner.rendezvous import sign_request
    req = urllib.request.Request(f"http://{addr}{path}", data=body,
                                 method=method)
    sign_request(req, method, "observe", key, body or b"")
    try:
        return _net.request_bytes(req, timeout=timeout,
                                  name=f"observe.{key}")
    except (urllib.error.HTTPError, OSError):
        return None


def push_snapshot(addr: str, round_idx: int, snap: dict,
                  timeout: float = 5.0) -> bool:
    body = json.dumps({"round": int(round_idx), "snap": snap}).encode()
    return _observe_request(addr, "/observe/snapshot", "snapshot",
                            body=body, method="PUT",
                            timeout=timeout) is not None


def fetch_fleet_digest(addr: str, min_round: int = 0,
                       wait_s: float = 0.0,
                       timeout: float = 8.0) -> Optional[dict]:
    raw = _observe_request(
        addr, f"/observe/fleet?round={int(min_round)}&wait_s={wait_s}",
        "fleet", timeout=timeout)
    if not raw:
        return None
    try:
        return json.loads(raw.decode())
    except ValueError:
        return None


def fetch_host_dumps(addr: str, timeout: float = 8.0
                     ) -> Optional[Dict[int, Optional[dict]]]:
    """One host's ranks' flight dumps via its observer (None =
    observer unreachable; per-rank None = that rank unreachable)."""
    raw = _observe_request(addr, "/observe/dumps", "dumps",
                           timeout=timeout)
    if not raw:
        return None
    try:
        payload = json.loads(raw.decode())
        return {int(r): d for r, d in (payload.get("ranks") or {}).items()}
    except (ValueError, TypeError):
        return None


def collect_fleet_dumps(rdv_addr: str, timeout: float = 3.0):
    """Host-sharded flight-dump collection: one ``GET /observe/dumps``
    per published observer.  Returns ``(dumps, host_status)`` — dumps
    maps rank → dump for every rank an observer ANSWERED FOR (ranks the
    observer reported as None are left out so callers' per-rank
    fallback still runs for them); host_status names each observer's
    fan-in outcome.  Shared by the hang watchdog (debug/hang.py) and
    the trace-merge CLI (debug/merge.py --from-fleet)."""
    from concurrent.futures import ThreadPoolExecutor
    from ..runner.rendezvous import http_list

    keys = http_list(rdv_addr, "observe", timeout=timeout) or []
    addr_keys = sorted(k for k in keys if k.startswith("addr_"))
    if not addr_keys:
        return {}, {}

    def fetch_host(key: str):
        cross = int(key[len("addr_"):])
        addr = observer_addr_for(cross, rdv_addr=rdv_addr,
                                 timeout=timeout, cached=False)
        if not addr:
            return key, None, None
        return key, addr, fetch_host_dumps(
            addr, timeout=max(timeout * 2, 5.0))

    dumps: Dict[int, dict] = {}
    status: Dict[str, str] = {}
    with ThreadPoolExecutor(
            max_workers=min(len(addr_keys), 16),
            thread_name_prefix="hvd-tpu-host-fetch") as pool:
        for key, addr, host_dumps in pool.map(fetch_host, addr_keys):
            name = f"host[{key[len('addr_'):]}]" \
                + (f"@{addr}" if addr else "")
            if host_dumps is None:
                status[name] = "unreachable (per-rank fallback)"
                continue
            absent = sorted(r for r, d in host_dumps.items()
                            if d is None)
            status[name] = "ok" if not absent else \
                f"partial (ranks {absent} unanswered; per-rank fallback)"
            dumps.update({r: d for r, d in host_dumps.items()
                          if d is not None})
    return dumps, status


def rank_sync(snap: dict, round_idx: int,
              timeout_s: Optional[float] = None) -> Optional[dict]:
    """The rank-side tree sync: hand this rank's snapshot to the host
    observer (in-process when this rank hosts it, loopback HTTP
    otherwise) and wait for the round's fleet digest.  Returns the best
    digest available within the deadline (a previous round's digest
    beats nothing), or None when no observer is reachable — the caller
    degrades to a local-only digest, it NEVER falls back to the flat
    collective mid-round (half a fleet in an allgather is a hang)."""
    if timeout_s is None:
        timeout_s = _config.metrics_tree_timeout_s()
    ob = current_observer()
    if ob is not None:
        ob.submit_snapshot(round_idx, snap)
        return ob.fleet_digest(min_round=round_idx, wait_s=timeout_s)
    from ..core.state import global_state
    addr = observer_addr_for(global_state.cross_rank)
    if addr is None:
        return None
    if not push_snapshot(addr, round_idx, snap):
        return None
    return fetch_fleet_digest(addr, min_round=round_idx,
                              wait_s=timeout_s, timeout=timeout_s + 3.0)
