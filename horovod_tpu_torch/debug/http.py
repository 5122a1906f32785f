"""Per-rank debug HTTP endpoints (port of horovod_tpu/debug/http.py) on
the shared BackgroundHTTPServer scaffold (``runner/rendezvous.py``): the
same serving idiom as the metrics subsystem's Prometheus endpoint, which
also mounts these paths when it is running (one port serves both
surfaces):

* ``GET /debug/flight`` — this rank's flight-recorder dump as JSON.
* ``GET /debug/regression`` — the last drift-triggered regression
  report (``hvd.debug.last_regression_report()``; 404 before the first
  confirmed drift).
* ``GET /debug/stacks`` — all-thread Python stacks via ``faulthandler``
  (the output a wedged rank would print on SIGUSR1, fetchable remotely
  while the main thread is stuck inside a collective: the handler runs
  on the server's daemon thread).
* ``GET /debug/autotune`` — the tuner's closed-loop status
  (``autotune.loop_status()``); 404 in a process that owns no tuner.
* ``GET /debug/fleet_scalars`` — the aggregator's per-rank scalars.
* ``GET /healthz`` — liveness.

Discovery: :func:`serve_and_publish` starts the server on an ephemeral
port and PUTs ``debug/flight_addr_<rank>`` to the rendezvous KV, so the
coordinator's stall watchdog (``debug/hang.py``) can reach every rank
without any new configuration."""

from __future__ import annotations

import json
import os
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from . import flight as _flight


def render_flight_json() -> bytes:
    """The local flight dump, serialized for the wire."""
    return json.dumps(_flight.recorder().dump_obj()).encode("utf-8")


def render_regression_json() -> Optional[bytes]:
    """The last regression report (debug/regression.py), serialized for
    the wire — None before the first confirmed drift.  Until now the
    perf_regression_step<N>.json artifact was only reachable over
    shared disk; this serves it beside /debug/flight under the same
    trust model."""
    from . import regression as _regression
    report = _regression.last_report()
    if report is None:
        return None
    return json.dumps(report, default=str).encode("utf-8")


def render_autotune_json() -> Optional[bytes]:
    """The active tuner's closed-loop status (``autotune.loop_status``:
    frozen, retuning, rollbacks, warm-started, current config)
    serialized for the wire; None when this process owns no tuner
    (only rank 0 of an ``HVD_TPU_AUTOTUNE`` job does)."""
    from .. import autotune as _autotune
    status = _autotune.loop_status()
    if status is None:
        return None
    return json.dumps(status, default=str).encode("utf-8")


def render_fleet_scalars_json() -> bytes:
    """The aggregator's queryable fleet surface: per-rank flat scalars
    from the last sync round ({} before the first).  Under the tree
    path the per-rank section is EMPTY by design (outlier evidence is
    pruned of scalar maps — metrics/digest.py) and the ``merged``
    section carries the fleet digest's exact counter totals and
    (min, max, last) gauge envelopes instead."""
    from ..metrics.aggregate import aggregator
    agg = aggregator()
    payload: dict = {"ranks": {str(r): s for r, s in
                               agg.fleet_scalars().items() if s}}
    digest = agg.fleet_digest()
    if digest is not None:
        payload["merged"] = {"counters": digest.get("counters") or {},
                             "gauges": digest.get("gauges") or {},
                             "hosts": digest.get("hosts") or [],
                             "ranks_merged": digest.get("ranks", 0)}
    return json.dumps(payload, default=str).encode("utf-8")


def request_authorized(headers, key: str) -> bool:
    """HMAC gate for a dump request — the same scheme as the rendezvous
    KV (signed as a GET of ``debug/<key>`` with the launch secret):
    stacks and event history are internals no stranger on the network
    should read.  Without a secret (unit-test/loopback mode) requests
    pass, like the KV server's unsigned mode.  Shared by the standalone
    debug endpoint AND the metrics-port mount, so setting the secret
    protects every copy of these paths."""
    from ..runner.rendezvous import request_authorized as _authorized
    return _authorized(headers, "GET", "debug", key)


def render_stacks_text() -> bytes:
    """All-thread stacks via faulthandler (needs a real fd, so the dump
    round-trips through an unlinked temp file)."""
    import faulthandler
    with tempfile.TemporaryFile(mode="w+b") as f:
        faulthandler.dump_traceback(file=f, all_threads=True)
        f.seek(0)
        return f.read()


class _DebugHandler(BaseHTTPRequestHandler):
    server_version = "hvd_tpu_debug"

    def log_message(self, fmt, *args):  # silence request logging
        pass

    def _send(self, body: bytes, ctype: str = "application/json"):
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_error(self, code: int, body: bytes):
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _authorized(self, key: str) -> bool:
        return request_authorized(self.headers, key)

    def do_GET(self):
        path = self.path.split("?", 1)[0]
        if path == "/debug/flight":
            if not self._authorized("flight"):
                self.send_response(403)
                self.end_headers()
                return
            self._send(render_flight_json())
        elif path == "/debug/regression":
            if not self._authorized("regression"):
                self.send_response(403)
                self.end_headers()
                return
            body = render_regression_json()
            if body is None:
                self._send_error(404, b'{"error": "no regression '
                                      b'report yet"}')
                return
            self._send(body)
        elif path == "/debug/stacks":
            if not self._authorized("stacks"):
                self.send_response(403)
                self.end_headers()
                return
            self._send(render_stacks_text(),
                       ctype="text/plain; charset=utf-8")
        elif path == "/debug/autotune":
            if not self._authorized("autotune"):
                self.send_response(403)
                self.end_headers()
                return
            body = render_autotune_json()
            if body is None:
                self._send_error(404, b'{"error": "no active tuner in '
                                      b'this process"}')
                return
            self._send(body)
        elif path == "/debug/fleet_scalars":
            if not self._authorized("fleet_scalars"):
                self.send_response(403)
                self.end_headers()
                return
            self._send(render_fleet_scalars_json())
        elif path == "/healthz":
            self._send(b"ok", ctype="text/plain")
        else:
            self.send_response(404)
            self.end_headers()


class _DebugHTTPServer(ThreadingHTTPServer):
    daemon_threads = True


class DebugServer:
    """Flight/stacks endpoints on a background daemon thread."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        from ..runner.rendezvous import BackgroundHTTPServer
        self._impl = BackgroundHTTPServer(
            _DebugHTTPServer((host, port), _DebugHandler))

    @property
    def port(self) -> int:
        return self._impl.port

    def start(self) -> int:
        return self._impl.start()

    def stop(self) -> None:
        self._impl.stop()


_serve_lock = threading.Lock()
_server: Optional[DebugServer] = None


def serve(port: int = 0, host: str = "0.0.0.0") -> DebugServer:
    """Start (or return) the module-level debug endpoint — idempotent so
    elastic re-``init()`` keeps one server across rounds."""
    global _server
    with _serve_lock:
        if _server is None:
            s = DebugServer(host=host, port=port)
            s.start()
            _server = s
        return _server


def stop_serving() -> None:
    global _server
    with _serve_lock:
        if _server is not None:
            _server.stop()
            _server = None


def _my_host() -> str:
    from ..runner.rendezvous import advertised_host
    return advertised_host()


def flight_addr_key(rank: int) -> str:
    return f"flight_addr_{rank}"


def serve_and_publish(rank: Optional[int] = None,
                      rdv_addr: Optional[str] = None,
                      port: int = 0) -> Optional[str]:
    """Start the debug endpoint and publish its ``host:port`` under the
    rendezvous KV key ``debug/flight_addr_<rank>`` so the coordinator's
    hang watchdog can fetch this rank's flight dump.  Returns the
    published address (None when no rendezvous address is known)."""
    rdv_addr = rdv_addr or os.environ.get("HVD_TPU_RENDEZVOUS_ADDR")
    if rank is None:
        rank = _flight.recorder().rank
    s = serve(port=port)
    if rdv_addr is None or rank is None:
        return None
    from ..runner.rendezvous import http_put
    addr = f"{_my_host()}:{s.port}"
    http_put(rdv_addr, "debug", flight_addr_key(int(rank)), addr.encode())
    return addr


def fetch_flight_dump(addr: str, timeout: float = 3.0) -> Optional[dict]:
    """GET one rank's ``/debug/flight`` (signed with the launch secret
    when one is set); None when unreachable/invalid.  Rides the hvd.net
    retry ladder so a transient fault doesn't turn a reachable rank's
    evidence into "unreachable" in a hang report."""
    import urllib.error
    import urllib.request
    from .. import net as _net
    from ..runner.rendezvous import sign_request
    req = urllib.request.Request(f"http://{addr}/debug/flight")
    sign_request(req, "GET", "debug", "flight")
    try:
        body = _net.request_bytes(req, timeout=timeout,
                                  name="debug.flight")
        return json.loads(body.decode("utf-8"))
    except (urllib.error.HTTPError, OSError, ValueError):
        return None
