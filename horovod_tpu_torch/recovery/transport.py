"""Replica transport (port of horovod_tpu/recovery/transport.py): a
rank's HTTP endpoint on the ``BackgroundHTTPServer`` scaffold, published
in the rendezvous KV as ``recovery/replica_addr_<rank>``.

* ``PUT /recovery/replica`` — receive a buddy's pushed payload (the body
  is :func:`store.entry_to_bytes`).
* ``PUT /recovery/seal/<key>/<step>`` — the owner's commit-completed
  marker for its pushed payloads (two-phase: an entry is served only
  once sealed).
* ``GET /recovery/replica/<key>/<rank>`` — a sealed entry (tooling and
  targeted fetches; the peer restore gathers over the collective plane).
* ``PUT`` / ``GET /recovery/kv/<key>`` — a one-shot mailbox for the
  serving plane's KV-page bundles: the GET pops (a bundle is adopted
  once) and the mailbox holds at most :data:`_KV_MAILBOX_CAP` bundles,
  dropping the oldest loudly.
* ``GET /healthz`` — liveness.

Requests are HMAC-gated with the launch secret
(``runner.rendezvous.request_authorized``: method, resource and body
signed), since replica payloads are raw optimizer state.  The
slow-peer chaos knob (``HVD_TPU_CHAOS_SLOW_PEER_MS``) sleeps in the
handlers, so drills take the path a congested host would.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

# Direct-name imports: the package exports a ``store()`` accessor that
# shadows the submodule attribute.
from .chaos import chaos
from .store import ReplicaEntry, entry_from_bytes, entry_to_bytes
from .store import store as _store

_SCOPE = "recovery"

# KV-migration mailbox, in insertion order, so an overflow drops the
# oldest bundle (its producer retries or times out loudly).
_KV_MAILBOX_CAP = 64
_kv_mailbox: "dict[str, bytes]" = {}
_kv_lock = threading.Lock()


def _authorized(headers, method: str, key: str,
                body: bytes = b"") -> bool:
    """``key`` is the whole resource path after the scope and ``body``
    the payload: both are signed, so a captured signature authorizes one
    request only."""
    from ..runner.rendezvous import request_authorized
    return request_authorized(headers, method, _SCOPE, key, body)


def _sign(req, method: str, key: str, body: bytes = b"") -> None:
    from ..runner.rendezvous import sign_request
    sign_request(req, method, _SCOPE, key, body)


class _RecoveryHandler(BaseHTTPRequestHandler):
    server_version = "hvd_tpu_recovery"

    def log_message(self, fmt, *args):  # no request logging
        pass

    def _send(self, code: int, body: bytes = b"",
              ctype: str = "application/octet-stream"):
        self.send_response(code)
        if body:
            self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _body(self) -> bytes:
        return self.rfile.read(int(self.headers.get("Content-Length", 0)))

    def do_PUT(self):
        parts = self.path.strip("/").split("/")
        chaos().slow_peer()
        if parts[:2] == [_SCOPE, "replica"] and len(parts) == 2:
            payload = self._body()
            if not _authorized(self.headers, "PUT", "replica", payload):
                return self._send(403)
            try:
                entry = entry_from_bytes(payload)
            except Exception:  # noqa: BLE001 — a torn PUT answers 400
                return self._send(400)
            _store().put_held(entry)
            return self._send(200)
        if parts[:2] == [_SCOPE, "seal"] and len(parts) == 4:
            if not _authorized(self.headers, "PUT", "/".join(parts[1:])):
                return self._send(403)
            try:
                _store().seal(parts[2], int(parts[3]))
            except ValueError:
                return self._send(400)
            return self._send(200)
        if parts[:2] == [_SCOPE, "kv"] and len(parts) == 3:
            payload = self._body()
            if not _authorized(self.headers, "PUT", f"kv/{parts[2]}",
                               payload):
                return self._send(403)
            with _kv_lock:
                while len(_kv_mailbox) >= _KV_MAILBOX_CAP:
                    dropped = next(iter(_kv_mailbox))
                    del _kv_mailbox[dropped]
                    from ..utils import logging as log
                    log.warning("recovery: kv mailbox full — dropped "
                                "oldest bundle %s", dropped)
                _kv_mailbox[parts[2]] = payload
            return self._send(200)
        self._send(404)

    def do_GET(self):
        parts = self.path.strip("/").split("/")
        if parts == ["healthz"]:
            return self._send(200, b"ok", ctype="text/plain")
        chaos().slow_peer()
        if parts[:2] == [_SCOPE, "replica"] and len(parts) == 4:
            if not _authorized(self.headers, "GET", "/".join(parts[1:])):
                return self._send(403)
            try:
                entry = _store().get(parts[2], int(parts[3]))
            except ValueError:
                return self._send(400)
            if entry is None or not entry.sealed:
                return self._send(404)
            return self._send(200, entry_to_bytes(entry))
        if parts[:2] == [_SCOPE, "kv"] and len(parts) == 3:
            if not _authorized(self.headers, "GET", f"kv/{parts[2]}"):
                return self._send(403)
            with _kv_lock:
                blob = _kv_mailbox.pop(parts[2], None)
            if blob is None:
                return self._send(404)
            return self._send(200, blob)
        self._send(404)


class _RecoveryHTTPServer(ThreadingHTTPServer):
    daemon_threads = True


class RecoveryServer:
    """The replica endpoints on a background daemon thread."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        from ..runner.rendezvous import BackgroundHTTPServer
        self._impl = BackgroundHTTPServer(
            _RecoveryHTTPServer((host, port), _RecoveryHandler))

    @property
    def port(self) -> int:
        return self._impl.port

    def start(self) -> int:
        return self._impl.start()

    def stop(self) -> None:
        self._impl.stop()


_serve_lock = threading.Lock()
_server: Optional[RecoveryServer] = None


def serve(port: int = 0, host: str = "0.0.0.0") -> RecoveryServer:
    """Start (or return) this process's replica endpoint: one server
    across elastic re-inits."""
    global _server
    with _serve_lock:
        if _server is None:
            s = RecoveryServer(host=host, port=port)
            s.start()
            _server = s
        return _server


def stop_serving() -> None:
    global _server
    with _serve_lock:
        if _server is not None:
            _server.stop()
            _server = None


def replica_addr_key(rank: int) -> str:
    return f"replica_addr_{int(rank)}"


def serve_and_publish(rank: int, rdv_addr: Optional[str] = None,
                      port: int = 0) -> Optional[str]:
    """Start the replica endpoint and publish its ``host:port`` under
    ``recovery/replica_addr_<rank>`` in the rendezvous KV (``rdv_addr``,
    else ``HVD_TPU_RENDEZVOUS_ADDR``).  Returns the published address,
    None when no rendezvous address is known."""
    rdv_addr = rdv_addr or os.environ.get("HVD_TPU_RENDEZVOUS_ADDR")
    s = serve(port=port)
    if rdv_addr is None:
        return None
    from ..runner.rendezvous import advertised_host, http_put
    addr = f"{advertised_host()}:{s.port}"
    http_put(rdv_addr, _SCOPE, replica_addr_key(rank), addr.encode())
    return addr


def lookup_addr(rank: int, rdv_addr: Optional[str] = None,
                timeout: float = 3.0) -> Optional[str]:
    """A rank's published replica endpoint, through ``net.poll_kv``
    (a transient rendezvous fault inside a commit window retries);
    None when unknown within ``timeout`` or refused."""
    rdv_addr = rdv_addr or os.environ.get("HVD_TPU_RENDEZVOUS_ADDR")
    if not rdv_addr:
        return None
    from .. import net as _net
    try:
        raw = _net.poll_kv(rdv_addr, _SCOPE, replica_addr_key(rank),
                           deadline_s=timeout, interval_s=0.2,
                           timeout_s=timeout)
    except (_net.DeadlineExceeded, PermissionError):
        return None
    return raw.decode() if raw else None


def _push_retry_policy():
    """A push gets one bounded retry inside the commit window: a
    transient fault must not leave a rank uncovered until the next
    commit, and the commit's latency cannot absorb a long ladder."""
    from .. import net as _net
    return dataclasses.replace(_net.Policy.from_env(), attempts=2)


def _request(addr: str, path: str, method: str, sig_key: str,
             body: Optional[bytes] = None, timeout: float = 5.0) -> bool:
    import urllib.request
    from .. import net as _net
    from ..metrics.registry import registry as _reg
    req = urllib.request.Request(f"http://{addr}{path}", data=body,
                                 method=method)
    _sign(req, method, sig_key, body or b"")
    attempts = {"n": 0}

    def run() -> bytes:
        attempts["n"] += 1
        return _net.request_bytes(
            req, timeout=timeout, name=f"recovery.{method.lower()}",
            policy=_net.Policy(attempts=1))

    try:
        _net.retry_call(run, policy=_push_retry_policy(),
                        name=f"recovery.{sig_key}")
        if attempts["n"] > 1:
            _reg().counter(
                "hvd_recovery_push_retries_total",
                "Replica pushes that succeeded only on a retry").inc()
        return True
    except OSError:
        return False


def push_replica(addr: str, entry: ReplicaEntry,
                 timeout: float = 5.0) -> bool:
    """PUT one payload to a buddy's replica endpoint; False when it never
    arrived (one bounded retry first, counted in
    ``hvd_recovery_push_retries_total`` when it saved the push)."""
    return _request(addr, f"/{_SCOPE}/replica", "PUT", "replica",
                    body=entry_to_bytes(entry), timeout=timeout)


def push_seal(addr: str, key: str, step: int,
              timeout: float = 5.0) -> bool:
    return _request(addr, f"/{_SCOPE}/seal/{key}/{int(step)}", "PUT",
                    f"seal/{key}/{int(step)}", body=b"",
                    timeout=timeout)


def fetch_replica(addr: str, key: str, rank: int,
                  timeout: float = 5.0) -> Optional[ReplicaEntry]:
    """GET one sealed entry from a peer's endpoint; None when absent or
    unreachable.  Transport faults ride the retry ladder; a 404 does
    not."""
    import urllib.error
    import urllib.request
    from .. import net as _net
    req = urllib.request.Request(
        f"http://{addr}/{_SCOPE}/replica/{key}/{int(rank)}")
    _sign(req, "GET", f"replica/{key}/{int(rank)}")
    try:
        body = _net.request_bytes(req, timeout=timeout,
                                  name="recovery.fetch")
        return entry_from_bytes(body)
    except (urllib.error.HTTPError, OSError, ValueError):
        return None


def push_kv(addr: str, key: str, blob: bytes,
            timeout: float = 10.0) -> bool:
    """PUT one KV-page bundle into a peer's one-shot mailbox, on the
    signed request and bounded retry of the replica pushes."""
    return _request(addr, f"/{_SCOPE}/kv/{key}", "PUT", f"kv/{key}",
                    body=blob, timeout=timeout)


def fetch_kv(addr: str, key: str,
             timeout: float = 10.0) -> Optional[bytes]:
    """GET (and consume: the server pops) one KV-page bundle; None when
    absent or unreachable."""
    import urllib.error
    import urllib.request
    from .. import net as _net
    req = urllib.request.Request(f"http://{addr}/{_SCOPE}/kv/{key}")
    _sign(req, "GET", f"kv/{key}")
    try:
        return _net.request_bytes(req, timeout=timeout,
                                  name="recovery.fetch_kv")
    except (urllib.error.HTTPError, OSError):
        return None
