"""The HTTP key-value rendezvous server and its clients (port of
horovod_tpu/runner/rendezvous.py).

A threaded HTTP server exposing PUT/GET/DELETE of scoped keys
(``/scope/key``) and the listing of a scope (``GET /scope/``): what
workers poll for the controller's address and what the recovery tier
publishes its replica endpoints in.  GET on a missing key answers 404
(clients poll).

Requests are HMAC-SHA256-signed with a per-launch secret over the
method, the resource and the body (the reference Horovod signs its RPC
messages the same way): without it anyone on the network could rewrite
an address.  The launcher exports the secret as
``HVD_TPU_RENDEZVOUS_SECRET``; a server created without one accepts
unsigned requests (loopback mode).  The signature is the serving plane's
request signature too, and ``BackgroundHTTPServer`` the scaffold of its
HTTP server and of the Prometheus endpoint.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import json
import os
import secrets as _secrets
import threading
import time as _time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

_SIG_HEADER = "X-HVD-Signature"

# The server's wall clock, answered at the virtual key ``debug/time`` (the
# reference point of the flight recorder's clock-offset estimate); a
# module attribute so tests can inject a skew.
_now_wall = _time.time

_AUTH_REFUSED = ("rendezvous server at {} rejected the request signature "
                 "(missing or wrong HVD_TPU_RENDEZVOUS_SECRET)")


def generate_secret() -> str:
    return _secrets.token_hex(16)


def _signature(secret: str, method: str, scope: str, key: str,
               body: bytes = b"") -> str:
    """HMAC-SHA256 over method, scope/key and the body: a captured
    signature authorizes nothing else."""
    mac = _hmac.new(secret.encode(), digestmod=hashlib.sha256)
    mac.update(f"{method}\n{scope}/{key}\n".encode())
    mac.update(body)
    return mac.hexdigest()


def _env_secret() -> Optional[str]:
    return os.environ.get("HVD_TPU_RENDEZVOUS_SECRET")


def advertised_host() -> str:
    """The host other members use to reach this process's auxiliary HTTP
    endpoints (the recovery replicas): ``HVD_TPU_FLIGHT_HOST`` when set,
    else the resolved hostname, loopback as the fallback."""
    import socket
    host = os.environ.get("HVD_TPU_FLIGHT_HOST")
    if host:
        return host
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def request_authorized(headers, method: str, scope: str, key: str,
                       body: bytes = b"") -> bool:
    """The HMAC gate of an auxiliary endpoint's request, signed with the
    launch secret under the KV server's scheme, body included.  Without
    a secret requests pass, as in the KV server's unsigned mode."""
    secret = _env_secret()
    if not secret:
        return True
    provided = headers.get(_SIG_HEADER, "")
    return _hmac.compare_digest(
        provided, _signature(secret, method, scope, key, body))


def sign_request(req, method: str, scope: str, key: str,
                 body: bytes = b"") -> None:
    """Stamp a ``urllib.request.Request`` with the launch secret's
    signature (nothing without a secret): the client half of
    :func:`request_authorized`."""
    secret = _env_secret()
    if secret:
        req.add_header(_SIG_HEADER,
                       _signature(secret, method, scope, key, body))


class _KVHandler(BaseHTTPRequestHandler):
    server_version = "hvd_tpu_rendezvous"

    def log_message(self, fmt, *args):  # no request logging
        pass

    def _split(self) -> Tuple[str, str]:
        stripped = self.path.strip("/")
        parts = stripped.split("/", 1)
        if len(parts) == 1:
            if stripped and self.path.endswith("/"):
                return parts[0], ""     # "/<scope>/": list the scope
            return "", parts[0]
        return parts[0], parts[1]

    def _verify(self, method: str, scope: str, key: str,
                body: bytes = b"") -> bool:
        secret = self.server.secret  # type: ignore[attr-defined]
        if not secret:
            return True
        provided = self.headers.get(_SIG_HEADER, "")
        return _hmac.compare_digest(
            provided, _signature(secret, method, scope, key, body))

    def _reply(self, code: int, body: Optional[bytes] = None,
               ctype: Optional[str] = None):
        self.send_response(code)
        if ctype:
            self.send_header("Content-Type", ctype)
        if body is not None:
            self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body is not None:
            self.wfile.write(body)

    def do_PUT(self):
        scope, key = self._split()
        length = int(self.headers.get("Content-Length", 0))
        value = self.rfile.read(length)
        if not self._verify("PUT", scope, key, value):
            return self._reply(403)
        self.server.store_put(scope, key, value)  # type: ignore[attr-defined]
        self._reply(200)

    def do_GET(self):
        scope, key = self._split()
        if not self._verify("GET", scope, key):
            return self._reply(403)
        if key == "":
            # The scope's keys as a JSON array (signed as a GET of the
            # empty key): how tooling discovers published endpoints.
            keys = self.server.store_keys(scope)  # type: ignore[attr-defined]
            return self._reply(200, json.dumps(keys).encode(),
                               "application/json")
        if scope == "debug" and key == "time":
            return self._reply(200, repr(_now_wall()).encode())
        value = self.server.store_get(scope, key)  # type: ignore[attr-defined]
        if value is None:
            return self._reply(404)
        self._reply(200, value)

    def do_DELETE(self):
        scope, key = self._split()
        if not self._verify("DELETE", scope, key):
            return self._reply(403)
        self.server.store_delete(scope, key)  # type: ignore[attr-defined]
        self._reply(200)


class _KVServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr, secret: Optional[str] = None):
        super().__init__(addr, _KVHandler)
        self.secret = secret
        self._store: Dict[Tuple[str, str], bytes] = {}
        self._lock = threading.Lock()

    def store_put(self, scope: str, key: str, value: bytes):
        with self._lock:
            self._store[(scope, key)] = value

    def store_get(self, scope: str, key: str) -> Optional[bytes]:
        with self._lock:
            return self._store.get((scope, key))

    def store_delete(self, scope: str, key: str):
        with self._lock:
            self._store.pop((scope, key), None)

    def store_keys(self, scope: str):
        with self._lock:
            return sorted(k for s, k in self._store if s == scope)


class BackgroundHTTPServer:
    """A ``ThreadingHTTPServer`` driven from a daemon thread.  Subclasses
    construct the server before calling ``start()``."""

    _server: ThreadingHTTPServer

    def __init__(self, server: ThreadingHTTPServer):
        self._server = server
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> int:
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self):
        # shutdown() blocks on serve_forever's exit handshake — calling
        # it on a server that was never start()ed would wait forever.
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join(timeout=5)
        self._server.server_close()


class RendezvousServer(BackgroundHTTPServer):
    """The KV server: ``start()`` returns its port, ``stop()`` closes it;
    ``put``/``get`` reach its store in-process."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0,
                 secret: Optional[str] = None):
        super().__init__(_KVServer((host, port), secret=secret))
        self.secret = secret

    def put(self, scope: str, key: str, value: bytes):
        self._server.store_put(scope, key, value)

    def get(self, scope: str, key: str) -> Optional[bytes]:
        return self._server.store_get(scope, key)


def _signed(addr: str, method: str, scope: str, key: str,
            secret: Optional[str], body: Optional[bytes] = None):
    import urllib.request
    req = urllib.request.Request(f"http://{addr}/{scope}/{key}", data=body,
                                 method=method)
    secret = secret or _env_secret()
    if secret:
        req.add_header(_SIG_HEADER,
                       _signature(secret, method, scope, key, body or b""))
    return req


def http_get(addr: str, scope: str, key: str, timeout: float = 5.0,
             secret: Optional[str] = None,
             policy=None) -> Optional[bytes]:
    """The value of ``scope/key``, or None when absent or unreachable once
    the retry budget is spent (callers poll).  Signs with ``secret`` or
    ``HVD_TPU_RENDEZVOUS_SECRET`` and rides rung 1 of the wire fabric
    (``net.request_bytes``).  A 403 raises ``PermissionError``: an
    authentication failure must not read as "not published yet"."""
    import urllib.error
    from .. import net as _net
    req = _signed(addr, "GET", scope, key, secret)
    try:
        return _net.request_bytes(req, timeout=timeout,
                                  name=f"kv.get.{scope}", policy=policy)
    except urllib.error.HTTPError as e:
        if e.code == 403:
            raise PermissionError(_AUTH_REFUSED.format(addr)) from e
        return None
    except OSError:
        return None


def http_list(addr: str, scope: str, timeout: float = 5.0,
              secret: Optional[str] = None) -> Optional[list]:
    """A scope's published keys, or None on failure."""
    raw = http_get(addr, scope, "", timeout=timeout, secret=secret)
    if raw is None:
        return None
    try:
        out = json.loads(raw.decode())
    except ValueError:
        return None
    return out if isinstance(out, list) else None


def http_delete(addr: str, scope: str, key: str, timeout: float = 5.0,
                secret: Optional[str] = None) -> bool:
    """Unpublish a key; best-effort (False on any failure, a refused
    signature included), as the reference's."""
    import urllib.error
    from .. import net as _net
    req = _signed(addr, "DELETE", scope, key, secret)
    try:
        _net.request_bytes(req, timeout=timeout,
                           name=f"kv.delete.{scope}")
        return True
    except (urllib.error.HTTPError, OSError):
        return False


def http_put(addr: str, scope: str, key: str, value: bytes,
             timeout: float = 5.0, secret: Optional[str] = None) -> bool:
    """Publish ``value`` under ``scope/key``; False when unreachable once
    the retry budget is spent, ``PermissionError`` on a 403."""
    import urllib.error
    from .. import net as _net
    req = _signed(addr, "PUT", scope, key, secret, body=value)
    try:
        _net.request_bytes(req, timeout=timeout, name=f"kv.put.{scope}")
        return True
    except urllib.error.HTTPError as e:
        if e.code == 403:
            raise PermissionError(_AUTH_REFUSED.format(addr)) from e
        return False
    except OSError:
        return False
