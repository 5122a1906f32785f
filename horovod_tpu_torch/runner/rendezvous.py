"""The request signature and the background HTTP server of
horovod_tpu/runner/rendezvous.py (:43-48, :211-239), which the serving
plane's request plane is built on.  The rendezvous KV server itself comes
with the launcher."""

from __future__ import annotations

import hashlib
import hmac as _hmac
import threading
from http.server import ThreadingHTTPServer
from typing import Optional

_SIG_HEADER = "X-HVD-Signature"


def _signature(secret: str, method: str, scope: str, key: str,
               body: bytes = b"") -> str:
    """HMAC-SHA256 over method, scope/key and the body: a captured
    signature authorizes nothing else."""
    mac = _hmac.new(secret.encode(), digestmod=hashlib.sha256)
    mac.update(f"{method}\n{scope}/{key}\n".encode())
    mac.update(body)
    return mac.hexdigest()


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
