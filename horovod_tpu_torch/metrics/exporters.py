"""Exporters: Prometheus text format over HTTP, and a rotating JSONL sink
(port of horovod_tpu/metrics/exporters.py).

Two consumption paths for the same registry:

* **Prometheus scrape** — :func:`render_prometheus` emits the text
  exposition format (v0.0.4), byte for byte as the reference renders it;
  :class:`MetricsServer` serves it at ``/metrics`` from a daemon thread on
  the port's ``runner.rendezvous.BackgroundHTTPServer``.  ``/healthz``
  answers 200 for liveness probes.  The debug routes of
  ``debug/http.py`` (``/debug/flight``, ``/debug/regression``,
  ``/debug/stacks``, ``/debug/autotune``, ``/debug/fleet_scalars``) are
  mounted here too, behind the same HMAC gate, and so are the host
  observer's ``/observe/{digest,fleet,dumps}`` (``observer.py``; 404
  when no observer runs in this process).
* **Offline analysis** — :class:`JsonlSink` appends one JSON object per
  ``write`` with size-based rotation and retention pruning.

``init()`` starts a server when ``HVD_TPU_METRICS_PORT`` is set
(core/basics.py) and ``shutdown()`` stops it; programmatic use goes
through :func:`serve`.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .registry import MetricsRegistry, registry as _default_registry

_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n") \
               .replace('"', '\\"')


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_labels(labels, extra=None) -> str:
    parts = [f'{k}="{_escape_label(str(v))}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def render_prometheus(reg: Optional[MetricsRegistry] = None) -> str:
    """The registry as Prometheus text exposition (name-sorted, series
    label-sorted — deterministic, so goldens can compare exactly).
    Iterates a ``collect()`` snapshot, never the live children dicts:
    a scrape races instrument creation (new label children appear from
    the native background thread mid-render) and a live dict iteration
    would raise mid-response."""
    reg = reg or _default_registry()
    lines = []
    for fam, children in reg.collect():
        if fam.help:
            lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for key, child in children:
            if fam.kind == "histogram":
                cum = child.cumulative_counts()
                for bound, c in zip(child.buckets, cum):
                    le = f'le="{_fmt_value(bound)}"'
                    lines.append(f"{fam.name}_bucket"
                                 f"{_fmt_labels(key, le)} {c}")
                inf = 'le="+Inf"'
                lines.append(f"{fam.name}_bucket{_fmt_labels(key, inf)} "
                             f"{cum[-1]}")
                lines.append(f"{fam.name}_sum{_fmt_labels(key)} "
                             f"{_fmt_value(child.sum)}")
                lines.append(f"{fam.name}_count{_fmt_labels(key)} "
                             f"{child.count}")
            else:
                lines.append(f"{fam.name}{_fmt_labels(key)} "
                             f"{_fmt_value(child.value)}")
    return "\n".join(lines) + ("\n" if lines else "")


class _MetricsHandler(BaseHTTPRequestHandler):
    server_version = "hvd_tpu_metrics"

    def log_message(self, fmt, *args):  # silence request logging
        pass

    def do_GET(self):
        path = self.path.split("?", 1)[0]
        if path in ("/metrics", "/"):
            body = render_prometheus(
                self.server.registry).encode("utf-8")  # type: ignore
            self.send_response(200)
            self.send_header("Content-Type", _CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif path == "/healthz":
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"ok")
        elif path in ("/debug/flight", "/debug/regression",
                      "/debug/stacks", "/debug/autotune",
                      "/debug/fleet_scalars"):
            # The metrics port doubles as a debug surface: one scrape
            # endpoint per host already exists, so the flight dump, the
            # last regression report, all-thread stacks, the autotune
            # loop status and the fleet-scalars view ride it instead of
            # demanding a second port (debug/http.py serves the same
            # handlers standalone — and the same HMAC gate applies on
            # BOTH mounts, or setting the launch secret would protect
            # one copy of the paths while this one stayed open).
            from ..debug.http import (render_autotune_json,
                                      render_fleet_scalars_json,
                                      render_flight_json,
                                      render_regression_json,
                                      render_stacks_text,
                                      request_authorized)
            key = path.rsplit("/", 1)[1]
            if not request_authorized(self.headers, key):
                self.send_response(403)
                self.end_headers()
                return
            code = 200
            if path == "/debug/flight":
                body, ctype = render_flight_json(), "application/json"
            elif path == "/debug/regression":
                body, ctype = render_regression_json(), "application/json"
                if body is None:
                    body = b'{"error": "no regression report yet"}'
                    code = 404
            elif path == "/debug/autotune":
                body, ctype = render_autotune_json(), "application/json"
                if body is None:
                    body = b'{"error": "no active tuner in this process"}'
                    code = 404
            elif path == "/debug/fleet_scalars":
                body, ctype = (render_fleet_scalars_json(),
                               "application/json")
            else:
                body, ctype = (render_stacks_text(),
                               "text/plain; charset=utf-8")
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif path.startswith("/observe/"):
            # The host observer's surface also answers on the metrics
            # port (one host, one serving slot — both are rank-gated to
            # local rank 0): /observe/digest, /observe/fleet,
            # /observe/dumps.  404 when no observer runs here.
            from .observer import current_observer, handle_observe_get
            code, body, ctype = handle_observe_get(
                current_observer(), self.path, self.headers)
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self.send_response(404)
            self.end_headers()


class _MetricsHTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr, reg: MetricsRegistry):
        super().__init__(addr, _MetricsHandler)
        self.registry = reg


class MetricsServer:
    """Prometheus scrape endpoint on a background daemon thread."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0,
                 reg: Optional[MetricsRegistry] = None):
        # Late import: the scaffold is stdlib-only, like this module.
        from ..runner.rendezvous import BackgroundHTTPServer
        self._impl = BackgroundHTTPServer(
            _MetricsHTTPServer((host, port), reg or _default_registry()))

    @property
    def port(self) -> int:
        return self._impl.port

    def start(self) -> int:
        return self._impl.start()

    def stop(self) -> None:
        self._impl.stop()


_serve_lock = threading.Lock()
_server: Optional[MetricsServer] = None


def serve(port: int = 0, host: str = "0.0.0.0",
          reg: Optional[MetricsRegistry] = None) -> MetricsServer:
    """Start (or return the already-running) module-level scrape
    endpoint.  Idempotent, so a second ``init()`` does not rebind the
    port."""
    global _server
    with _serve_lock:
        if _server is None:
            s = MetricsServer(host=host, port=port, reg=reg)
            s.start()
            _server = s
        return _server


def stop_serving() -> None:
    global _server
    with _serve_lock:
        if _server is not None:
            _server.stop()
            _server = None


class JsonlSink:
    """Rotating JSONL writer for offline metric analysis.

    ``write(obj)`` appends one compact JSON line.  When the file would
    exceed ``max_bytes`` it rotates: ``path`` → ``path.1`` → ... →
    ``path.<backups>`` (oldest dropped).  Each write opens/closes the
    file — this is the offline sink, not a hot path, and it keeps
    rotation trivially correct.

    ``backups`` defaults to the ``HVD_TPU_METRICS_RETAIN_FILES`` knob
    (3 when unset); a sink prunes down to it on construction, so stale
    ``path.<N>`` backups from an earlier looser setting cannot
    accumulate."""

    def __init__(self, path: str, max_bytes: int = 4 << 20,
                 backups: Optional[int] = None):
        from ..core import config as _config
        self.path = path
        self.max_bytes = int(max_bytes)
        if backups is None:
            backups = _config.get_int_or(
                _config.METRICS_RETAIN_FILES,
                _config.TELEMETRY.metrics_retain_files)
        self.backups = max(int(backups), 1)
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._prune()

    def _prune(self) -> None:
        """Drop rotated backups beyond the current retention — covers a
        sink re-created with a tighter ``backups`` over files a looser
        predecessor left behind."""
        i = self.backups + 1
        while os.path.exists(f"{self.path}.{i}"):
            try:
                os.unlink(f"{self.path}.{i}")
            except OSError:
                break
            i += 1

    def _rotate(self) -> None:
        oldest = f"{self.path}.{self.backups}"
        if os.path.exists(oldest):
            os.unlink(oldest)
        for i in range(self.backups - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.rename(src, f"{self.path}.{i + 1}")
        if os.path.exists(self.path):
            os.rename(self.path, f"{self.path}.1")

    def write(self, obj) -> None:
        line = json.dumps(obj, sort_keys=True,
                          separators=(",", ":")) + "\n"
        with self._lock:
            try:
                size = os.path.getsize(self.path)
            except OSError:
                size = 0
            if size and size + len(line) > self.max_bytes:
                self._rotate()
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(line)

    def write_snapshot(self, reg: Optional[MetricsRegistry] = None,
                       **extra) -> None:
        """Convenience: one line = {ts-free extras + registry scalars}
        (caller stamps times/steps via ``extra`` so replays stay
        deterministic)."""
        reg = reg or _default_registry()
        payload = dict(extra)
        payload["metrics"] = reg.scalars()
        self.write(payload)
