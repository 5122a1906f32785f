"""The serving request plane — HTTP ingress + the continuous-batching
serving loop (port of horovod_tpu/serving/server.py).

Built on the same ``BackgroundHTTPServer`` scaffold as the rendezvous
server (``runner/rendezvous.py``).  Endpoints::

    GET  /serve/healthz     liveness + identity (unsigned)
    GET  /serve/stats       engine + queue stats (signed)
    POST /serve/generate    one generation request (signed); JSON body
                            {"tokens": [...], "max_new_tokens": N,
                             "stream": bool, "tenant", "priority",
                             "deadline_s", "temperature", "seed",
                             "eos_id"}

``/serve/generate`` is HMAC-gated with ``HVD_TPU_SERVING_SECRET`` under
the rendezvous signature scheme (method + scope + path + body — a
captured signature authorizes nothing else).  The admission queue is
BOUNDED (``HVD_TPU_SERVING_QUEUE_CAP``): a request arriving over the cap
is shed loudly at ingress with a 503 before it is ever enqueued, and a
queued request whose TTFT deadline lapses is shed by the policy
(``policy.py``) with the same 503 shape.  Streamed responses are
newline-delimited JSON, one object per token, closed by a
``{"done": true}`` record.

One daemon loop thread drives the engine: every iteration it asks the
pure policy for decisions over the current queue, executes the admits
and sheds, runs one engine step, and routes the resulting events to the
per-request response queues the handler threads block on.
"""

from __future__ import annotations

import json
import queue as _queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from ..runner.rendezvous import BackgroundHTTPServer, _signature
from . import policy as P
from . import tracing as _tracing
from ..core import config as _config
from .engine import (DecodeEngine, Request, log, record_request,
                     record_shed, set_queue_depth)
from .slo import SloTracker

SERVICE_NAME = "horovod_tpu_serving"

# The reference's TTFT histogram buckets (seconds): arrival to first
# token, request-plane queueing included.
TTFT_BUCKETS = (0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0, 60.0)


class _ServeHandler(BaseHTTPRequestHandler):
    server_version = "hvd_tpu_serving"

    def log_message(self, fmt, *args):  # silence request logging
        pass

    def _key(self) -> Optional[str]:
        parts = self.path.partition("?")[0].strip("/").split("/")
        if not parts or parts[0] != "serve":
            return None
        return "/".join(parts[1:])

    def _authorized(self, method: str, key: str, body: bytes = b"") -> bool:
        secret = self.server.serving.secret  # type: ignore[attr-defined]
        if not secret:
            return True
        import hmac
        provided = self.headers.get("X-HVD-Signature", "")
        return hmac.compare_digest(
            provided, _signature(secret, method, "serve", key, body))

    def _send(self, code: int, payload) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        sv = self.server.serving  # type: ignore[attr-defined]
        key = self._key()
        if key is None:
            return self._send(404, {"error": "not found"})
        if key == "healthz":
            health = sv.loop_health()
            return self._send(200, {
                "service": SERVICE_NAME, "ok": not health["stalled"],
                "slots": sv.engine.slots,
                "active": sv.engine.active(),
                "queue_depth": sv.queue_depth(),
                "params_tag": str(sv.engine.params_tag),
                "last_iteration_age_s": health["last_iteration_age_s"],
                "loop_stalled": health["stalled"],
            })
        if not self._authorized("GET", key):
            return self._send(403, {"error": "bad or missing signature"})
        if key == "stats":
            stats = dict(sv.engine.stats())
            stats["queue_depth"] = sv.queue_depth()
            stats["continuous"] = sv.continuous
            health = sv.loop_health()
            stats["last_iteration_age_s"] = health["last_iteration_age_s"]
            stats["loop_stalled"] = health["stalled"]
            stats["slo"] = sv.slo.stats(time.monotonic())
            stats["ttft_exemplars"] = sv.ttft_exemplars()
            return self._send(200, stats)
        return self._send(404, {"error": "not found"})

    def do_POST(self):
        sv = self.server.serving  # type: ignore[attr-defined]
        key = self._key()
        if key != "generate":
            return self._send(404, {"error": "not found"})
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        if not self._authorized("POST", key, body):
            return self._send(403, {"error": "bad or missing signature"})
        try:
            req, stream, timeout_s = sv.parse_request(body, self.headers)
        except (ValueError, TypeError, KeyError) as e:
            return self._send(400, {"error": f"malformed request: {e}"})
        events: _queue.Queue = _queue.Queue()
        accepted = sv.submit(req, events)
        if not accepted:
            return self._send(503, {
                "error": "overloaded", "shed": "overload",
                "queue_depth": sv.queue_depth()})
        if stream:
            return self._stream(req, events, timeout_s)
        deadline = time.monotonic() + timeout_s
        toks: List[int] = []
        ttft = None
        while True:
            try:
                ev = events.get(timeout=max(0.05,
                                            deadline - time.monotonic()))
            except _queue.Empty:
                return self._send(504, {"error": "timed out", "id": req.id})
            if ev["kind"] == "shed":
                return self._send(503, {"error": "shed",
                                        "shed": ev["reason"],
                                        "id": req.id})
            if ev["kind"] == "token":
                toks.append(ev["token"])
                if ev.get("first"):
                    ttft = ev["ttft_s"]
            if ev["kind"] == "finish":
                return self._send(200, {
                    "id": req.id, "tokens": ev["tokens"],
                    "reason": ev["reason"], "ttft_s": ttft,
                    "trace": (req.trace.header()
                              if req.trace is not None else None),
                    "params_tag": str(sv.engine.params_tag)})

    def _stream(self, req: Request, events: _queue.Queue,
                timeout_s: float) -> None:
        # Newline-delimited JSON over a close-delimited HTTP/1.0 body:
        # one record per token as it decodes, then the done record.
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.end_headers()

        def _line(obj) -> bool:
            try:
                self.wfile.write((json.dumps(obj) + "\n").encode())
                self.wfile.flush()
                return True
            except OSError:
                return False     # client went away; the engine finishes

        deadline = time.monotonic() + timeout_s
        while True:
            try:
                ev = events.get(timeout=max(0.05,
                                            deadline - time.monotonic()))
            except _queue.Empty:
                _line({"error": "timed out", "id": req.id})
                return
            if ev["kind"] == "shed":
                _line({"error": "shed", "shed": ev["reason"],
                       "id": req.id})
                return
            if ev["kind"] == "token":
                if not _line({"token": ev["token"],
                              **({"ttft_s": ev["ttft_s"]}
                                 if ev.get("first") else {})}):
                    return
            if ev["kind"] == "finish":
                _line({"done": True, "id": req.id, "tokens": ev["tokens"],
                       "reason": ev["reason"],
                       "trace": (req.trace.header()
                                 if req.trace is not None else None),
                       "params_tag": str(sv_tag(self))})
                return


def sv_tag(handler) -> str:
    return str(handler.server.serving.engine.params_tag)


class _ServeHTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr, serving: "ServingServer"):
        super().__init__(addr, _ServeHandler)
        self.serving = serving


class ServingServer(BackgroundHTTPServer):
    """HTTP plane + serving loop around one :class:`DecodeEngine`."""

    def __init__(self, engine: DecodeEngine, port: Optional[int] = None,
                 host: str = "0.0.0.0", secret: Optional[str] = None,
                 queue_cap: Optional[int] = None,
                 continuous: bool = True, tick_s: float = 0.02):
        if port is None:
            port = _config.serving_port()
        if secret is None:
            secret = _config.serving_secret()
        self.engine = engine
        self.secret = secret
        # Clamped as the knob is: a cap of 0 would 503 every
        # request at ingress — a total outage from a typo'd knob.
        self.queue_cap = max(1, int(
            queue_cap if queue_cap is not None else
            _config.serving_queue_cap()))
        self.continuous = continuous
        self._tick_s = tick_s
        # Policy planes for the plan() call: page-reservation aging
        # and the per-plan prefill admission budget (the latter mirrors
        # the engine's per-iteration chunk budget — one knob, two
        # enforcement points).
        self.aging_s = _config.serving_aging_s()
        self.prefill_budget = max(0, getattr(
            engine, "prefill_chunk", 0))
        # Per-tenant SLO error budgets: a request's first token is a
        # good/bad event against its deadline (or the replica-wide
        # SERVING_SLO_TTFT_S target); sheds always count bad.  The
        # burn-rate dict feeds policy.plan and the autoscaler.
        self.slo = SloTracker()
        self.slo_ttft_s = _config.serving_slo_ttft_s()
        # Plan-decision dedup for trace spans: a queued request is
        # re-planned every tick — emit a span only when its decision
        # (or reason) changes, so a long wait is one span, not one per
        # tick.
        self._plan_last: Dict[str, tuple] = {}
        self._last_iter_mono = time.monotonic()
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._queued: List[Request] = []
        self._events: Dict[str, _queue.Queue] = {}
        self._seq = 0
        self._stop = threading.Event()
        self._loop_thread: Optional[threading.Thread] = None
        super().__init__(_ServeHTTPServer((host, port), self))

    # -- lifecycle ---------------------------------------------------------

    def serve(self) -> int:
        port = self.start()
        self._stop.clear()
        self._loop_thread = threading.Thread(
            target=self._loop, name="hvd-tpu-serving-loop", daemon=True)
        self._loop_thread.start()
        return port

    def close(self) -> None:
        self._stop.set()
        with self._wake:
            self._wake.notify_all()
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=10)
            self._loop_thread = None
        self.stop()

    # -- ingress -----------------------------------------------------------

    def parse_request(self, body: bytes, headers=None):
        """Parse one /serve/generate body into (Request, stream,
        timeout_s); raises ValueError on malformed input.  ``headers``
        (when given) is consulted for the ``x-hvd-trace`` propagation
        header — a client-supplied context wins over local minting."""
        d = json.loads(body.decode())
        toks = d.get("tokens")
        if (not isinstance(toks, list) or not toks
                or not all(isinstance(t, int) for t in toks)):
            raise ValueError("'tokens' must be a non-empty int list")
        with self._lock:
            self._seq += 1
            seq = self._seq
        req = Request(
            id=d.get("id") or f"req{seq:08d}",
            prompt=[int(t) for t in toks],
            max_new_tokens=int(d.get("max_new_tokens")
                               or _config.serving_max_new_tokens()),
            eos_id=(None if d.get("eos_id") is None
                    else int(d["eos_id"])),
            tenant=str(d.get("tenant") or "default"),
            priority=int(d.get("priority") or 0),
            deadline_s=float(d.get("deadline_s") or 0.0),
            temperature=float(d.get("temperature") or 0.0),
            seed=int(d.get("seed") or 0),
            arrival_mono=time.monotonic(),
            submit_seq=seq)
        req.trace = _tracing.mint(
            req.id, header=(headers.get(_tracing.HEADER)
                            if headers is not None else None))
        _tracing.span(req.trace, "ingress", request=req.id,
                      tenant=req.tenant, prompt=len(req.prompt),
                      queue_depth=self.queue_depth())
        if req.pages_needed(self.engine.page_tokens) \
                > self.engine.pages_per_slot:
            raise ValueError(
                f"prompt + output budget ({len(req.prompt)} + "
                f"{req.max_new_tokens} tokens) exceeds the slot "
                f"context ({self.engine.max_len})")
        return req, bool(d.get("stream")), float(d.get("timeout_s")
                                                 or 120.0)

    def submit(self, req: Request, events: _queue.Queue) -> bool:
        """Bounded admission: False (and a loud shed) over the cap."""
        record_request(req.tenant)
        with self._wake:
            if len(self._queued) >= self.queue_cap:
                record_shed(req.id, req.tenant, "overload")
                return False
            if req.id in self._events:
                # A client retry reusing its id must not collide with
                # the in-flight original: two identical ids would cross
                # their response queues and the loop's id-keyed
                # bookkeeping.  Uniquify; the response carries the
                # rewritten id.
                req.id = f"{req.id}.{req.submit_seq}"
            self._queued.append(req)
            self._events[req.id] = events
            set_queue_depth(len(self._queued))
            self._wake.notify_all()
        return True

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queued)

    def loop_health(self) -> Dict[str, object]:
        """Serving-loop liveness: seconds since the loop last completed
        an iteration, and whether that age says "wedged" rather than
        "idle" (an idle loop still iterates every tick)."""
        age = time.monotonic() - self._last_iter_mono
        running = (self._loop_thread is not None
                   and self._loop_thread.is_alive())
        stalled = bool(running and age > max(1.0, 20 * self._tick_s))
        return {"last_iteration_age_s": round(age, 4),
                "stalled": stalled}

    def ttft_exemplars(self) -> Dict[str, Dict[str, object]]:
        """The newest sampled request's trace id in each TTFT bucket
        (upper bound in seconds) — the tail-latency breadcrumbs
        ``/serve/stats`` surfaces."""
        out: Dict[str, Dict[str, object]] = {}
        for ttft, trace_id in list(self.engine.ttft_samples):
            if trace_id is None:
                continue
            le = next((b for b in TTFT_BUCKETS if ttft <= b), "+Inf")
            out[str(le)] = {"trace_id": trace_id, "value": ttft}
        return out

    # -- the serving loop --------------------------------------------------

    def _emit(self, req_id: str, payload: dict, final: bool) -> None:
        q = self._events.get(req_id)
        if q is not None:
            q.put(payload)
            if final:
                self._events.pop(req_id, None)

    def _loop(self) -> None:
        t0 = time.monotonic()
        while not self._stop.is_set():
            try:
                self._tick(t0)
            except Exception as e:  # noqa: BLE001 — the loop must
                # survive: a dead loop is a silent outage behind a
                # healthy-looking /serve/healthz.
                log.warning("serving loop iteration failed: %r", e)
                time.sleep(self._tick_s)
            self._last_iter_mono = time.monotonic()

    def _tick(self, t0: float) -> None:
        with self._wake:
            queued = list(self._queued)
            if not queued and self.engine.active() == 0:
                # Idle is still "between decode iterations": a parked
                # weight swap applies so a drained replica advances
                # (healthz shows the live step).
                self.engine.maybe_swap()
                self._wake.wait(timeout=self._tick_s)
                return
        now = time.monotonic() - t0
        free = self.engine.free_slots()
        if not self.continuous and self.engine.active() > 0:
            free = 0
        views = [P.RequestView(
            id=r.id, tenant=r.tenant, priority=r.priority,
            submit_seq=r.submit_seq, arrival_s=r.arrival_mono - t0,
            deadline_s=r.deadline_s,
            pages_needed=r.pages_needed(self.engine.page_tokens),
            prompt_tokens=len(r.prompt))
            for r in queued]
        now_abs = time.monotonic()
        decisions = P.plan(
            views, free, self.engine.free_pages(), now_s=now,
            running=self.engine.running_by_tenant(),
            queue_cap=self.queue_cap,
            slot_pages=min(self.engine.pages_per_slot,
                           self.engine.total_pages),
            aging_s=self.aging_s,
            prefill_budget=self.prefill_budget,
            burn=self.slo.burn_rates(now_abs),
            burn_threshold=self.slo.burn_threshold)
        by_id = {r.id: r for r in queued}
        events = []
        for d in decisions:
            req = by_id.get(d[1])
            if req is not None and req.trace is not None \
                    and req.trace.sampled:
                key = (d[0], d[2] if len(d) > 2 else "")
                if self._plan_last.get(req.id) != key:
                    self._plan_last[req.id] = key
                    _tracing.span(req.trace, "plan", decision=d[0],
                                  reason=key[1], request=req.id)
        for d in decisions:
            if d[0] == "admit":
                req = by_id[d[1]]
                with self._lock:
                    self._queued.remove(req)
                self._plan_last.pop(req.id, None)
                events.extend(self.engine.admit(req))
            elif d[0] == "shed":
                req = by_id[d[1]]
                with self._lock:
                    self._queued.remove(req)
                self._plan_last.pop(req.id, None)
                record_shed(req.id, req.tenant, d[2])
                _tracing.span(req.trace, "shed", reason=d[2],
                              tenant=req.tenant)
                self.slo.record(req.tenant, False, now_abs,
                                trace_id=(req.trace.trace_id
                                          if req.trace is not None
                                          else None))
                self._emit(req.id, {"kind": "shed", "reason": d[2]},
                           final=True)
        with self._lock:
            set_queue_depth(len(self._queued))
        events.extend(self.engine.step())
        now_mono = time.monotonic()
        for ev in events:
            if ev.kind == "token":
                payload = {"kind": "token", "token": ev.token}
                if ev.first:
                    payload["first"] = True
                    ttft = (now_mono - ev.request.arrival_mono
                            if ev.request.arrival_mono else None)
                    payload["ttft_s"] = ttft
                    # First token = the SLO moment: good when it beat
                    # the request's own deadline (or the replica-wide
                    # TTFT target; no target at all = always good).
                    target = (ev.request.deadline_s
                              or self.slo_ttft_s or 0.0)
                    ok = ttft is None or target <= 0.0 or ttft <= target
                    self.slo.record(
                        ev.request.tenant, ok, now_mono,
                        trace_id=(ev.request.trace.trace_id
                                  if ev.request.trace is not None
                                  else None))
                self._emit(ev.request.id, payload, final=False)
            else:
                self._emit(ev.request.id,
                           {"kind": "finish", "tokens": ev.tokens,
                            "reason": ev.reason}, final=True)
