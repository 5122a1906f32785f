"""The fleet gateway (port of horovod_tpu/fleet/gateway.py) — an
always-on, multi-tenant job submission plane.  Its endpoints, signatures
and payloads are the reference's, so either package's client speaks to
either package's gateway.

Promoted from the rendezvous/metrics ``BackgroundHTTPServer`` scaffold
(``runner/rendezvous.py``): one HTTP server owns the fleet, tenants
submit jobs to it, and the :class:`.scheduler.Scheduler` multiplexes
them onto the device inventory.  Endpoints::

    GET    /fleet/healthz      liveness + identity (unsigned — this is
                               what ``hvdrun-torch`` probes to print the
                               "fleet mode is active" error)
    GET    /fleet/status       capacity + job counts
    POST   /fleet/jobs         submit a JobSpec (JSON body)
    GET    /fleet/jobs         list job records
    GET    /fleet/jobs/<id>    one job record
    DELETE /fleet/jobs/<id>    cancel (queued or running)
    GET    /fleet/tuning/<key> stored tuned config (tuning memory)
    PUT    /fleet/tuning/<key> persist a tuned config record
    POST   /fleet/observe/<job> ingest one host digest (fleet timeline)
    GET    /fleet/observe/<job> the job's retained series [?since=ts]
    GET    /fleet/observe      jobs with series + store stats
    GET    /fleet/metrics      fleet-wide Prometheus exposition
                               (unsigned, like every scrape endpoint)

All job endpoints are HMAC-gated with the fleet secret
(``HVD_TPU_FLEET_SECRET``) under the rendezvous KV's signature scheme —
method + path + body, so a captured signature authorizes nothing else.
Admission control runs at submit time: a spec whose ``min_np`` exceeds
the *healthy* capacity (inventory minus health-hint exclusions) is
recorded DENIED with a pointed reason instead of queueing forever.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

from ..runner.hosts import HostInfo
from ..runner.rendezvous import BackgroundHTTPServer, _signature
from .job import DENIED, PREEMPTED, QUEUED, RUNNING, JobSpec
from .queue import DurableJobQueue
from .scheduler import Scheduler

SERVICE_NAME = "horovod_tpu_fleet"


class _FleetHandler(BaseHTTPRequestHandler):
    server_version = "hvd_tpu_fleet"

    def log_message(self, fmt, *args):  # silence request logging
        pass

    # -- plumbing ----------------------------------------------------------

    def _key(self) -> Optional[str]:
        """The signature key: the path under /fleet/, query stripped
        (None = not ours).  Clients sign the bare key — a ``?since=``
        filter is a read refinement, not a distinct resource."""
        parts = self.path.partition("?")[0].strip("/").split("/")
        if not parts or parts[0] != "fleet":
            return None
        return "/".join(parts[1:])

    def _authorized(self, method: str, key: str, body: bytes = b"") -> bool:
        secret = self.server.gateway.secret  # type: ignore[attr-defined]
        if not secret:
            return True
        import hmac
        provided = self.headers.get("X-HVD-Signature", "")
        return hmac.compare_digest(
            provided, _signature(secret, method, "fleet", key, body))

    def _send(self, code: int, payload) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    # -- verbs -------------------------------------------------------------

    def do_GET(self):
        gw = self.server.gateway  # type: ignore[attr-defined]
        key = self._key()
        if key is None:
            return self._send(404, {"error": "not found"})
        if key == "healthz":
            # Unsigned on purpose: liveness probes and the launcher's
            # gateway detection must work without the tenant secret.
            return self._send(200, {
                "service": SERVICE_NAME, "ok": True,
                "jobs": len(gw.store.list()),
            })
        if key == "metrics":
            # Fleet-wide Prometheus exposition of the timeline's latest
            # sample per job — unsigned like every scrape endpoint in
            # this stack (scrapers cannot sign; only aggregates leave).
            body = gw.observe.render_prometheus().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if not self._authorized("GET", key):
            return self._send(403, {"error": "bad or missing signature"})
        if key == "status":
            records = gw.store.list()
            return self._send(200, {
                "service": SERVICE_NAME,
                "healthy_slots": gw.scheduler.healthy_slots(),
                "total_slots": sum(
                    h.slots for h in gw.scheduler.fleet_hosts()),
                "queued": sum(1 for r in records
                              if r.state in (QUEUED, PREEMPTED)),
                "running": gw.scheduler.running_count(),
                # Long-lived inference replicas currently seated
                # (JobSpec kind="service" — serving/service.py).
                "services": sum(1 for r in records
                                if r.spec.kind == "service"
                                and r.state == RUNNING),
            })
        if key == "jobs":
            return self._send(200, {
                "jobs": [r.to_dict() for r in gw.store.list()]})
        if key.startswith("jobs/"):
            rec = gw.store.get(key[len("jobs/"):])
            if rec is None:
                return self._send(404, {"error": "no such job"})
            return self._send(200, rec.to_dict())
        if key.startswith("tuning/"):
            # Tuning memory (fleet/tuning.py): the stored record is
            # served raw — schema/dims validation belongs to the
            # consumer, whose knob space the server cannot know.
            rec = gw.tuning.get(key[len("tuning/"):])
            if rec is None:
                return self._send(404, {"error": "no tuned config"})
            return self._send(200, rec)
        if key == "observe":
            return self._send(200, {"jobs": gw.observe.jobs(),
                                    "stats": gw.observe.stats()})
        if key.startswith("observe/"):
            # The fleet timeline (fleet/observe.py): per-job series
            # derived from pushed host digests — observability without
            # touching worker disks.
            job = key[len("observe/"):]
            since = 0.0
            q = self.path.partition("?")[2]
            for part in q.split("&"):
                if part.startswith("since="):
                    try:
                        since = float(part[6:])
                    except ValueError:
                        pass
            if job not in gw.observe.jobs():
                return self._send(404, {"error": "no series for job "
                                                 f"{job!r}"})
            # A known job with nothing newer than ?since= is an EMPTY
            # window, not a missing job — 404 here would make every
            # idle poll interval read as "series disappeared".
            rows = gw.observe.series(job, since=since)
            return self._send(200, {"job": job, "series": rows})
        return self._send(404, {"error": "not found"})

    def do_POST(self):
        gw = self.server.gateway  # type: ignore[attr-defined]
        key = self._key()
        if key is not None and key.startswith("observe/"):
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            if not self._authorized("POST", key, body):
                return self._send(403,
                                  {"error": "bad or missing signature"})
            try:
                gw.observe.ingest(key[len("observe/"):],
                                  json.loads(body.decode()))
            except (ValueError, TypeError) as e:
                return self._send(400, {"error": f"malformed digest: {e}"})
            return self._send(200, {"ok": True})
        if key != "jobs":
            return self._send(404, {"error": "not found"})
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        if not self._authorized("POST", key, body):
            return self._send(403, {"error": "bad or missing signature"})
        try:
            spec = JobSpec.from_dict(json.loads(body.decode()))
        except (ValueError, TypeError, KeyError) as e:
            return self._send(400, {"error": f"malformed job spec: {e}"})
        rec = gw.submit(spec)
        if isinstance(rec, str):  # validation refusal
            return self._send(400, {"error": rec})
        return self._send(200, rec.to_dict())

    def do_PUT(self):
        gw = self.server.gateway  # type: ignore[attr-defined]
        key = self._key()
        if key is None or not key.startswith("tuning/"):
            return self._send(404, {"error": "not found"})
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        if not self._authorized("PUT", key, body):
            return self._send(403, {"error": "bad or missing signature"})
        from .tuning import TuningSchemaMismatch
        try:
            rec = json.loads(body.decode())
            stored = gw.tuning.put(key[len("tuning/"):], rec)
        except (ValueError, TypeError, TuningSchemaMismatch) as e:
            return self._send(400, {"error": f"malformed tuned-config "
                                             f"record: {e}"})
        return self._send(200, stored)

    def do_DELETE(self):
        gw = self.server.gateway  # type: ignore[attr-defined]
        key = self._key()
        if key is None or not key.startswith("jobs/"):
            return self._send(404, {"error": "not found"})
        if not self._authorized("DELETE", key):
            return self._send(403, {"error": "bad or missing signature"})
        rec = gw.scheduler.cancel(key[len("jobs/"):])
        if rec is None:
            return self._send(404, {"error": "no such job"})
        return self._send(200, rec.to_dict())


class _FleetServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr, gateway: "FleetGateway"):
        super().__init__(addr, _FleetHandler)
        self.gateway = gateway


class FleetGateway(BackgroundHTTPServer):
    """The composed service: durable queue + scheduler + HTTP plane.

    ``hosts`` is the fleet inventory — a static list or a callable
    (e.g. a discovery script wrapper) re-evaluated each tick.  Pass
    ``port=0`` for an ephemeral port (tests); the production default is
    ``HVD_TPU_FLEET_PORT``."""

    def __init__(self, hosts, port: Optional[int] = None,
                 host: str = "0.0.0.0",
                 fleet_dir: Optional[str] = None,
                 secret: Optional[str] = None,
                 runner_factory=None,
                 health_hook: Optional[Callable[[], List[str]]] = None,
                 quota_slots: Optional[int] = None,
                 preemption: Optional[bool] = None,
                 preempt_grace_s: Optional[float] = None,
                 tick_s: Optional[float] = None,
                 extra_env=None,
                 verbose: bool = False):
        from ..core import config as _cfg
        if port is None:
            port = _cfg.fleet_port()
        if fleet_dir is None:
            fleet_dir = _cfg.fleet_dir()
        if secret is None:
            secret = _cfg.fleet_secret()
        self.secret = secret
        self.store = DurableJobQueue(fleet_dir)
        # Fleet-level tuning memory: tuned configs persist beside the
        # job queue with the same durability discipline, served at
        # GET/PUT /fleet/tuning/<key> so resubmitted jobs start warm.
        from .tuning import LocalTuningStore
        self.tuning = LocalTuningStore(fleet_dir)
        # The fleet timeline (fleet/observe.py): bounded per-job series
        # fed by host-digest pushes; telemetry, deliberately NOT
        # persisted with the queue's durability.
        from .observe import FleetSeriesStore
        self.observe = FleetSeriesStore()
        hosts_provider = hosts if callable(hosts) else (lambda: list(hosts))
        self.scheduler = Scheduler(
            self.store, hosts_provider, runner_factory=runner_factory,
            health_hook=health_hook, quota_slots=quota_slots,
            preemption=preemption, preempt_grace_s=preempt_grace_s,
            tick_s=tick_s, extra_env=extra_env, verbose=verbose)
        super().__init__(_FleetServer((host, port), self))
        self._submit_lock = threading.Lock()

    # -- service lifecycle -------------------------------------------------

    def serve(self) -> int:
        """Start the HTTP plane and the scheduler; returns the port."""
        port = self.start()
        self.scheduler.start()
        return port

    def close(self, cancel_jobs: bool = False) -> None:
        self.scheduler.stop(cancel_jobs=cancel_jobs)
        self.stop()

    # -- submission plane --------------------------------------------------

    def submit(self, spec: JobSpec):
        """Admission-checked submission.  Returns the JobRecord (state
        QUEUED or DENIED), or an error string for a malformed spec."""
        bad = spec.validate()
        if bad is not None:
            return bad
        with self._submit_lock:
            healthy = self.scheduler.healthy_slots()
            # Deny only against a capacity we have actually observed: a
            # hosts-provider glitch at startup reads as "unknown", and
            # an unknown fleet queues the job instead of refusing it.
            if spec.min_np > healthy and self.scheduler.inventory_seen:
                rec = self.store.submit(
                    spec, state=DENIED,
                    reason=(f"admission refused: healthy capacity "
                            f"{healthy} < min_np {spec.min_np}"))
                from ..metrics.registry import registry
                registry().counter(
                    "hvd_fleet_admission_denials_total",
                    "Jobs denied by the admission controller").inc()
            else:
                rec = self.store.submit(spec)
            from ..debug import flight
            flight.record("fleet.submit", rec.id, tenant=spec.tenant,
                          priority=spec.priority, min_np=spec.min_np,
                          state=rec.state)
            return rec
