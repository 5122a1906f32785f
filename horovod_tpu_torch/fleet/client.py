"""Fleet gateway client (port of horovod_tpu/fleet/client.py) —
submit/inspect/cancel jobs over HTTP.

Requests ride the wire fabric's rung-1 ladder (``hvd.net``) and are
HMAC-signed with the fleet secret (``HVD_TPU_FLEET_SECRET`` or the
``secret=`` argument) under the rendezvous signature scheme.  The
default gateway address is ``HVD_TPU_FLEET_ADDR``, falling back to
``127.0.0.1:<HVD_TPU_FLEET_PORT>``.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import List, Optional

from .job import TERMINAL_STATES, JobRecord, JobSpec


def default_addr(addr: Optional[str] = None) -> str:
    from ..core import config as _cfg
    if addr:
        return addr
    env = _cfg.fleet_addr()
    if env:
        return env
    return f"127.0.0.1:{_cfg.fleet_port()}"


def _secret(secret: Optional[str]) -> Optional[str]:
    from ..core import config as _cfg
    return secret if secret is not None else _cfg.fleet_secret()


def _request(method: str, addr: str, key: str, body: bytes = b"",
             secret: Optional[str] = None, timeout: float = 5.0,
             none_on_404: bool = False, query: str = ""):
    from .. import net as _net
    from ..runner.rendezvous import _signature
    req = urllib.request.Request(
        f"http://{addr}/fleet/{key}" + (f"?{query}" if query else ""),
        data=body or None, method=method)
    sec = _secret(secret)
    if sec:
        req.add_header("X-HVD-Signature",
                       _signature(sec, method, "fleet", key, body))
    try:
        raw = _net.request_bytes(req, timeout=timeout,
                                 name=f"fleet.{method.lower()}.{key}")
    except urllib.error.HTTPError as e:
        if e.code == 404 and none_on_404:
            # A miss is an answer, not a failure (tuning-memory lookups).
            return None
        if e.code == 403:
            raise PermissionError(
                f"fleet gateway at {addr} rejected the request signature "
                "(missing or wrong HVD_TPU_FLEET_SECRET)") from None
        try:
            detail = json.loads(e.read().decode()).get("error", "")
        except Exception:  # noqa: BLE001
            detail = ""
        raise RuntimeError(
            f"fleet gateway at {addr}: HTTP {e.code} on {method} "
            f"/fleet/{key}" + (f": {detail}" if detail else "")) from None
    return json.loads(raw.decode())


def detect_gateway(addr: str, timeout: float = 2.0) -> Optional[dict]:
    """Probe ``/fleet/healthz`` (unsigned).  Returns the identity
    payload when a live fleet gateway answers there, else None — the
    launcher uses this to turn an opaque bind failure into the pointed
    "fleet mode is active" error."""
    req = urllib.request.Request(f"http://{addr}/fleet/healthz")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            payload = json.loads(resp.read().decode())
    except (OSError, ValueError, urllib.error.URLError):
        return None
    if isinstance(payload, dict) and \
            payload.get("service") == "horovod_tpu_fleet":
        return payload
    return None


def submit_job(spec: JobSpec, addr: Optional[str] = None,
               secret: Optional[str] = None) -> JobRecord:
    payload = json.dumps(spec.to_dict()).encode()
    return JobRecord.from_dict(
        _request("POST", default_addr(addr), "jobs", payload,
                 secret=secret))


def get_job(job_id: str, addr: Optional[str] = None,
            secret: Optional[str] = None) -> JobRecord:
    return JobRecord.from_dict(
        _request("GET", default_addr(addr), f"jobs/{job_id}",
                 secret=secret))


def list_jobs(addr: Optional[str] = None,
              secret: Optional[str] = None) -> List[JobRecord]:
    payload = _request("GET", default_addr(addr), "jobs", secret=secret)
    return [JobRecord.from_dict(d) for d in payload.get("jobs", [])]


def cancel_job(job_id: str, addr: Optional[str] = None,
               secret: Optional[str] = None) -> JobRecord:
    return JobRecord.from_dict(
        _request("DELETE", default_addr(addr), f"jobs/{job_id}",
                 secret=secret))


def push_observation(job_id: str, host_digest: dict,
                     addr: Optional[str] = None,
                     secret: Optional[str] = None) -> None:
    """Ingest one host digest into the gateway's fleet timeline
    (``fleet/observe.py``) — what the per-host observer's push loop
    calls on the ``HVD_TPU_FLEET_OBSERVE_PUSH_S`` cadence."""
    payload = json.dumps(host_digest).encode()
    _request("POST", default_addr(addr), f"observe/{job_id}", payload,
             secret=secret)


def get_observation(job_id: str, addr: Optional[str] = None,
                    secret: Optional[str] = None,
                    since: float = 0.0) -> Optional[dict]:
    """The job's retained timeline series (None when the gateway has
    none) — "what was job J's MFU over the last hour" without touching
    worker disks."""
    return _request("GET", default_addr(addr), f"observe/{job_id}",
                    secret=secret, none_on_404=True,
                    query=f"since={since}" if since else "")


def list_observed_jobs(addr: Optional[str] = None,
                       secret: Optional[str] = None) -> List[str]:
    payload = _request("GET", default_addr(addr), "observe",
                       secret=secret)
    return list(payload.get("jobs", []))


def wait_job(job_id: str, addr: Optional[str] = None,
             secret: Optional[str] = None, timeout: float = 3600.0,
             poll_s: float = 1.0) -> JobRecord:
    """Poll until the job reaches a terminal state (done/failed/
    cancelled/denied)."""
    deadline = time.time() + timeout
    while True:
        rec = get_job(job_id, addr=addr, secret=secret)
        if rec.state in TERMINAL_STATES:
            return rec
        if time.time() >= deadline:
            raise TimeoutError(
                f"job {job_id} still {rec.state} after {timeout}s")
        time.sleep(poll_s)
