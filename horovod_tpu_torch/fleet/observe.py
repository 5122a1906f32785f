"""The fleet timeline (port of horovod_tpu/fleet/observe.py) —
bounded-retention time series at the gateway.

Until now every fleet-scale question ("what was job J's MFU over the
last hour?", "did step time drift after the resize?") needed a rank-0
JSONL on some worker's disk.  This module gives the gateway memory:
per-host observers (``metrics/observer.py``) push their host digests on
the ``HVD_TPU_FLEET_OBSERVE_PUSH_S`` cadence, the gateway merges pushes
belonging to the same sync round (the digest algebra is closed — a
partial round is still a valid, named-partial sample) and retains a
bounded ring of derived samples per job:

    step-time p50/p95/mean/max · fleet MFU min/mean · wall-component
    shares · reporting hosts/ranks · outlier ranks · missing evidence

Queryable over the gateway's HTTP plane (``fleet/gateway.py``)::

    POST /fleet/observe/<job>    ingest one host digest  (HMAC-gated)
    GET  /fleet/observe/<job>    the job's retained series (HMAC-gated)
    GET  /fleet/observe          jobs with series (HMAC-gated)
    GET  /fleet/metrics          fleet-wide Prometheus exposition of the
                                 latest sample per job (unsigned, like
                                 every scrape endpoint in this stack)

Retention is ``HVD_TPU_FLEET_OBSERVE_RETAIN`` samples per job (default
512) — a ring, not a database: old samples fall off, the memory bound
is samples x jobs, and a gateway restart starts empty (series are
telemetry, not state; the durable queue stays the only thing the
gateway persists).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

from ..metrics import digest as _digest


def _slo_summary(d: dict) -> Optional[dict]:
    """Per-job SLO rollup from the digest's merged gauge map
    (``hvd_slo_*{tenant=...}`` — serving/slo.py): the worst burn rate
    and thinnest remaining budget across every tenant on every
    reporting replica, plus which tenants are burning (>= 1.0).  None
    for jobs that serve no SLO-tracked traffic (training jobs)."""
    gauges = d.get("gauges") or {}
    burn: Dict[str, float] = {}
    budget: Dict[str, float] = {}
    for key, v in gauges.items():
        for prefix, dst in (("hvd_slo_burn_rate{", burn),
                            ("hvd_slo_budget_remaining{", budget)):
            if key.startswith(prefix):
                tenant = key[len(prefix):-1]
                tenant = tenant.partition("tenant=")[2] or tenant
                last = float(v[2])   # gauges merge as [min, max, last]
                # Merge rule across replicas: worst case wins.
                if dst is burn:
                    dst[tenant] = max(dst.get(tenant, 0.0), last)
                else:
                    dst[tenant] = min(dst.get(tenant, 1.0), last)
    if not burn and not budget:
        return None
    return {
        "burn_max": max(burn.values()) if burn else 0.0,
        "budget_min": min(budget.values()) if budget else 1.0,
        "tenants": len(set(burn) | set(budget)),
        "burning": sorted(t for t, b in burn.items() if b >= 1.0),
    }


def _sample_from_digest(d: dict, ts: float) -> dict:
    """One retained timeline sample, derived (not stored raw — digests
    carry full scalar maps; the ring keeps only the series shape)."""
    steps = _digest.digest_step_quantiles(d)
    mfu = _digest.digest_mfu(d)
    window = d.get("window") or {}
    n = int(window.get("step_count", 0))
    sample = {
        "ts": ts,
        "round": int(d.get("round", -1)),
        "step": int(d.get("step", 0)),
        "hosts": len(d.get("hosts") or []),
        "ranks": int(d.get("ranks", 0)),
        "failed_hosts": list(d.get("failed_hosts") or []),
        "missing_ranks": list(d.get("missing") or []),
        "step_time_mean": (float(window.get("step_time_sum", 0.0)) / n)
        if n else None,
        "step_p50": steps["p50"] if steps else None,
        "step_p95": steps["p95"] if steps else None,
        "step_max": steps["max"] if steps else None,
        "mfu_min": mfu["min"] if mfu else None,
        "mfu_mean": mfu["mean"] if mfu else None,
        "shares": _digest.digest_shares(d),
        "outlier_ranks": [int(s.get("rank", -1))
                          for s in d.get("outliers") or []],
        "slo": _slo_summary(d),
    }
    return sample


class FleetSeriesStore:
    """Bounded per-job ring of timeline samples, fed by digest pushes.

    Pushes carrying the same ``round`` merge (the closed digest
    algebra) until a newer round arrives, which SEALS the previous one
    into a sample — hosts push independently, and a sample should
    reflect every host that reported for its round, not just the first
    pusher.  The open round is visible in queries too (marked
    ``open``), so a dashboard never lags a full round behind.
    """

    def __init__(self, retain: Optional[int] = None):
        from ..core import config as _cfg
        if retain is None:
            retain = _cfg.fleet_observe_retain()
        self.retain = max(int(retain), 1)
        self._lock = threading.Lock()
        self._series: Dict[str, deque] = {}
        self._open: Dict[str, "OrderedDict[int, dict]"] = {}
        self._sealed: Dict[str, int] = {}   # job -> highest sealed round
        self._ingests = 0
        self._late_drops = 0

    # -- write side --------------------------------------------------------

    def ingest(self, job: str, host_digest: dict,
               now: Optional[float] = None) -> None:
        if not isinstance(host_digest, dict) or \
                int(host_digest.get("v", 0)) != _digest.DIGEST_VERSION:
            raise ValueError("not a digest (or an unknown digest "
                             "version)")
        # Shape-check BEFORE storing: a field-poor digest (buggy or
        # future client) accepted into an open round would poison it —
        # every later legitimate same-round push hits the merge's
        # KeyError instead of a 400, and the round's sample is lost.
        if not isinstance(host_digest.get("window"), dict) or \
                not isinstance(host_digest.get("outliers", []), list):
            raise ValueError("digest missing required fields "
                             "(window/outliers)")
        try:
            _sample_from_digest(host_digest, 0.0)
        except (KeyError, TypeError, AttributeError) as e:
            raise ValueError(f"malformed digest field: {e!r}") from None
        ts = time.time() if now is None else float(now)
        r = int(host_digest.get("round", -1))
        with self._lock:
            self._ingests += 1
            open_rounds = self._open.setdefault(job, OrderedDict())
            sealed = self._sealed.get(job)
            if sealed is not None and r <= sealed and r not in open_rounds:
                if sealed - r <= 2:
                    # A straggling host's push for a recently-sealed
                    # round: dropping it (bounded by the push cadence)
                    # beats appending a duplicate, out-of-order,
                    # unmerged sample behind the sealed one.
                    self._late_drops += 1
                    return
                # A round far BELOW the sealed high-water mark is not a
                # straggler — the job's round clock restarted (elastic
                # reset, job resubmission).  Start a fresh epoch.
                for old in sorted(open_rounds):
                    self._seal_locked(job, old, open_rounds.pop(old))
                self._sealed[job] = r - 1
            if r in open_rounds:
                try:
                    open_rounds[r]["digest"] = _digest.merge_digests(
                        open_rounds[r]["digest"], host_digest)
                except (KeyError, TypeError) as e:
                    raise ValueError(
                        f"digest does not merge: {e!r}") from None
                open_rounds[r]["ts"] = ts
            else:
                open_rounds[r] = {"digest": dict(host_digest), "ts": ts}
            # Seal every open round older than the newest: its pushers
            # have moved on (merging a straggler into a sealed *sample*
            # would reorder history — a late push to a sealed round is
            # dropped, bounded by the push cadence).  This also caps
            # open rounds per job at exactly one.
            newest = max(open_rounds)
            for old in [k for k in open_rounds if k < newest]:
                entry = open_rounds.pop(old)
                self._seal_locked(job, old, entry)

    def _seal_locked(self, job: str, round_idx: int, entry: dict) -> None:
        ring = self._series.setdefault(job, deque(maxlen=self.retain))
        ring.append(_sample_from_digest(entry["digest"], entry["ts"]))
        prev = self._sealed.get(job)
        self._sealed[job] = round_idx if prev is None \
            else max(prev, round_idx)

    # -- read side ---------------------------------------------------------

    def jobs(self) -> List[str]:
        with self._lock:
            return sorted(set(self._series) | set(self._open))

    def series(self, job: str, since: float = 0.0) -> List[dict]:
        """The job's samples oldest-first (sealed rounds plus the open
        one, marked)."""
        with self._lock:
            out = [dict(s) for s in self._series.get(job, ())
                   if s["ts"] >= since]
            for r, entry in (self._open.get(job) or {}).items():
                if entry["ts"] >= since:
                    s = _sample_from_digest(entry["digest"], entry["ts"])
                    s["open"] = True
                    out.append(s)
        return out

    def latest(self, job: str) -> Optional[dict]:
        """The newest sample (the open round when one exists, else the
        last sealed) — O(1) per job, NOT a series() copy: the unsigned
        /fleet/metrics exposition calls this per job per scrape."""
        with self._lock:
            open_rounds = self._open.get(job)
            if open_rounds:
                r = max(open_rounds)
                s = _sample_from_digest(open_rounds[r]["digest"],
                                        open_rounds[r]["ts"])
                s["open"] = True
                return s
            ring = self._series.get(job)
            return dict(ring[-1]) if ring else None

    def stats(self) -> dict:
        with self._lock:
            return {"jobs": len(set(self._series) | set(self._open)),
                    "ingests": self._ingests,
                    "late_drops": self._late_drops,
                    "samples": sum(len(v) for v in self._series.values()),
                    "retain": self.retain}

    # -- exposition --------------------------------------------------------

    def render_prometheus(self) -> str:
        """Fleet-wide text exposition: the latest sample per job as
        ``hvd_fleet_job_*{job=...}`` gauges — what a fleet dashboard
        scrapes off the gateway instead of 125 worker hosts."""
        gauges = (
            ("hvd_fleet_job_step_time_mean_seconds", "step_time_mean",
             "Mean step time in the job's last observed window"),
            ("hvd_fleet_job_step_time_p50_seconds", "step_p50",
             "Median per-step time (sketched)"),
            ("hvd_fleet_job_step_time_p95_seconds", "step_p95",
             "95th-percentile per-step time (sketched)"),
            ("hvd_fleet_job_mfu_min", "mfu_min",
             "Lowest per-rank MFU in the job's last window"),
            ("hvd_fleet_job_mfu_mean", "mfu_mean",
             "Mean per-rank MFU in the job's last window"),
            ("hvd_fleet_job_ranks", "ranks",
             "Ranks that reported into the job's last window"),
        )
        # Tenant-supplied job ids go into label VALUES: escape them
        # (exporters.py's exposition rules) or one job id containing a
        # quote would malform the whole scrape for every job.
        from ..metrics.exporters import _escape_label
        lines: List[str] = []
        latest = {job: self.latest(job) for job in self.jobs()}
        for name, field, help_text in gauges:
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} gauge")
            for job in sorted(latest):
                s = latest[job]
                if s is None or s.get(field) is None:
                    continue
                lines.append(f'{name}{{job="{_escape_label(job)}"}} '
                             f'{float(s[field])!r}')
        slo_gauges = (
            ("hvd_fleet_job_slo_burn_max", "burn_max",
             "Worst per-tenant SLO burn rate across the job's serving "
             "replicas (1.0 = spending budget exactly at rate)"),
            ("hvd_fleet_job_slo_budget_min", "budget_min",
             "Thinnest per-tenant SLO error budget remaining across "
             "the job's serving replicas"),
        )
        for name, field, help_text in slo_gauges:
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} gauge")
            for job in sorted(latest):
                s = latest[job]
                slo = s.get("slo") if s else None
                if not slo or slo.get(field) is None:
                    continue
                lines.append(f'{name}{{job="{_escape_label(job)}"}} '
                             f'{float(slo[field])!r}')
        lines.append("# HELP hvd_fleet_job_component_share Wall-time "
                     "share by component in the job's last window")
        lines.append("# TYPE hvd_fleet_job_component_share gauge")
        for job in sorted(latest):
            s = latest[job]
            if s is None or not s.get("shares"):
                continue
            for comp in sorted(s["shares"]):
                lines.append(
                    'hvd_fleet_job_component_share'
                    f'{{job="{_escape_label(job)}",'
                    f'component="{comp}"}} {float(s["shares"][comp])!r}')
        return "\n".join(lines) + ("\n" if lines else "")
