"""The fleet scheduler (port of horovod_tpu/fleet/scheduler.py) —
multiplexes queued jobs onto one device fleet.

Executes :func:`.policy.plan` decisions against real jobs: each running
job is an :class:`ElasticJobRunner` (an ``ElasticDriver`` on a slice of
the fleet's hosts, driven through its ``request_resize``/``preempt``
carve-outs), and preemption is **checkpoint-mediated** —
a shrink/stop decision first parks in ``_pending_preempt`` until the
victim announces a commit newer than the decision (or the grace window
expires), so the victim always resumes from the step it just committed.

The scheduler is deliberately driveable without threads: ``tick()`` is
the whole control loop, tests call it directly with fake runners, and
``start()`` just runs it on a cadence.  Every decision lands in
``hvd_fleet_*`` metrics and ``fleet.*`` flight events.

**Card sets.**  The reference allocates slot *counts* per host.  On a GPU
host a slot is a card: an elastic slot ``host:i`` computes on the host's
card *i* for the life of its worker (``runner/chips.elastic_slot_env``),
so two jobs seated on one host by count would both take cards 0..k-1.
The port's allocation is a list of *named cards* per host (indices into
the host's cards): a start or a grow takes free cards, appended to the
job's list; a shrink frees the tail of the list, so the survivors keep
theirs; and the job's ``ElasticDriver`` maps its slot ``host:i`` to the
*i*-th card of its list (``seed_cards``, before every start and
resize).  No card ever hosts two jobs' workers.  The plans, the counts
and the job states are the reference's.

The scheduler and the gateway are a control plane: nothing here touches
CUDA, so the gateway's process holds no context on a card beside a
job's workers.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..runner.hosts import HostInfo
from .job import (DENIED, DONE, FAILED, CANCELLED, PREEMPTED, PREEMPTING,
                  QUEUED, RUNNING, JobRecord)
from .policy import JobView, plan
from .queue import DurableJobQueue

# Queue-wait SLO buckets (seconds): sub-second dispatch .. multi-hour
# backlog.
_WAIT_BUCKETS = (0.5, 2.0, 10.0, 60.0, 300.0, 1800.0, 7200.0)


def _flight(kind: str, name: Optional[str] = None, **fields):
    from ..debug import flight
    flight.record(kind, name, **fields)


def _registry():
    from ..metrics.registry import registry
    return registry()


class ElasticJobRunner:
    """One job = one ``ElasticDriver`` on a host slice, run on a daemon
    thread (``driver.run()`` blocks until the job ends)."""

    def __init__(self, record: JobRecord, extra_env: Dict[str, str],
                 verbose: bool = False):
        from ..runner.elastic_driver import ElasticDriver, FixedHosts
        self._record_id = record.id
        self._discovery = FixedHosts([])
        env = dict(record.spec.env)
        env.update(extra_env)
        env["HVD_TPU_FLEET_JOB_ID"] = record.id
        env["HVD_TPU_FLEET_TENANT"] = record.spec.tenant
        env["HVD_TPU_FLEET_JOB_KIND"] = record.spec.kind
        self._driver = ElasticDriver(
            self._discovery, list(record.spec.command),
            min_np=record.spec.min_np, max_np=record.spec.max_np,
            extra_env=env, verbose=verbose)
        self._thread: Optional[threading.Thread] = None
        self._rc: Optional[int] = None
        self.cancelled = False

    def seed_cards(self, card_sets: Dict[str, List[int]]) -> None:
        """The job's cards by host, seeded before each start and resize
        (``ElasticDriver.seed_cards``)."""
        self._driver.seed_cards(card_sets)

    def start(self, hosts: List[HostInfo]) -> None:
        self._discovery.set(list(hosts))

        def _run():
            self._rc = self._driver.run()

        self._thread = threading.Thread(
            target=_run, name=f"hvd-tpu-fleet-job-{self._record_id}",
            daemon=True)
        self._thread.start()

    def resize(self, hosts: List[HostInfo], np: int, reason: str) -> bool:
        self._discovery.set(list(hosts))
        return self._driver.request_resize(np, reason)

    def announce_resize(self) -> float:
        return self._driver.announce_resize()

    def preempt(self, reason: str) -> bool:
        return self._driver.preempt(reason)

    def cancel(self, reason: str) -> bool:
        # Flag only on success: a job whose run() already returned 0
        # must reap as DONE, not CANCELLED, when the DELETE races its
        # completion.
        if self._driver.preempt(reason):
            self.cancelled = True
            return True
        return False

    def last_commit(self) -> Optional[dict]:
        return self._driver.last_commit()

    @property
    def preempted(self) -> bool:
        return self._driver.preempted

    def result(self) -> Optional[int]:
        if self._thread is not None and self._thread.is_alive():
            return None
        return self._rc

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)


class Scheduler:
    """Drives the queue.  ``hosts_provider()`` returns the fleet's total
    inventory; ``health_hook()`` (optional) returns hostnames the
    health plane excludes — their slots are never promised.
    ``runner_factory(record, extra_env)`` builds a runner (tests inject
    fakes); the default is :class:`ElasticJobRunner`."""

    def __init__(self, store: DurableJobQueue,
                 hosts_provider: Callable[[], List[HostInfo]],
                 runner_factory=None,
                 health_hook: Optional[Callable[[], List[str]]] = None,
                 quota_slots: Optional[int] = None,
                 preemption: Optional[bool] = None,
                 preempt_grace_s: Optional[float] = None,
                 tick_s: Optional[float] = None,
                 extra_env: Optional[Dict[str, str]] = None,
                 verbose: bool = False):
        from ..core import config as _cfg
        self._store = store
        self._hosts_provider = hosts_provider
        self._health_hook = health_hook
        self._runner_factory = runner_factory or (
            lambda rec, env: ElasticJobRunner(rec, env, verbose=verbose))
        self._quota = (_cfg.fleet_quota_slots()
                       if quota_slots is None else int(quota_slots))
        self._preemption = (_cfg.fleet_preemption()
                            if preemption is None else bool(preemption))
        self._grace_s = (_cfg.fleet_preempt_grace_s()
                         if preempt_grace_s is None
                         else float(preempt_grace_s))
        self._tick_s = (_cfg.fleet_tick_s()
                        if tick_s is None else float(tick_s))
        self._extra_env = dict(extra_env or {})
        self._verbose = verbose
        self._lock = threading.RLock()
        self._runners: Dict[str, object] = {}
        # job -> host -> the job's cards there (indices, in slot order)
        self._alloc: Dict[str, Dict[str, List[int]]] = {}
        # victim_id -> {"kind", "np", "for_job", "t0", "deadline"}
        self._pending_preempt: Dict[str, dict] = {}
        self._quota_waiting: set = set()
        self._shrunk: set = set()  # shrunk victims owed a resume/regrow
        # Inventory resilience: a transient hosts_provider failure must
        # not read as "capacity 0" (plan() would DENY the whole queue,
        # a terminal state).  Keep the last good view; until one exists,
        # admission denials are suppressed entirely.
        self._last_hosts: List[HostInfo] = []
        self._inventory_seen = False
        # Per-tick healthy-inventory snapshot (None outside a tick).
        self._healthy_now: Optional[List[HostInfo]] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- capacity ----------------------------------------------------------

    def fleet_hosts(self) -> List[HostInfo]:
        try:
            hosts = list(self._hosts_provider())
        except Exception as e:  # noqa: BLE001 — glitch: keep last view
            from ..utils import logging as log
            log.warning("fleet inventory read failed (%r); keeping the "
                        "last good view (%d hosts)", e,
                        len(self._last_hosts))
            return list(self._last_hosts)
        self._last_hosts = hosts
        self._inventory_seen = True
        return hosts

    @property
    def inventory_seen(self) -> bool:
        """True once the hosts provider has succeeded at least once —
        before that, capacity 0 means "unknown", not "deny"."""
        return self._inventory_seen

    def healthy_hosts(self) -> List[HostInfo]:
        hosts = self.fleet_hosts()
        if self._health_hook is None:
            return hosts
        try:
            excluded = set(self._health_hook() or ())
        except Exception:  # noqa: BLE001 — a hint, not an oracle
            excluded = set()
        return [h for h in hosts if h.hostname not in excluded]

    def healthy_slots(self) -> int:
        return sum(h.slots for h in self.healthy_hosts())

    def _allocate(self, np: int) -> Optional[Dict[str, List[int]]]:
        """Greedy slice of free healthy cards, inventory order (from the
        tick's snapshot when inside a tick), lowest free card first."""
        healthy = self._healthy_now
        if healthy is None:
            healthy = self.healthy_hosts()
        used: Dict[str, set] = {}
        for alloc in self._alloc.values():
            for host, cards in alloc.items():
                used.setdefault(host, set()).update(cards)
        out: Dict[str, List[int]] = {}
        for h in healthy:
            if np <= 0:
                break
            busy = used.get(h.hostname, set())
            free = [i for i in range(h.slots) if i not in busy]
            if not free:
                continue
            out[h.hostname] = free[:np]
            np -= len(out[h.hostname])
        return out if np <= 0 else None

    @staticmethod
    def _trim_alloc(alloc: Dict[str, List[int]], np: int
                    ) -> Dict[str, List[int]]:
        """Shrink an allocation to np cards, keeping the earliest hosts
        and each host's first cards (survivor slots stay seated on their
        cards; the tail frees)."""
        out: Dict[str, List[int]] = {}
        for host, cards in alloc.items():
            if np <= 0:
                break
            out[host] = list(cards[:np])
            np -= len(out[host])
        return out

    @staticmethod
    def _hosts_of(alloc: Dict[str, List[int]]) -> List[HostInfo]:
        return [HostInfo(h, len(cards)) for h, cards in alloc.items()]

    @staticmethod
    def _seed(runner, alloc: Dict[str, List[int]]) -> None:
        """Hand a runner its cards (runners without cards, such as test
        doubles of the reference's interface, take the counts alone)."""
        seed = getattr(runner, "seed_cards", None)
        if seed is not None:
            seed({h: list(cards) for h, cards in alloc.items()})

    def card_sets(self) -> Dict[str, Dict[str, List[int]]]:
        """Each running job's cards by host (indices, in slot order)."""
        with self._lock:
            return {j: {h: list(c) for h, c in a.items()}
                    for j, a in self._alloc.items()}

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="hvd-tpu-fleet-scheduler", daemon=True)
        self._thread.start()

    def stop(self, cancel_jobs: bool = False) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if cancel_jobs:
            with self._lock:
                runners = list(self._runners.values())
            for r in runners:
                r.cancel("gateway shutdown")
            for r in runners:
                r.join(timeout=15)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                from ..utils import logging as log
                log.warning("fleet scheduler tick failed: %r", e)
            self._stop.wait(self._tick_s)

    # -- control loop ------------------------------------------------------

    def tick(self) -> List[tuple]:
        """One scheduling round; returns the decisions it executed
        (tests assert on them)."""
        with self._lock:
            # One inventory read per tick: the provider may be a
            # subprocess-backed discovery script, and the plan, the
            # allocations, and the gauges must all see the SAME view —
            # re-reading mid-tick is both redundant I/O and a window
            # for plan/allocate disagreement.
            self._healthy_now = self.healthy_hosts()
            try:
                self._reap()
                self._run_pending_preemptions()
                decisions = self._plan_and_execute(self._healthy_now)
                self._update_gauges(self._healthy_now)
                return decisions
            finally:
                self._healthy_now = None

    def _reap(self) -> None:
        now = time.time()
        for job_id in list(self._runners):
            runner = self._runners[job_id]
            rc = runner.result()
            if rc is None:
                continue
            self._runners.pop(job_id)
            self._alloc.pop(job_id, None)
            self._pending_preempt.pop(job_id, None)
            rec = self._store.get(job_id)
            if rec is None:
                continue
            if getattr(runner, "cancelled", False):
                state, reason = CANCELLED, "cancelled"
            elif getattr(runner, "preempted", False):
                # Suspended for a higher-priority job: observable as
                # PREEMPTED (scheduled like a queued job, keeping its
                # submit_seq seniority); the entrypoint resumes from its
                # committed checkpoint when reseated.
                state, reason = PREEMPTED, rec.reason or "preempted"
            elif rc == 0:
                state, reason = DONE, ""
            else:
                state, reason = FAILED, f"exit code {rc}"

            def _mut(r, state=state, reason=reason, rc=rc, now=now):
                r.state = state
                r.np = 0
                r.reason = reason
                if state == QUEUED:
                    r.exit_code = None
                else:
                    r.exit_code = rc
                    r.finished_at = now

            self._store.update(job_id, _mut)
            self._shrunk.discard(job_id)
            _flight("fleet.job_end", job_id, state=state, exit=rc)

    def _run_pending_preemptions(self) -> None:
        now = time.time()
        for victim_id in list(self._pending_preempt):
            p = self._pending_preempt[victim_id]
            runner = self._runners.get(victim_id)
            if runner is None:
                self._pending_preempt.pop(victim_id)
                continue
            lc = runner.last_commit()
            # Generation comparison, not wall clocks: the worker stamps
            # ts with ITS host's clock, so skew against the gateway
            # would either void the gate (worker ahead: a pre-announce
            # commit passes) or always burn the grace window (worker
            # behind).  The commit counter is monotonic and clock-free.
            committed = (lc is not None and
                         int(lc.get("generation", 0)) > p["gen0"])
            if not committed and now < p["deadline"]:
                continue
            self._pending_preempt.pop(victim_id)
            self._execute_preemption(victim_id, p, runner,
                                     committed=committed, commit=lc)

    def _execute_preemption(self, victim_id: str, p: dict, runner,
                            committed: bool, commit=None) -> None:
        generation = (commit or {}).get("generation")
        _registry().counter(
            "hvd_fleet_preemptions_total",
            "Jobs shrunk or suspended for a higher-priority job").inc()
        _flight("fleet.preempt", victim_id, mode=p["kind"],
                np=p.get("np"), for_job=p["for_job"],
                committed=committed, generation=generation)
        if p["kind"] == "shrink":
            new_alloc = self._trim_alloc(
                self._alloc.get(victim_id, {}), p["np"])
            hosts = self._hosts_of(new_alloc)
            self._seed(runner, new_alloc)
            if runner.resize(hosts, p["np"],
                             f"preempted by {p['for_job']}"):
                self._alloc[victim_id] = new_alloc
                self._shrunk.add(victim_id)

                def _mut(r, np=p["np"]):
                    r.state = RUNNING
                    r.np = np
                    r.preemptions += 1
                    r.preempt_generation = generation
                    r.reason = (f"shrunk for {p['for_job']} at commit "
                                f"generation {generation}")
                self._store.update(victim_id, _mut)
            else:
                # Resize refused (job completing): drop back to RUNNING,
                # on the cards it holds.
                self._seed(runner, self._alloc.get(victim_id, {}))
                self._store.update(
                    victim_id, lambda r: setattr(r, "state", RUNNING))
        else:  # stop: suspend the whole job; requeued at reap time
            def _mut(r):
                r.preemptions += 1
                r.preempt_generation = generation
                r.reason = f"preempted by {p['for_job']}"
            self._store.update(victim_id, _mut)
            runner.preempt(f"preempted by {p['for_job']}")

    def _views(self) -> List[JobView]:
        views = []
        for rec in self._store.list():
            if rec.state in (QUEUED, PREEMPTED):
                state = "queued"
            elif rec.state == RUNNING:
                state = ("preempting"
                         if rec.id in self._pending_preempt else "running")
            elif rec.state == PREEMPTING:
                state = "preempting"
            else:
                continue
            views.append(JobView(
                id=rec.id, tenant=rec.spec.tenant,
                priority=rec.spec.priority, min_np=rec.spec.min_np,
                max_np=rec.spec.max_np, submit_seq=rec.submit_seq,
                state=state, np=rec.np,
                max_queue_s=rec.spec.max_queue_s))
        return views

    def _plan_and_execute(self, healthy_hosts: List[HostInfo]) \
            -> List[tuple]:
        healthy = sum(h.slots for h in healthy_hosts)
        decisions = plan(self._views(), healthy,
                         quota_slots=self._quota,
                         preemption=self._preemption)
        now = time.time()
        new_quota_waiting = set()
        for d in decisions:
            kind = d[0]
            if kind == "deny":
                if not self._inventory_seen:
                    continue  # capacity unknown, not absent: keep queued
                _, job_id, reason = d

                def _mut(r, reason=reason, now=now):
                    r.state = DENIED
                    r.reason = reason
                    r.finished_at = now
                self._store.update(job_id, _mut)
                _registry().counter(
                    "hvd_fleet_admission_denials_total",
                    "Jobs denied by the admission controller").inc()
                _flight("fleet.schedule", job_id, decision="deny",
                        reason=reason)
            elif kind == "quota_wait":
                _, job_id, tenant = d
                new_quota_waiting.add(job_id)
                if job_id not in self._quota_waiting:
                    _registry().counter(
                        "hvd_fleet_quota_denials_total",
                        "Scheduling passes a job waited on its tenant "
                        "quota", tenant=tenant).inc()
                    _flight("fleet.schedule", job_id,
                            decision="quota_wait", tenant=tenant)
            elif kind == "start":
                _, job_id, np = d
                self._start_job(job_id, np, now)
            elif kind == "grow":
                _, job_id, np = d
                self._grow_job(job_id, np)
            elif kind in ("shrink", "stop"):
                victim_id = d[1]
                if victim_id in self._pending_preempt:
                    continue
                runner = self._runners.get(victim_id)
                if runner is None:
                    continue
                # Graceful phase one: the host event parks every victim
                # worker at its next commit (HostsUpdatedInterrupt), so
                # the shrink that follows lands between steps — never
                # mid-collective.  The commit gate waits for a commit
                # GENERATION beyond the one current at announce time
                # (clock-free; see _run_pending_preemptions).  gen0 is
                # read before the announce: a commit racing the publish
                # may open the gate un-parked, which just means the
                # shrink takes the ordinary failure-path restore to that
                # same committed step.
                gen0 = int((runner.last_commit() or {})
                           .get("generation", 0))
                announce = getattr(runner, "announce_resize", None)
                t0 = announce() if announce is not None else now
                p = {"kind": kind,
                     "np": d[2] if kind == "shrink" else 0,
                     "for_job": d[-1], "t0": t0, "gen0": gen0,
                     "deadline": t0 + self._grace_s}
                self._pending_preempt[victim_id] = p
                self._store.update(
                    victim_id, lambda r: setattr(r, "state", PREEMPTING))
                _flight("fleet.preempt", victim_id, mode=kind,
                        phase="commit_wait", for_job=p["for_job"])
        self._quota_waiting = new_quota_waiting
        return decisions

    def _start_job(self, job_id: str, np: int, now: float) -> None:
        rec = self._store.get(job_id)
        if rec is None or rec.state not in (QUEUED, PREEMPTED):
            return
        alloc = self._allocate(np)
        if alloc is None:
            return  # raced with a health change; next tick replans
        hosts = self._hosts_of(alloc)
        runner = self._runner_factory(rec, dict(self._extra_env))
        self._runners[job_id] = runner
        self._alloc[job_id] = alloc
        resume = rec.started_at > 0

        def _mut(r):
            r.state = RUNNING
            r.np = np
            r.started_at = now
            if not r.first_started_at:
                r.first_started_at = now
                r.queue_wait_s = now - r.submitted_at
            if resume:
                r.resumes += 1
        self._store.update(job_id, _mut)
        if not resume:
            _registry().histogram(
                "hvd_fleet_queue_wait_seconds",
                "Submission to first start", buckets=_WAIT_BUCKETS
            ).observe(max(0.0, now - rec.submitted_at))
        self._seed(runner, alloc)
        runner.start(hosts)
        _flight("fleet.resume" if resume else "fleet.schedule",
                job_id, np=np, tenant=rec.spec.tenant)

    def _grow_job(self, job_id: str, np: int) -> None:
        runner = self._runners.get(job_id)
        rec = self._store.get(job_id)
        if runner is None or rec is None:
            return
        cur = self._alloc.get(job_id, {})
        extra = self._allocate(np - sum(len(c) for c in cur.values()))
        if extra is None:
            return
        merged = {h: list(c) for h, c in cur.items()}
        for h, cards in extra.items():
            merged.setdefault(h, []).extend(cards)
        hosts = self._hosts_of(merged)
        self._seed(runner, merged)
        if runner.resize(hosts, np, "fleet capacity available"):
            self._alloc[job_id] = merged
            self._store.update(job_id, lambda r: setattr(r, "np", np))
            if job_id in self._shrunk:
                # A preemption victim regained its width: the shrink
                # half of preempt/resume closes here.
                self._shrunk.discard(job_id)
                _flight("fleet.resume", job_id, np=np, regrow=True)
            else:
                _flight("fleet.schedule", job_id, decision="grow", np=np)
        else:
            self._seed(runner, cur)

    # -- operations --------------------------------------------------------

    def cancel(self, job_id: str) -> Optional[JobRecord]:
        with self._lock:
            rec = self._store.get(job_id)
            if rec is None:
                return None
            runner = self._runners.get(job_id)
            if runner is not None:
                runner.cancel("cancelled by tenant")
                return self._store.get(job_id)  # reaped on a later tick
            if rec.state in (QUEUED, PREEMPTED):
                def _mut(r):
                    r.state = CANCELLED
                    r.reason = "cancelled"
                    r.finished_at = time.time()
                return self._store.update(job_id, _mut)
            return rec

    def running_count(self) -> int:
        with self._lock:
            return len(self._runners)

    def _update_gauges(self, healthy_hosts: List[HostInfo]) -> None:
        reg = _registry()
        records = self._store.list()
        reg.gauge("hvd_fleet_jobs_queued",
                  "Jobs waiting for capacity").set(
            sum(1 for r in records
                if r.state in (QUEUED, PREEMPTED)))
        reg.gauge("hvd_fleet_jobs_running",
                  "Jobs currently holding fleet slots").set(
            sum(1 for r in records
                if r.state in (RUNNING, PREEMPTING)))
        reg.gauge("hvd_fleet_healthy_slots",
                  "Slots the admission controller may promise").set(
            sum(h.slots for h in healthy_hosts))
