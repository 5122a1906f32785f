"""Scheduling policy (port of horovod_tpu/fleet/policy.py) — pure,
deterministic, golden-testable.

One function, :func:`plan`, maps the fleet's current view (job states,
healthy capacity, quotas) to a list of decisions.  No I/O, no clocks, no
threads: the scheduler executes decisions; this module only chooses
them.  Determinism matters — two gateway restarts over the same queue
must schedule identically.

Policy, in order:

* **Admission** — a queued job whose ``min_np`` exceeds the *healthy*
  capacity (total slots minus health-hint exclusions) is denied: the
  gateway never promises capacity the straggler/health plane says is
  sick.
* **Priority** — queued jobs are considered highest priority first.
* **Fair share** — among equal priority, the tenant with the fewest
  running slots goes first; ties break on the SLO hint (tightest
  ``max_queue_s`` first) then submission order.
* **Quota** — a per-tenant concurrent-slot ceiling; a job that would
  exceed it waits (counted, never silently) rather than being denied.
* **Preemption** — when the head job cannot fit, lower-priority running
  jobs are shrunk toward their ``min_np`` (newest first), and suspended
  outright only when shrinking cannot free enough.  Preemption
  decisions are commit-gated by the scheduler (the checkpoint-mediated
  part); the freed slots go to the preemptor on a later tick, and the
  plan stops there so no lower-priority queued job can steal them.
* **Grow** — leftover healthy capacity is handed to running jobs below
  their ``max_np``, highest priority first (how a shrunk victim resumes
  its full width once the preemptor finishes).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

# Decision tuples (kind first; see plan()):
#   ("deny",       job_id, reason)
#   ("quota_wait", job_id, tenant)
#   ("start",      job_id, np)
#   ("grow",       job_id, np)           # raise a running job to np
#   ("shrink",     victim_id, np, for_job_id)
#   ("stop",       victim_id, for_job_id)
Decision = Tuple


@dataclasses.dataclass
class JobView:
    """The policy-relevant projection of a JobRecord."""

    id: str
    tenant: str
    priority: int
    min_np: int
    max_np: Optional[int]
    submit_seq: int
    state: str                 # "queued" | "running" | "preempting"
    np: int = 0                # slots currently held (running/preempting)
    max_queue_s: float = 0.0   # SLO hint; 0 = no target


_INF = float("inf")


def plan(views: List[JobView], healthy_slots: int,
         quota_slots: int = 0, preemption: bool = True) -> List[Decision]:
    decisions: List[Decision] = []
    running = [v for v in views if v.state in ("running", "preempting")]
    tenant_used = {}
    for v in running:
        tenant_used[v.tenant] = tenant_used.get(v.tenant, 0) + v.np
    free = healthy_slots - sum(v.np for v in running)

    def quota_room(tenant: str) -> float:
        if quota_slots <= 0:
            return _INF
        return quota_slots - tenant_used.get(tenant, 0)

    queued = sorted(
        (v for v in views if v.state == "queued"),
        key=lambda v: (-v.priority, tenant_used.get(v.tenant, 0),
                       v.max_queue_s if v.max_queue_s > 0 else _INF,
                       v.submit_seq))
    for v in queued:
        if v.min_np > healthy_slots:
            decisions.append((
                "deny", v.id,
                f"healthy capacity {healthy_slots} < min_np {v.min_np} "
                "(health hints exclude part of the fleet)"
                if healthy_slots > 0 else
                f"healthy capacity 0 < min_np {v.min_np} "
                "(health hints exclude the whole fleet)"))
            continue
        if quota_room(v.tenant) < v.min_np:
            decisions.append(("quota_wait", v.id, v.tenant))
            continue
        if free >= v.min_np:
            np = int(min(v.max_np if v.max_np is not None else free,
                         free, quota_room(v.tenant)))
            decisions.append(("start", v.id, np))
            free -= np
            tenant_used[v.tenant] = tenant_used.get(v.tenant, 0) + np
            continue
        if not preemption:
            continue
        # Preemption: reclaim (min_np - free) slots from strictly lower
        # priority running jobs — shrink newest victims toward their
        # min_np first, suspend outright only if shrinking cannot cover.
        victims = sorted(
            (r for r in running
             if r.state == "running" and r.priority < v.priority),
            key=lambda r: (r.priority, -r.submit_seq))
        need = v.min_np - free
        shrinks = {}   # victim_id -> new np
        stops = []
        for victim in victims:
            if need <= 0:
                break
            reclaim = victim.np - victim.min_np
            if reclaim <= 0:
                continue
            take = min(reclaim, need)
            shrinks[victim.id] = victim.np - take
            need -= take
        if need > 0:
            for victim in victims:
                if need <= 0:
                    break
                freed = (victim.np - shrinks.pop(victim.id)
                         if victim.id in shrinks else 0)
                stops.append(victim.id)
                need -= victim.np - freed
        if need > 0:
            continue  # even full preemption cannot seat it; keep waiting
        for vid, np in shrinks.items():
            decisions.append(("shrink", vid, np, v.id))
        for vid in stops:
            decisions.append(("stop", vid, v.id))
        # The freed slots are promised to v (it starts once they free);
        # planning further queued jobs against them would hand them to a
        # lower-priority job first.
        return decisions
    # Grow: leftover healthy capacity to running jobs below max_np.
    if free > 0:
        for v in sorted((r for r in running if r.state == "running"),
                        key=lambda r: (-r.priority, r.submit_seq)):
            if free <= 0:
                break
            ceiling = min(v.max_np if v.max_np is not None else _INF,
                          v.np + free, v.np + quota_room(v.tenant))
            if ceiling > v.np:
                give = int(ceiling) - v.np
                decisions.append(("grow", v.id, v.np + give))
                free -= give
                tenant_used[v.tenant] = \
                    tenant_used.get(v.tenant, 0) + give
    return decisions
