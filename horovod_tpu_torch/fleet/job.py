"""Job specs and records (port of horovod_tpu/fleet/job.py) — the unit
of work the fleet gateway schedules.

A *spec* is what a tenant submits (entrypoint, resource envelope,
priority, SLO hints); a *record* is the gateway's durable bookkeeping
around it (state machine, timestamps, preemption counters).  Both are
plain-dict-serializable so the queue file and the HTTP wire share one
format.

State machine::

    QUEUED ──start──▶ RUNNING ──exit 0──▶ DONE
      ▲                │  │
      │                │  └──exit ≠0──▶ FAILED
      └──requeue── PREEMPTED ◀──preempt()──┘   (RUNNING may also pass
                                                through PREEMPTING while
                                                the scheduler waits for
                                                the victim's commit)
    QUEUED ──admission──▶ DENIED     QUEUED/RUNNING ──DELETE──▶ CANCELLED
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

# Job states.
QUEUED = "queued"
RUNNING = "running"
PREEMPTING = "preempting"   # running, commit-gated shrink/stop pending
PREEMPTED = "preempted"     # suspended; requeued for resume
DONE = "done"
FAILED = "failed"
CANCELLED = "cancelled"
DENIED = "denied"

ACTIVE_STATES = (QUEUED, RUNNING, PREEMPTING, PREEMPTED)
TERMINAL_STATES = (DONE, FAILED, CANCELLED, DENIED)


@dataclasses.dataclass
class JobSpec:
    """What a tenant submits.  ``command`` is the worker argv (each rank
    runs it, exactly like an ``hvdrun-torch`` command); ``min_np`` is the
    floor below which the job cannot run, ``max_np`` the width it can
    use when the fleet has room (None = as much as offered).  Higher
    ``priority`` preempts lower.  ``max_queue_s`` is an SLO hint: the
    queue-wait target the dashboards grade this tenant against (the
    scheduler also uses it to order equal-priority submissions —
    tightest target first)."""

    command: List[str]
    min_np: int = 1
    max_np: Optional[int] = None
    priority: int = 0
    tenant: str = "default"
    name: str = ""
    env: Dict[str, str] = dataclasses.field(default_factory=dict)
    checkpoint_dir: str = ""
    max_queue_s: float = 0.0
    # "batch" jobs run to completion; "service" jobs (serving replicas,
    # serving/service.py) never complete — the scheduler seats them like
    # any running job (shrinkable toward min_np by preemption, grown
    # back when capacity frees), and only a DELETE or a preemption
    # suspend ever ends one.
    kind: str = "batch"

    def __post_init__(self):
        # Coerce the numeric fields at the boundary (JSON clients send
        # "5" as easily as 5): every internal consumer — the policy's
        # sort keys, capacity comparisons — may then assume real
        # numbers.  Uncoercible values raise ValueError/TypeError here,
        # which the HTTP handler maps to a 400 instead of a queued
        # record that wedges the scheduler's sort on every tick.
        self.min_np = int(self.min_np)
        self.max_np = None if self.max_np is None else int(self.max_np)
        self.priority = int(self.priority)
        self.max_queue_s = float(self.max_queue_s)

    def validate(self) -> Optional[str]:
        """None when launchable, else a pointed refusal reason."""
        if not self.command or not all(
                isinstance(c, str) for c in self.command):
            return "command must be a non-empty list of strings"
        if self.min_np < 1:
            return "min_np must be >= 1"
        if self.max_np is not None and self.max_np < self.min_np:
            return "max_np must be >= min_np"
        if not self.tenant:
            return "tenant must be non-empty"
        if not isinstance(self.env, dict) or not all(
                isinstance(k, str) and isinstance(v, str)
                for k, v in self.env.items()):
            return "env must be a {str: str} mapping"
        if self.kind not in ("batch", "service"):
            return f"kind must be 'batch' or 'service', got {self.kind!r}"
        return None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "JobSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class JobRecord:
    """The gateway's durable view of one submission."""

    id: str
    spec: JobSpec
    state: str = QUEUED
    submit_seq: int = 0          # FIFO tie-break, monotonic per gateway
    submitted_at: float = 0.0
    started_at: float = 0.0      # last (re)start
    first_started_at: float = 0.0
    finished_at: float = 0.0
    np: int = 0                  # slots currently assigned
    exit_code: Optional[int] = None
    preemptions: int = 0         # times shrunk or suspended for a peer
    resumes: int = 0             # times rescheduled after a suspension
    reason: str = ""             # denial / failure / preemption detail
    queue_wait_s: float = 0.0    # submit → first start (the SLO metric)
    # Commit generation the last preemption acted on (the victim's
    # restored step) — the checkpoint-mediated guarantee, queryable.
    preempt_generation: Optional[int] = None

    def queue_wait(self, now: Optional[float] = None) -> float:
        if self.first_started_at:
            return self.first_started_at - self.submitted_at
        return (now or time.time()) - self.submitted_at

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["spec"] = self.spec.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "JobRecord":
        d = dict(d)
        spec = JobSpec.from_dict(d.pop("spec"))
        known = {f.name for f in dataclasses.fields(cls)} - {"spec"}
        return cls(spec=spec, **{k: v for k, v in d.items() if k in known})
