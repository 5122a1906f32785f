"""Admission policy — pure, deterministic, golden-testable (a copy of
horovod_tpu/serving/policy.py: no framework in it).

One function,
:func:`plan`, maps the queue's current view (waiting requests, free
decode slots, free cache pages, per-tenant occupancy) to a list of
decisions.  No I/O, no clocks (``now_s`` is an argument), no threads:
the serving loop executes decisions; this module only chooses them.
Two replicas restarted over the same queue admit identically.

Policy, in order:

* **Shed on overload** — loudly, never silently.  A request whose TTFT
  deadline has already passed while queued is shed (serving it late
  helps nobody and holds a slot a live request needs), a request whose
  page reservation exceeds ``slot_pages`` — what any slot can EVER
  hold — is shed as ``too_large`` (it would wait forever), and when
  the queue exceeds ``queue_cap`` the lowest-priority newest
  submissions beyond the cap are shed (the bounded-admission-queue
  half lives at the HTTP ingress, which 503s before enqueueing; this
  covers growth after admission control, e.g. a slot-starved backlog).
* **Priority** — waiting requests are considered highest priority
  first.
* **Per-tenant fair share** — among equal priority, the tenant holding
  the fewest decode slots goes first.
* **Deadline-aware ordering** — ties break on the tightest absolute
  deadline (arrival + deadline_s; no deadline sorts last) then
  submission order.
* **Slot assignment** — a request is admitted while a free slot AND
  its page reservation fit; a request that does not fit *waits* without
  blocking smaller requests behind it (head-of-line blocking would
  idle slots a later request could use).
* **Page-reservation aging** (``aging_s`` > 0) — the bounded answer to
  the starvation that head-of-line-free admission invites: under
  sustained small-request load a page-hungry request could otherwise
  wait forever.  When the FIRST selected-but-page-starved request has
  waited at least ``aging_s``, its page reservation (up to what the
  pool holds) is withheld from every candidate considered after it in
  this plan — small requests stop leapfrogging it, the pool drains to
  it as slots retire, and it seats as soon as its reservation fits.
  Bounded deliberately: ONE aged request reserves per plan, so aging
  can delay but never collapse throughput (``SERVING_AGING_S``).
* **Prefill budget** (``prefill_budget`` > 0) — bounds the prompt
  tokens admitted per plan so one burst of long prompts cannot enqueue
  an unbounded prefill backlog ahead of the chunked-prefill loop
  (``SERVING_PREFILL_CHUNK``); the first admission always fits (a
  prompt longer than the whole budget must still be servable), later
  ones wait as ``"prefill"`` until the next plan.
* **SLO burn priority** (``burn`` / ``burn_threshold``) — per-tenant
  error-budget burn rates from ``serving/slo.py``: a tenant at/over
  the threshold is missing its SLO *right now*, so among equal
  priorities its requests select ahead of healthy tenants' (and shed
  last under overload).  The signal is a plain input dict, so the
  function stays pure and two replicas fed the same budgets decide
  identically (``HVD_TPU_SLO_*``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

# Decision tuples (kind first):
#   ("shed",  request_id, reason)   # "deadline" | "overload" | "too_large"
#   ("admit", request_id)
#   ("wait",  request_id, reason)   # "slots" | "pages" | "prefill"
Decision = Tuple

_INF = float("inf")


@dataclasses.dataclass
class RequestView:
    """The policy-relevant projection of one queued request."""

    id: str
    tenant: str = "default"
    priority: int = 0
    submit_seq: int = 0
    arrival_s: float = 0.0
    deadline_s: float = 0.0    # TTFT SLO in seconds; 0 = no target
    pages_needed: int = 1      # KV page reservation (prompt + output cap)
    prompt_tokens: int = 0     # prefill cost (the prefill-budget unit)


def plan(queued: List[RequestView], free_slots: int, free_pages: int,
         now_s: float, running: Optional[Dict[str, int]] = None,
         queue_cap: int = 0, slot_pages: int = 0,
         aging_s: float = 0.0,
         prefill_budget: int = 0,
         burn: Optional[Dict[str, float]] = None,
         burn_threshold: float = 1.0) -> List[Decision]:
    running = dict(running or {})
    burn = burn or {}

    def burning(tenant: str) -> bool:
        # SLO error-budget signal (serving/slo.py): a tenant at/over
        # its burn threshold is already missing its target — deferring
        # it further digs the hole.  Pure input, same as ``running``.
        return burn.get(tenant, 0.0) >= burn_threshold

    decisions: List[Decision] = []
    live: List[RequestView] = []
    for v in queued:
        if v.deadline_s > 0 and now_s - v.arrival_s > v.deadline_s:
            decisions.append(("shed", v.id, "deadline"))
        elif slot_pages > 0 and v.pages_needed > slot_pages:
            # Larger than any slot can EVER hold: waiting would hold a
            # queue position forever (and an idle engine hostage).
            decisions.append(("shed", v.id, "too_large"))
        else:
            live.append(v)
    if queue_cap > 0 and len(live) > queue_cap:
        # Overload: shed the lowest-priority newest submissions beyond
        # the cap, so what survives is exactly what the cap promises to
        # eventually serve.
        # A burning tenant's requests shed LAST among equals: shedding
        # them spends error budget that is already gone.
        doomed = sorted(live, key=lambda v: (
            1 if burning(v.tenant) else 0, v.priority, -v.submit_seq))
        for v in doomed[:len(live) - queue_cap]:
            decisions.append(("shed", v.id, "overload"))
        doomed_ids = {d[1] for d in decisions if d[0] == "shed"}
        live = [v for v in live if v.id not in doomed_ids]

    # Selection is one-at-a-time because each admit CHANGES the fair-
    # share key (the admitted tenant now holds one more slot) — a
    # precomputed sort would hand a burst tenant every free slot in
    # one pass.
    def key(v: RequestView):
        return (-v.priority,
                0 if burning(v.tenant) else 1,
                running.get(v.tenant, 0),
                (v.arrival_s + v.deadline_s) if v.deadline_s > 0
                else _INF,
                v.submit_seq)

    pending = list(live)
    budget_left = prefill_budget
    admitted_any = False
    reserve_used = False
    while pending:
        v = min(pending, key=key)
        pending.remove(v)
        if free_slots <= 0:
            decisions.append(("wait", v.id, "slots"))
            continue
        if v.pages_needed > free_pages:
            decisions.append(("wait", v.id, "pages"))
            if (aging_s > 0 and not reserve_used
                    and now_s - v.arrival_s >= aging_s):
                # Aged: withhold its reservation from everyone behind
                # it this plan.  One reservation per plan keeps aging
                # bounded — it ages the POOL toward one request, it
                # does not serialize admission.
                free_pages -= min(v.pages_needed, free_pages)
                reserve_used = True
            continue
        if (prefill_budget > 0 and admitted_any
                and budget_left < v.prompt_tokens):
            decisions.append(("wait", v.id, "prefill"))
            continue
        decisions.append(("admit", v.id))
        admitted_any = True
        budget_left -= v.prompt_tokens
        free_slots -= 1
        free_pages -= v.pages_needed
        running[v.tenant] = running.get(v.tenant, 0) + 1
    return decisions
