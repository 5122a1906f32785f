"""Open-loop load driving (port of horovod_tpu/serving/loadgen.py) —
shared by the chip smoke test, the tests and the load client.

:func:`synthetic_workload` draws a seeded open-loop request schedule
(Poisson arrivals, mixed prompt/output lengths); :func:`drive` runs one
engine under such a schedule through the same policy→admit→step
iteration the HTTP serving loop uses, and returns per-request results
plus occupancy accounting.  ``continuous=False`` is the static-batch
arm: admission only happens when EVERY slot is free (the classic
batch barrier), which is exactly what the continuous engine's
mid-batch retire/admit removes; ``chip_smoke.py`` phase 13 reads the
difference on the card.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import policy as P
from .engine import DecodeEngine, Request, record_shed


def percentile(values: List[float], p: float) -> Optional[float]:
    """Nearest-rank percentile of an unsorted sample (None when empty)
    — the one TTFT-summary implementation the bench and the load
    client share."""
    if not values:
        return None
    ordered = sorted(values)
    return round(ordered[min(len(ordered) - 1, int(p * len(ordered)))], 4)


def synthetic_workload(seed: int, n: int, rate_rps: float,
                       prompt_lens: Tuple[int, int] = (8, 32),
                       output_lens: Tuple[int, int] = (4, 64),
                       vocab: int = 64,
                       tenants: Tuple[str, ...] = ("default",),
                       ) -> List[Tuple[float, Request]]:
    """A seeded open-loop schedule: ``n`` requests with exponential
    inter-arrivals at ``rate_rps``, prompt/output lengths uniform over
    the given (inclusive) ranges.  Returns (arrival_offset_s, Request)
    sorted by arrival."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for i in range(n):
        t += float(rng.exponential(1.0 / rate_rps)) if rate_rps > 0 else 0.0
        plen = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        olen = int(rng.integers(output_lens[0], output_lens[1] + 1))
        out.append((t, Request(
            id=f"r{i:05d}",
            prompt=[int(x) for x in rng.integers(0, vocab, plen)],
            max_new_tokens=olen,
            tenant=tenants[i % len(tenants)],
            submit_seq=i)))
    return out


def drive(engine: DecodeEngine,
          schedule: List[Tuple[float, Request]],
          continuous: bool = True,
          wall_s: Optional[float] = None,
          queue_cap: int = 0,
          on_event=None,
          aging_s: float = 0.0,
          prefill_budget: Optional[int] = None) -> Dict[str, object]:
    """Run one engine under an open-loop schedule until the work (or
    the wall budget) is exhausted.

    Returns ``{"results": {id: {...}}, "occupancy": mean occupied
    fraction over decoding iterations, "iters", "tokens", "wall_s"}``.
    Per-request results carry ``tokens`` (the output), ``ttft_s``, and
    ``finish_s``; shed requests carry ``shed`` instead.
    """
    t0 = time.monotonic()
    if prefill_budget is None:
        prefill_budget = getattr(engine, "prefill_chunk", 0)
    pending = deque(sorted(schedule, key=lambda ar: (ar[0],
                                                     ar[1].submit_seq)))
    queued: List[Request] = []
    by_id: Dict[str, Request] = {}
    results: Dict[str, dict] = {}
    occ_sum = 0.0
    iters = 0
    tokens = 0
    while True:
        now = time.monotonic() - t0
        if wall_s is not None and now >= wall_s:
            break
        while pending and pending[0][0] <= now:
            at, req = pending.popleft()
            req.arrival_mono = t0 + at
            queued.append(req)
            by_id[req.id] = req
        if not pending and not queued and engine.active() == 0:
            break
        free = engine.free_slots()
        if not continuous and engine.active() > 0:
            free = 0      # static-batch barrier: drain before refilling
        views = [P.RequestView(
            id=r.id, tenant=r.tenant, priority=r.priority,
            submit_seq=r.submit_seq, arrival_s=r.arrival_mono - t0,
            deadline_s=r.deadline_s,
            pages_needed=r.pages_needed(engine.page_tokens),
            prompt_tokens=len(r.prompt))
            for r in queued]
        decisions = P.plan(views, free, engine.free_pages(), now_s=now,
                           running=engine.running_by_tenant(),
                           queue_cap=queue_cap,
                           slot_pages=min(engine.pages_per_slot,
                                          engine.total_pages),
                           aging_s=aging_s,
                           prefill_budget=prefill_budget)
        events = []
        admitted = False
        for d in decisions:
            if d[0] == "admit":
                admitted = True
                req = by_id[d[1]]
                queued.remove(req)
                events.extend(engine.admit(req))
            elif d[0] == "shed":
                req = by_id[d[1]]
                queued.remove(req)
                record_shed(req.id, req.tenant, d[2])
                results[req.id] = {"shed": d[2]}
        if (queued and not admitted and not pending
                and engine.active() == 0):
            # Idle engine, no arrivals left, nothing admitted: static
            # capacity can never seat what remains — terminating shed
            # instead of spinning forever.
            for req in queued:
                record_shed(req.id, req.tenant, "capacity")
                results[req.id] = {"shed": "capacity"}
            queued = []
        if engine.active() > 0:
            occ_sum += engine.occupancy()
            iters += 1
            events.extend(engine.step())
        elif pending:
            # Idle but arrivals remain: wait for the next one.
            time.sleep(min(0.001, max(0.0, pending[0][0] - now)))
        for ev in events:
            if on_event is not None:
                on_event(ev)
            if ev.kind == "token":
                tokens += 1
                if ev.first:
                    results.setdefault(ev.request.id, {})["ttft_s"] = (
                        time.monotonic() - ev.request.arrival_mono)
            else:
                r = results.setdefault(ev.request.id, {})
                r["tokens"] = ev.tokens
                r["reason"] = ev.reason
                r["finish_s"] = time.monotonic() - ev.request.arrival_mono
    return {
        "results": results,
        "occupancy": (occ_sum / iters) if iters else 0.0,
        "iters": iters,
        "tokens": tokens,
        "wall_s": time.monotonic() - t0,
    }
