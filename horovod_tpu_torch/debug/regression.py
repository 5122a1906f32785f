"""Drift-triggered regression diagnosis: name the suspect subsystem (port
of horovod_tpu/debug/regression.py).

The hang report (debug/hang.py) answers "who stopped"; this report
answers "who got *slower* and what changed right before".  When the
drift detector (metrics/baseline.py) confirms a sustained step-time
regression it calls :func:`build_regression_report`, which correlates
the drift ONSET against the flight recorder's causal event stream (the
events every config-changing subsystem emits: elastic rounds and resets,
net-fabric recovery rungs, checkpoint activity, input-pipeline stalls,
schedule dispatch, serving swaps) and against the cross-rank attribution
view when one is available, so the report says e.g. "input component
grew on rank 2 within 1.4 s of a data.chaos_delay" instead of "steps got
slower".

The report is written as ``perf_regression_step<N>.json`` in
``HVD_TPU_FLIGHT_DIR`` (atomic tmp+rename, like flight dumps) and kept
in memory (:func:`last_report`).  Event → subsystem classification
lives in :data:`EVENT_SUBSYSTEM`; the *suspect* is the latest
classified event at or before the onset inside the lookback window
(``HVD_TPU_PERF_DRIFT_LOOKBACK_S``), with every other in-window event
quoted as context.  The vocabulary is the reference's, autotune and
fleet kinds included, so that a dump of either package classifies the
same.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from ..core import config as _config
from . import flight as _flight

# kind (exact, or prefix with a trailing ".") -> subsystem.  The drift
# diagnoser's whole causal vocabulary: anything a subsystem does that
# can change steady-state performance should land here when it grows a
# flight event.
EVENT_SUBSYSTEM: Dict[str, str] = {
    "autotune.decision": "autotune",
    # The closed loop's own events (autotune.py): a re-tune episode, a
    # regression-gated rollback, and a memory warm start are discrete
    # config-changing moments the diagnoser must be able to quote — a
    # rollback in particular is how a drift RESOLVES.
    "autotune.retune": "autotune", "autotune.rollback": "autotune",
    "autotune.warm_start": "autotune",
    "elastic.reset": "elastic", "elastic.sync": "elastic",
    "elastic.restore": "elastic", "elastic.commit": "elastic_commit",
    "fleet.preempt": "fleet", "fleet.schedule": "fleet",
    "fleet.resume": "fleet", "elastic.resize": "fleet",
    "net.reconnect": "net", "net.renegotiate": "net",
    "net.recovery": "net", "net.retry": "net",
    "recovery.restore.done": "recovery", "recovery.replicate": "recovery",
    "recovery.evict": "recovery",
    "overlap.plan": "overlap",
    # Per-payload schedule dispatch (ops/dispatch.py): a table install
    # or probe is a discrete event that changes every subsequent
    # collective's schedule — exactly the kind of cause a comm-exposed
    # drift should be able to name.
    "dispatch.table": "dispatch", "dispatch.probe": "dispatch",
    "checkpoint.save.begin": "checkpoint",
    "checkpoint.save.commit": "checkpoint",
    "checkpoint.restore.begin": "checkpoint",
    "checkpoint.restore.done": "checkpoint",
    "data.stall_warning": "data", "data.stall_timeout": "data",
    "data.producer_dead": "data", "data.chaos_delay": "data",
    "data.wait": "data",
    # Comm-side chaos injection (ops/collective.py): the wire analog of
    # data.chaos_delay — a deliberately slowed eager plane reads as a
    # net-subsystem event, consistent with the comm_exposed component.
    "net.chaos_delay": "net",
    # Serving plane (serving/): a weight hot-swap or an
    # autoscale resize is a discrete config-changing moment on a
    # colocated replica; admits/sheds corroborate load pressure.
    "serving.swap": "serving", "serving.autoscale": "serving",
    "serving.admit": "serving", "serving.shed": "serving",
    # Production-scale serving: per-request cache/prefill/
    # speculation chatter plus the KV-page migration moment (a
    # migration IS a discrete placement change — suspect-eligible).
    "serving.prefix_hit": "serving", "serving.chunk": "serving",
    "serving.speculate": "serving", "serving.migrate": "serving",
    # Prefix families (trailing "."): any kind under these namespaces
    # classifies even when it has no exact entry — subsystems grow new
    # event kinds (checkpoint.extract.*, recovery.restore.miss, ...)
    # and an unlisted kind silently vanishing from the causal window
    # is a false "no event precedes the onset" verdict.  Exact entries
    # above win (elastic.commit stays elastic_commit).  Deliberately
    # absent: collective./negotiate./overlap. op-stream chatter and
    # perf. (the diagnoser's own output).
    "autotune.": "autotune", "elastic.": "elastic", "fleet.": "fleet",
    "net.": "net", "recovery.": "recovery", "checkpoint.": "checkpoint",
    "data.": "data", "dispatch.": "dispatch", "serving.": "serving",
    # Request-scoped spans (serving/tracing.py): serving-plane events
    # named by trace id.
    "trace.": "serving",
}

# Subsystems that can plausibly explain a given drifting component —
# used to prefer a *consistent* suspect over merely the latest event.
COMPONENT_SUBSYSTEMS: Dict[str, tuple] = {
    "input": ("data", "fleet", "elastic"),
    "comm_exposed": ("dispatch", "net", "autotune", "overlap", "elastic",
                     "fleet"),
    "checkpoint": ("checkpoint", "recovery", "elastic_commit"),
    "compute": ("autotune", "overlap", "fleet", "elastic"),
    # Bubble grows when pipeline geometry changes (microbatch count,
    # stage count) — an elastic resize or an autotune episode.
    "pipeline_bubble": ("autotune", "elastic", "fleet"),
    "host": ("autotune", "data", "recovery"),
}

# Event kinds too frequent to be "the thing that changed" on their own
# (they corroborate a component, they don't name a cause).
_CORROBORATING = {"data.wait", "elastic.commit", "checkpoint.save.begin",
                  "checkpoint.save.commit", "recovery.replicate",
                  "overlap.plan",
                  # Per-request serving chatter: evidence of load, not
                  # a discrete config change (swap/autoscale/shed are;
                  # so is serving.migrate — a placement change).
                  "serving.admit", "serving.retire",
                  "serving.prefix_hit", "serving.chunk",
                  "serving.speculate",
                  # Per-request trace spans: pure load chatter.  The
                  # discrete-moment spans (trace.migrate*, .swap_stall,
                  # .shed) stay suspect-eligible — they mirror
                  # serving.migrate/swap/shed.
                  "trace.ingress", "trace.plan", "trace.admit",
                  "trace.prefix", "trace.prefill", "trace.decode",
                  "trace.speculate", "trace.finish"}

_last_report: Optional[dict] = None
_last_lock = threading.Lock()


def _classify(kind: Optional[str]) -> Optional[str]:
    if not kind:
        return None
    sub = EVENT_SUBSYSTEM.get(kind)
    if sub is not None:
        return sub
    # Prefix fallback, longest first: "checkpoint.extract.begin" →
    # "checkpoint.".
    parts = kind.split(".")
    while len(parts) > 1:
        parts.pop()
        sub = EVENT_SUBSYSTEM.get(".".join(parts) + ".")
        if sub is not None:
            return sub
    return None


def build_regression_report(event, write: bool = True,
                            events: Optional[List[dict]] = None) -> dict:
    """Assemble (and by default write) the regression report for one
    confirmed :class:`~horovod_tpu_torch.metrics.baseline.DriftEvent`.

    ``events`` overrides the flight snapshot (tests)."""
    lookback = _config.perf_drift_lookback_s()
    snap = events if events is not None else _flight.snapshot()
    onset_mono = float(getattr(event, "onset_mono", 0.0) or time.monotonic())
    window: List[dict] = []
    for ev in snap:
        t = ev.get("t_mono")
        if t is None or t < onset_mono - lookback:
            continue
        sub = _classify(ev.get("kind"))
        if sub is None:
            continue
        entry = dict(ev)
        entry["subsystem"] = sub
        entry["vs_onset_s"] = round(t - onset_mono, 3)
        window.append(entry)

    component = getattr(event, "component", "compute")
    preferred = COMPONENT_SUBSYSTEMS.get(component, ())
    # Candidate suspects: discrete events at or before the onset (small
    # slack — clock granularity between the event and the step that
    # first paid for it), newest first.  An event whose subsystem is
    # consistent with the drifting component outranks a merely-newer
    # one; corroborating high-frequency kinds only win if nothing
    # discrete is in the window.
    slack = 1.0
    candidates = [ev for ev in window if ev["vs_onset_s"] <= slack]
    discrete = [ev for ev in candidates
                if ev["kind"] not in _CORROBORATING]
    corroborating = [ev for ev in candidates
                     if ev["kind"] in _CORROBORATING]
    suspect = None
    for pool in (
            [ev for ev in discrete if ev["subsystem"] in preferred],
            discrete,
            [ev for ev in corroborating if ev["subsystem"] in preferred],
            corroborating):
        if pool:
            suspect = max(pool, key=lambda ev: ev["vs_onset_s"])
            break

    # Rank attribution: the cross-rank aggregation's component sums,
    # when a sync has run (metrics/aggregate.py snapshot "attr").
    ranks = []
    try:
        from ..metrics.aggregate import aggregator
        fleet = aggregator().fleet() or []
        for s in fleet:
            attr = s.get("attr") or {}
            steps = max(attr.get("steps", 0.0), 0.0)
            comps = {k: v for k, v in attr.items()
                     if k not in ("steps", "flops", "wall")}
            entry = {"rank": s.get("rank"),
                     "steps": int(steps),
                     "step_time_mean_s": (
                         s.get("step_time_sum", 0.0) /
                         max(s.get("step_count", 0), 1)),
                     "component_mean_s": {
                         k: (v / steps if steps else 0.0)
                         for k, v in comps.items()}}
            ranks.append(entry)
    except Exception:  # noqa: BLE001 — diagnosis must not throw
        pass
    slowest = None
    if ranks:
        slowest = max(ranks, key=lambda r: r["step_time_mean_s"])

    rec = _flight.recorder()
    report = {
        "version": 1,
        "kind": "perf_regression",
        "rank": rec.rank,
        "world": rec.world,
        "drift": event.as_dict() if hasattr(event, "as_dict") else dict(
            event),
        "component": component,
        "suspect": (None if suspect is None else {
            "subsystem": suspect["subsystem"],
            "kind": suspect["kind"],
            "name": suspect.get("name"),
            "vs_onset_s": suspect["vs_onset_s"],
            "event": {k: v for k, v in suspect.items()
                      if k not in ("subsystem", "vs_onset_s")},
        }),
        "verdict": _verdict(component, suspect),
        # Quote discrete (config-changing) events and high-frequency
        # corroborating chatter under separate caps: between onset and
        # the CUSUM fire, per-step chatter (data.wait every slow poll —
        # precisely the input-regression case) would otherwise evict
        # the pre-onset causal event the report exists to show.
        "events": sorted(
            [ev for ev in window if ev["kind"] not in _CORROBORATING][-30:]
            + [ev for ev in window if ev["kind"] in _CORROBORATING][-20:],
            key=lambda ev: ev.get("t_mono") or 0.0),
        "ranks": ranks,
        "slowest_rank": slowest,
        # What the feedback loop did about this drift: filled in by
        # autotune.notify_drift right after this build (retune started /
        # refused / not tunable) and again when the episode resolves
        # (rolled back / accepted / confirmed), through record_tuning,
        # which rewrites the JSON on disk too.
        "tuning": None,
    }
    path = None
    if write:
        try:
            path = _write(report, getattr(event, "step", 0))
            report["path"] = path
            _flight.record("perf.report", path, step=report["drift"].get(
                "step"), suspect=(suspect or {}).get("subsystem"))
        except Exception:  # noqa: BLE001
            report["path"] = None
    global _last_report
    with _last_lock:
        _last_report = report
    return report


def _verdict(component: str, suspect: Optional[dict]) -> str:
    comp_text = {
        "input": "the input pipeline (data component)",
        "comm_exposed": "exposed communication",
        "checkpoint": "checkpoint/commit work",
        "compute": "compute (or an unmeasured residual)",
        "pipeline_bubble": "pipeline-schedule bubble (fill/drain idle)",
        "host": "unattributed host time",
    }.get(component, component)
    if suspect is None:
        return (f"step time drifted with {comp_text} growing; no "
                "flight-recorded subsystem event precedes the onset "
                "inside the lookback window")
    rel = suspect["vs_onset_s"]
    # The candidate window extends a small slack PAST the onset (clock
    # granularity between an event and the first step that paid for
    # it) — state the direction honestly either way.
    when = (f"{abs(rel):.1f}s before onset" if rel <= 0
            else f"{rel:.1f}s after onset, within the causal slack")
    return (f"step time drifted with {comp_text} growing; nearest "
            f"subsystem event: {suspect['kind']} "
            f"({suspect['subsystem']}, {when})")


def _write(report: dict, step: int) -> str:
    d = _config.flight_dir()
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"perf_regression_step{int(step)}.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=1, default=str)
    os.replace(tmp, path)
    return path


def record_tuning(info: dict) -> Optional[dict]:
    """Merge the feedback loop's activity into the last regression
    report's ``tuning`` section (the tuner records its trigger decision
    and the episode's resolution) and rewrite the on-disk JSON so the
    artifact matches.  Returns the
    updated report (None when no drift has been reported yet)."""
    global _last_report
    with _last_lock:
        if _last_report is None:
            return None
        tuning = dict(_last_report.get("tuning") or {})
        tuning.update(info)
        _last_report["tuning"] = tuning
        report = dict(_last_report)
    path = report.get("path")
    if path:
        try:
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(report, f, indent=1, default=str)
            os.replace(tmp, path)
        except OSError:
            pass  # the in-memory report still carries the section
    return report


def last_report() -> Optional[dict]:
    """The most recent regression report (None before the first
    drift)."""
    with _last_lock:
        return _last_report


def reset() -> None:
    global _last_report
    with _last_lock:
        _last_report = None
