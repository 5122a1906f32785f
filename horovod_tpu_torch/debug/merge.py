"""Fleet trace merge (port of horovod_tpu/debug/merge.py): per-rank flight
dumps + the native Chrome timeline → one clock-aligned Chrome/Perfetto
trace.

::

    python -m horovod_tpu_torch.debug.merge -o merged.json \\
        flight_rank0.json flight_rank1.json [--timeline timeline.json]
    python -m horovod_tpu_torch.debug.merge -o merged.json \\
        --from-fleet <rendezvous host:port>

Neither existing view shows the whole slice: the per-rank profiler sees
one process, the coordinator timeline (``HOROVOD_TIMELINE``) sees only
negotiation.  The merge puts every rank on one time axis — a process row
per rank (flight events on the ``flight`` thread, native timeline events
on the ``native`` thread of the recording coordinator's rows) — so a
single ``chrome://tracing`` / Perfetto load answers "who arrived late".

Clock alignment:

* Flight events carry wall timestamps plus each dump's coordinator
  clock-offset estimate (``clock.offset_s``, from
  :func:`horovod_tpu_torch.debug.flight.estimate_clock_offset`): aligned
  wall = ``t_wall - offset_s``.
* The native timeline's timestamps are microseconds from the
  coordinator's steady clock at ``Timeline::Start``.  The coordinator's
  flight dump records the wall time of that start
  (``meta.native_init_wall`` / ``meta.timeline_start_wall``, set by
  ``native/controller.py``), giving the anchor; without one the
  timeline is left-aligned to the earliest flight event and a
  ``merge.unanchored`` metadata arg says so.

Completed collectives (``collective.done`` events with ``dur_s``) render
as complete ("X") slices; everything else renders as instants — robust
to interleaved async ops, where begin/end pairs would violate Chrome's
per-thread stack nesting.

Request-scoped traces (``serving/tracing.py``): ``--trace <trace_id>``
filters every dump down to that one request's ``trace.*`` spans before
merging.

A live fleet (``--from-fleet``) is fetched one request per host through
the published host observers (``metrics/observer.py``), and rank by rank
through the ``debug/flight_addr_<rank>`` addresses on the rendezvous KV
for whatever no observer answered for.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

_TID_NATIVE = 0
_TID_FLIGHT = 1


def load_dump(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def fetch_fleet_dumps(rdv_addr: str,
                      timeout: float = 5.0) -> Dict[int, dict]:
    """Fetch every reachable rank's flight dump from a LIVE fleet —
    the merge CLI's ``--from-fleet`` source.

    Host-sharded when per-host observers are published
    (``HVD_TPU_METRICS_TREE`` — metrics/observer.py): one
    ``GET /observe/dumps`` per host returns all its ranks' dumps, so a
    125-host fleet costs 125 requests, not 1000.  Hosts without an
    observer (or whose observer is down) degrade to per-rank fetches of
    the ``debug/flight_addr_<rank>`` endpoints; either way unreachable
    ranks are skipped with a stderr note, never fatal."""
    from ..metrics.observer import collect_fleet_dumps
    from ..runner.rendezvous import http_get, http_list
    from . import http as _dhttp

    dumps, host_status = collect_fleet_dumps(rdv_addr, timeout=timeout)
    for host, status in sorted(host_status.items()):
        if status != "ok":
            sys.stderr.write(f"merge: {host} {status}\n")

    # Per-rank sweep for whatever the observers did not cover.
    debug_keys = http_list(rdv_addr, "debug", timeout=timeout) or []
    for key in sorted(k for k in debug_keys
                      if k.startswith("flight_addr_")):
        try:
            rank = int(key[len("flight_addr_"):])
        except ValueError:
            continue
        if rank in dumps:
            continue
        raw = http_get(rdv_addr, "debug", key, timeout=timeout)
        addr = raw.decode() if raw else None
        d = _dhttp.fetch_flight_dump(addr, timeout=timeout) \
            if addr else None
        if d is not None:
            dumps[rank] = d
        else:
            sys.stderr.write(f"merge: rank {rank} unreachable; its row "
                             "will be absent from the trace\n")
    return dumps


def load_timeline(path: str) -> List[dict]:
    """Native Chrome timeline: tolerant of a truncated file (a process
    that died mid-run leaves the JSON array unterminated)."""
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    try:
        obj = json.loads(text)
    except ValueError:
        # Repair: drop a trailing partial line, close the array.
        body = text.strip()
        if body.endswith(","):
            body = body[:-1]
        if not body.endswith("]"):
            body = body.rstrip(",\n ") + "\n]"
        try:
            obj = json.loads(body)
        except ValueError:
            lines = [ln.rstrip(",") for ln in text.splitlines()
                     if ln.strip().startswith("{")]
            obj = []
            for ln in lines:
                try:
                    obj.append(json.loads(ln.rstrip(",")))
                except ValueError:
                    continue
    if isinstance(obj, dict):
        obj = obj.get("traceEvents", [])
    return [e for e in obj if isinstance(e, dict)]


def _aligned_wall(ev: dict, offset_s: float) -> float:
    return float(ev["t_wall"]) - offset_s


def filter_trace(dumps: List[dict], trace_id: str) -> List[dict]:
    """Pure filter: keep only ``trace.*`` flight events whose name is
    ``trace_id`` (span events are NAMED by their trace id — one grep
    key end to end).  Dumps left with no matching spans drop out
    entirely; clock/meta/rank survive so the merge stays aligned."""
    out = []
    for d in dumps:
        events = [ev for ev in d.get("events", [])
                  if str(ev.get("kind", "")).startswith("trace.")
                  and ev.get("name") == trace_id]
        if events:
            nd = {k: v for k, v in d.items() if k != "events"}
            nd["events"] = events
            out.append(nd)
    return out


def merge_dumps(dumps: List[dict],
                timeline_events: Optional[List[dict]] = None) -> dict:
    """Pure merge: flight dumps (+ optional native timeline events) →
    a Chrome trace object ``{"traceEvents": [...]}``."""
    ranks: Dict[int, dict] = {}
    for d in dumps:
        r = d.get("rank")
        r = int(r) if r is not None else len(ranks)
        ranks[r] = d

    # Global origin: earliest aligned flight wall time (the trace reads
    # in relative microseconds, like the native timeline does).
    starts = []
    for r, d in ranks.items():
        off = float(d.get("clock", {}).get("offset_s", 0.0))
        for ev in d.get("events", []):
            starts.append(_aligned_wall(ev, off))
            break  # events are oldest-first: the first is the earliest
    anchor_wall = None
    coord = ranks.get(0)
    if coord is not None:
        meta = coord.get("meta", {})
        raw = meta.get("timeline_start_wall", meta.get("native_init_wall"))
        if raw is not None:
            anchor_wall = float(raw) - float(
                coord.get("clock", {}).get("offset_s", 0.0))
            starts.append(anchor_wall)
    base = min(starts) if starts else 0.0

    out: List[dict] = []
    for r in sorted(ranks):
        d = ranks[r]
        host = d.get("host", "")
        out.append({"name": "process_name", "ph": "M", "pid": r,
                    "tid": _TID_FLIGHT,
                    "args": {"name": f"rank {r}"
                             + (f" ({host})" if host else "")}})
        out.append({"name": "process_sort_index", "ph": "M", "pid": r,
                    "tid": _TID_FLIGHT, "args": {"sort_index": r}})
        out.append({"name": "thread_name", "ph": "M", "pid": r,
                    "tid": _TID_FLIGHT,
                    "args": {"name": "flight recorder"}})
        off = float(d.get("clock", {}).get("offset_s", 0.0))
        for ev in d.get("events", []):
            ts_us = round((_aligned_wall(ev, off) - base) * 1e6)
            args = {k: v for k, v in ev.items()
                    if k not in ("t_wall", "t_mono", "kind", "name")}
            name = ev.get("name") or ev.get("kind", "event")
            kind = ev.get("kind", "event")
            dur_s = ev.get("dur_s")
            if kind == "collective.done" and dur_s is not None:
                out.append({"name": name, "cat": kind, "ph": "X",
                            "ts": ts_us - round(float(dur_s) * 1e6),
                            "dur": round(float(dur_s) * 1e6),
                            "pid": r, "tid": _TID_FLIGHT, "args": args})
            else:
                out.append({"name": name, "cat": kind, "ph": "i",
                            "ts": ts_us, "s": "t", "pid": r,
                            "tid": _TID_FLIGHT, "args": args})

    if timeline_events:
        tl_min = min((float(e.get("ts", 0.0)) for e in timeline_events
                      if e.get("ph") != "M"), default=0.0)
        if anchor_wall is not None:
            shift_us = (anchor_wall - base) * 1e6
        else:
            shift_us = -tl_min  # left-align: no anchor available
        seen_tids = set()
        for e in timeline_events:
            if e.get("ph") == "M":
                continue  # rank rows are re-labeled below
            ev = dict(e)
            pid = int(ev.get("pid", 0))
            ev["pid"] = pid
            ev["tid"] = _TID_NATIVE
            ev["ts"] = round(float(ev.get("ts", 0.0)) + shift_us)
            if anchor_wall is None:
                ev.setdefault("args", {})
                if isinstance(ev["args"], dict):
                    ev["args"]["merge.unanchored"] = True
            out.append(ev)
            if pid not in seen_tids:
                seen_tids.add(pid)
                out.append({"name": "thread_name", "ph": "M", "pid": pid,
                            "tid": _TID_NATIVE,
                            "args": {"name": "native runtime"}})
                if pid not in ranks:
                    out.append({"name": "process_name", "ph": "M",
                                "pid": pid, "tid": _TID_NATIVE,
                                "args": {"name": f"rank {pid}"}})

    return {"traceEvents": out, "displayTimeUnit": "ms"}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.debug.merge",
        description="Merge per-rank flight dumps (+ the native Chrome "
                    "timeline) into one clock-aligned Chrome trace.")
    p.add_argument("dumps", nargs="*",
                   help="flight_rank<N>.json files (one per rank)")
    p.add_argument("-o", "--output", default="merged_trace.json")
    p.add_argument("--timeline", default=None,
                   help="native Chrome timeline (HVD_TPU_TIMELINE file)")
    p.add_argument("--from-fleet", default=None, metavar="RDV_ADDR",
                   help="fetch dumps from a live fleet via its "
                        "rendezvous KV (host:port) — one request per "
                        "host when per-host observers are running, "
                        "per-rank otherwise")
    p.add_argument("--trace", default=None, metavar="TRACE_ID",
                   help="emit only this request's trace.* spans "
                        "(serving/tracing.py trace id) — one "
                        "clock-aligned single-request trace across "
                        "every replica that touched it")
    args = p.parse_args(argv)
    if not args.dumps and not args.from_fleet:
        p.error("give dump files or --from-fleet RDV_ADDR")

    dumps = [load_dump(path) for path in args.dumps]
    if args.from_fleet:
        fetched = fetch_fleet_dumps(args.from_fleet)
        dumps.extend(fetched[r] for r in sorted(fetched))
    if args.trace:
        n_in = len(dumps)
        dumps = filter_trace(dumps, args.trace)
        spans = sum(len(d.get("events", [])) for d in dumps)
        sys.stderr.write(
            f"trace {args.trace}: {spans} span(s) across "
            f"{len(dumps)}/{n_in} dump(s)\n")
        if not dumps:
            sys.stderr.write(
                "no spans found — was the request sampled? "
                "(HVD_TPU_TRACE_SAMPLE, or force via x-hvd-trace)\n")
    timeline = load_timeline(args.timeline) if args.timeline else None
    trace = merge_dumps(dumps, timeline_events=timeline)
    with open(args.output, "w", encoding="utf-8") as f:
        json.dump(trace, f)
    pids = sorted({e.get("pid") for e in trace["traceEvents"]})
    sys.stderr.write(
        f"merged {len(dumps)} flight dump(s)"
        + (" + native timeline" if timeline else "")
        + f" -> {args.output} ({len(trace['traceEvents'])} events, "
        f"process rows for ranks {pids})\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
