"""Worker bodies of the telemetry plane's multi-rank tests
(test_torch_port_observatory.py, test_torch_port_telemetry_families.py,
test_torch_port_debug.py): two gloo ranks, started once per test process
and part by ``_torch_port_pool.part_results``, each writing
``<part><rank>.pt``.

* ``telemetry``: each rank runs the eager collectives on seeded inputs
  and keeps the metric families they moved, then closes ``N_STEPS``
  steps of seeded wall times through ``metrics.step_end`` and runs one
  ``metrics.sync()``.
* ``hang``: the reference's forced hang (tests/test_debug_flight.py)
  through ``init()``: both ranks attach the native controller with the
  debug endpoint published on the test's rendezvous KV; rank 1 records a
  ``data.wait`` and never submits the allreduce "never", and rank 0's
  stall watchdog, started by ``init()``, writes the hang report.
* ``observe``: four ranks as two hosts of two (``LOCAL_SIZE=2``) under
  ``HVD_TPU_METRICS_TREE``, a host observer on each host's local rank 0
  and the test's rendezvous KV: the same seeded steps synced through
  the tree and then through the flat allgather (the straggler verdicts
  of both), a hang report collected one request per host, and a tree
  round with host 1's observer stopped.

Torch only: the ranks import neither JAX nor horovod_tpu."""

import os
import time

import numpy as np

WORLD = 2
N_STEPS = 12
STEP_FLOPS = 3.0e9
PEAK_TFLOPS = "100"


def step_times(rank: int) -> list:
    """Seeded step wall times: rank 1 four times slower (a straggler at
    the default factor 1.5)."""
    rng = np.random.default_rng(30 + rank)
    base = 0.010 if rank == 0 else 0.040
    return [float(base * (1.0 + 0.05 * z))
            for z in rng.standard_normal(N_STEPS)]


def op_inputs(rank: int) -> dict:
    rng = np.random.default_rng(40 + rank)
    return {"x": rng.standard_normal((5, 7)).astype(np.float32),
            "g": rng.standard_normal((3, 4)).astype(np.float32),
            "a": rng.standard_normal((4, 3)).astype(np.float32),
            "rs": rng.standard_normal((4, 3)).astype(np.float32)}


def run_ops(hvd, inp: dict) -> None:
    """The eager collectives of the families check, by name; ``inp``
    holds the package's tensor type (torch tensors or numpy arrays)."""
    hvd.allreduce(inp["x"], name="t.ar")
    hvd.allreduce(inp["x"], op=hvd.Sum, name="t.sum")
    hvd.allgather(inp["g"], name="t.ag")
    hvd.broadcast(inp["x"], 0, name="t.bc")
    hvd.alltoall(inp["a"], name="t.a2a")
    hvd.reducescatter(inp["rs"], name="t.rs")
    hvd.synchronize(hvd.allreduce_async(inp["x"], name="t.async"))


def family_delta(before: dict, after: dict) -> dict:
    """{family: {"kind", "series": {label key string: value}}} of the
    series whose value moved between ``before`` and ``after`` (two
    ``registry().snapshot()``s; a series new in ``after`` moved from 0);
    a histogram's value is its count."""
    out = {}
    for name, fam in after.items():
        old = {tuple(sorted(s["labels"].items())): s
               for s in before.get(name, {}).get("series", [])}
        moved = {}
        for s in fam["series"]:
            key = tuple(sorted(s["labels"].items()))
            v = s["count"] if fam["kind"] == "histogram" else s["value"]
            prev = old.get(key)
            pv = None if prev is None else (
                prev["count"] if fam["kind"] == "histogram"
                else prev["value"])
            pv = 0.0 if pv is None else pv
            if pv != v:
                moved[",".join(f"{k}={x}" for k, x in key)] = v - pv
        if moved:
            out[name] = {"kind": fam["kind"], "series": moved}
    return out


def telemetry_part(rank, world, rendezvous, out_dir):
    from _torch_port_workers import _topology_env
    _topology_env(rank, world, 1)
    os.environ.update({"HVD_TPU_PEAK_TFLOPS": PEAK_TFLOPS,
                       "HVD_TPU_FLIGHT_DIR": out_dir})
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import debug, metrics
    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"file://{rendezvous}")
    res = {}
    reg = metrics.registry()
    inp = {k: torch.from_numpy(v) for k, v in op_inputs(rank).items()}
    before = reg.snapshot()
    # New events by sequence number, not position: a full ring stops
    # growing.
    seq0 = max((e["seq"] for e in debug.snapshot()), default=-1)
    run_ops(hvd, inp)
    res["families"] = family_delta(before, reg.snapshot())
    res["events"] = [(e["kind"], e["name"], e.get("op"))
                     for e in debug.snapshot() if e["seq"] > seq0]
    metrics.set_step_flops(STEP_FLOPS)
    for i, t in enumerate(step_times(rank)):
        metrics.step_end(step_time_s=t, step=i)
    metrics.step_end(step_time_s=1.0, step=N_STEPS - 1)   # absorbed
    gathered = metrics.sync()
    res["gathered"] = [{k: v for k, v in s.items() if k != "scalars"}
                       for s in gathered]
    res["scalar_keys"] = [sorted(s["scalars"]) for s in gathered]
    res["fleet"] = metrics.fleet_snapshot() == gathered
    res["report"] = [(h.rank, h.step_time_mean, h.data_wait_mean, h.score,
                      h.flagged, h.cause, h.steps, h.components)
                     for h in metrics.straggler_report()]
    snap = reg.snapshot()
    res["fleet_gauges"] = {
        n: snap[n]["series"][0]["value"]
        for n in ("hvd_mfu_fleet_min", "hvd_mfu_fleet_mean",
                  "hvd_straggler_ranks", "hvd_metrics_syncs_total")}
    res["steps_total"] = snap["hvd_steps_total"]["series"][0]["value"]
    res["dump"] = os.path.basename(debug.dump())
    hvd.shutdown()
    torch.save(res, os.path.join(out_dir, f"telemetry{rank}.pt"))


# The forced hang's stall window and the controller's stall shutdown
# (seconds), and how long rank 1 sits out.
HANG_STALL_S, HANG_SHUTDOWN_S, HANG_SIT_OUT_S = 1, 3, 6.0


def hang_part(rank, world, rendezvous, out_dir):
    import glob
    import json
    import time
    from _torch_port_workers import _topology_env
    _topology_env(rank, world, 1)
    with open(os.path.join(out_dir, "ports.json")) as f:
        (port,) = json.load(f)
    with open(os.path.join(out_dir, "kv.txt")) as f:
        kv = f.read().strip()
    reports = os.path.join(out_dir, "reports")
    os.environ.update({
        "HVD_TPU_CONTROLLER_ADDR": f"127.0.0.1:{port}",
        "HVD_TPU_RENDEZVOUS_ADDR": kv, "HVD_TPU_FLIGHT_HOST": "127.0.0.1",
        "HVD_TPU_FLIGHT_DIR": reports, "HVD_TPU_CYCLE_TIME": "1",
        "HVD_TPU_SCHEDULE_PROBE": "0",
        "HOROVOD_STALL_CHECK_TIME_SECONDS": str(HANG_STALL_S),
        "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS": str(HANG_SHUTDOWN_S)})
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import debug
    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"file://{rendezvous}")
    res = {"warmup": float(hvd.allreduce(torch.ones(4), op=hvd.Sum,
                                         name="warmup")[0])}
    if rank == 0:
        try:
            hvd.allreduce(torch.ones(4), op=hvd.Sum, name="never")
            res["error"] = None
        except Exception as e:  # noqa: BLE001 — the stall's verdict
            res["error"] = str(e)
        deadline = time.time() + 10
        found = []
        while time.time() < deadline and not found:
            found = glob.glob(os.path.join(reports, "hang_report_*.json"))
            time.sleep(0.2)
        res["reports"] = [json.load(open(p)) for p in sorted(found)]
    else:
        # The missing rank, stuck waiting on its input pipeline.
        debug.record("data.wait", "train_loader", waited_s=2.0)
        time.sleep(HANG_SIT_OUT_S)
    hvd.shutdown()
    torch.save(res, os.path.join(out_dir, f"hang{rank}.pt"))


# The observe part: steps a sync window, host 1's straggler (rank 3,
# its input pipeline slow) and the tree's deadlines (seconds).
OBSERVE_WORLD, OBSERVE_LOCAL = 4, 2
OBSERVE_STEPS = 6
OBSERVE_STRAGGLER = 3
OBSERVE_TIMEOUT_S = "2"


def observe_steps(rank: int) -> list:
    """Seeded (step time, data wait) pairs: rank 3 2.5x slower, the
    excess spent waiting for input."""
    rng = np.random.default_rng(50 + rank)
    out = []
    for z in rng.standard_normal(OBSERVE_STEPS):
        t = 0.020 * (1.0 + 0.02 * z)
        wait = 0.001
        if rank == OBSERVE_STRAGGLER:
            t, wait = t + 0.030, wait + 0.030
        out.append((float(t), wait))
    return out


def _observe_window(metrics, reg, rank: int) -> None:
    waits = reg.counter("hvd_data_wait_seconds_total",
                        "Cumulative input-pipeline wait")
    spans = reg.counter("hvd_data_wait_spans_total",
                        "Number of input-pipeline wait spans")
    for t, wait in observe_steps(rank):
        waits.inc(wait)
        spans.inc()
        metrics.step_end(step_time_s=t)


def _verdicts(metrics) -> list:
    return sorted((h.rank, h.flagged, h.cause)
                  for h in metrics.straggler_report())


def observe_part(rank, world, rendezvous, out_dir):
    from _torch_port_workers import _topology_env
    _topology_env(rank, world, OBSERVE_LOCAL)
    with open(os.path.join(out_dir, "kv.txt")) as f:
        kv = f.read().strip()
    os.environ.update({
        "HVD_TPU_RENDEZVOUS_ADDR": kv, "HVD_TPU_METRICS_TREE": "1",
        # Two names of this machine: the observers' host names, and the
        # addresses they advertise.
        "HVD_TPU_FLIGHT_HOST": ("127.0.0.1", "localhost")[
            rank // OBSERVE_LOCAL],
        "HVD_TPU_METRICS_TREE_TIMEOUT_S": OBSERVE_TIMEOUT_S,
        "HVD_TPU_ATTRIBUTION": "0", "HVD_TPU_FLIGHT_DIR": out_dir})
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import debug, metrics
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.debug import hang
    from horovod_tpu_torch.metrics import observer
    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"file://{rendezvous}")
    reg = metrics.registry()
    res = {"observer": observer.current_observer() is not None}
    dist.barrier()                     # every host's observer published

    # The tree sync, then the flat one, over the same window.
    _observe_window(metrics, reg, rank)
    res["tree_outliers"] = [o["rank"] for o in metrics.sync()]
    digest = metrics.fleet_digest()
    res["tree_digest"] = {k: digest[k] for k in (
        "round", "ranks", "hosts", "failed_hosts", "missing", "window")}
    res["tree"] = _verdicts(metrics)
    metrics.detector().reset()
    global_state.metrics_tree = False
    _observe_window(metrics, reg, rank)
    res["flat_ranks"] = [s["rank"] for s in metrics.sync()]
    res["flat"] = _verdicts(metrics)
    global_state.metrics_tree = True

    # The hang watchdog's collection: one request per host.
    debug.serve_and_publish(rank=rank, rdv_addr=kv)
    dist.barrier()
    if rank == 0:
        wd = hang.StallWatchdog(None, rdv_addr=kv)
        per_rank = []
        fallback = wd._collect_per_rank
        wd._collect_per_rank = lambda ranks: (
            per_rank.append(list(ranks)), fallback(ranks))[1]
        dumps = wd._collect_dumps(world)
        report = hang.build_hang_report(
            [{"name": "held", "type": 0, "missing": [OBSERVE_STRAGGLER]}],
            dumps, world=world, step=1, host_status=wd.last_host_status)
        res["hang"] = {"hosts": report["hosts"], "per_rank": per_rank,
                       "reachable": [report["ranks"][str(r)]["reachable"]
                                     for r in range(world)]}
    dist.barrier()

    # Host 1's observer stops: the sync still returns (the round's
    # exchange outlasts the ranks' wait, so they keep the previous
    # round's digest, counted stale, or fall back to their own), and
    # host 0's observer names host 1 failed in round 2's digest.
    if rank == OBSERVE_LOCAL:
        observer.stop_host_observer()
    dist.barrier()
    _observe_window(metrics, reg, rank)
    stale = reg.counter("hvd_metrics_tree_stale_rounds_total", "")
    stale0 = stale.value
    t0 = time.perf_counter()
    metrics.sync()
    res["failed_round_s"] = time.perf_counter() - t0
    digest = metrics.fleet_digest()
    res["failed_sync"] = {"round": digest["round"],
                          "ranks": digest["ranks"],
                          "stale": stale.value - stale0}
    if rank < OBSERVE_LOCAL:
        addr = observer.observer_addr_for(0)
        digest = observer.fetch_fleet_digest(
            addr, min_round=2, wait_s=float(OBSERVE_TIMEOUT_S))
        res["failed_digest"] = {k: digest[k] for k in (
            "round", "ranks", "hosts", "failed_hosts", "missing")}
    dist.barrier()
    debug.stop_serving()
    hvd.shutdown()
    torch.save(res, os.path.join(out_dir, f"observe{rank}.pt"))
