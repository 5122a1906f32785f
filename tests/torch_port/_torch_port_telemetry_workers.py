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

Torch only: the ranks import neither JAX nor horovod_tpu."""

import os

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
    n0 = len(debug.snapshot())
    run_ops(hvd, inp)
    res["families"] = family_delta(before, reg.snapshot())
    res["events"] = [(e["kind"], e["name"], e.get("op"))
                     for e in debug.snapshot()[n0:]]
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
