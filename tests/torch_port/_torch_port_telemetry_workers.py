"""Worker bodies of the telemetry plane's multi-rank tests
(test_torch_port_observatory.py, test_torch_port_telemetry_families.py):
two gloo ranks, started once per test process by
``_torch_port_pool.part_results(..., "telemetry")``, each writing
``telemetry<rank>.pt``.  Each rank runs the eager collectives on seeded
inputs and keeps the metric families they moved, then closes
``N_STEPS`` steps of seeded wall times through ``metrics.step_end`` and
runs one ``metrics.sync()``.  Torch only: the ranks import neither JAX
nor horovod_tpu."""

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
