#!/usr/bin/env python3
"""The negotiated eager plane across several GPUs.

    python3 tools/multi_gpu_eager.py [--world 4] [--device cuda|cpu]
        [--small] [--drill hang]

Starts ``--world`` processes, one a GPU (NCCL; ``--device cpu``: gloo on
the CPU, with ``--small`` shapes, to rehearse the same program), each with
the native controller attached (``init(use_controller=True)``), on the
flagship of chip_smoke.py (vocab 8192, d_model 512, 8 heads, d_ff 2048,
8 layers, seq 512, bf16, batch 8 a rank, fp32 parameters; ``--small``: a
2-layer toy):

1. each rank's step-0 local gradients, enqueued by name in a
   rank-permuted order (``allreduce_async`` of every gradient, then the
   waits), against the flat ``DistributedOptimizer`` (one NCCL allreduce
   a parameter, no controller) on the same gradients: within 4 fp32 ulps
   of the tensor's largest magnitude (a fused buffer moves each element's
   offset, and with it the order the ring sums the ranks in);
2. 6 training steps, AdamW(3e-4, wd 1e-4), without the controller and
   with it: losses (held within rtol 1e-4 for the summation order),
   ``all_reduce`` calls a step at ``torch.distributed`` (per parameter
   against fused responses), names per response, response-cache hits a
   step, host step (median of steps 1-5, each ending in a synchronize and
   a barrier) and peak memory of a rank;
3. 6 steps with the coordinator's stamped int8 wire on the device plane
   (``set_wire_compression("int8")`` on rank 0): losses finite and
   falling, bytes raw and sent a step, host step.

``--drill hang`` runs the hang drill instead: every rank attaches the
controller with the debug endpoint published on a rendezvous KV this
process serves (``init()`` does both, and starts the stall watchdog on
rank 0), and after a warm-up allreduce rank 2 records a ``data.wait``
and holds back the negotiated allreduce "held" for ``HOLD_S``, past the
stall window ``HOROVOD_STALL_CHECK_TIME_SECONDS`` (``STALL_S``).  Rank
0's watchdog must write one hang report naming "held" and rank 2, with
rank 2's state (reachable, input-bound, its last events) fetched from
its ``/debug/flight``; the allreduce then completes with the world's
sum on every rank.

Prints one JSON line per result from rank 0 and writes them to
chiprun_out/multi_gpu_eager.json (the drill: multi_gpu_eager_hang.json);
exits non-zero if a check fails.
"""

import argparse
import datetime
import json
import math
import os
import socket
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STEPS = 6
# The hang drill: the stall window, how long rank 2 holds "held" back,
# and the rank that does.
STALL_S, HOLD_S, HELD_RANK = 2, 8.0, 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _sync(torch, dist, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dist.barrier()


def _ulps(torch, got, want):
    """max |got - want| in fp32 ulps (2^-23) of the tensor's largest
    magnitude, the measure of ROADMAP queue 3's "4 fp32 ulps"."""
    scale = 2.0 ** -23 * want.abs().max().clamp_min(1e-30)
    return ((got - want).abs().max() / scale).item()


class _Counted:
    """Counts ``dist.all_reduce`` calls of more than one element."""

    def __init__(self, dist):
        self.dist, self.calls = dist, 0
        self.saved = dist.all_reduce

    def __enter__(self):
        def call(*a, **kw):
            t = a[0] if a else kw.get("tensor")
            if t.numel() > 1:
                self.calls += 1
            return self.saved(*a, **kw)
        self.dist.all_reduce = call
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce = self.saved


def _train(torch, dist, hvd, tfm, cfg, par, batch, dev, ctl=None):
    """N_STEPS steps of a fresh seed-0 flagship with DistributedOptimizer:
    losses, host step, all_reduce calls a step (steps 1..), peak memory,
    and the controller's counters a step."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    model = tfm.Transformer(cfg, par, seed=0, device=dev)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=3e-4, weight_decay=1e-4))
    step = tfm.make_train_step(cfg, par, model, opt)
    losses, times, snaps = [], [], [ctl.stats()] if ctl else []
    with _Counted(dist) as counted:
        for i in range(N_STEPS):
            if i == 1:
                counted.calls = 0
            _sync(torch, dist, dev)
            t0 = time.perf_counter()
            loss = step(*batch)
            _sync(torch, dist, dev)
            times.append(time.perf_counter() - t0)
            losses.append(loss.item())
            if ctl:
                snaps.append(ctl.stats())
    run = {"losses": losses,
           "step_ms": statistics.median(times[1:]) * 1e3,
           "all_reduce_per_step": counted.calls / (N_STEPS - 1)}
    if dev.type == "cuda":
        run["peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    if ctl:
        run["cache_hits_per_step"] = [
            b["cache_hits"] - a["cache_hits"] for a, b in zip(snaps,
                                                             snaps[1:])]
        run["responses_per_step"] = [
            b["responses"] - a["responses"] for a, b in zip(snaps,
                                                           snaps[1:])]
        run["bytes_raw_per_step"] = [
            b["bytes_raw"] - a["bytes_raw"] for a, b in zip(snaps,
                                                           snaps[1:])]
        run["bytes_sent_per_step"] = [
            b["bytes_sent"] - a["bytes_sent"] for a, b in zip(snaps,
                                                             snaps[1:])]
        run["names_per_response"] = snaps[-1]["names_per_response"]
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    return run


def rank_main(rank, world, ports, device, small, out_path):
    sys.path.insert(0, ROOT)
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(world),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(world),
                      HOROVOD_CROSS_RANK="0", HOROVOD_CROSS_SIZE="1",
                      HVD_TPU_CYCLE_TIME="1")
    import numpy as np
    import torch
    import torch.distributed as dist
    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    else:
        torch.cuda.set_device(rank)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.models import transformer as tfm
    cfg = tfm.TransformerConfig(
        vocab_size=256, d_model=64, n_heads=4, d_ff=128, n_layers=2,
        seq_len=32, dtype=torch.float32, remat=False) if small else \
        tfm.TransformerConfig(vocab_size=8192, d_model=512, n_heads=8,
                              d_ff=2048, n_layers=8, seq_len=512,
                              dtype=torch.bfloat16, remat=False)
    par = tfm.ParallelConfig()

    def init(controller: bool, run: int):
        dist.init_process_group(
            "gloo" if device == "cpu" else "nccl",
            init_method=f"tcp://localhost:{ports[run]}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=300))
        hvd.init(device=device, use_controller=controller)
        return hvd.device()

    report = {"world": world}
    # Without the controller: the flat step-0 reduction and the training.
    dev = init(False, 0)
    report["device"] = torch.cuda.get_device_name(dev) \
        if dev.type == "cuda" else "cpu"
    batch = tfm.synthetic_batch(cfg, 2 if small else 8, seed=1 + rank,
                                device=dev)
    model = tfm.Transformer(cfg, par, seed=0, device=dev)
    tfm.forward_loss(cfg, par, model, *batch).backward()
    local = [p.grad.detach().clone() for p in model.parameters()]
    names = [n for n, _ in model.named_parameters()]
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.0))
    opt.synchronize()
    flat = [p.grad.detach().clone() for p in model.parameters()]
    del model, opt
    report["flat"] = _train(torch, dist, hvd, tfm, cfg, par, batch, dev)
    hvd.shutdown()
    dist.destroy_process_group()

    # With the controller.
    os.environ["HVD_TPU_CONTROLLER_ADDR"] = f"127.0.0.1:{ports[2]}"
    dev = init(True, 1)
    ctl = global_state.controller
    order = np.random.default_rng(rank).permutation(len(local)).tolist()
    _sync(torch, dist, dev)
    t0 = time.perf_counter()
    hs = {i: hvd.allreduce_async(local[i],
                                 name=f"DistributedOptimizer.grad.{i}")
          for i in order}
    got = {i: hvd.synchronize(h) for i, h in hs.items()}
    _sync(torch, dist, dev)
    ulps = {names[i]: _ulps(torch, got[i], flat[i])
            for i in range(len(local))}
    report["permuted"] = {"order_rank0": order, "max_ulps": ulps,
                          "seconds": time.perf_counter() - t0,
                          "names_per_response":
                              ctl.stats()["names_per_response"]}
    assert max(ulps.values()) <= 4, ulps
    report["controller"] = _train(torch, dist, hvd, tfm, cfg, par, batch,
                                  dev, ctl)
    worst = max(abs(a - b) / abs(b) for a, b in
                zip(report["controller"]["losses"],
                    report["flat"]["losses"]))
    report["controller"]["max_rel_loss_diff"] = worst
    assert worst <= 1e-4, report
    if rank == 0:
        ctl.set_wire_compression("int8")
    hvd.barrier()
    report["controller_int8"] = _train(torch, dist, hvd, tfm, cfg, par,
                                       batch, dev, ctl)
    sent = report["controller_int8"]["bytes_sent_per_step"][1:]
    raw = report["controller_int8"]["bytes_raw_per_step"][1:]
    assert all(0 < s < r for s, r in zip(sent, raw)), (sent, raw)
    hvd.shutdown()
    dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(report, f)


def hang_main(rank, world, ports, device, small, out_path):
    """The hang drill's rank (the module's docstring)."""
    sys.path.insert(0, ROOT)
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(world),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(world),
                      HOROVOD_CROSS_RANK="0", HOROVOD_CROSS_SIZE="1",
                      HVD_TPU_CYCLE_TIME="1", HVD_TPU_FLIGHT_HOST="127.0.0.1",
                      HVD_TPU_CONTROLLER_ADDR=f"127.0.0.1:{ports[2]}",
                      HOROVOD_STALL_CHECK_TIME_SECONDS=str(STALL_S))
    import faulthandler
    import glob
    import torch
    import torch.distributed as dist
    faulthandler.enable(all_threads=True)   # a crash's Python stacks
    if device == "cuda":
        torch.cuda.set_device(rank)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import debug
    dist.init_process_group(
        "gloo" if device == "cpu" else "nccl",
        init_method=f"tcp://localhost:{ports[0]}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=300))
    hvd.init(device=device, use_controller=True)
    dev = hvd.device()
    x = torch.ones(1 << (10 if small else 20), device=dev)
    warm = hvd.allreduce(x, op=hvd.Sum, name="warm")
    if rank == HELD_RANK:
        debug.record("data.wait", "drill_loader", waited_s=HOLD_S)
        time.sleep(HOLD_S)
    t0 = time.perf_counter()
    held = hvd.allreduce(x, op=hvd.Sum, name="held")
    held_s = time.perf_counter() - t0
    assert float(warm[0]) == float(held[-1]) == world, (warm, held)
    hvd.barrier()
    report = {"world": world, "held_s_rank0": held_s,
              "device": torch.cuda.get_device_name(dev)
              if dev.type == "cuda" else "cpu"}
    if rank == 0:
        paths = sorted(glob.glob(os.path.join(
            os.environ["HVD_TPU_FLIGHT_DIR"], "hang_report_*.json")))
        with open(paths[0]) as f:
            rep = json.load(f)
        report.update(reports=len(paths), report=rep)
        (held_stall,) = [s for s in rep["stalled"] if s["name"] == "held"]
        assert held_stall["type_name"] == "allreduce", held_stall
        assert held_stall["missing"] == [HELD_RANK], held_stall
        assert rep["missing_ranks"] == [HELD_RANK], rep["missing_ranks"]
        late = rep["ranks"][str(HELD_RANK)]
        assert late["missing"] and late["reachable"], late
        assert late["attribution"] == "input-bound", late["attribution"]
        assert "data.wait" in [e["kind"] for e in late["last_events"]]
        assert all(e["reachable"] for e in rep["ranks"].values())
    hvd.shutdown()
    dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(report, f)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--drill", choices=("hang",), default=None)
    args = ap.parse_args()
    import tempfile
    import torch
    import torch.multiprocessing as mp
    if args.device == "cuda" and torch.cuda.device_count() < args.world:
        print(f"needs {args.world} GPUs, found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    if args.drill == "hang":
        return hang_drill(args, mp)
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "report.json")
        ports = [_free_port() for _ in range(3)]
        mp.start_processes(rank_main, args=(args.world, ports, args.device,
                                            args.small, out_path),
                           nprocs=args.world, join=True,
                           start_method="spawn")
        with open(out_path) as f:
            report = json.load(f)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "multi_gpu_eager.json"), "w") as f:
        json.dump(report, f, indent=1)
    for part in ("permuted", "flat", "controller", "controller_int8"):
        print(json.dumps({"part": part, **report[part]}))
    print(json.dumps({"device": report["device"], "world": report["world"]}))
    return 0


def hang_drill(args, mp) -> int:
    """Runs the hang drill's ranks beside a rendezvous KV of this process
    and writes their report."""
    import tempfile
    sys.path.insert(0, ROOT)
    from horovod_tpu_torch.runner.rendezvous import RendezvousServer
    kv = RendezvousServer(host="127.0.0.1", port=0)
    kv.start()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.environ.update(HVD_TPU_RENDEZVOUS_ADDR=f"127.0.0.1:{kv.port}",
                              HVD_TPU_FLIGHT_DIR=tmp)
            out_path = os.path.join(tmp, "report.json")
            ports = [_free_port() for _ in range(3)]
            t0 = time.perf_counter()
            mp.start_processes(hang_main, args=(args.world, ports,
                                                args.device, args.small,
                                                out_path),
                               nprocs=args.world, join=True,
                               start_method="spawn")
            with open(out_path) as f:
                report = json.load(f)
            report["seconds"] = time.perf_counter() - t0
    finally:
        kv.stop()
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "multi_gpu_eager_hang.json"), "w") as f:
        json.dump(report, f, indent=1)
    rep = report["report"]
    print(json.dumps({"drill": "hang", "device": report["device"],
                      "world": report["world"],
                      "seconds": report["seconds"],
                      "held_s_rank0": report["held_s_rank0"],
                      "reports": report["reports"],
                      "stalled": rep["stalled"],
                      "missing_ranks": rep["missing_ranks"],
                      "rank2": {k: rep["ranks"]["2"][k] for k in
                                ("missing", "reachable", "attribution")},
                      "rank2_last_events": [
                          (e["kind"], e["name"]) for e in
                          rep["ranks"]["2"]["last_events"]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
