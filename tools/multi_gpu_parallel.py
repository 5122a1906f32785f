#!/usr/bin/env python3
"""Sequence parallelism and the GSPMD ZeRO plane across several GPUs.

    python3 tools/multi_gpu_parallel.py [--world 4] [--device cuda|cpu]
        [--small]

Starts ``--world`` processes, one a GPU (NCCL; ``--device cpu``: gloo on
the CPU, with ``--small`` shapes, to rehearse the same program), and:

1. ring and Ulysses attention at sp = world over the sequence of a seeded
   (1, 8192, 16, 64) bf16 q/k/v (``--small``: (1, 256, 4, 32) fp32): each
   rank its shard; the joined outputs and dq/dk/dv against one
   ``flash_attention`` call over the whole sequence (out atol 2e-2, grads
   atol 5e-2 rtol 1e-2, each also ≤ 1e-2 normwise: the kernels'
   tolerances); the kernel launches of a rank, and the host time of a
   forward and backward (median of 5, ending in a synchronize and a
   barrier) against the one call's;
2. the flagship of chip_smoke.py (vocab 8192, d_model 512, 8 heads, d_ff
   2048, 8 layers, seq 512, bf16, batch 8 a rank; ``--small``: a 2-layer
   toy) through ``gspmd.make_zero_train_step`` on ``hvd.mesh()`` at stages
   1, 2, 3 and 2 on int8, beside ``ZeroShardedOptimizer`` at the same
   stage, 5 steps each, AdamW(3e-4, wd 1e-4): losses (the two planes sum
   the ranks' gradients in different orders: held within rtol 1e-4),
   host step (median of steps 1-4), peak memory of a rank, collectives a
   step, and the GSPMD state's ``residency_report``.

Prints one JSON line per result from rank 0 and writes them to
chiprun_out/multi_gpu_parallel.json; exits non-zero if a check fails.
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
COUNTED = ("all_reduce", "all_to_all_single", "all_gather_into_tensor",
           "reduce_scatter_tensor")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _close(torch, got, want, atol, rtol):
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    rel = ((got.float() - want.float()).norm()
           / want.float().norm().clamp_min(1e-30)).item()
    assert rel <= 1e-2, rel
    return (got.float() - want.float()).abs().max().item(), rel


def _sync(torch, dist, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dist.barrier()


def sequence_parallel(torch, dist, hvd, dev, world, small):
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import ring_attention as ra
    from horovod_tpu_torch.parallel import ulysses
    b, s, h, d = (1, 256, 4, 32) if small else (1, 8192, 16, 64)
    dtype = torch.float32 if small else torch.bfloat16
    g = torch.Generator().manual_seed(31)
    q, k, v, do = (torch.randn((b, s, h, d), generator=g).to(dev, dtype)
                   for _ in range(4))
    rank = dist.get_rank()
    rows = slice(rank * s // world, (rank + 1) * s // world)
    group = hvd.mesh().get_group("data")
    out = {}

    def one_call():
        whole = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        fa.flash_attention(*whole, causal=True).backward(do)
        return whole

    def sharded(fn):
        shard = [t[:, rows].detach().clone().requires_grad_()
                 for t in (q, k, v)]
        o = fn(*shard, group, causal=True)
        o.backward(do[:, rows])
        return o, shard

    whole = one_call()
    o_whole = fa.flash_attention(q, k, v, causal=True)
    for name, fn in (("ring", ra.ring_attention),
                     ("ulysses", ulysses.ulysses_attention)):
        fa.reset_launches()
        o, shard = sharded(fn)
        _sync(torch, dist, dev)
        launches = dict(fa.launches)
        joined = [torch.cat(hvd.allgather(t.contiguous()).split(
            b, dim=0), dim=1) for t in
            [o.detach()] + [x.grad for x in shard]]
        errs = {"out": _close(torch, joined[0], o_whole, 2e-2, 1e-3)}
        for what, got, w in zip(("dq", "dk", "dv"), joined[1:], whole):
            errs[what] = _close(torch, got, w.grad, 5e-2, 1e-2)
        times = {}
        for label, run in (("sharded", lambda: sharded(fn)),
                           ("one_call", one_call)):
            samples = []
            for _ in range(6):
                _sync(torch, dist, dev)
                t0 = time.perf_counter()
                run()
                _sync(torch, dist, dev)
                samples.append(time.perf_counter() - t0)
            times[label] = statistics.median(samples[1:]) * 1e3
        out[name] = {"shape": (b, s, h, d), "world": world,
                     "launches_rank0": launches, "errs": errs,
                     "fwd_bwd_host_ms": times}
    return out


def zero_planes(torch, dist, hvd, dev, world, small):
    import functools
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import gspmd

    class Counted:
        def __init__(self):
            self.counts = dict.fromkeys(COUNTED, 0)
            self.saved = {n: getattr(dist, n) for n in COUNTED}

        def __enter__(self):
            for n in COUNTED:
                def call(*a, n=n, **kw):
                    t = a[0] if a else kw.get("tensor")
                    if not (n == "all_reduce" and t.numel() == 1):
                        self.counts[n] += 1
                    return self.saved[n](*a, **kw)
                setattr(dist, n, call)
            return self

        def __exit__(self, *exc):
            for n, f in self.saved.items():
                setattr(dist, n, f)

    cfg = tfm.TransformerConfig(
        vocab_size=256, d_model=64, n_heads=4, d_ff=128, n_layers=2,
        seq_len=32, dtype=torch.float32) if small else \
        tfm.TransformerConfig(vocab_size=8192, d_model=512, n_heads=8,
                              d_ff=2048, n_layers=8, seq_len=512,
                              dtype=torch.bfloat16)
    par = tfm.ParallelConfig()
    batch = tfm.synthetic_batch(cfg, 2 if small else 8,
                                seed=1 + dist.get_rank(), device=dev)
    adamw = functools.partial(torch.optim.AdamW, lr=3e-4, weight_decay=1e-4)
    n_steps = 5
    out = {}
    for stage, wire in ((1, None), (2, None), (3, None), (2, "int8")):
        runs = {}
        for plane in ("flat", "gspmd"):
            if dev.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            model = tfm.Transformer(cfg, par, seed=0, device=dev)
            state = None
            if plane == "flat":
                train = tfm.make_train_step(cfg, par, model,
                                            hvd.ZeroShardedOptimizer(
                                                model, adamw, stage=stage,
                                                compression=wire))

                def step():
                    return train(*batch)
            else:
                fns = gspmd.make_zero_train_step(
                    lambda p, bt: torch.func.functional_call(model, p, bt),
                    adamw, hvd.mesh(), stage=stage, compression=wire)
                params, state = fns.init(dict(model.named_parameters()))
                for p in model.parameters():
                    p.data = p.data.new_empty(0)

                def step():
                    return fns.step(params, state, batch)[2]
            losses, times = [], []
            for i in range(n_steps):
                _sync(torch, dist, dev)
                t0 = time.perf_counter()
                if i == 1:
                    with Counted() as counted:
                        loss = step()
                else:
                    loss = step()
                _sync(torch, dist, dev)
                times.append(time.perf_counter() - t0)
                losses.append(loss.item())
            run = {"losses": losses,
                   "step_ms": statistics.median(times[1:]) * 1e3,
                   "calls_per_step": {n: c for n, c in
                                      counted.counts.items() if c}}
            if dev.type == "cuda":
                run["peak_mib"] = (torch.cuda.max_memory_allocated()
                                   - base) / 2**20
            if state is not None:
                run["residency"] = gspmd.residency_report(
                    (params, state), hvd.mesh())
            runs[plane] = run
            del model, state
        worst = max(abs(a - b) / abs(b) for a, b in
                    zip(runs["gspmd"]["losses"], runs["flat"]["losses"]))
        assert worst <= 1e-4, (stage, wire, runs)
        out[f"stage{stage}" + ("" if wire is None else f"_{wire}")] = dict(
            runs, max_rel_loss_diff=worst)
    return out


def rank_main(rank, world, port, device, small, out_path):
    sys.path.insert(0, ROOT)
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(world),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(world),
                      HOROVOD_CROSS_RANK="0", HOROVOD_CROSS_SIZE="1")
    import torch
    import torch.distributed as dist
    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    else:
        torch.cuda.set_device(rank)
    dist.init_process_group("gloo" if device == "cpu" else "nccl",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    import horovod_tpu_torch as hvd
    hvd.init(device=device)
    try:
        dev = hvd.device()
        report = {"device": torch.cuda.get_device_name(dev)
                  if dev.type == "cuda" else "cpu", "world": world,
                  "sequence_parallel": sequence_parallel(
                      torch, dist, hvd, dev, world, small),
                  "zero_planes": zero_planes(torch, dist, hvd, dev, world,
                                             small)}
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(report, f)
    finally:
        hvd.shutdown()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    import tempfile
    import torch
    import torch.multiprocessing as mp
    if args.device == "cuda" and torch.cuda.device_count() < args.world:
        print(f"needs {args.world} GPUs, found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "report.json")
        mp.start_processes(rank_main, args=(args.world, _free_port(),
                                            args.device, args.small,
                                            out_path),
                           nprocs=args.world, join=True,
                           start_method="spawn")
        with open(out_path) as f:
            report = json.load(f)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "multi_gpu_parallel.json"), "w") as f:
        json.dump(report, f, indent=1)
    for part in ("sequence_parallel", "zero_planes"):
        for name, res in report[part].items():
            print(json.dumps({"part": part, "name": name, **res}))
    print(json.dumps({"device": report["device"], "world": report["world"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
