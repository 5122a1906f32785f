#!/usr/bin/env python3
"""The horovod.torch API of the port (``horovod_tpu_torch.torch``) across
several GPUs.

    python3 tools/multi_gpu_frontend.py [--world 4] [--device cuda|cpu]
        [--small]

Starts ``--world`` processes, one a GPU (NCCL; ``--device cpu``: gloo on
the CPU, with ``--small`` shapes, to rehearse the same program), each on
its own seeded batch:

1. the flagship of chip_smoke.py (vocab 8192, d_model 512, 8 heads, d_ff
   2048, 8 layers, seq 512, bf16, batch 8 a rank; ``--small``: a 2-layer
   fp32 toy) trained ``N_STEPS`` steps through the front end's
   ``DistributedOptimizer(AdamW, named_parameters=)`` after
   ``broadcast_parameters`` and ``broadcast_optimizer_state``, beside the
   port's ``DistributedOptimizer`` on the same seeds, without the native
   controller and with it: every rank's parameters equal bit for bit
   after each run, and the front end's losses within rtol 1e-4 of the
   port optimizer's (the fused sums' order, tools/multi_gpu_eager.py's
   bar); host step of each;
2. ``sparse_allreduce`` of a sparse tensor with distinct rows on each
   rank, against the dense mean of all ranks' tensors (bit for bit);
3. ``SyncBatchNorm`` against ``nn.BatchNorm2d`` on the gathered batch:
   outputs, input gradients and running statistics within 1e-5, the
   affine gradients summed over the ranks;
4. ``join()`` with uneven batches under the controller (rank r trains
   r + 2 batches of a linear model): each rank's parameters against a
   local replay of the world's steps, the joined ranks' zeros in the
   mean (rtol 1e-5 for the summation order), and the same answer from
   ``join()`` on every rank;
5. the Adasum delta optimizer against the port's ``adasum_allreduce`` of
   the same deltas (bit for bit).

Prints one JSON line per part from rank 0 and writes them to
chiprun_out/multi_gpu_frontend.json; exits non-zero if a check fails.
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
TOL_LOSS_REL = 1e-4
TOL_SBN = dict(rtol=1e-5, atol=1e-5)
TOL_JOIN = dict(rtol=1e-5, atol=1e-6)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _sync(torch, dist, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dist.barrier()


def _same_on_every_rank(torch, dist, tensors) -> bool:
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    root = flat.clone()
    dist.broadcast(root, src=0)
    ok = torch.tensor([int(torch.equal(root, flat))], device=flat.device)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    return bool(ok.item())


def _flagship(torch, dist, hvd, fe, tfm, cfg, par, batch, dev, frontend):
    """N_STEPS steps from seed 0: losses, host step, one-bits check."""
    model = tfm.Transformer(cfg, par, seed=0, device=dev)
    adamw = torch.optim.AdamW(model.parameters(), lr=3e-4,
                              weight_decay=1e-4)
    if frontend:
        fe.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = fe.DistributedOptimizer(
            adamw, named_parameters=model.named_parameters())
        fe.broadcast_optimizer_state(opt, root_rank=0)
    else:
        hvd.broadcast_parameters(model.state_dict())
        opt = hvd.DistributedOptimizer(adamw)
    step = tfm.make_train_step(cfg, par, model, opt)
    losses, times = [], []
    for _ in range(N_STEPS):
        _sync(torch, dist, dev)
        t0 = time.perf_counter()
        loss = step(*batch)
        _sync(torch, dist, dev)
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    same = _same_on_every_rank(torch, dist, list(model.parameters()))
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    assert same, "the ranks' parameters differ"
    return {"losses": losses, "step_ms": statistics.median(times[1:]) * 1e3,
            "same_bits_on_every_rank": same}


def _flagship_pair(torch, dist, hvd, fe, tfm, cfg, par, batch, dev):
    port = _flagship(torch, dist, hvd, fe, tfm, cfg, par, batch, dev, False)
    front = _flagship(torch, dist, hvd, fe, tfm, cfg, par, batch, dev, True)
    worst = max(abs(a - b) / abs(b)
                for a, b in zip(front["losses"], port["losses"]))
    assert worst <= TOL_LOSS_REL, (front["losses"], port["losses"])
    return {"frontend": front, "port": port, "max_rel_loss_diff": worst,
            "bit_equal": front["losses"] == port["losses"]}


def _sparse(torch, fe, rank, world, dev):
    rows, cols = 16 * world, 8

    def rank_tensor(r):
        idx = torch.arange(r * 16, r * 16 + 16, 2)
        vals = torch.full((idx.numel(), cols), float(r + 1))
        return torch.sparse_coo_tensor(idx.unsqueeze(0), vals, (rows, cols))

    got = fe.sparse_allreduce(rank_tensor(rank).to(dev), name="sp")
    want = sum(rank_tensor(r).to_dense() for r in range(world)) / world
    assert got.device == dev
    assert torch.equal(got.to_dense().cpu(), want), "sparse_allreduce"
    return {"rows_per_rank": 8, "bit_equal": True}


def _sync_batch_norm(torch, fe, rank, world, dev):
    shape = (4, 8, 6, 6)
    xs = [torch.randn(shape, generator=torch.Generator().manual_seed(100 + r))
          for r in range(world)]
    cts = [torch.randn(shape, generator=torch.Generator().manual_seed(200 + r))
           for r in range(world)]
    sbn = fe.SyncBatchNorm(8).to(dev)
    x = xs[rank].clone().to(dev).requires_grad_()
    y = sbn(x)
    (y * cts[rank].to(dev)).sum().backward()
    bn = torch.nn.BatchNorm2d(8)
    xa = torch.cat(xs).requires_grad_()
    ya = bn(xa)
    (ya * torch.cat(cts)).sum().backward()
    n = shape[0]
    rows = slice(rank * n, (rank + 1) * n)
    torch.testing.assert_close(y.detach().cpu(), ya.detach()[rows],
                               **TOL_SBN)
    torch.testing.assert_close(x.grad.cpu(), xa.grad[rows], **TOL_SBN)
    torch.testing.assert_close(sbn.running_mean.cpu(), bn.running_mean,
                               **TOL_SBN)
    torch.testing.assert_close(sbn.running_var.cpu(), bn.running_var,
                               **TOL_SBN)
    gw = fe.allreduce(sbn.weight.grad.detach(), op=fe.Sum, name="sbn.gw")
    torch.testing.assert_close(gw.cpu(), bn.weight.grad, **TOL_SBN)
    return {"max_abs_out": (y.detach().cpu() - ya.detach()[rows]).abs()
            .max().item(),
            "max_abs_grad": (x.grad.cpu() - xa.grad[rows]).abs().max()
            .item()}


def _linear(torch, dev):
    lin = torch.nn.Linear(16, 4)
    with torch.no_grad():
        g = torch.Generator().manual_seed(3)
        lin.weight.copy_(torch.randn(4, 16, generator=g))
        lin.bias.copy_(torch.randn(4, generator=g))
    return lin.to(dev)


def _batch(torch, rank, step):
    return torch.randn(8, 16, generator=torch.Generator().manual_seed(
        1000 * rank + step))


def _join(torch, fe, rank, world, dev):
    steps = [r + 2 for r in range(world)]
    model = _linear(torch, dev)
    opt = fe.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())
    for s in range(steps[rank]):
        opt.zero_grad()
        (model(_batch(torch, rank, s).to(dev)) ** 2).mean().backward()
        opt.step()
    last = fe.join()
    # The world replayed locally: each step's gradient is the mean over
    # all ranks of those still training, zeros for the joined.
    ref = _linear(torch, "cpu")
    ref_opt = torch.optim.SGD(ref.parameters(), lr=0.1, momentum=0.9)
    for s in range(steps[rank]):
        grads = [torch.zeros_like(p) for p in ref.parameters()]
        for r in range(world):
            if s < steps[r]:
                ref.zero_grad()
                (ref(_batch(torch, r, s)) ** 2).mean().backward()
                for g, p in zip(grads, ref.parameters()):
                    g += p.grad
        for g, p in zip(grads, ref.parameters()):
            p.grad = g / world
        ref_opt.step()
    for p, q in zip(model.parameters(), ref.parameters()):
        torch.testing.assert_close(p.detach().cpu(), q.detach(), **TOL_JOIN)
    return {"steps": steps, "join_returned": last}


def _adasum(torch, fe, rank, world, dev):
    from horovod_tpu_torch.ops.adasum import adasum_allreduce
    model = _linear(torch, dev)
    start = [p.detach().clone() for p in model.parameters()]
    opt = fe.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                  lr=0.1),
                                  named_parameters=model.named_parameters(),
                                  op=fe.Adasum)
    (model(_batch(torch, rank, 0).to(dev)) ** 2).mean().backward()
    opt.step()
    local = _linear(torch, dev)
    local_opt = torch.optim.SGD(local.parameters(), lr=0.1)
    (local(_batch(torch, rank, 0).to(dev)) ** 2).mean().backward()
    local_opt.step()
    for p, q, s in zip(model.parameters(), local.parameters(), start):
        want = s + adasum_allreduce(q.detach() - s)
        assert torch.equal(p.detach(), want), "adasum"
    return {"bit_equal": True}


def rank_main(rank, world, ports, device, small, out_path):
    sys.path.insert(0, ROOT)
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(world),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(world),
                      HOROVOD_CROSS_RANK="0", HOROVOD_CROSS_SIZE="1",
                      HVD_TPU_CYCLE_TIME="1")
    import torch
    import torch.distributed as dist
    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    else:
        torch.cuda.set_device(rank)
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as fe
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
        fe.init(device=device, use_controller=controller)
        return fe.device()

    report = {"world": world}
    dev = init(False, 0)
    report["device"] = torch.cuda.get_device_name(dev) \
        if dev.type == "cuda" else "cpu"
    batch = tfm.synthetic_batch(cfg, 2 if small else 8, seed=1 + rank,
                                device=dev)
    report["flat"] = _flagship_pair(torch, dist, hvd, fe, tfm, cfg, par,
                                    batch, dev)
    report["sparse"] = _sparse(torch, fe, rank, world, dev)
    report["sync_batch_norm"] = _sync_batch_norm(torch, fe, rank, world,
                                                 dev)
    report["adasum"] = _adasum(torch, fe, rank, world, dev)
    fe.shutdown()
    dist.destroy_process_group()

    os.environ["HVD_TPU_CONTROLLER_ADDR"] = f"127.0.0.1:{ports[2]}"
    dev = init(True, 1)
    report["controller"] = _flagship_pair(torch, dist, hvd, fe, tfm, cfg,
                                          par, batch, dev)
    report["join"] = _join(torch, fe, rank, world, dev)
    answers = fe.allgather(torch.tensor([report["join"]["join_returned"]],
                                        device=dev), name="join.answers")
    assert len(set(answers.tolist())) == 1, answers
    fe.shutdown()
    dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(report, f)


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
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "report.json")
        ports = [_free_port() for _ in range(3)]
        mp.start_processes(rank_main, args=(args.world, ports, args.device,
                                            args.small, out_path),
                           nprocs=args.world, join=True,
                           start_method="spawn")
        with open(out_path) as f:
            report = json.load(f)
    report["seconds"] = time.perf_counter() - t0
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "multi_gpu_frontend.json"), "w") as f:
        json.dump(report, f, indent=1)
    for part in ("flat", "controller", "sparse", "sync_batch_norm", "join",
                 "adasum"):
        print(json.dumps({"part": part, **report[part]}))
    print(json.dumps({"device": report["device"], "world": report["world"],
                      "seconds": report["seconds"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
