#!/usr/bin/env python3
"""The peer recovery tier and the self-healing wire across several GPUs.

    python3 tools/multi_gpu_recovery.py [--world 4] [--device cuda|cpu]
        [--small]

Starts ``--world`` processes, one a GPU (NCCL; ``--device cpu``: gloo on
the CPU, with ``--small`` shapes, to rehearse the same program), on the
flagship of chip_smoke.py (vocab 8192, d_model 512, 8 heads, d_ff 2048,
8 layers, seq 512, bf16, batch 8 a rank; ``--small``: a 2-layer toy):

1. ``recovery`` (twice: clean, then with ``HVD_TPU_CHAOS_NET_RESET_PCT``
   on the pushes): rank 0 serves a signed ``RendezvousServer`` KV, every
   rank publishes its ``RecoveryServer`` there.  ZeRO stage 2 AdamW
   trains 4 steps, then commits {"model": state_dict, "opt": optimizer}:
   ``extract_zero_state`` -> ``replicate`` (each rank's buddy copy pushed
   over HTTP to rank + 1) -> ``save_extracted`` -> ``seal_commit``.  Rank
   2's process exits; the three survivors destroy the process group,
   re-form a world of 3 and run ``peer_restore`` (4 -> 3) and
   ``restore_zero_state`` of the same step into fresh models and
   optimizers: bit for bit equal, and 4 steps resumed from each give the
   same losses (the restore's two gathers and its checksum verification
   timed apart).  Under chaos, every push lands (one bounded retry each)
   and ``hvd_net_retries_total{plane="http"}`` counts the retries.
2. ``eager`` (clean, then with ``HVD_TPU_CHAOS_NET_RESET_PCT`` on the
   controller's TCP mesh): the native controller attached, 30 rounds of
   named ``allreduce_async`` Sums of integer-valued tensors on the device
   plane (fused NCCL sums, exact in fp32 in any order): the chaos run's
   sums equal the clean run's bit for bit, and the ranks' ``net_counters()``
   show the reconnects.

Prints one JSON line per result from rank 0 and writes them to
chiprun_out/multi_gpu_recovery.json; exits non-zero if a check fails.
"""

import argparse
import datetime
import json
import math
import os
import socket
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMIT_AT, RESUME_STEPS, STAGE = 4, 4, 2
DEAD = 2                      # the rank whose process exits after commit
SECRET = "multi-gpu-recovery"
# A seeded reset schedule under which every rank's push fails once and
# lands on its one retry (a pure function of the seed and the order of
# each rank's requests).
PUSH_CHAOS = {"HVD_TPU_CHAOS_NET_SEED": "9",
              "HVD_TPU_CHAOS_NET_RESET_PCT": "30"}
EAGER_CHAOS = {"HVD_TPU_CHAOS_NET_SEED": "7",
               "HVD_TPU_CHAOS_NET_RESET_PCT": "1",
               "HVD_TPU_CHAOS_NET_DROP_PCT": "0.5"}
EAGER_ROUNDS = 30
EAGER_SIZES = (4096, 1000, 77)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _setup(rank, world, device):
    sys.path.insert(0, ROOT)
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(world),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(world),
                      HOROVOD_CROSS_RANK="0", HOROVOD_CROSS_SIZE="1",
                      HVD_TPU_CYCLE_TIME="1",
                      # Each rank's buddy is rank + 1 (the default stride is
                      # the local size: one host here).
                      HVD_TPU_RECOVERY_STRIDE="1")
    import torch
    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    else:
        torch.cuda.set_device(rank)
    return torch


def _init(torch, hvd, rank, world, port, device, controller=False):
    import torch.distributed as dist
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(world),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(world))
    dist.init_process_group(
        "gloo" if device == "cpu" else "nccl",
        init_method=f"tcp://localhost:{port}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=300))
    hvd.init(device=device, use_controller=controller)
    return hvd.device()


def _leave(hvd):
    import torch.distributed as dist
    hvd.shutdown()
    if dist.is_initialized():
        dist.destroy_process_group()


def _config(torch, small):
    from horovod_tpu_torch.models import transformer as tfm
    cfg = tfm.TransformerConfig(
        vocab_size=256, d_model=64, n_heads=4, d_ff=128, n_layers=2,
        seq_len=32, dtype=torch.bfloat16, remat=False) if small else \
        tfm.TransformerConfig(vocab_size=8192, d_model=512, n_heads=8,
                              d_ff=2048, n_layers=8, seq_len=512,
                              dtype=torch.bfloat16, remat=False)
    return tfm, cfg, tfm.ParallelConfig()


def _state(torch, model, opt):
    """Every parameter and optimizer tensor, cloned, by name."""
    out = {f"param.{n}": p.detach().clone()
           for n, p in model.named_parameters()}
    for i, s in enumerate(opt.shards):
        for k, v in opt.optimizer.state[s].items():
            out[f"opt.{i}.{k}"] = v.clone()
    return out


def _max_diff(torch, a, b):
    assert sorted(a) == sorted(b)
    worst = 0.0
    for k in a:
        if not torch.equal(a[k], b[k]):
            worst = max(worst, (a[k].double() - b[k].double()).abs().max()
                        .item())
    return worst


def _timed_restore_parts(rep):
    """Time the peer restore's two gathers (entries and payload bytes
    each) and its checksum verification, into ``rep``."""
    from horovod_tpu_torch import optimizers
    from horovod_tpu_torch.recovery import peer
    gather, verify = optimizers.allgather_object, peer.verify_entry
    rep["gathers"], rep["verify_s"] = [], 0.0

    def timed_gather(obj, name=None):
        t0 = time.perf_counter()
        out = gather(obj, name=name)
        entries = [e for contrib in out for e in contrib]
        rep["gathers"].append({"name": name, "entries": len(entries),
                               "bytes": sum(e.nbytes() for e in entries),
                               "s": time.perf_counter() - t0})
        return out

    def timed_verify(entry):
        t0 = time.perf_counter()
        ok = verify(entry)
        rep["verify_s"] += time.perf_counter() - t0
        return ok

    optimizers.allgather_object = timed_gather
    peer.verify_entry = timed_verify


def rank_recovery(rank, world, ports, device, small, out_dir, chaos):
    torch = _setup(rank, world, device)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint as ckpt
    from horovod_tpu_torch import net
    from horovod_tpu_torch import recovery as rec
    from horovod_tpu_torch.metrics.registry import registry
    from horovod_tpu_torch.runner.rendezvous import RendezvousServer
    os.environ.update(HVD_TPU_RENDEZVOUS_SECRET=SECRET,
                      HVD_TPU_FLIGHT_HOST="127.0.0.1")
    tfm, cfg, par = _config(torch, small)
    batch = 2 if small else 8
    root = os.path.join(out_dir, "disk", "opt_state")

    def adamw(params):
        return torch.optim.AdamW(params, lr=3e-4, weight_decay=1e-4)

    def fresh(seed):
        model = tfm.Transformer(cfg, par, seed=seed)
        return model, hvd.ZeroShardedOptimizer(model, adamw, stage=STAGE)

    def train(model, opt, r, steps, first):
        step = tfm.make_train_step(cfg, par, model, opt)
        losses = [step(*tfm.synthetic_batch(cfg, batch,
                                            seed=1000 * (first + i) + r))
                  .item() for i in range(steps)]
        assert all(math.isfinite(x) for x in losses), losses
        return losses

    def counter(name, **labels):
        return registry().counter(name, **labels).value

    rep = {"rank": rank}
    dev = _init(torch, hvd, rank, world, ports[0], device)
    rep["device"] = torch.cuda.get_device_name(dev) \
        if dev.type == "cuda" else "cpu"
    rdv = None
    if rank == 0:
        rdv = RendezvousServer(host="127.0.0.1", secret=SECRET)
        rdv.start()
    addr = hvd.broadcast_object(
        f"127.0.0.1:{rdv.port}" if rdv is not None else None)
    rep["published"] = rec.transport.serve_and_publish(rank, addr)
    os.environ["HVD_TPU_RENDEZVOUS_ADDR"] = addr
    hvd.barrier()
    model, opt = fresh(0)
    rep["losses"] = train(model, opt, rank, COMMIT_AT, 0)
    if chaos:
        os.environ.update(PUSH_CHAOS)
        net.reset_net_chaos()
    retries0 = counter("hvd_net_retries_total", plane="http")
    failures0 = counter("hvd_recovery_push_failures_total")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    ext = ckpt.extract_zero_state({"model": model.state_dict(), "opt": opt})
    rep["extract_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep["replicated_bytes"] = rec.replicate("opt_state", COMMIT_AT, ext)
    rep["replicate_s"] = time.perf_counter() - t0
    ckpt.save_extracted(root, ext, COMMIT_AT)
    rec.seal_commit("opt_state", COMMIT_AT, ext)
    rep["http_retries"] = counter("hvd_net_retries_total",
                                  plane="http") - retries0
    rep["push_failures"] = counter(
        "hvd_recovery_push_failures_total") - failures0
    for k in PUSH_CHAOS:
        os.environ.pop(k, None)
    net.reset_net_chaos()
    del model, opt, ext
    hvd.barrier()
    rep["held"] = [(e.key, e.rank, e.step, e.sealed) for e in
                   rec.store().contribution("opt_state", role="held")]
    assert rep["push_failures"] == 0, rep
    assert rep["held"] == [("opt_state", (rank - 1) % world, COMMIT_AT,
                            True)], rep
    if chaos:
        assert rep["http_retries"] > 0, rep
    if rdv is not None:
        rdv.stop()      # every lookup of the commit is done
    _leave(hvd)
    if rank == DEAD:    # this process and its memory are gone
        rec.transport.stop_serving()
        return
    survivors = [r for r in range(world) if r != DEAD]
    new_rank, new_world = survivors.index(rank), len(survivors)
    dev = _init(torch, hvd, new_rank, new_world, ports[1], device)
    _timed_restore_parts(rep)
    restored = {}
    for path in ("peer", "disk"):
        model, opt = fresh(1)
        like = {"model": model.state_dict(), "opt": opt}
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if path == "peer":
            _, _, report = rec.peer_restore("opt_state", like)
            rep["report"] = report.to_dict()
        else:
            ckpt.restore_zero_state(root, like, step=COMMIT_AT)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        rep[f"{path}_restore_s"] = time.perf_counter() - t0
        state = _state(torch, model, opt)
        rep[f"{path}_devices"] = sorted(
            {str(v.device) for k, v in state.items()
             if not k.endswith(".step")})
        rep[f"{path}_resumed"] = train(model, opt, new_rank, RESUME_STEPS,
                                       COMMIT_AT)
        restored[path] = state
        del model, opt
    rep["peer_vs_disk_max_diff"] = _max_diff(torch, restored["peer"],
                                             restored["disk"])
    assert rep["report"]["path"] == "peer" and \
        (rep["report"]["world_from"], rep["report"]["world_to"]) == \
        (world, new_world), rep["report"]
    assert rep["peer_vs_disk_max_diff"] == 0.0, rep
    assert rep["peer_resumed"] == rep["disk_resumed"], rep
    assert rep["peer_devices"] == [str(dev)], rep
    _leave(hvd)
    rec.transport.stop_serving()
    with open(os.path.join(out_dir, f"recovery{rank}.json"), "w") as f:
        json.dump(rep, f)


def rank_eager(rank, world, ports, device, small, out_dir, chaos):
    torch = _setup(rank, world, device)
    os.environ.update(HVD_TPU_CONTROLLER_ADDR=f"127.0.0.1:{ports[1]}",
                      HVD_TPU_DISABLE_SHM="1", HVD_TPU_NET_PROBE_MS="300")
    if chaos:
        os.environ.update(EAGER_CHAOS)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.state import global_state
    dev = _init(torch, hvd, rank, world, ports[0], device, controller=True)
    sums = []
    t0 = time.perf_counter()
    for i in range(EAGER_ROUNDS):
        xs = [(torch.arange(n, device=dev) % 97 + rank * 10 + i).float()
              for n in EAGER_SIZES]
        hs = [hvd.allreduce_async(x, name=f"round{i}.{j}", op=hvd.Sum)
              for j, x in enumerate(xs)]
        sums.append([hvd.synchronize(h).cpu() for h in hs])
    seconds = time.perf_counter() - t0
    counters = global_state.controller.net_counters()
    stats = global_state.controller.stats()
    _leave(hvd)
    exact = all(torch.equal(s, sum((torch.arange(n) % 97 + r * 10 + i)
                                   .float() for r in range(world)))
                for i, row in enumerate(sums)
                for s, n in zip(row, EAGER_SIZES))
    torch.save({"sums": sums, "counters": counters, "exact": exact,
                "seconds": seconds,
                "names_per_response": stats["names_per_response"]},
               os.path.join(out_dir, f"eager{rank}.pt"))


def _spawn(fn, world, device, small, out_dir, chaos):
    import torch.multiprocessing as mp
    ports = [_free_port() for _ in range(2)]
    mp.start_processes(fn, args=(world, ports, device, small, out_dir, chaos),
                       nprocs=world, join=True, start_method="spawn")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    import tempfile
    import torch
    if args.world <= DEAD:
        print(f"needs a world above {DEAD}", file=sys.stderr)
        return 2
    if args.device == "cuda" and torch.cuda.device_count() < args.world:
        print(f"needs {args.world} GPUs, found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    report = {"world": args.world}
    if args.device == "cuda":
        import subprocess
        report["cards"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
    for label, chaos in (("clean", False), ("chaos", True)):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            _spawn(rank_recovery, args.world, args.device, args.small, tmp,
                   chaos)
            ranks = []
            for r in range(args.world):
                if r == DEAD:
                    continue
                with open(os.path.join(tmp, f"recovery{r}.json")) as f:
                    ranks.append(json.load(f))
            report[f"recovery_{label}"] = {
                "seconds": time.perf_counter() - t0, "ranks": ranks}
    eager = {}
    for label, chaos in (("clean", False), ("chaos", True)):
        with tempfile.TemporaryDirectory() as tmp:
            _spawn(rank_eager, args.world, args.device, args.small, tmp,
                   chaos)
            eager[label] = [torch.load(os.path.join(tmp, f"eager{r}.pt"))
                            for r in range(args.world)]
    equal = all(torch.equal(a, b)
                for c, k in zip(eager["clean"], eager["chaos"])
                for ra, rb in zip(c["sums"], k["sums"])
                for a, b in zip(ra, rb))
    report["eager"] = {
        label: {"exact": [r["exact"] for r in runs],
                "seconds": [r["seconds"] for r in runs],
                "net_counters": [r["counters"] for r in runs],
                "names_per_response": runs[0]["names_per_response"]}
        for label, runs in eager.items()}
    report["eager"]["chaos_equals_clean"] = equal
    reconnects = sum(r["counters"]["reconnects"] for r in eager["chaos"])
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "multi_gpu_recovery.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    for label in ("clean", "chaos"):
        print(json.dumps({"part": f"recovery_{label}",
                          **report[f"recovery_{label}"]}, default=str))
    print(json.dumps({"part": "eager", **report["eager"]}, default=str))
    print(json.dumps({"world": args.world,
                      "cards": report.get("cards", ["cpu"])}))
    assert all(all(r["exact"] for r in runs) for runs in eager.values())
    assert equal, "the chaos run's sums differ from the clean run's"
    assert reconnects > 0, report["eager"]["chaos"]["net_counters"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
