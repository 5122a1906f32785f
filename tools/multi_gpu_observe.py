#!/usr/bin/env python3
"""The fleet-level observer across four GPUs, run as two hosts of two.

    python3 tools/multi_gpu_observe.py [--device cuda|cpu] [--small]

Starts four ranks on this machine as two hosts of two local ranks
(``HOROVOD_LOCAL_SIZE=2``, ``HOROVOD_CROSS_RANK``/``_CROSS_SIZE``): each
host sees its own pair of cards through ``CUDA_VISIBLE_DEVICES`` ("0,1"
and "2,3"), as two real hosts would, and is named by
``HVD_TPU_FLIGHT_HOST`` (``127.0.0.1`` and ``localhost``, two names of
this machine, which are also the addresses its endpoints advertise).
Every rank attaches the native controller (the hang drill needs its
stall inspector) with ``HVD_TPU_METRICS_TREE=1`` and a rendezvous KV
this process serves, so ``init()`` starts a host observer on each
host's local rank 0.  Every rank trains the flagship of chip_smoke.py
(vocab 8192, d_model 512, 8 heads, d_ff 2048, 8 layers, seq 512, bf16,
batch 8 a rank, ``DistributedOptimizer(AdamW)``; ``--small``: a 2-layer
toy) fed by ``DataLoader`` on its card; rank 3 (host 1) is an input
straggler (``HVD_TPU_CHAOS_INPUT_DELAY_MS``), and ``step_end`` runs a
metrics sync every ``SYNC`` steps.  Checks:

1. ``STEPS`` steps under the tree sync: each round's fleet digest has
   ranks 4, hosts ``[127.0.0.1, localhost]``, none failed or missing;
   then ``STEPS`` under the flat sync (the allgather): the straggler
   verdicts of the two equal, and both name rank 3 the rank with the
   most data wait a step (in a synchronous world the others' collective
   waits absorb its delay, so no step time stands out); then ``STEPS``
   of each again on the step's local part alone (forward and backward,
   no collective, each rank's step time its own): both flag rank 3, and
   it alone, with the same cause;
2. a forced hang (``tools/multi_gpu_eager.py --drill hang``'s: rank 2
   records a ``data.wait`` and holds the negotiated allreduce "held"
   back past the stall window): rank 0's watchdog writes one hang
   report, whose ``hosts`` section names both hosts' observers "ok"
   (one request per host fetched every rank's dump) and whose rank 2 is
   reachable and input-bound;
3. host 1's observer stopped: within ``METRICS_TREE_TIMEOUT_S`` (+ the
   round's seal) host 0's observer names host 1 in ``failed_hosts``,
   and the training goes on with finite losses.

It also records the coordinator's sync seconds a round, tree against
flat, and the median step of each.  ``--device cpu`` rehearses the same
program on gloo.  Prints one JSON line per result, writes them to
chiprun_out/multi_gpu_observe.json, and exits non-zero if a check fails.
"""

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, LOCAL = 4, 2
HOSTS = ("127.0.0.1", "localhost")
CARDS = ("0,1", "2,3")
STEPS, SYNC = 10, 5
STRAGGLER, DELAY_MS = 3, 100
TREE_TIMEOUT_S = 5
# The hang drill's stall window, how long rank 2 holds "held" back.
STALL_S, HOLD_S, HELD_RANK = 2, 8.0, 2
RUN_DEADLINE_S = 600


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _config(torch, small):
    from horovod_tpu_torch.models import transformer as tfm
    cfg = tfm.TransformerConfig(
        vocab_size=256, d_model=64, n_heads=4, d_ff=128, n_layers=2,
        seq_len=32, dtype=torch.bfloat16, remat=False) if small else \
        tfm.TransformerConfig(vocab_size=8192, d_model=512, n_heads=8,
                              d_ff=2048, n_layers=8, seq_len=512,
                              dtype=torch.bfloat16, remat=False)
    return tfm, cfg, tfm.ParallelConfig()


def worker(rank, device, small, port, out_dir):
    """One rank (the module's docstring); rank 0 writes the report."""
    sys.path.insert(0, ROOT)
    import glob
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import debug, metrics
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.data import ArraySource, DataLoader
    from horovod_tpu_torch.metrics import observer
    if device == "cpu":
        torch.set_num_threads(2)
    hvd.init(device=device, init_method=f"tcp://127.0.0.1:{port}",
             use_controller=True)
    dev = hvd.device()
    tfm, cfg, par = _config(torch, small)
    batch = 2 if small else 8
    model = tfm.Transformer(cfg, par, seed=0)
    hvd.broadcast_parameters(model.state_dict())
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=3e-4, weight_decay=1e-4))
    step = tfm.make_train_step(cfg, par, model, opt)
    # The loader shards the sequences over the world: enough for every
    # step of the run (STEPS four times, SYNC + 2 after the drill, a
    # warm-up) in one epoch.
    seqs = np.random.default_rng(100).integers(
        0, cfg.vocab_size, (WORLD * batch * (4 * STEPS + SYNC + 8),
                            cfg.seq_len + 1), dtype=np.int32)
    loader = DataLoader(ArraySource(seqs), batch, shuffle=True, seed=rank,
                        prefetch=False, device=str(dev))
    it = iter(loader)
    reg = metrics.registry()
    agg = metrics.aggregator()
    syncs = reg.counter("hvd_metrics_syncs_total",
                        "Cross-rank metric aggregations")
    sync_s = reg.gauge("hvd_metrics_sync_seconds",
                       "Duration of the last metrics aggregation "
                       "(gather + health scoring)")

    def one_step():
        b = next(it)
        loss = step(b[:, :-1].long(), b[:, 1:].long()).item()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return loss

    def one_local():
        """The step's forward and backward on this rank alone: no
        collective gates it, so an input delay stays on its rank."""
        b = next(it)
        loss = model(b[:, :-1].long(), b[:, 1:].long())
        loss.backward()
        model.zero_grad(set_to_none=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return loss.item()

    def window(n, local=False):
        """``n`` steps closed by step_end; losses, walls, a record a
        sync (its seconds, digest and verdicts).  ``local``: the steps
        are ``one_local``, each closed with its own time, which leaves
        out the flat sync's wait for the straggler."""
        losses, walls, rounds = [], [], []
        for _ in range(n):
            k = syncs.value
            t = time.perf_counter()
            losses.append(one_local() if local else one_step())
            walls.append(time.perf_counter() - t)
            agg.step_end(step_time_s=walls[-1] if local else None)
            if syncs.value > k:
                d = agg.fleet_digest() if global_state.metrics_tree \
                    else None
                rounds.append({
                    "seconds": sync_s.value,
                    "verdicts": sorted(
                        (h.rank, h.flagged, h.cause, h.data_wait_mean)
                        for h in metrics.straggler_report()),
                    **({k: d[k] for k in ("round", "ranks", "hosts",
                                          "failed_hosts", "missing")}
                       if d else {})})
        return {"losses": losses, "walls": walls, "rounds": rounds}

    res = {"observer": observer.current_observer() is not None}
    one_step()                                   # warm-up, not counted
    hvd.barrier()
    res["tree"] = window(STEPS)
    global_state.metrics_tree = False
    metrics.detector().reset()
    res["flat"] = window(STEPS)
    for mode in ("tree", "flat"):
        global_state.metrics_tree = mode == "tree"
        metrics.detector().reset()
        hvd.barrier()
        res[f"{mode}_local"] = window(STEPS, local=True)
    global_state.metrics_tree = True
    hvd.barrier()

    # The hang drill.
    x = torch.ones(1 << (10 if small else 20), device=dev)
    warm = hvd.allreduce(x, op=hvd.Sum, name="warm")
    if rank == HELD_RANK:
        debug.record("data.wait", "drill_loader", waited_s=HOLD_S)
        time.sleep(HOLD_S)
    held = hvd.allreduce(x, op=hvd.Sum, name="held")
    assert float(warm[0]) == float(held[-1]) == WORLD, (warm, held)
    hvd.barrier()
    if rank == 0:
        paths = sorted(glob.glob(os.path.join(
            os.environ["HVD_TPU_FLIGHT_DIR"], "hang_report_*.json")))
        with open(paths[0]) as f:
            rep = json.load(f)
        res["hang"] = {"reports": len(paths), "hosts": rep["hosts"],
                       "stalled": [s["name"] for s in rep["stalled"]],
                       "missing_ranks": rep["missing_ranks"],
                       "ranks": {r: {k: e.get(k) for k in (
                           "missing", "reachable", "attribution", "host")}
                           for r, e in rep["ranks"].items()}}

    # Host 1's observer stops; host 0's names it failed.
    if rank == LOCAL:
        observer.stop_host_observer()
    hvd.barrier()
    losses, t_sync = [], None
    for i in range(SYNC):
        if i == SYNC - 1:
            t_sync = time.perf_counter()
        losses.append(one_step())
        agg.step_end()
    failed = {"losses": losses, "sync_return_s":
              time.perf_counter() - t_sync}
    ob = observer.current_observer()
    if rank == 0:
        # The flat syncs count no round.
        rnd = len(res["tree"]["rounds"] + res["tree_local"]["rounds"]) + 1
        d = ob.fleet_digest(min_round=rnd, wait_s=TREE_TIMEOUT_S + 10)
        failed.update(named_s=time.perf_counter() - t_sync,
                      digest={k: d[k] for k in (
                          "round", "ranks", "hosts", "failed_hosts",
                          "missing")}, sync_round=rnd)
    failed["losses"] += [one_step() for _ in range(2)]
    res["failed"] = failed
    hvd.barrier()
    loader.close()
    hvd.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _check(report):
    """The checks of the module's docstring."""
    ranks = report["ranks"]
    assert [r["observer"] for r in ranks] == [True, False, True, False]
    r0 = ranks[0]
    tree, flat = r0["tree"]["rounds"], r0["flat"]["rounds"]
    assert [r["round"] for r in tree] == [1, 2], tree
    assert all((r["ranks"], r["hosts"], r["failed_hosts"], r["missing"])
               == (4, list(HOSTS), [], []) for r in tree), tree
    for a, b in zip(tree, flat):
        assert [v[:3] for v in a["verdicts"]] == \
            [v[:3] for v in b["verdicts"]], (a, b)
        for r in (a, b):
            waits = [v[3] for v in r["verdicts"]]
            assert waits.index(max(waits)) == STRAGGLER, r["verdicts"]
    tree, flat = r0["tree_local"]["rounds"], r0["flat_local"]["rounds"]
    assert len(tree) == len(flat) == 2 and all(
        (r["ranks"], r["failed_hosts"], r["missing"]) == (4, [], [])
        for r in tree), tree
    for a, b in zip(tree, flat):
        assert [v[:3] for v in a["verdicts"]] == \
            [v[:3] for v in b["verdicts"]], (a, b)
        assert [v[0] for v in a["verdicts"] if v[1]] == [STRAGGLER], a
    hang = r0["hang"]
    assert hang["reports"] == 1 and "held" in hang["stalled"], hang
    assert hang["missing_ranks"] == [HELD_RANK], hang
    assert sorted(h.split("@")[0] for h in hang["hosts"]) == \
        ["host[0]", "host[1]"] and \
        set(hang["hosts"].values()) == {"ok"}, hang["hosts"]
    late = hang["ranks"][str(HELD_RANK)]
    assert late["reachable"] and late["attribution"] == "input-bound", late
    assert all(e["reachable"] for e in hang["ranks"].values()), hang
    failed = r0["failed"]
    d = failed["digest"]
    assert (d["round"], d["ranks"], d["hosts"]) == \
        (failed["sync_round"], 2, [HOSTS[0]]), d
    assert [h.split("@")[0] for h in d["failed_hosts"]] == ["host1"], d
    assert failed["named_s"] <= TREE_TIMEOUT_S + 3, failed["named_s"]
    import math
    for r in ranks:
        assert all(math.isfinite(x) for x in r["failed"]["losses"])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(**json.loads(args.worker))
        return 0
    import tempfile
    sys.path.insert(0, ROOT)
    from horovod_tpu_torch.runner.rendezvous import RendezvousServer
    report = {"cards": ["cpu"]}
    if args.device == "cuda":
        import torch
        if torch.cuda.device_count() < WORLD:
            print(f"needs {WORLD} GPUs, found {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 2
        report["cards"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
    print(json.dumps({"cards": report["cards"]}), flush=True)
    kv = RendezvousServer(host="127.0.0.1", port=0)
    kv.start()
    procs = []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            port, ctl = _free_port(), _free_port()
            t0 = time.time()
            for rank in range(WORLD):
                cross = rank // LOCAL
                env = dict(
                    os.environ, HOROVOD_RANK=str(rank),
                    HOROVOD_SIZE=str(WORLD),
                    HOROVOD_LOCAL_RANK=str(rank % LOCAL),
                    HOROVOD_LOCAL_SIZE=str(LOCAL),
                    HOROVOD_CROSS_RANK=str(cross),
                    HOROVOD_CROSS_SIZE=str(WORLD // LOCAL),
                    CUDA_VISIBLE_DEVICES=CARDS[cross]
                    if args.device == "cuda" else "",
                    HVD_TPU_FLIGHT_HOST=HOSTS[cross],
                    HVD_TPU_RENDEZVOUS_ADDR=f"127.0.0.1:{kv.port}",
                    HVD_TPU_CONTROLLER_ADDR=f"127.0.0.1:{ctl}",
                    HVD_TPU_CYCLE_TIME="1", HVD_TPU_FLIGHT_DIR=tmp,
                    HOROVOD_STALL_CHECK_TIME_SECONDS=str(STALL_S),
                    HVD_TPU_METRICS_TREE="1",
                    HVD_TPU_METRICS_SYNC_STEPS=str(SYNC),
                    HVD_TPU_METRICS_TREE_TIMEOUT_S=str(TREE_TIMEOUT_S))
                if rank == STRAGGLER:
                    env["HVD_TPU_CHAOS_INPUT_DELAY_MS"] = str(DELAY_MS)
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--worker", json.dumps({
                         "rank": rank, "device": args.device,
                         "small": args.small, "port": port,
                         "out_dir": tmp})], env=env))
            deadline = time.time() + RUN_DEADLINE_S
            rcs = [p.wait(timeout=max(deadline - time.time(), 1))
                   for p in procs]
            report["seconds"] = time.time() - t0
            report["rcs"] = rcs
            assert rcs == [0] * WORLD, rcs
            report["ranks"] = []
            for rank in range(WORLD):
                with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                    report["ranks"].append(json.load(f))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        kv.stop()
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "multi_gpu_observe.json"), "w") as f:
        json.dump(report, f, indent=1)
    r0 = report["ranks"][0]
    for part in ("tree", "flat", "tree_local", "flat_local"):
        w = r0[part]
        print(json.dumps({"part": part, "rounds": w["rounds"],
                          "sync_s": [r["seconds"] for r in w["rounds"]],
                          "step_s": statistics.median(w["walls"][1:]),
                          "losses": w["losses"]}), flush=True)
    print(json.dumps({"part": "hang", **r0["hang"]}), flush=True)
    print(json.dumps({"part": "failed_host", **r0["failed"]}), flush=True)
    print(json.dumps({"seconds": report["seconds"]}), flush=True)
    _check(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
