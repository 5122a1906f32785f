#!/usr/bin/env python3
"""The fleet gateway and the autotuner across four GPUs of one host.

    python3 tools/multi_gpu_fleet.py [--device cuda|cpu] [--small]
        [--runs multiplex,autotune]   (default: both)

``multiplex``: a ``FleetGateway`` in this process (which never
initialises CUDA) over one host of four cards, ``localhost:4``.  Job A
(priority 0, ``min_np`` 2, ``max_np`` 4) trains the flagship of
chip_smoke.py (vocab 8192, d_model 512, 8 heads, d_ff 2048, 8 layers,
seq 512, bf16, batch 8 a rank; ``--small``: a 2-layer toy) with ZeRO
stage 2 AdamW under ``@elastic.run``, its ``TpuState`` committing
{"model", "opt", "step"} after every step to the buddy tier and a
checkpoint directory.  Once A has committed twice at width 4, job B
(priority 10, np 2, the same worker) is submitted: the scheduler shrinks
A to 2 after a commit, and B runs on the two cards A freed.  When B is
done A regrows to 4 and runs ``AFTER_REGROW`` more steps.  Every worker
logs its card's UUID with each step; each sync logs the step it restored
and a sha256 of its parameters, each commit the same.  Checks: A and B
end DONE, A was preempted once (shrunk) and regrew; no card UUID served
two jobs' steps at overlapping times; the scheduler's card sets were
disjoint at every poll, A's survivors kept their cards; every sync after
the first restored the parameters of the step it names bit for bit (the
hash a committing worker logged at that step).

``autotune``: ``hvdrun-torch -np 4 --autotune`` on the four cards, the
reference's tests/test_autotune.py:307-347 worker on the negotiated
device plane: 16 concurrent 1 MB allreduces a step for 40 steps, one
warm-up window, 32 reports a window, 7 scored windows.  Checks: rank 0
saw at least two distinct proposals and froze; every rank's last fused
response took at least two sizes; the log has >= 2 samples, one final
line last, and at least two (fusion, cycle) pairs.

``--device cpu`` rehearses both on gloo (the slots pinned to the CPU:
card sets are then the scheduler's only, there are no UUIDs).  Prints
one JSON line per result, writes them to chiprun_out/multi_gpu_fleet.json
with each run's seconds, and exits non-zero if a check fails.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import textwrap
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
A_PRIORITY, B_PRIORITY = 0, 10
B_STEPS = 4
AFTER_REGROW = 3           # A's steps at width 4 after its regrow
MAX_STEPS = 400            # A's cap, should the regrow never come
PACE_S = 0.3               # a pause after each commit
RUN_DEADLINE_S = 600.0


def _log(prefix, **fields):
    slot = os.environ["HVD_TPU_ELASTIC_SLOT"]
    fields.update(slot=slot, pid=os.getpid(), t=time.time())
    with open(f"{prefix}.{slot}", "a") as f:
        f.write(json.dumps(fields) + "\n")


def _card_id(torch, device):
    if device != "cuda":
        return "cpu:" + os.environ["HVD_TPU_ELASTIC_SLOT"]
    uuid = getattr(torch.cuda.get_device_properties(0), "uuid", None)
    return str(uuid) if uuid is not None else \
        "visible:" + os.environ.get("CUDA_VISIBLE_DEVICES", "?")


def _digest(model):
    h = hashlib.sha256()
    for name, t in sorted(model.state_dict().items()):
        h.update(name.encode())
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def worker(device, small, job, log, ckpt_dir, steps):
    """One slot of a fleet job: ``steps`` steps (0 = until AFTER_REGROW
    steps at width 4 after a regrow)."""
    sys.path.insert(0, ROOT)
    import functools
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import elastic, recovery
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.models import transformer as tfm
    if device == "cpu":
        torch.set_num_threads(1)
    hvd.init()
    card = _card_id(torch, device)
    cfg = tfm.TransformerConfig(
        vocab_size=256, d_model=64, n_heads=4, d_ff=128, n_layers=2,
        seq_len=32, dtype=torch.bfloat16, remat=False) if small else \
        tfm.TransformerConfig(vocab_size=8192, d_model=512, n_heads=8,
                              d_ff=2048, n_layers=8, seq_len=512,
                              dtype=torch.bfloat16, remat=False)
    par = tfm.ParallelConfig()
    batch = 2 if small else 8
    model = tfm.Transformer(cfg, par, seed=0)
    opt = hvd.ZeroShardedOptimizer(model, functools.partial(
        torch.optim.AdamW, lr=3e-4, weight_decay=1e-4), stage=2)
    counter = torch.zeros((), dtype=torch.int64)
    state = elastic.TpuState(
        opt_state={"model": model.state_dict(), "opt": opt,
                   "step": counter}, checkpoint_dir=ckpt_dir,
        checkpoint_keep=MAX_STEPS + 1)
    step = tfm.make_train_step(cfg, par, model, opt)
    stop = {"at": steps or None}

    @elastic.run
    def train(state):
        rep = recovery.last_report()
        i0 = int(counter)
        _log(log, event="sync", job=job, round=global_state.elastic_round,
             size=hvd.size(), rank=hvd.rank(), step=i0, card=card,
             path=rep.path if rep else None, digest=_digest(model))
        if not steps and hvd.size() == 4 and global_state.elastic_round > 0:
            stop["at"] = i0 + AFTER_REGROW
        while int(counter) < (stop["at"] or MAX_STEPS):
            i = int(counter)
            tokens, labels = tfm.synthetic_batch(
                cfg, batch, seed=3000 + 100 * i + hvd.rank())
            loss = step(tokens, labels).item()
            counter.add_(1)
            digest = _digest(model)
            try:
                state.commit()
            finally:
                _log(log, event="step", job=job, step=i + 1, loss=loss,
                     size=hvd.size(), rank=hvd.rank(), card=card,
                     round=global_state.elastic_round, digest=digest)
            time.sleep(PACE_S)

    train(state)
    hvd.shutdown()


def _events(prefix):
    import glob
    out = []
    for path in glob.glob(prefix + ".*"):
        with open(path) as f:
            out += [json.loads(line) for line in f]
    return sorted(out, key=lambda e: e["t"])


def multiplex(device, small):
    sys.path.insert(0, ROOT)
    from horovod_tpu_torch import fleet
    from horovod_tpu_torch.runner.hosts import HostInfo
    report = {}
    os.environ["HVD_TPU_ELASTIC_DISCOVERY_INTERVAL"] = "0.2"
    with tempfile.TemporaryDirectory() as tmp:
        def spec(job, np_range, priority, steps):
            cmd = [sys.executable, os.path.abspath(__file__), "--worker",
                   json.dumps({"device": device, "small": small, "job": job,
                               "log": os.path.join(tmp, f"log_{job}"),
                               "ckpt_dir": os.path.join(tmp, f"ckpt_{job}"),
                               "steps": steps})]
            return fleet.JobSpec(command=cmd, min_np=np_range[0],
                                 max_np=np_range[1], priority=priority,
                                 name=job)

        gw = fleet.FleetGateway([HostInfo("localhost", 4)], port=0,
                                host="127.0.0.1",
                                fleet_dir=os.path.join(tmp, "fleet"),
                                tick_s=0.25, preempt_grace_s=120.0)
        gw.serve()
        addr = f"127.0.0.1:{gw.port}"
        polls, errors = [], []
        done = threading.Event()

        def poll():
            while not done.is_set():
                sets = gw.scheduler.card_sets()
                seen = {}
                for job, by_host in sets.items():
                    for c in by_host.get("localhost", []):
                        if c in seen:
                            errors.append((time.time(), c, seen[c], job))
                        seen[c] = job
                polls.append((time.time(), sets))
                time.sleep(0.2)

        poller = threading.Thread(target=poll, daemon=True)
        poller.start()
        t0 = time.time()
        try:
            a = fleet.submit_job(spec("A", (2, 4), A_PRIORITY, 0),
                                 addr=addr)
            deadline = t0 + RUN_DEADLINE_S
            while sum(e["event"] == "step" and e["size"] == 4
                      for e in _events(os.path.join(tmp, "log_A"))) < 8:
                assert time.time() < deadline, "A never ran at width 4"
                time.sleep(0.5)
            b = fleet.submit_job(spec("B", (2, 2), B_PRIORITY, B_STEPS),
                                 addr=addr)
            recs = {}
            while True:
                recs = {r.id: r for r in fleet.list_jobs(addr=addr)}
                if all(r.state in fleet.TERMINAL_STATES
                       for r in recs.values()):
                    break
                assert time.time() < deadline, \
                    {k: r.state for k, r in recs.items()}
                time.sleep(0.5)
        finally:
            done.set()
            poller.join(5)
            gw.close(cancel_jobs=True)
        report["seconds"] = time.time() - t0
        ev = {j: _events(os.path.join(tmp, f"log_{j}")) for j in "AB"}
    ra, rb = recs[a.id], recs[b.id]
    report["records"] = {"A": ra.to_dict(), "B": rb.to_dict()}
    report["card_set_errors"] = errors
    report["card_sets"] = polls[::10]
    # A's survivors kept their cards across the shrink: the cards of A's
    # slots 0 and 1 at its first poll equal them at every later one.
    a_sets = [s[a.id]["localhost"] for _, s in polls if a.id in s]
    report["a_card_sets"] = sorted({tuple(x) for x in a_sets})
    report["survivors_kept"] = all(x[:2] == a_sets[0][:2] for x in a_sets)
    # No card served two jobs' steps at overlapping times.
    spans = {}
    for j in "AB":
        for e in ev[j]:
            if e["event"] == "step":
                k = (e["card"], j, e["pid"])
                lo, hi = spans.get(k, (e["t"], e["t"]))
                spans[k] = (min(lo, e["t"]), max(hi, e["t"]))
    overlaps = [(ka, kb) for ka, (a0, a1) in spans.items()
                for kb, (b0, b1) in spans.items()
                if ka[0] == kb[0] and ka[1] == "A" and kb[1] == "B"
                and a0 <= b1 and b0 <= a1 and not ka[0].startswith("cpu")]
    report["cards"] = {j: sorted({e["card"] for e in ev[j]
                                  if e["event"] == "step"}) for j in "AB"}
    report["overlaps"] = overlaps
    # Each sync after the first restored the committed step bit for bit.
    committed = {(e["step"], e["digest"]) for e in ev["A"]
                 if e["event"] == "step"}
    syncs = [e for e in ev["A"] if e["event"] == "sync"]
    report["syncs"] = [(e["slot"], e["round"], e["size"], e["path"],
                        e["step"], e["card"]) for e in syncs]
    report["restored_equal"] = [
        (e["step"], e["digest"]) in committed for e in syncs if e["step"]]
    report["sizes"] = sorted({e["size"] for e in ev["A"]
                              if e["event"] == "step"})
    report["b_sizes"] = sorted({e["size"] for e in ev["B"]
                                if e["event"] == "step"})
    report["a_steps"] = max(e["step"] for e in ev["A"]
                            if e["event"] == "step")
    return report


def _check_multiplex(r):
    a, b = r["records"]["A"], r["records"]["B"]
    assert (a["state"], b["state"]) == ("done", "done"), (a, b)
    assert a["preemptions"] == 1, a
    assert r["sizes"] == [2, 4] and r["b_sizes"] == [2], r
    assert not r["card_set_errors"], r["card_set_errors"]
    assert r["survivors_kept"], r["a_card_sets"]
    assert not r["overlaps"], r["overlaps"]
    assert r["restored_equal"] and all(r["restored_equal"]), r["syncs"]
    regrow = [s for s in r["syncs"] if s[2] == 4 and s[1] > 0]
    assert regrow, r["syncs"]


AUTOTUNE_WORKER = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {root!r})
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.state import global_state

    hvd.init()
    rank = hvd.rank()
    ctl = global_state.controller
    assert ctl is not None
    if rank == 0:
        assert ctl._autotune is not None, "--autotune did not engage"
        kw = ctl._autotune_kwargs
        gates = [kw["tune_toggles"], kw["tune_compression"],
                 kw["tune_overlap"]]
    bufs = [torch.full((262144,), float(rank + 1), device=hvd.device())
            for _ in range(16)]
    fused, params, frozen_at = set(), set(), None
    for it in range(40):
        hs = [hvd.allreduce_async(b, op=hvd.Sum, name=f"at.{{it % 2}}.{{j}}")
              for j, b in enumerate(bufs)]
        for h in hs:
            hvd.synchronize(h)
        fused.add(int(ctl.last_fused_names()))
        if rank == 0:
            params.add(ctl._autotune.current)
            if ctl._autotune.frozen and frozen_at is None:
                frozen_at = it
    out = {{"rank": rank, "device": str(hvd.device()),
            "fused_counts": sorted(fused), "params_seen": len(params),
            "frozen_at": frozen_at}}
    if rank == 0:
        out["gates"] = gates
    with open({out!r} + f".{{rank}}", "w") as f:
        json.dump(out, f)
    hvd.shutdown()
""")


def autotune(device):
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result")
        log = os.path.join(tmp, "autotune.csv")
        script = os.path.join(tmp, "worker.py")
        with open(script, "w") as f:
            f.write(AUTOTUNE_WORKER.format(root=ROOT, out=out))
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
             "4", *(["--worker-platform", "cpu"] if device == "cpu" else []),
             "--autotune", "--autotune-log-file", log,
             "--autotune-warmup-samples", "1",
             "--autotune-steps-per-sample", "32",
             "--autotune-bayes-opt-max-samples", "7", sys.executable,
             script], cwd=ROOT, capture_output=True, text=True,
            timeout=RUN_DEADLINE_S,
            env=dict(os.environ, HVD_TPU_SCHEDULE_PROBE="0"))
        report["seconds"] = time.time() - t0
        report["rc"] = proc.returncode
        if proc.returncode != 0:
            report["output"] = (proc.stdout + proc.stderr)[-6000:]
            return report
        report["ranks"] = [json.load(open(f"{out}.{r}")) for r in range(4)]
        with open(log) as f:
            report["log"] = [ln.split(",") for ln in f.read().splitlines()]
    return report


def _check_autotune(r):
    assert r["rc"] == 0, r.get("output")
    r0 = r["ranks"][0]
    assert r0["params_seen"] >= 2 and r0["frozen_at"] is not None, r0
    for x in r["ranks"]:
        assert len(x["fused_counts"]) >= 2, x
    tags = [ln[0] for ln in r["log"]]
    assert tags.count("sample") >= 2, tags
    assert tags.count("final") == 1 and tags[-1] == "final", tags
    assert len({(ln[1], ln[2]) for ln in r["log"]}) >= 2, r["log"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--runs", default="multiplex,autotune")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(**json.loads(args.worker))
        return 0
    sys.path.insert(0, ROOT)
    report = {}
    if args.device == "cuda":
        from horovod_tpu_torch.runner.gpu_discovery import local_devices
        if len(local_devices()) < 4:
            print(f"needs 4 GPUs, found {len(local_devices())}",
                  file=sys.stderr)
            return 2
        report["cards"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
    print(json.dumps({"cards": report.get("cards", ["cpu"])}), flush=True)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    runs = args.runs.split(",")
    checks = {"multiplex": _check_multiplex, "autotune": _check_autotune}
    for run in runs:
        report[run] = r = (multiplex(args.device, args.small)
                           if run == "multiplex" else autotune(args.device))
        with open(os.path.join(out_dir, "multi_gpu_fleet.json"), "w") as f:
            json.dump(report, f, indent=1)
        for k, v in r.items():
            if k not in ("card_sets", "log", "output"):
                print(json.dumps({"run": run, k: v}), flush=True)
    import torch
    report["tool_process_cuda_initialized"] = torch.cuda.is_initialized()
    print(json.dumps({"tool_process_cuda_initialized":
                      report["tool_process_cuda_initialized"]}))
    for run in runs:
        checks[run](report[run])
    assert not report["tool_process_cuda_initialized"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
