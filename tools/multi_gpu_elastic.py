#!/usr/bin/env python3
"""Elastic training of the flagship across four GPUs, with a worker killed
while the ZeRO step's NCCL collectives are in flight.

    python3 tools/multi_gpu_elastic.py [--device cuda|cpu] [--small]
        [--drill kill|hang|both|autoscale]   (default: both)

Runs the port's ``ElasticDriver`` over the alias hosts ``localhost:2``,
``127.0.0.1:1`` and ``<hostname>:1`` (four ranks on one machine; each
worker pins its host's cards through ``CUDA_VISIBLE_DEVICES`` before it
imports torch: localhost GPUs 0-1, 127.0.0.1 GPU 2, the hostname GPU 3).
Every worker trains the flagship of chip_smoke.py (vocab 8192, d_model
512, 8 heads, d_ff 2048, 8 layers, seq 512, bf16, batch 8 a rank;
``--small``: a 2-layer toy) with ZeRO stage 2 AdamW under
``@elastic.run``, its ``TpuState`` committing {"model", "opt", "step"}
after every step to the buddy tier (``HVD_TPU_RECOVERY_STRIDE=1``: rank
r's copy lives with rank r + 1) and to a checkpoint directory.

Two drills, each a run of its own.  ``kill``: at step ``KILL_AT`` rank 2
(127.0.0.1) sleeps while the other ranks enter the step's reduce-scatter
and all-gather, then exits.  ``hang``: rank 2 instead hangs alive in that
step for ``HANG_S``, past the forward's negotiated loss mean and before
its reduce-scatter, so that no round is published, with the operation
deadline (``HVD_TPU_NET_OP_DEADLINE_S``) at ``HANG_DEADLINE_S``; then it
exits.  Checks:

* kill: every survivor raises ``HorovodInternalError`` within
  ``DETECT_BOUND_S`` of the death (the world watch aborts its NCCL
  communicators when the driver publishes the next round), with its
  process alive;
* hang: every survivor raises it at the deadline (the world watch finds
  a beacon of the step's collectives overdue, marks the world failed
  and aborts its communicators, all at once), within ``DETECT_BOUND_S``
  past it and before the hung peer exits, and commits nothing of that
  step: its restore is the previous step, and its resumed losses equal
  the kill drill's;
* the driver blacklists 127.0.0.1 and the three survivors re-form a world
  of 3; ``sync()`` reports ``peer`` (rank 3 holds rank 2's copy);
* the peer restore equals the disk restore of the same step bit for bit
  (every parameter, moment and the step counter);
* the steps resumed from the peer restore and, rerun, from the disk
  restore give equal losses bit for bit.

Each survivor also logs the end of its reset (a reset callback: the
failed world torn down and the next one formed), and each drill reports
the reset alone, from the survivor's error (after a hang, from the hung
peer's exit, before which no round is published), held to
``RESET_BOUND_S``.  In the hang drill a worker whose step outlasts the
deadline by 3 s writes every thread's Python stack to
``chiprun_out/multi_gpu_elastic_stacks.<slot>``.

``--drill autoscale`` (not part of ``both``) runs the serving
autoscaler's resizes instead: the same workers, with no fault, pace
their steps (``AUTOSCALE_PACE_S``) under a driver of ``min_np`` 2 and
``max_np`` 3, and ``serving.Autoscaler`` drives the driver's
``request_resize`` from a scripted status: an idle queue takes the world
from 3 to 2, queue pressure from 2 to 3, and an idle queue after the
cooldown from 3 to 2.  The driver's rounds (each survivor's sync: round,
size, restore path, step) and the workers' losses go in the JSON; every
loss is finite and the last world of 2 finishes the steps.

``--device cpu`` rehearses the same program on gloo.  Prints one JSON
line per result, writes them to chiprun_out/multi_gpu_elastic.json, and
exits non-zero if a check fails.
"""

import argparse
import json
import os
import socket
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, KILL_AT = 8, 4
VICTIM = "127.0.0.1:0"
# The time a survivor may take to raise HorovodInternalError after the
# death of a peer inside the ZeRO step's collectives (PERF.md), and in
# the hang drill after the operation deadline.
DETECT_BOUND_S = 5.0
# The reset alone (the failed world torn down, the next one formed).
RESET_BOUND_S = 5.0
HANG_DEADLINE_S = 20
HANG_S = HANG_DEADLINE_S + 15
CARDS = {"localhost": "0,1", "127.0.0.1": "2"}   # else GPU 3
RUN_DEADLINE_S = 240.0   # a drill's
# The autoscale drill: its steps, their pacing (the driver's resizes land
# between them), the autoscaler's cooldown, the steps a round takes
# before the next scripted status, and the script: (queue depth, the
# width the autoscaler must ask for).
AUTOSCALE_STEPS, AUTOSCALE_PACE_S = 30, 0.3
AUTOSCALE_COOLDOWN_S = 5.0
AUTOSCALE_ROUND_STEPS = 3
AUTOSCALE_SCRIPT = ((0, 2), (20, 3), (0, 2))


def _log(prefix, **fields):
    fields.update(slot=os.environ["HVD_TPU_ELASTIC_SLOT"], t=time.time())
    with open(prefix + "." + os.environ["HVD_TPU_ELASTIC_SLOT"], "a") as f:
        f.write(json.dumps(fields) + "\n")


def _config(torch, small):
    from horovod_tpu_torch.models import transformer as tfm
    cfg = tfm.TransformerConfig(
        vocab_size=256, d_model=64, n_heads=4, d_ff=128, n_layers=2,
        seq_len=32, dtype=torch.bfloat16, remat=False) if small else \
        tfm.TransformerConfig(vocab_size=8192, d_model=512, n_heads=8,
                              d_ff=2048, n_layers=8, seq_len=512,
                              dtype=torch.bfloat16, remat=False)
    return tfm, cfg, tfm.ParallelConfig()


def _tensors(tree):
    """Every tensor of a committed tree by path, cloned to the host."""
    from horovod_tpu_torch import checkpoint as ckpt
    ext = ckpt.extract_zero_state(tree)
    (vals,) = ext.rank_values.values()
    return {s.path: v for s, v in zip(ext.specs, vals)}


def worker(device, small, log, ckpt_dir, drill):
    host = os.environ["HVD_TPU_HOSTNAME"]
    if device == "cuda":
        os.environ["CUDA_VISIBLE_DEVICES"] = CARDS.get(host, "3")
    sys.path.insert(0, ROOT)
    import functools
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint as ckpt
    from horovod_tpu_torch import elastic, recovery
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.ops import flash_attention as fa
    if device == "cpu":
        torch.set_num_threads(2)
    hvd.init(device=device)
    tfm, cfg, par = _config(torch, small)
    batch = 2 if small else 8

    def build(seed):
        model = tfm.Transformer(cfg, par, seed=seed)
        opt = hvd.ZeroShardedOptimizer(model, functools.partial(
            torch.optim.AdamW, lr=3e-4, weight_decay=1e-4), stage=2)
        counter = torch.zeros((), dtype=torch.int64)
        return model, opt, {"model": model.state_dict(), "opt": opt,
                            "step": counter}

    model, opt, tree = build(0)
    counter = tree["step"]
    victim = os.environ["HVD_TPU_ELASTIC_SLOT"] == VICTIM
    if victim and drill == "hang":
        reduce_grads = opt.reduce_grads

        def hung_reduce_grads():
            if int(counter) == KILL_AT:
                # Past the forward's negotiated loss mean, before the
                # reduce-scatter: alive and stuck, while the peers wait
                # in the step's NCCL collectives until the deadline
                # aborts them.
                _log(log, event="hang", step=KILL_AT, rank=hvd.rank())
                time.sleep(HANG_S)
                _log(log, event="death", step=KILL_AT, rank=hvd.rank())
                os._exit(1)
            reduce_grads()

        opt.reduce_grads = hung_reduce_grads
    autoscale = drill == "autoscale"
    n_steps = AUTOSCALE_STEPS if autoscale else STEPS
    state = elastic.TpuState(opt_state=tree, checkpoint_dir=ckpt_dir,
                             checkpoint_keep=n_steps + 1)
    state.register_reset_callbacks([lambda: _log(
        log, event="reset", rank=hvd.rank(), size=hvd.size())])
    step = tfm.make_train_step(cfg, par, model, opt)

    def batch_of(i):
        return tfm.synthetic_batch(cfg, batch, seed=1000 + 100 * i +
                                   hvd.rank())

    stacks = None
    if drill == "hang":
        # Every thread's Python stack, written if a step outlasts the
        # deadline by 3 s (the hung step; cancelled after each step).
        import faulthandler
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        stacks = open(os.path.join(
            ROOT, "chiprun_out", "multi_gpu_elastic_stacks." +
            os.environ["HVD_TPU_ELASTIC_SLOT"].replace(":", "_")), "a")

    def run(first, last):
        losses = []
        for i in range(first, last):
            losses.append(step(*batch_of(i)).item())
        return losses

    @elastic.run
    def train(state):
        rep = recovery.last_report()
        _log(log, event="sync", round=global_state.elastic_round,
             rank=hvd.rank(), size=hvd.size(), step=int(counter),
             path=rep.path if rep else None,
             report=rep.to_dict() if rep else None)
        if global_state.elastic_round > 0 and rep is not None and \
                not autoscale:
            # The disk restore of the step the peer tier restored, into a
            # model and optimizer of another seed.
            _, _, like = build(1)
            like = ckpt.restore_zero_state(
                os.path.join(ckpt_dir, "opt_state"), like, step=rep.step)
            a, b = _tensors(state.opt_state), _tensors(like)
            equal = sorted(a) == sorted(b) and all(
                a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                and a[k].tobytes() == b[k].tobytes() for k in a)
            _log(log, event="peer_vs_disk", equal=equal, leaves=len(a),
                 step=rep.step)
        fa.reset_launches()
        while int(counter) < n_steps:
            i = int(counter)
            tokens, labels = batch_of(i)
            if victim and drill == "kill" and i == KILL_AT:
                # The peers are inside the step's collectives by now.
                time.sleep(2.0)
                _log(log, event="death", step=i, rank=hvd.rank())
                os._exit(1)
            if stacks is not None:
                faulthandler.dump_traceback_later(HANG_DEADLINE_S + 3,
                                                  file=stacks)
            try:
                loss = step(tokens, labels).item()
                counter.add_(1)
                state.commit()
            except hvd.HorovodInternalError as e:
                _log(log, event="error", step=i, rank=hvd.rank(),
                     error=str(e)[:300])
                raise
            finally:
                if stacks is not None:
                    faulthandler.cancel_dump_traceback_later()
            _log(log, event="step", step=i, loss=loss, rank=hvd.rank(),
                 size=hvd.size(), round=global_state.elastic_round,
                 launches=dict(fa.launches))
            if autoscale:
                time.sleep(AUTOSCALE_PACE_S)
        if global_state.elastic_round > 0 and not autoscale:
            # Rerun the resumed steps from the disk restore of the same
            # committed step.
            rep = recovery.last_report()
            ckpt.restore_zero_state(os.path.join(ckpt_dir, "opt_state"),
                                    state.opt_state, step=rep.step)
            _log(log, event="disk_rerun", first=int(counter),
                 losses=run(int(counter), STEPS))

    train(state)
    hvd.shutdown()


def _read(log, slots):
    events = []
    for slot in slots:
        path = f"{log}.{slot}"
        if os.path.exists(path):
            with open(path) as f:
                events += [json.loads(line) for line in f]
    return events


def _drill(kind, device, small, hosts, slots):
    """One run under the driver; its events and the driver's verdict."""
    import tempfile
    import threading
    from horovod_tpu_torch.runner.elastic_driver import (ElasticDriver,
                                                         FixedHosts)
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "log")
        cmd = [sys.executable, os.path.abspath(__file__), "--worker",
               json.dumps({"device": device, "small": small, "log": log,
                           "ckpt_dir": os.path.join(tmp, "ckpt"),
                           "drill": kind})]
        # The worker takes its fake host's cards itself (CARDS): the
        # driver's plan leaves the card view as it is ("gpu").
        driver = ElasticDriver(FixedHosts(hosts), cmd, min_np=3, max_np=4,
                               verbose=True, platform_policy="gpu")
        result = {}
        t0 = time.time()
        th = threading.Thread(
            target=lambda: result.update(rc=driver.run()), daemon=True)
        th.start()
        th.join(RUN_DEADLINE_S)
        if th.is_alive():
            driver.preempt("the tool's deadline")
            th.join(60)
        report["seconds"] = time.time() - t0
        report["rc"] = result.get("rc")
        report["blacklist"] = sorted(driver._blacklist)
        events = _read(log, slots)
    death = [e for e in events if e["event"] == "death"]
    hang = [e for e in events if e["event"] == "hang"]
    errors = [e for e in events if e["event"] == "error"]
    syncs = [e for e in events if e["event"] == "sync"]
    steps = [e for e in events if e["event"] == "step"]
    report["death"] = death
    report["hang"] = hang
    start = (hang or death)[0]["t"] if (hang or death) else None
    report["detect_s"] = {e["slot"]: e["t"] - start
                          for e in errors} if start else {}
    report["detected_alive"] = {e["slot"]: e["t"] < death[0]["t"]
                                for e in errors} if death else {}
    report["errors"] = {e["slot"]: e["error"] for e in errors}
    resets = {e["slot"]: e["t"] for e in events if e["event"] == "reset"}
    report["reset_s"] = {
        e["slot"]: resets[e["slot"]] - max(e["t"], death[0]["t"])
        for e in errors if e["slot"] in resets and death}
    report["syncs"] = syncs
    report["peer_vs_disk"] = [e for e in events
                              if e["event"] == "peer_vs_disk"]
    resumed = {}
    for e in steps:
        if e["round"] > 0:
            resumed.setdefault(e["slot"], []).append(e["loss"])
    report["resumed"] = resumed
    report["reruns"] = {e["slot"]: e["losses"] for e in events
                        if e["event"] == "disk_rerun"}
    report["losses"] = {s: [(e["step"], e["size"], e["loss"])
                            for e in steps if e["slot"] == s]
                        for s in slots}
    report["resumed_equal_disk_rerun"] = {
        s: resumed.get(s) == report["reruns"].get(s)
        for s in report["reruns"]}
    report["launches"] = {e["slot"]: e["launches"] for e in steps
                          if e["step"] == STEPS - 1}
    report["events"] = events
    return report


def _autoscale(device, small, hosts, slots):
    """The autoscale drill's run (the module's docstring): the driver's
    rounds, the autoscaler's resizes, the workers' losses."""
    import tempfile
    import threading
    from horovod_tpu_torch.metrics.registry import registry
    from horovod_tpu_torch.runner.elastic_driver import (ElasticDriver,
                                                         FixedHosts)
    from horovod_tpu_torch.serving import Autoscaler
    report = {"ticks": []}
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "log")
        cmd = [sys.executable, os.path.abspath(__file__), "--worker",
               json.dumps({"device": device, "small": small, "log": log,
                           "ckpt_dir": os.path.join(tmp, "ckpt"),
                           "drill": "autoscale"})]
        driver = ElasticDriver(FixedHosts(hosts), cmd, min_np=2, max_np=3,
                               verbose=True, platform_policy="gpu")
        status = {}
        scaler = Autoscaler(driver, lambda: dict(status), min_np=2,
                            max_np=3, target_queue=4.0, slo_ttft_s=0.0,
                            cooldown_s=AUTOSCALE_COOLDOWN_S)
        result = {}
        t0 = time.time()
        th = threading.Thread(
            target=lambda: result.update(rc=driver.run()), daemon=True)
        th.start()

        def world(after_round):
            """(round, size) once a round past ``after_round`` has taken
            AUTOSCALE_ROUND_STEPS steps; None at the deadline."""
            while time.time() - t0 < RUN_DEADLINE_S and th.is_alive():
                steps = [e for e in _read(log, slots)
                         if e["event"] == "step"
                         and e["round"] > after_round]
                rounds = {}
                for e in steps:
                    rounds.setdefault((e["round"], e["size"]),
                                      set()).add(e["step"])
                done = [k for k, v in rounds.items()
                        if len(v) >= AUTOSCALE_ROUND_STEPS]
                if done:
                    return min(done)
                time.sleep(0.2)
            return None

        last = -1
        for queue, want in AUTOSCALE_SCRIPT:
            cur = world(last)
            assert cur is not None, ("no round to resize", report["ticks"])
            last = cur[0]
            status.update(np=cur[1], queue_depth=queue, occupancy=0.0)
            got = None
            while got is None and time.time() - t0 < RUN_DEADLINE_S:
                got = scaler.maybe_resize()
                if got is None:
                    time.sleep(0.2)
            report["ticks"].append({"t": time.time() - t0, "wall": time.time(),
                                    "round": cur[0], "size": cur[1],
                                    "queue_depth": queue, "asked": got,
                                    "want": want})
        th.join(max(RUN_DEADLINE_S - (time.time() - t0), 1))
        if th.is_alive():
            driver.preempt("the tool's deadline")
            th.join(60)
        report["seconds"] = time.time() - t0
        report["rc"] = result.get("rc")
        events = _read(log, slots)
    report["resizes"] = {
        c["labels"]["direction"]: c["value"]
        for c in registry().snapshot().get(
            "hvd_serving_autoscale_total", {}).get("series", [])}
    report["syncs"] = [(e["slot"], e["round"], e["size"], e["path"],
                        e["step"]) for e in events if e["event"] == "sync"]
    steps = [e for e in events if e["event"] == "step"]
    report["sizes_by_round"] = sorted({(e["round"], e["size"])
                                       for e in steps})
    report["losses"] = {s: [(e["step"], e["round"], e["size"], e["loss"])
                            for e in steps if e["slot"] == s]
                        for s in slots}
    report["last_step"] = max((e["step"] for e in steps), default=None)
    # Each resize, from the autoscaler's request to the first step of the
    # round it started.
    firsts = {}
    for e in steps:
        firsts[e["round"]] = min(firsts.get(e["round"], e["t"]), e["t"])
    report["resize_s"] = [firsts[t["round"] + 1] - t["wall"]
                          for t in report["ticks"]
                          if t["round"] + 1 in firsts]
    return report


def _check_autoscale(report):
    import math
    assert report["rc"] == 0, report["rc"]
    assert [(t["asked"], t["want"]) for t in report["ticks"]] == \
        [(w, w) for _, w in AUTOSCALE_SCRIPT], report["ticks"]
    sizes = [size for _, size in report["sizes_by_round"]]
    assert sizes == [3, 2, 3, 2], report["sizes_by_round"]
    assert report["resizes"] == {"down": 2, "up": 1}, report["resizes"]
    assert report["last_step"] == AUTOSCALE_STEPS - 1, report["last_step"]
    assert all(math.isfinite(x[3]) for v in report["losses"].values()
               for x in v), report["losses"]


def _check(kind, report, survivors):
    """The drill's checks (the module's docstring)."""
    assert report["rc"] == 0, report["rc"]
    assert report["blacklist"] == ["127.0.0.1"], report["blacklist"]
    assert len(report["death"]) == 1 and \
        sorted(report["detect_s"]) == survivors, report["detect_s"]
    if kind == "hang":
        assert len(report["hang"]) == 1, report["hang"]
        low, high = HANG_DEADLINE_S - 1, HANG_DEADLINE_S + DETECT_BOUND_S
        assert all(report["detected_alive"].values()), report
    else:
        low, high = 0, DETECT_BOUND_S
    assert all(low <= d <= high for d in report["detect_s"].values()), \
        report["detect_s"]
    assert sorted(report["reset_s"]) == survivors and all(
        0 <= r <= RESET_BOUND_S for r in report["reset_s"].values()), \
        report["reset_s"]
    after = [e for e in report["syncs"] if e["round"] > 0]
    assert sorted(e["slot"] for e in after) == survivors, after
    # The restore is the last step committed before the fault.
    assert all(e["size"] == 3 and e["path"] == "peer" and
               e["step"] == KILL_AT for e in after), after
    assert len(report["peer_vs_disk"]) == 3 and all(
        e["equal"] for e in report["peer_vs_disk"]), report["peer_vs_disk"]
    assert sorted(report["reruns"]) == survivors and all(
        report["resumed_equal_disk_rerun"].values()), \
        (report["resumed"], report["reruns"])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--drill", choices=("kill", "hang", "both",
                                        "autoscale"), default="both")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(**json.loads(args.worker))
        return 0
    import subprocess
    sys.path.insert(0, ROOT)
    from horovod_tpu_torch.runner.hosts import HostInfo
    report = {}
    if args.device == "cuda":
        import torch
        if torch.cuda.device_count() < 4:
            print(f"needs 4 GPUs, found {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 2
        report["cards"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
    hostname = socket.gethostname()
    hosts = [HostInfo("localhost", 2), HostInfo("127.0.0.1", 1),
             HostInfo(hostname, 1)]
    slots = ["localhost:0", "localhost:1", VICTIM, f"{hostname}:0"]
    os.environ.update(HVD_TPU_ELASTIC_DISCOVERY_INTERVAL="0.2",
                      HVD_TPU_RECOVERY_STRIDE="1", HVD_TPU_CYCLE_TIME="1")
    kinds = ("kill", "hang") if args.drill == "both" else (args.drill,)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    print(json.dumps({"cards": report.get("cards", ["cpu"])}), flush=True)
    if args.drill == "autoscale":
        report["autoscale"] = r = _autoscale(args.device, args.small, hosts,
                                             slots)
        with open(os.path.join(out_dir, "multi_gpu_elastic_autoscale.json"),
                  "w") as f:
            json.dump(report, f, indent=1)
        for k in ("rc", "seconds", "ticks", "resizes", "resize_s",
                  "sizes_by_round", "syncs", "last_step", "losses"):
            print(json.dumps({"drill": "autoscale", k: r[k]}), flush=True)
        _check_autoscale(r)
        return 0
    for kind in kinds:
        if kind == "hang":
            os.environ["HVD_TPU_NET_OP_DEADLINE_S"] = str(HANG_DEADLINE_S)
        report[kind] = r = _drill(kind, args.device, args.small, hosts,
                                  slots)
        os.environ.pop("HVD_TPU_NET_OP_DEADLINE_S", None)
        with open(os.path.join(out_dir, "multi_gpu_elastic.json"), "w") as f:
            json.dump(report, f, indent=1)
        for k in ("rc", "seconds", "blacklist", "detect_s", "reset_s",
                  "errors",
                  "peer_vs_disk", "resumed_equal_disk_rerun", "losses",
                  "launches"):
            print(json.dumps({"drill": kind, k: r[k]}), flush=True)
        print(json.dumps({"drill": kind, "syncs": [
            (e["slot"], e["round"], e["size"], e["path"], e["step"],
             e["t"]) for e in r["syncs"]]}), flush=True)
    survivors = [s for s in slots if s != VICTIM]
    if len(kinds) == 2:
        report["hang_resumed_equal_kill"] = {
            s: report["hang"]["resumed"].get(s) ==
            report["kill"]["resumed"].get(s) for s in survivors}
        with open(os.path.join(out_dir, "multi_gpu_elastic.json"), "w") as f:
            json.dump(report, f, indent=1)
        print(json.dumps({"hang_resumed_equal_kill":
                          report["hang_resumed_equal_kill"]}))
    for kind in kinds:
        _check(kind, report[kind], survivors)
    if len(kinds) == 2:
        assert all(report["hang_resumed_equal_kill"].values()), report
    return 0


if __name__ == "__main__":
    sys.exit(main())
