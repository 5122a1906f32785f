#!/usr/bin/env python3
"""The port's launcher on the four GPUs of one host.

    python3 tools/multi_gpu_launch.py [--device cuda|cpu] [--small]
        [--runs partition4,two_cards,fake_hosts,run_fn,elastic]

Each run starts its workers through ``python -m
horovod_tpu_torch.runner.launch`` (or ``runner.run``), and every worker
takes the card the launcher's plan gave it: it calls ``init()`` with no
device and pins nothing itself.  The model is the flagship of
chip_smoke.py (vocab 8192, d_model 512, 8 heads, d_ff 2048, 8 layers,
seq 512, bf16, batch 8 a rank, its own seeded batch each; ``--small``: a
2-layer toy), trained with DistributedOptimizer(AdamW) on NCCL.

* ``partition4`` — ``-np 4`` on one host: the plan partitions the four
  cards, one a worker (``CUDA_VISIBLE_DEVICES`` = its local rank), each
  on its own ``cuda:0`` (four distinct card UUIDs); 10 steps; every
  rank ends with the same parameters bit for bit (a SHA-256 of every
  parameter's bytes); every rank's losses equal, within its spread, a
  world-4 run of the same seed that this tool spawns itself with
  ``torch.multiprocessing`` (rank r on ``cuda:r``, no launcher), twice.
* ``determinism`` — what may move those losses: the reference run with
  each rank seeing only its own card (``CUDA_VISIBLE_DEVICES`` = r, as
  a partitioned slot does) must equal the all-card one bit for bit; two
  launches with the native controller attached are reported against the
  reference and each other.  The other runs' workers initialise without
  the controller (``init(use_controller=False)``): its fusion depends on
  timing, so a controller-attached world-4 run's losses move in the
  last bits from run to run.
* ``two_cards`` — ``-np 2``: two cards a worker ("0,1", "2,3"), each
  worker on the first of its own; 3 steps, parameters bit-equal.
* ``fake_hosts`` — ``-np 4 -H 127.0.0.2:2,127.0.0.3:2`` through a
  PATH-shimmed ``ssh`` (the reference's tests/test_ssh_launch.py:28-60
  in Python): it records each call, scrubs the inherited HVD_TPU_* /
  HOROVOD_* env and runs the remote command here, as a host whose cards
  are ``HVD_LAUNCH_TEST_CARDS[host]`` (127.0.0.2 the cards 0-1,
  127.0.0.3 the cards 2-3: it maps the plan's indices through them).
  ``HVD_TPU_CHIPS_PER_HOST=2`` tells the launcher each remote host's
  count.  Checks: cross_size 2 and local_size 2 on every rank, the secret
  arrived through stdin and is in no remote argv, the rendezvous address
  is one the NIC probe gave both hosts, rank 0's store port came through
  the KV (``MASTER_PORT=auto``), four distinct cards, 10 steps with
  parameters bit-equal; the losses against the reference's are
  reported.
* ``run_fn`` — ``runner.run(fn, np=4)``: each worker on its own card
  (the plan), an allreduce of ``rank + 1`` giving 10.
* ``elastic`` — ``--min-np 3 --max-np 4 --host-discovery-script`` over
  the fake remote hosts 127.0.0.2:2, 127.0.0.3:1 and 127.0.0.4:1 (cards
  0-1, 2 and 3), which the elastic driver refused before the NIC probe
  was ported.  ZeRO stage 2 AdamW under ``@elastic.run``, a
  ``TpuState`` committing after every step to the buddy tier
  (``HVD_TPU_RECOVERY_STRIDE=1``: rank r's copy lives with rank r + 1)
  and to a checkpoint directory; rank 3 (127.0.0.4) exits after its
  step-4 commit (``HVD_TPU_CHAOS_KILL_STEPS=3@4``); the driver
  blacklists 127.0.0.4, the three survivors re-form a world of 3, their
  sync reports ``peer`` at step 4, and all 8 steps finish.

``--device cpu`` rehearses every run on gloo (``--worker-platform cpu``,
``worker_platform="cpu"``).  Prints one JSON line per result, writes
them to chiprun_out/multi_gpu_launch.json, and exits non-zero if a check
fails.
"""

import argparse
import glob
import hashlib
import json
import os
import re
import socket
import stat
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, TWO_CARD_STEPS = 10, 3
ELASTIC_STEPS, ELASTIC_KILL = 8, "3@4"
BATCH_SEED = 3100
RUN_DEADLINE_S = 300.0
RUNS = ("partition4", "determinism", "two_cards", "fake_hosts", "run_fn",
        "elastic")
FAKE_HOSTS = {"127.0.0.2": "0,1", "127.0.0.3": "2,3"}
ELASTIC_HOSTS = {"127.0.0.2": "0,1", "127.0.0.3": "2", "127.0.0.4": "3"}

SSH_SHIM = r'''#!/usr/bin/env python3
"""Test double for ssh: validate the flags, record the call, run the
remote command here without the driver's HVD_TPU_*/HOROVOD_* env, as a
host whose cards are HVD_LAUNCH_TEST_CARDS[host]."""
import json, os, re, sys
args = sys.argv[1:]
port = ident = ""
while args and args[0].startswith("-"):
    flag = args.pop(0)
    if flag == "-o":
        args.pop(0)
    elif flag == "-p":
        port = args.pop(0)
    elif flag == "-i":
        ident = args.pop(0)
    else:
        sys.exit(f"ssh-shim: unexpected flag {flag}")
if len(args) < 2:
    sys.exit("ssh-shim: missing host or remote command")
host, remote = args[0], " ".join(args[1:])
with open(os.environ["HVD_LAUNCH_TEST_SSH_LOG"], "a") as f:
    f.write(json.dumps({"host": host, "port": port, "ident": ident,
                        "cmd": remote}) + "\n")
env = {k: v for k, v in os.environ.items()
       if not k.startswith(("HVD_TPU_", "HOROVOD_"))}
cards = json.loads(os.environ.get("HVD_LAUNCH_TEST_CARDS", "{}")).get(host)
if cards is not None:
    base = cards.split(",")
    remote = re.sub(r"CUDA_VISIBLE_DEVICES=([0-9][0-9,]*)",
                    lambda m: "CUDA_VISIBLE_DEVICES=" + ",".join(
                        base[int(i)] for i in m.group(1).split(",")),
                    remote)
    env["CUDA_VISIBLE_DEVICES"] = cards
os.execvpe("bash", ["bash", "-c", remote], env)
'''


def _config(torch, small):
    from horovod_tpu_torch.models import transformer as tfm
    cfg = tfm.TransformerConfig(
        vocab_size=256, d_model=64, n_heads=4, d_ff=128, n_layers=2,
        seq_len=32, dtype=torch.bfloat16, remat=False) if small else \
        tfm.TransformerConfig(vocab_size=8192, d_model=512, n_heads=8,
                              d_ff=2048, n_layers=8, seq_len=512,
                              dtype=torch.bfloat16, remat=False)
    return tfm, cfg, tfm.ParallelConfig(), (2 if small else 8)


def _card(torch):
    """The card this process computes on, by UUID ("" on the CPU)."""
    if not torch.cuda.is_available():
        return ""
    return str(getattr(torch.cuda.get_device_properties(0), "uuid", ""))


def train(small, n_steps):
    """``n_steps`` data-parallel steps of a seed-0 model on the world
    ``init()`` formed, each rank on its own seeded batch: its losses, a
    SHA-256 of every parameter's bytes at the end, and the kernels'
    launches."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import flash_attention as fa
    tfm, cfg, par, batch = _config(torch, small)
    model = tfm.Transformer(cfg, par, seed=0)
    hvd.broadcast_parameters(model.state_dict())
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=3e-4, weight_decay=1e-4))
    step = tfm.make_train_step(cfg, par, model, opt)
    fa.reset_launches()
    losses, times = [], []
    for i in range(n_steps):
        tokens, labels = tfm.synthetic_batch(
            cfg, batch, seed=BATCH_SEED + 100 * i + hvd.rank())
        t0 = time.perf_counter()
        losses.append(step(tokens, labels).item())
        times.append(time.perf_counter() - t0)
    digest = hashlib.sha256()
    for name, p in sorted(model.named_parameters()):
        digest.update(name.encode())
        digest.update(p.detach().float().cpu().numpy().tobytes())
    return {"losses": losses, "params_sha256": digest.hexdigest(),
            "step_times_s": times, "launches": dict(fa.launches)}


def _identity(torch, hvd):
    return {"rank": hvd.rank(), "size": hvd.size(),
            "local_rank": hvd.local_rank(), "local_size": hvd.local_size(),
            "cross_rank": hvd.cross_rank(), "cross_size": hvd.cross_size(),
            "device": str(hvd.device()), "card": _card(torch),
            "device_count": torch.cuda.device_count(),
            "cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "hostname": os.environ.get("HVD_TPU_HOSTNAME", ""),
            "secret_present":
                bool(os.environ.get("HVD_TPU_RENDEZVOUS_SECRET")),
            "rendezvous": os.environ.get("HVD_TPU_RENDEZVOUS_ADDR"),
            "master": (os.environ.get("MASTER_ADDR"),
                       os.environ.get("MASTER_PORT"))}


def worker(out, small, n_steps, controller):
    """A static launch's worker: its identity and ``train``'s result, one
    JSON file a rank.  ``controller``: attach the native controller the
    launcher's env names (``init()``'s default)."""
    sys.path.insert(0, ROOT)
    import torch
    import horovod_tpu_torch as hvd
    if not torch.cuda.is_available():
        torch.set_num_threads(2)
    hvd.init(use_controller=None if controller else False)
    rec = _identity(torch, hvd)
    rec.update(train(small, n_steps))
    hvd.shutdown()
    with open(f"{out}.{rec['rank']}", "w") as f:
        json.dump(rec, f)


def elastic_worker(log, ckpt_dir, small, env):
    """The elastic run's worker (the module's docstring): one JSON line
    an event to ``<log>.<slot>``.  ``env`` carries the knobs, which an
    ssh launch does not forward from the driver's environment."""
    os.environ.update(env)
    sys.path.insert(0, ROOT)
    import functools
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import elastic, recovery
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.ops import flash_attention as fa
    if not torch.cuda.is_available():
        torch.set_num_threads(2)
    slot = os.environ["HVD_TPU_ELASTIC_SLOT"]

    def note(**fields):
        fields.update(slot=slot, t=time.time())
        with open(f"{log}.{slot}", "a") as f:
            f.write(json.dumps(fields) + "\n")

    hvd.init()
    tfm, cfg, par, batch = _config(torch, small)
    model = tfm.Transformer(cfg, par, seed=0)
    opt = hvd.ZeroShardedOptimizer(model, functools.partial(
        torch.optim.AdamW, lr=3e-4, weight_decay=1e-4), stage=2)
    counter = torch.zeros((), dtype=torch.int64)
    state = elastic.TpuState(
        opt_state={"model": model.state_dict(), "opt": opt,
                   "step": counter}, checkpoint_dir=ckpt_dir)
    step = tfm.make_train_step(cfg, par, model, opt)

    @elastic.run
    def run(state):
        rep = recovery.last_report()
        note(event="sync", round=global_state.elastic_round,
             path=rep.path if rep else None, step=int(counter),
             **_identity(torch, hvd))
        fa.reset_launches()
        while int(counter) < ELASTIC_STEPS:
            i = int(counter)
            tokens, labels = tfm.synthetic_batch(
                cfg, batch, seed=BATCH_SEED + 100 * i + hvd.rank())
            loss = step(tokens, labels).item()
            counter.add_(1)
            state.commit()
            note(event="step", step=i + 1, loss=loss, rank=hvd.rank(),
                 size=hvd.size(), round=global_state.elastic_round,
                 launches=dict(fa.launches))
            recovery.chaos().maybe_kill(hvd.rank(), i + 1, hard=True)

    run(state)
    hvd.shutdown()


def _ref_rank(rank, world, port, device, small, out, pin=False):
    """One rank of the reference run: spawned by torch.multiprocessing,
    rank r on cuda:r (or the CPU), no launcher.  ``pin``: the rank sees
    only card r, as a partitioned slot does."""
    os.environ.update(HVD_TPU_RANK=str(rank), HVD_TPU_SIZE=str(world),
                      HVD_TPU_LOCAL_RANK=str(rank),
                      HVD_TPU_LOCAL_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    if pin:
        os.environ.update(CUDA_VISIBLE_DEVICES=str(rank),
                          HVD_TPU_DEVICE_PARTITION=f"{rank}/{world}")
    sys.path.insert(0, ROOT)
    import torch
    import horovod_tpu_torch as hvd
    if device == "cpu":
        torch.set_num_threads(2)
    hvd.init(device=device)
    rec = {"rank": rank, "device": str(hvd.device())}
    rec.update(train(small, STEPS))
    hvd.shutdown()
    with open(f"{out}.{rank}", "w") as f:
        json.dump(rec, f)


def _run_fn():
    """``run_fn``'s worker: its place, card and an allreduce."""
    import torch
    import horovod_tpu_torch as hvd
    hvd.init()
    x = hvd.allreduce(torch.tensor([float(hvd.rank() + 1)],
                                   device=hvd.device()), op=hvd.Sum)
    rec = _identity(torch, hvd)
    rec["sum"] = float(x[0])
    hvd.shutdown()
    return rec


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(args, env=None):
    """``python -m horovod_tpu_torch.runner.launch <args>``: exit code,
    output and wall seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=RUN_DEADLINE_S,
        env=dict(os.environ, **(env or {})))
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        print(text[-8000:], file=sys.stderr)
    return proc.returncode, text, time.perf_counter() - t0


def _static(np_, device, small, n_steps, extra=(), env=None,
            controller=False):
    """A static launch of ``np_`` workers of ``worker``: (exit code, the
    ranks' records, output, seconds)."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank")
        platform = ["--worker-platform", "cpu"] if device == "cpu" else []
        rc, text, secs = _launch(
            ["-np", str(np_), "-v", "--controller-port", str(_free_port()),
             *platform, *extra, sys.executable, os.path.abspath(__file__),
             "--worker", json.dumps({"out": out, "small": small,
                                     "n_steps": n_steps,
                                     "controller": controller})], env)
        ranks = []
        for r in range(np_):
            if os.path.exists(f"{out}.{r}"):
                with open(f"{out}.{r}") as f:
                    ranks.append(json.load(f))
    return rc, ranks, text, secs


def _shim(tmp, cards):
    bin_dir = os.path.join(tmp, "bin")
    os.makedirs(bin_dir)
    path = os.path.join(bin_dir, "ssh")
    with open(path, "w") as f:
        f.write(SSH_SHIM)
    os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR)
    log = os.path.join(tmp, "ssh.log")
    return log, {"PATH": f"{bin_dir}:{os.environ['PATH']}",
                 "HVD_LAUNCH_TEST_SSH_LOG": log,
                 "HVD_LAUNCH_TEST_CARDS": json.dumps(cards)}


def _ssh_calls(log):
    if not os.path.exists(log):
        return []
    with open(log) as f:
        return [json.loads(line) for line in f]


def _probed(rendezvous, calls):
    """Whether the advertised rendezvous host was a candidate of every
    host's probe (the probe's match: a candidate each host reached)."""
    host = rendezvous.rsplit(":", 1)[0]
    probes = [c for c in calls if c["cmd"].startswith("python3 -c")]
    return bool(probes) and all(f'"{host}"' in c["cmd"] for c in probes)


def _max_diff(a, b):
    return max(abs(x - y) for x, y in zip(a, b))


def _ranks_diff(ranks, losses):
    """Max |diff| of each rank's losses against ``losses[rank]``."""
    return max(_max_diff(r["losses"], losses[r["rank"]]) for r in ranks)


def _reference(device, small, pin=False):
    """The world-4 run without the launcher, twice: each rank's losses
    of the first run and the run-to-run spread."""
    import torch.multiprocessing as mp
    runs = []
    for _ in range(2):
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "ref")
            mp.spawn(_ref_rank, args=(4, _free_port(), device, small, out,
                                      pin),
                     nprocs=4, join=True)
            runs.append([json.load(open(f"{out}.{r}")) for r in range(4)])
    spread = max(_max_diff(a["losses"], b["losses"])
                 for a, b in zip(*runs))
    return {"losses": [r["losses"] for r in runs[0]],
            "params_sha256": [r["params_sha256"] for r in runs[0]],
            "devices": [r["device"] for r in runs[0]], "spread": spread}


def run_partition4(device, small, report):
    ref = report.setdefault("reference", _reference(device, small))
    rc, ranks, text, secs = _static(4, device, small, STEPS)
    diff = _ranks_diff(ranks, ref["losses"]) if len(ranks) == 4 else None
    res = {"rc": rc, "seconds": secs, "ranks": ranks, "max_diff": diff,
           "spread": ref["spread"],
           "bit_equal": [r["losses"] for r in ranks] == ref["losses"]}
    report["partition4"] = res
    assert rc == 0 and len(ranks) == 4, rc
    assert len({r["params_sha256"] for r in ranks}) == 1, ranks
    assert diff <= ref["spread"], (diff, ref["spread"])
    if device == "cuda":
        assert [r["cuda_visible"] for r in ranks] == ["0", "1", "2", "3"]
        assert all(r["device"] == "cuda:0" and r["device_count"] == 1
                   for r in ranks), ranks
        assert len({r["card"] for r in ranks}) == 4, ranks


def run_determinism(device, small, report):
    ref = report.setdefault("reference", _reference(device, small))
    pinned = _reference(device, small, pin=True)
    ctl = []
    for _ in range(2):
        rc, ranks, text, secs = _static(4, device, small, STEPS,
                                        controller=True)
        assert rc == 0 and len(ranks) == 4, rc
        assert len({r["params_sha256"] for r in ranks}) == 1, ranks
        ctl.append([r["losses"] for r in sorted(ranks,
                                                key=lambda r: r["rank"])])
    res = {"pinned_vs_reference": max(
               _max_diff(a, b) for a, b in zip(pinned["losses"],
                                               ref["losses"])),
           "pinned_spread": pinned["spread"],
           "controller_vs_reference": [max(
               _max_diff(a, b) for a, b in zip(c, ref["losses"]))
               for c in ctl],
           "controller_a_vs_b": max(_max_diff(a, b)
                                    for a, b in zip(*ctl))}
    report["determinism"] = res
    assert res["pinned_vs_reference"] <= ref["spread"], res


def run_two_cards(device, small, report):
    rc, ranks, text, secs = _static(2, device, small, TWO_CARD_STEPS)
    report["two_cards"] = {"rc": rc, "seconds": secs, "ranks": ranks}
    assert rc == 0 and len(ranks) == 2, rc
    assert len({r["params_sha256"] for r in ranks}) == 1, ranks
    if device == "cuda":
        assert [r["cuda_visible"] for r in ranks] == ["0,1", "2,3"]
        assert all(r["device"] == "cuda:0" and r["device_count"] == 2
                   for r in ranks), ranks
        assert len({r["card"] for r in ranks}) == 2, ranks


def run_fake_hosts(device, small, report):
    with tempfile.TemporaryDirectory() as tmp:
        log, env = _shim(tmp, FAKE_HOSTS)
        env["HVD_TPU_CHIPS_PER_HOST"] = "2"
        rc, ranks, text, secs = _static(
            4, device, small, STEPS,
            ["-H", ",".join(f"{h}:2" for h in FAKE_HOSTS),
             "--ssh-port", "2299"], env)
        calls = _ssh_calls(log)
    launches = [c for c in calls if "read -r HVD_TPU_RENDEZVOUS_SECRET"
                in c["cmd"]]
    ref = report.get("reference")
    res = {"rc": rc, "seconds": secs, "ranks": ranks,
           "ssh_calls": len(calls),
           "probed": bool(ranks) and _probed(ranks[0]["rendezvous"], calls),
           "max_diff_vs_reference": (_ranks_diff(ranks, ref["losses"])
                                     if ref and len(ranks) == 4 else None)}
    report["fake_hosts"] = res
    assert rc == 0 and len(ranks) == 4, rc
    assert all((r["cross_size"], r["local_size"], r["size"]) == (2, 2, 4)
               and r["secret_present"] for r in ranks), ranks
    assert [r["hostname"] for r in ranks] == [h for h in FAKE_HOSTS
                                              for _ in range(2)]
    assert len(launches) == 4 and all(
        "HVD_TPU_RENDEZVOUS_SECRET=" not in c["cmd"] and
        "MASTER_PORT=auto" in c["cmd"] and c["port"] == "2299"
        for c in launches), launches
    assert res["probed"], (ranks[0]["rendezvous"], calls)
    assert all(r["master"][1].isdigit() for r in ranks), ranks
    assert len({r["params_sha256"] for r in ranks}) == 1, ranks
    if device == "cuda":
        assert [r["cuda_visible"] for r in ranks] == ["0", "1", "2", "3"]
        assert len({r["card"] for r in ranks}) == 4, ranks


def run_fn(device, small, report):
    from horovod_tpu_torch import runner
    t0 = time.perf_counter()
    ranks = runner.run(_run_fn, np=4, controller_port=_free_port(),
                       worker_platform="cpu" if device == "cpu"
                       else "auto")
    report["run_fn"] = {"ranks": ranks,
                        "seconds": time.perf_counter() - t0}
    assert [r["sum"] for r in ranks] == [10.0] * 4, ranks
    if device == "cuda":
        assert all(r["device"] == "cuda:0" for r in ranks), ranks
        assert len({r["card"] for r in ranks}) == 4, ranks


def run_elastic(device, small, report):
    with tempfile.TemporaryDirectory() as tmp:
        log_ssh, env = _shim(tmp, ELASTIC_HOSTS)
        env.update(HVD_TPU_CHIPS_PER_HOST="2",
                   HVD_TPU_ELASTIC_DISCOVERY_INTERVAL="0.2")
        script = os.path.join(tmp, "discover.sh")
        with open(script, "w") as f:
            f.write("#!/bin/sh\necho 127.0.0.2:2\necho 127.0.0.3:1\n"
                    "echo 127.0.0.4:1\n")
        os.chmod(script, 0o755)
        log = os.path.join(tmp, "log")
        knobs = {"HVD_TPU_RECOVERY_STRIDE": "1", "HVD_TPU_CYCLE_TIME": "1",
                 "HVD_TPU_CHAOS_KILL_STEPS": ELASTIC_KILL}
        platform = ["--worker-platform", "cpu"] if device == "cpu" else []
        rc, text, secs = _launch(
            ["--min-np", "3", "--max-np", "4", "--host-discovery-script",
             script, "-v", *platform, sys.executable,
             os.path.abspath(__file__), "--elastic-worker",
             json.dumps({"log": log, "ckpt_dir": os.path.join(tmp, "ckpt"),
                         "small": small, "env": knobs})], env)
        events = []
        for path in glob.glob(log + ".*"):
            with open(path) as f:
                events += [json.loads(line) for line in f]
        events.sort(key=lambda e: e["t"])
        calls = _ssh_calls(log_ssh)
    syncs = [e for e in events if e["event"] == "sync"]
    steps = [e for e in events if e["event"] == "step"]
    blacklisted = re.findall(r"blacklisting (\S+)", text)
    after = [(e["slot"], e["round"], e["size"], e["path"], e["step"],
              e["cuda_visible"]) for e in syncs if e["round"] > 0]
    res = {"rc": rc, "seconds": secs, "blacklisted": blacklisted,
           "syncs": [(e["slot"], e["round"], e["size"], e["path"],
                      e["step"], e["cuda_visible"], e["card"])
                     for e in syncs],
           "losses": {s: [(e["step"], e["size"], e["loss"]) for e in steps
                          if e["slot"] == s]
                      for s in sorted({e["slot"] for e in steps})},
           "launches": {e["slot"]: e["launches"] for e in steps
                        if e["step"] == ELASTIC_STEPS},
           "probed": bool(syncs) and _probed(syncs[0]["rendezvous"], calls)}
    report["elastic"] = res
    assert rc == 0, rc
    assert blacklisted == ["127.0.0.4"], blacklisted
    assert res["probed"], (syncs[:1], calls)
    assert sorted(a[0] for a in after) == \
        ["127.0.0.2:0", "127.0.0.2:1", "127.0.0.3:0"], after
    assert all(a[2] == 3 and a[3] == "peer" and a[4] == 4 for a in after), \
        after
    finished = {e["slot"] for e in steps if e["step"] == ELASTIC_STEPS}
    assert finished == {a[0] for a in after}, finished
    if device == "cuda":
        first = {e["slot"]: e["card"] for e in syncs if e["round"] == 0}
        assert len(set(first.values())) == 4, first


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--runs", default=",".join(RUNS))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--elastic-worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(**json.loads(args.worker))
        return 0
    if args.elastic_worker:
        elastic_worker(**json.loads(args.elastic_worker))
        return 0
    sys.path.insert(0, ROOT)
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
    print(json.dumps({"cards": report.get("cards", ["cpu"])}), flush=True)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    runs = {"partition4": run_partition4, "determinism": run_determinism,
            "two_cards": run_two_cards,
            "fake_hosts": run_fake_hosts, "run_fn": run_fn,
            "elastic": run_elastic}
    failed = []
    for name in args.runs.split(","):
        try:
            runs[name](args.device, args.small, report)
        except Exception as e:  # noqa: BLE001 — report it, run the rest
            failed.append(name)
            report.setdefault(name, {})["error"] = repr(e)[:4000]
        finally:
            with open(os.path.join(out_dir, "multi_gpu_launch.json"),
                      "w") as f:
                json.dump(report, f, indent=1)
        summary = {k: v for k, v in report.get(name, {}).items()
                   if k not in ("ranks",)}
        print(json.dumps({"run": name, **summary}), flush=True)
    if "reference" in report:
        print(json.dumps({"reference": report["reference"]}), flush=True)
    print(json.dumps({"failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
