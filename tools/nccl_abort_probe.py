#!/usr/bin/env python3
"""How long the survivors of an NCCL world take to leave a collective
whose peer hangs alive, and to form a new world after it.

    python3 tools/nccl_abort_probe.py [--device cuda|cpu]
        [--configs port,no_monitor,...] [--deadline S]

Four ranks, one a GPU (``--device cpu``: gloo on the CPU, a rehearsal of
the harness).  Each rank forms the world as an elastic worker of the port
does (``core/failure.world_options``) with a second group over the world
(the native controller's executor group in an elastic worker), warms both
up with an allreduce, and then rank 2 sleeps alive for ``HANG_S`` while
the other three enter one allreduce on the world and wait for its result
(``.item()``).  At the operation deadline a thread of each survivor aborts
the groups as ``core/failure.abort_groups`` does, timing each group's
abort; the main thread records when the wait returns (or raises).  Then
each survivor destroys the world and forms a world of three with the other
survivors, whose allreduce of ones must give 3.

Each configuration is a run of its own, with the environment it names.
All but ``port`` and ``world_first`` abort the groups one after the
other, in ``_groups()``'s order (the executor's group, then the world),
as ``abort_groups`` did before it aborted them together:

* ``port``: the port's world and ``core/failure.abort_groups`` as they
  are (blocking communicators, NCCL's timeout twice the deadline,
  ``TORCH_NCCL_ASYNC_ERROR_HANDLING=2``, every group aborted at once,
  each on a thread of its own);
* ``sequential``: the same world, the groups aborted one after the other;
* ``world_first``: one after the other, the world's group first;
* ``no_monitor``: sequential, and NCCL's heartbeat monitor, its dump on
  timeout and its flight recorder off;
* ``nonblocking``: sequential, with non-blocking communicators
  (``TORCH_NCCL_USE_COMM_NONBLOCKING=1``);
* ``timeout_deadline``: sequential, NCCL's timeout at the deadline;
* ``nonblocking_no_monitor``: sequential, the two together.

A survivor still blocked ``STACK_AFTER_S`` past the deadline writes its
Python stacks (``faulthandler``) and, where ``gdb`` is installed, its
native stacks to ``chiprun_out/nccl_abort_probe/``.  Prints one JSON line
per configuration and writes them to ``chiprun_out/nccl_abort_probe.json``.
"""

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out", "nccl_abort_probe")
WORLD, HANG_RANK = 4, 2
STACK_AFTER_S = 15.0
CONFIGS = {
    "port": {"env": {}, "abort": "port"},
    "sequential": {"env": {}},
    "world_first": {"env": {}, "abort": "world_first"},
    "no_monitor": {"env": {"TORCH_NCCL_ENABLE_MONITORING": "0",
                           "TORCH_NCCL_DUMP_ON_TIMEOUT": "0",
                           "TORCH_NCCL_TRACE_BUFFER_SIZE": "0"}},
    "nonblocking": {"env": {"TORCH_NCCL_USE_COMM_NONBLOCKING": "1"}},
    "timeout_deadline": {"env": {}, "timeout_factor": 1.0},
    "nonblocking_no_monitor": {"env": {
        "TORCH_NCCL_USE_COMM_NONBLOCKING": "1",
        "TORCH_NCCL_ENABLE_MONITORING": "0",
        "TORCH_NCCL_DUMP_ON_TIMEOUT": "0",
        "TORCH_NCCL_TRACE_BUFFER_SIZE": "0"}},
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _native_stacks(path: str) -> None:
    """This process's native stacks through gdb, where it is installed
    (the process allows any tracer of its own user first)."""
    gdb = shutil.which("gdb")
    if gdb is None:
        with open(path, "w") as f:
            f.write("gdb not installed\n")
        return
    import ctypes
    libc = ctypes.CDLL(None)
    libc.prctl(0x59616d61, ctypes.c_ulong(0xffffffffffffffff), 0, 0, 0)
    with open(path, "w") as f:
        subprocess.run([gdb, "-p", str(os.getpid()), "-batch", "-ex",
                        "thread apply all bt"], stdout=f,
                       stderr=subprocess.STDOUT, timeout=90, check=False)


def _abort_timed(groups, rec: dict, mode: str) -> None:
    """Abort the groups: ``port`` through ``failure.abort_groups``, else
    one after the other (``world_first``: the world's group first), with
    each group's seconds in ``rec["abort_s"]``."""
    import torch
    if mode == "port":
        from horovod_tpu_torch.core import failure
        t = time.monotonic()
        failure.abort_groups()
        rec["abort_s"] = [time.monotonic() - t]
        return
    if mode == "world_first":
        groups = groups[::-1]
    rec["abort_s"] = []
    for group in groups:
        t = time.monotonic()
        try:
            backend = group._get_backend(torch.device("cuda"))
        except (RuntimeError, ValueError, AttributeError):
            rec["abort_s"].append("no NCCL backend")
            continue
        abort = getattr(backend, "abort", None) or \
            getattr(backend, "_abort", None)
        if abort is not None:
            abort()
        rec["abort_s"].append(time.monotonic() - t)


def rank_main(rank, config, deadline, port, device, hang_s):
    import datetime
    import faulthandler
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    os.environ["HVD_TPU_NET_OP_DEADLINE_S"] = str(deadline)
    from horovod_tpu_torch.core import failure
    from horovod_tpu_torch.core.state import global_state
    spec = CONFIGS[config]
    cuda = device == "cuda"
    backend = "nccl" if cuda else "gloo"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    opts = failure.world_options(backend)
    if spec.get("timeout_factor"):
        opts["timeout"] = datetime.timedelta(
            seconds=deadline * spec["timeout_factor"])
    path = os.path.join(OUT, f"{config}.rank{rank}")
    rec = {"rank": rank, "timeout_s": opts["timeout"].total_seconds()}

    def save():
        with open(path + ".json", "w") as f:
            json.dump(rec, f)

    store = dist.TCPStore("127.0.0.1", port, WORLD, is_master=rank == 0,
                          timeout=datetime.timedelta(seconds=120))
    dist.init_process_group(backend, store=dist.PrefixStore("w4", store),
                            rank=rank, world_size=WORLD, **opts)
    second = dist.new_group(list(range(WORLD)))
    x = torch.ones(1 << 20, device=dev)
    dist.all_reduce(x)
    dist.all_reduce(x, group=second)
    if cuda:
        torch.cuda.synchronize()
    global_state.device = dev
    global_state.controller_group = second
    store.set(f"ready{rank}", "1")
    store.wait([f"ready{r}" for r in range(WORLD)])
    if rank == HANG_RANK:
        time.sleep(hang_s)   # alive and stuck, then gone
        os._exit(0)
    t0 = time.monotonic()
    groups = failure._groups()
    rec["groups"] = len(groups)
    released = threading.Event()

    def watch():
        time.sleep(deadline)
        rec["abort_start"] = time.monotonic() - t0
        save()
        _abort_timed(groups, rec, spec.get("abort", "sequential"))
        rec["abort_end"] = time.monotonic() - t0
        save()

    def stacks():
        if released.wait(deadline + STACK_AFTER_S):
            return
        with open(path + ".py_stacks", "w") as f:
            faulthandler.dump_traceback(file=f, all_threads=True)
        if rank == 0:
            _native_stacks(path + ".native_stacks")

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    threading.Thread(target=stacks, daemon=True).start()
    try:
        dist.all_reduce(x)
        rec["result"] = float(x[0].item())
    except Exception as e:  # noqa: BLE001 — the probe records any outcome
        rec["error"] = f"{type(e).__name__}: {str(e)[:300]}"
    rec["released"] = time.monotonic() - t0
    released.set()
    save()
    watcher.join()
    # The reset: destroy the world, form one of the three survivors.
    survivors = [r for r in range(WORLD) if r != HANG_RANK]
    t = time.monotonic()
    try:
        dist.destroy_process_group()
        rec["destroy_s"] = time.monotonic() - t
        save()
        dist.init_process_group(
            backend, store=dist.PrefixStore("w3", store),
            rank=survivors.index(rank), world_size=len(survivors),
            timeout=datetime.timedelta(seconds=60))
        y = torch.ones(4, device=dev)
        dist.all_reduce(y)
        rec["new_world_sum"] = float(y[0].item())
        rec["reset_s"] = time.monotonic() - t
        dist.destroy_process_group()
    except Exception as e:  # noqa: BLE001
        rec["reset_error"] = f"{type(e).__name__}: {str(e)[:300]}"
    save()
    # The store's host waits for the others' results before it exits.
    store.set(f"done{rank}", "1")
    if rank == 0:
        store.wait([f"done{r}" for r in survivors],
                   datetime.timedelta(seconds=120))
    os._exit(0)


def run_config(config, deadline, device, limit_s):
    port = _free_port()
    hang_s = deadline + 20.0
    env = dict(os.environ, **CONFIGS[config]["env"])
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--config", config, "--deadline", str(deadline), "--port",
         str(port), "--device", device, "--hang-s", str(hang_s)], env=env)
        for r in range(WORLD)]
    end = time.monotonic() + limit_s
    for p in procs:
        try:
            p.wait(max(end - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            pass
    killed = [r for r, p in enumerate(procs) if p.poll() is None]
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    ranks = {}
    for r in range(WORLD):
        path = os.path.join(OUT, f"{config}.rank{r}.json")
        if os.path.exists(path):
            with open(path) as f:
                ranks[r] = json.load(f)
    return {"config": config, "deadline_s": deadline, "killed": killed,
            "ranks": ranks}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--deadline", type=float, default=10.0)
    ap.add_argument("--limit", type=float, default=45.0,
                    help="seconds a configuration may run")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--config", help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--hang-s", type=float, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args.rank, args.config, args.deadline, args.port,
                  args.device, args.hang_s)
        return 0
    os.makedirs(OUT, exist_ok=True)
    head = {"device": args.device}
    if args.device == "cuda":
        import torch
        if torch.cuda.device_count() < WORLD:
            print(f"needs {WORLD} GPUs", file=sys.stderr)
            return 2
        head.update(
            cards=subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.strip().splitlines(),
            torch=torch.__version__, nccl=".".join(
                map(str, torch.cuda.nccl.version())))
    print(json.dumps(head), flush=True)
    results = [head]
    for config in args.configs.split(","):
        res = run_config(config, args.deadline, args.device, args.limit)
        results.append(res)
        print(json.dumps(res), flush=True)
        with open(OUT + ".json", "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
