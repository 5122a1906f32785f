#!/usr/bin/env python3
"""The native stall snapshot under a live stall.

    python3 tools/stall_snapshot_stress.py [--runs 4] [--threads 4]
        [--hold-s 5] [--lib PATH]

Each run starts two ranks of the port's native controller (the host
plane, no torch.distributed).  After a warm-up allreduce, rank 1 holds
the allreduce "held" back for ``--hold-s`` seconds past the stall window
(``HOROVOD_STALL_CHECK_TIME_SECONDS=1``) while ``--threads`` threads of
rank 0 call ``NativeController.stalled()`` (the hang watchdog's poll)
as fast as they can.  ``--lib`` loads another build of the runtime, for
instance the parent commit's built with its own Makefile, in place of
this tree's.  Prints one JSON line per run (rank 0's exit code, negative
for a signal; its polls; the snapshot it last saw) and exits non-zero if
a run failed.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_main(rank, port, threads, hold_s, lib):
    import faulthandler
    faulthandler.enable(all_threads=True)   # a crash's Python stacks
    os.environ.update(HVD_TPU_CYCLE_TIME="1",
                      HOROVOD_STALL_CHECK_TIME_SECONDS="1")
    sys.path.insert(0, ROOT)
    import numpy as np
    if lib:
        from horovod_tpu_torch.native import _build
        _build.build = lambda: lib
    from horovod_tpu_torch.native.controller import NativeController
    ctl = NativeController(rank, 2, f"127.0.0.1:{port}")
    ctl.allreduce(np.ones(4, np.float32), op=1, name="warm")
    if rank == 1:
        time.sleep(hold_s)
        ctl.allreduce(np.ones(4, np.float32), op=1, name="held")
        ctl.shutdown()
        return
    stop = threading.Event()
    polls, seen = [0] * threads, [None] * threads

    def poll(i):
        while not stop.is_set():
            snap = ctl.stalled()
            polls[i] += 1
            if snap:
                seen[i] = snap

    pollers = [threading.Thread(target=poll, args=(i,)) for i in
               range(threads)]
    for t in pollers:
        t.start()
    out = ctl.allreduce(np.ones(4, np.float32), op=1, name="held")
    stop.set()
    for t in pollers:
        t.join()
    print(json.dumps({"polls": sum(polls), "sum": float(out[0]),
                      "snapshot": next((s for s in seen if s), None)}),
          flush=True)
    ctl.shutdown()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--hold-s", type=float, default=5.0)
    ap.add_argument("--lib", default="")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args.rank, args.port, args.threads, args.hold_s,
                  args.lib)
        return 0
    failed = 0
    for run in range(args.runs):
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--port", str(port), "--threads", str(args.threads),
             "--hold-s", str(args.hold_s), "--lib", args.lib],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=args.hold_s + 60))
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate())
        res = {"run": run, "lib": args.lib or "this tree",
               "rank0_rc": procs[0].returncode,
               "rank1_rc": procs[1].returncode}
        lines = [ln for ln in outs[0][0].splitlines() if ln.startswith("{")]
        if lines:
            res.update(json.loads(lines[-1]))
        ok = res["rank0_rc"] == 0 and res.get("sum") == 2.0
        failed += not ok
        if not ok:
            res["rank0_stderr_tail"] = outs[0][1][-1500:]
        print(json.dumps(res), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
