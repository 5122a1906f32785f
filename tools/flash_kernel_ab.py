#!/usr/bin/env python3
"""Compare builds of the flash-attention kernels on one GPU.

    python3 tools/flash_kernel_ab.py --baseline OLD.cu [--baseline OLDER.cu]

A baseline is an earlier version of the kernel source, for example
``git show <commit>:horovod_tpu_torch/csrc/flash_attention.cu`` saved
under the git-ignored ``horovod_tpu_torch/_build/ab/``.  Builds each
baseline (same C interface and ``FlashParams`` layout as the tree's;
named by its file stem) and the tree's
``horovod_tpu_torch/csrc/flash_attention.cu``, checks every build against
the plain PyTorch versions at the flagship training shape, and times each
kernel of every build with CUDA events in the order baselines, tree,
tree, baselines reversed, at the flagship shape (8, 512, 8, 64) and at
long context (1, 8192, 16, 64), causal, bf16.

Beside each device time it takes the host's cost of one launch
(``launch_us``): the C entry point called through ctypes on a prepared
parameter block, 200 calls back to back, best of 5 rounds.  It holds what
the launcher does on the host, such as encoding TMA descriptors, so the
difference between two builds is their difference in host work.  The SM
clock is sampled with nvidia-smi while the long-context shape is timed.
Prints one JSON object and
writes it to chiprun_out/kernel_ab.json.
"""

import argparse
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (shared helpers: inputs, timing, bounds)

ENTRY = {"flash_fwd": "hvd_flash_fwd", "flash_bwd_dq": "hvd_flash_bwd_dq",
         "flash_bwd_dkv": "hvd_flash_bwd_dkv"}


def launch_us(torch, lib, entry, params, calls=200, rounds=5):
    """Host time (µs) of one call of C entry point ``entry`` on the
    parameter block ``params``, launches enqueued back to back."""
    fn = getattr(lib, entry)
    stream = torch.cuda.current_stream().cuda_stream
    best = math.inf
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            if fn(ctypes.byref(params), stream):
                raise RuntimeError(f"{entry} launch failed")
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return best


def kernel_params(torch, fa, q, k, v, do, lse, delta, args):
    """The FlashParams each kernel is launched with, and the outputs and
    inputs they point at (kept alive by the caller)."""
    out = torch.empty_like(q)
    lse_out = torch.empty_like(lse)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fwd = fa._params(q, k, v, *args, out=out, lse_out=lse_out)
    dq, keep_dq = fa._bwd_params(q, k, v, do, lse, delta, *args, out=out)
    dkv, keep_dkv = fa._bwd_params(q, k, v, do, lse, delta, *args, dk=dk,
                                   dv=dv)
    return ({"flash_fwd": fwd, "flash_bwd_dq": dq, "flash_bwd_dkv": dkv},
            (out, lse_out, dk, dv, keep_dq, keep_dkv))


class ClockSampler:
    """nvidia-smi sampling the SM clock (MHz) every 100 ms."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
             "nounits", "-lms", "100"], stdout=subprocess.PIPE, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=10)
        self.mhz = [int(x) for x in out.split() if x.strip().isdigit()]
        return False


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", action="append", required=True)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa

    card = chip_smoke.card_line()
    libs = {os.path.splitext(os.path.basename(src))[0]: fa._bind(
        ctypes.CDLL(_build.build_file(os.path.abspath(src))))
        for src in args.baseline}
    base = list(libs)
    libs["tree"] = fa._library()
    result = {"card": card, "shapes": {}}
    for label, (b, s, h, d), iters in (("flagship", (8, 512, 8, 64), 50),
                                       ("long_context", (1, 8192, 16, 64),
                                        10)):
        q, k, v, do = chip_smoke.rand_qkv(torch, b, s, s, h, d, seed=7)
        args_ = (True, 1.0 / math.sqrt(d), 0, 0)
        o, lse = fa.attention_with_lse_plain(q, k, v, *args_)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        bargs = (do, lse, delta) + args_
        calls = {
            "flash_fwd": lambda: fa.flash_fwd(q, k, v, *args_),
            "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, *bargs),
            "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, *bargs),
        }
        params, keep = kernel_params(torch, fa, q, k, v, do, lse, delta,
                                     args_)
        times = {name: {n: [] for n in calls} for name in libs}
        host = {name: {n: [] for n in calls} for name in libs}
        with ClockSampler() as clock:
            for name in base + ["tree", "tree"] + base[::-1]:
                fa._lib = libs[name]
                if label == "flagship" and not times[name]["flash_fwd"]:
                    chip_smoke.check_case(torch, fa, q, k, v, do, True, 0, 0)
                for n, fn in calls.items():
                    times[name][n].append(chip_smoke.time_ms(torch, fn, iters))
                    host[name][n].append(launch_us(torch, libs[name],
                                                   ENTRY[n], params[n]))
        del keep
        bnd = chip_smoke.bounds(b, s, h, d)
        result["shapes"][label] = {
            "shape": [b, s, h, d],
            "bound_ms": {n: bnd[n][0] for n in calls},
            "ms": {name: {n: sum(t) / len(t) for n, t in per.items()}
                   for name, per in times.items()},
            "runs_ms": times,
            "launch_us": {name: {n: min(t) for n, t in per.items()}
                          for name, per in host.items()},
            "sm_clock_mhz": {
                "median": statistics.median(clock.mhz) if clock.mhz else None,
                "min": min(clock.mhz, default=None),
                "max": max(clock.mhz, default=None)}}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "kernel_ab.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
