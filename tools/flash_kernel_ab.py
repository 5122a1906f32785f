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
long context (1, 8192, 16, 64), causal, bf16.  Every build is launched
through its C entry points on the same parameter blocks, so a baseline
whose dQ reads a precomputed δ (before δ moved into dQ) runs beside the
tree's, which computes δ from O.

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


def kernel_params(torch, fa, q, k, v, do, lse, o, delta, args):
    """The FlashParams each kernel is launched with, the outputs of each
    kernel, and the inputs they point at (kept alive by the caller).  dQ's
    block carries δ, which an earlier build's dQ reads, and O with a δ
    output, which the tree's dQ reads and writes."""
    outs = {"flash_fwd": (torch.empty_like(q), torch.empty_like(lse)),
            "flash_bwd_dq": (torch.empty_like(q), torch.empty_like(lse)),
            "flash_bwd_dkv": (torch.empty_like(k), torch.empty_like(v))}
    fwd = fa._params(q, k, v, *args, out=outs["flash_fwd"][0],
                     lse_out=outs["flash_fwd"][1])
    dq, keep_dq = fa._bwd_params(q, k, v, do, *args, lse=lse, delta=delta,
                                 o=o, out=outs["flash_bwd_dq"][0],
                                 delta_out=outs["flash_bwd_dq"][1])
    dkv, keep_dkv = fa._bwd_params(q, k, v, do, *args, lse=lse, delta=delta,
                                   dk=outs["flash_bwd_dkv"][0],
                                   dv=outs["flash_bwd_dkv"][1])
    return ({"flash_fwd": fwd, "flash_bwd_dq": dq, "flash_bwd_dkv": dkv},
            outs, (keep_dq, keep_dkv))


def launcher(torch, lib, entry, params):
    """A call that launches C entry point ``entry`` on ``params`` on the
    current stream (the capture stream while a CUDA graph is recorded)."""
    fn = getattr(lib, entry)

    def run():
        if fn(ctypes.byref(params), torch.cuda.current_stream().cuda_stream):
            raise RuntimeError(f"{entry} launch failed")
    return run


def check_build(torch, fa, lib, params, outs, q, k, v, do, lse, o, delta,
                args, writes_delta):
    """Each kernel of one build, launched on the parameter blocks, against
    the plain versions, with chip_smoke.py's tolerances."""
    for n, entry in ENTRY.items():
        launcher(torch, lib, entry, params[n])()
    torch.cuda.synchronize()
    cmp = chip_smoke.compare
    cmp(torch, outs["flash_fwd"][0], o, chip_smoke.TOL_OUT)
    torch.testing.assert_close(outs["flash_fwd"][1], lse,
                               **chip_smoke.TOL_LSE)
    dq_p, delta_p = fa.bwd_dq_plain(q, k, v, do, lse, o, *args)
    cmp(torch, outs["flash_bwd_dq"][0], dq_p, chip_smoke.TOL_GRAD)
    if writes_delta:
        cmp(torch, outs["flash_bwd_dq"][1], delta_p, chip_smoke.TOL_DELTA)
    for got, ref in zip(outs["flash_bwd_dkv"],
                        fa.bwd_dkv_plain(q, k, v, do, lse, delta, *args)):
        cmp(torch, got, ref, chip_smoke.TOL_GRAD)


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
        delta = fa.bwd_dq_plain(q, k, v, do, lse, o, *args_)[1].contiguous()
        params, outs, keep = kernel_params(torch, fa, q, k, v, do, lse, o,
                                           delta, args_)
        times = {name: {n: [] for n in ENTRY} for name in libs}
        host = {name: {n: [] for n in ENTRY} for name in libs}
        with ClockSampler() as clock:
            for name in base + ["tree", "tree"] + base[::-1]:
                lib = libs[name]
                if label == "flagship" and not times[name]["flash_fwd"]:
                    check_build(torch, fa, lib, params, outs, q, k, v, do,
                                lse, o, delta, args_, name == "tree")
                for n, entry in ENTRY.items():
                    times[name][n].append(chip_smoke.time_ms(
                        torch, launcher(torch, lib, entry, params[n]), iters))
                    host[name][n].append(launch_us(torch, lib, entry,
                                                   params[n]))
        del keep, outs
        bnd = chip_smoke.bounds(b, s, h, d)
        result["shapes"][label] = {
            "shape": [b, s, h, d],
            "bound_ms": {n: bnd[n][0] for n in ENTRY},
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
