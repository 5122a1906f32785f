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
long context (1, 8192, 16, 64), causal, bf16.  Prints one JSON object and
writes it to chiprun_out/kernel_ab.json.
"""

import argparse
import ctypes
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (shared helpers: inputs, timing, bounds)


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
        times = {name: {n: [] for n in calls} for name in libs}
        for name in base + ["tree", "tree"] + base[::-1]:
            fa._lib = libs[name]
            if label == "flagship" and not times[name]["flash_fwd"]:
                chip_smoke.check_case(torch, fa, q, k, v, do, True, 0, 0)
            for n, fn in calls.items():
                times[name][n].append(chip_smoke.time_ms(torch, fn, iters))
        bnd = chip_smoke.bounds(b, s, h, d)
        result["shapes"][label] = {
            "shape": [b, s, h, d],
            "bound_ms": {n: bnd[n][0] for n in calls},
            "ms": {name: {n: sum(t) / len(t) for n, t in per.items()}
                   for name, per in times.items()},
            "runs_ms": times}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "kernel_ab.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
