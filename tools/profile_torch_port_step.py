#!/usr/bin/env python3
"""Where the time of one horovod_tpu_torch training step goes, on one GPU.

    python3 tools/profile_torch_port_step.py [--steps 3] [--flash 1|0]
        [--compression none|fp16|bf16|int8|int4]

Runs the flagship configuration of chip_smoke.py (vocab 8192, d_model 512,
8 heads, d_ff 2048, 8 layers, seq 512, bf16, batch 8) through
init() / DistributedOptimizer(AdamW) / make_train_step, warms up, then
traces ``--steps`` steps with torch.profiler.  Prints the wall time per
step, the device's busy share (union of kernel intervals over the wall
time), and the kernel time and launches per step by group: the port's
flash kernels, matrix products, NCCL, the optimizer, and the rest.  ``--flash 0`` runs the
plain attention path instead (HVD_TPU_FLASH=0); ``--compression`` puts the
gradients on that wire (DistributedOptimizer(compression=)), whose
quantize/cast work lands in "other".  Writes the numbers to
chiprun_out/profile_step[_plain][_<wire>].json and the trace beside it.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GROUPS = (  # first match wins; matched against the lower-cased kernel name
    ("flash_kernels", ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                       "flash_bwd_dkv_kernel")),
    ("nccl", ("nccl",)),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "cublas", "sm90_")),
    ("optimizer", ("multi_tensor", "adam")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--flash", default="1", choices=("0", "1"))
    ap.add_argument("--compression", default="none",
                    choices=("none", "fp16", "bf16", "int8", "int4"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_port_step: no CUDA device", file=sys.stderr)
        return 2
    os.environ["HVD_TPU_FLASH"] = args.flash
    sys.path.insert(0, ROOT)
    import chip_smoke
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tfm
    from torch.profiler import ProfilerActivity, profile

    card = chip_smoke.card_line()
    hvd.init()
    cfg = tfm.TransformerConfig(vocab_size=8192, d_model=512, n_heads=8,
                                d_ff=2048, n_layers=8, seq_len=512,
                                dtype=torch.bfloat16)
    par = tfm.ParallelConfig()
    model = tfm.Transformer(cfg, par, seed=0)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=3e-4, weight_decay=1e-4),
        compression=args.compression)
    step = tfm.make_train_step(cfg, par, model, opt)
    tokens, labels = tfm.synthetic_batch(cfg, 8, seed=1)
    for _ in range(3):
        step(tokens, labels)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(tokens, labels)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps
    # Device activity: kernels, memsets, copies.  Record-function ranges
    # mirrored on the device timeline (user annotations, such as the
    # optimizer's step) span kernels already counted and are left out.
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    by_group, by_name, spans, n_group = {}, {}, [], {}
    for e in kernels:
        dur = e.time_range.end - e.time_range.start       # microseconds
        g = group_of(e.name)
        by_group[g] = by_group.get(g, 0.0) + dur
        n_group[g] = n_group.get(g, 0) + 1
        by_name[e.name] = by_name.get(e.name, 0.0) + dur
        spans.append((e.time_range.start, e.time_range.end))
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    per_step = lambda us: us / args.steps / 1e3           # -> ms per step
    result = {
        "card": card, "flash": args.flash, "compression": args.compression,
        "steps": args.steps,
        "wall_ms_per_step": wall * 1e3,
        "kernel_ms_per_step": per_step(sum(by_name.values())),
        "busy_ms_per_step": per_step(busy),
        "busy_share_of_wall": busy / (wall * args.steps * 1e6),
        "busy_share_of_kernel_window": busy / window,
        "launches_per_step": len(kernels) / args.steps,
        "group_launches_per_step": {g: n / args.steps
                                    for g, n in sorted(n_group.items())},
        "group_ms_per_step": {g: per_step(t) for g, t in
                              sorted(by_group.items(), key=lambda x: -x[1])},
        "top_kernels_ms_per_step": {
            n[:90]: per_step(t) for n, t in
            sorted(by_name.items(), key=lambda x: -x[1])[:15]},
    }
    hvd.shutdown()
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    tag = ("" if args.flash == "1" else "_plain") + (
        "" if args.compression == "none" else "_" + args.compression)
    with open(os.path.join(out_dir, f"profile_step{tag}.json"), "w") as f:
        json.dump(result, f, indent=1)
    prof.export_chrome_trace(os.path.join(out_dir,
                                          f"profile_step{tag}_trace.json"))
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
