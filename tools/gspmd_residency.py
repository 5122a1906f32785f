#!/usr/bin/env python3
"""Residency of the flagship's GSPMD ZeRO state at world 4, on the CPU.

    python3 tools/gspmd_residency.py [--world 4] [--stages 1 2 3]

Starts ``--world`` gloo ranks on this host's CPU.  Each builds the
flagship of chip_smoke.py (vocab 8192, d_model 512, 8 heads, d_ff 2048,
8 layers, seq 512) from seed 0 in fp32, takes one step of
``gspmd.make_zero_train_step`` with AdamW at each stage on one sequence of
16 tokens a rank (the step creates the moments; the batch does not change
the residency), and reads ``residency_report((params, state), mesh)``.
The parameters go in as the reference's nested tree (``['layers']['w1']``),
so the report names the leaves as the reference's does.
Prints one JSON line per stage (rank 0's report; every rank holds the
same bytes) and writes them to chiprun_out/gspmd_residency.json.  Needs
about 1 GB of host memory a rank.
"""

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def nested(named):
    """{"layers.w1": t} → {"layers": {"w1": t}}."""
    out = {}
    for name, t in named:
        *path, leaf = name.split(".")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = t
    return out


def flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    return {k: v for key, sub in tree.items()
            for k, v in flat(sub, f"{prefix}{key}.").items()}


def rank_main(rank, world, rendezvous, stages, out_path):
    sys.path.insert(0, ROOT)
    import torch
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(world))
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import gspmd

    hvd.init(device="cpu", init_method=f"file://{rendezvous}")
    try:
        cfg = tfm.TransformerConfig(vocab_size=8192, d_model=512, n_heads=8,
                                    d_ff=2048, n_layers=8, seq_len=512,
                                    dtype=torch.float32)
        tokens, labels = tfm.synthetic_batch(cfg, 1, seed=rank,
                                             device="cpu")
        batch = (tokens[:, :16], labels[:, :16])
        reports = {}
        for stage in stages:
            model = tfm.Transformer(cfg, seed=0, device="cpu")
            fns = gspmd.make_zero_train_step(
                lambda p, b: torch.func.functional_call(model, flat(p), b),
                lambda ps: torch.optim.AdamW(ps, lr=3e-4, weight_decay=1e-4),
                hvd.mesh(), stage=stage)
            params, state = fns.init(nested(model.named_parameters()))
            fns.step(params, state, batch)
            reports[stage] = gspmd.residency_report((params, state),
                                                    hvd.mesh())
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(reports, f)
    finally:
        hvd.shutdown()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--stages", type=int, nargs="+", default=[1, 2, 3])
    args = ap.parse_args()
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "reports.json")
        mp.start_processes(rank_main, args=(args.world,
                                            os.path.join(tmp, "rdv"),
                                            args.stages, out_path),
                           nprocs=args.world, join=True,
                           start_method="spawn")
        with open(out_path) as f:
            reports = json.load(f)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "gspmd_residency.json"), "w") as f:
        json.dump({"world": args.world, "reports": reports}, f, indent=1)
    for stage, rep in reports.items():
        print(json.dumps({"stage": int(stage), **rep}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
