"""Long-context attention on the port: ring vs Ulysses sequence
parallelism (the counterpart of examples/long_context_attention.py).

Shards a long sequence over the world and runs exact causal attention
both ways, checking them against each other and timing them.  On the
card each block of the ring runs the hand-written flash kernels.

    hvdrun-torch -np 4 python examples/torch_port/long_context_attention.py
    python examples/torch_port/long_context_attention.py --device cpu \
        --seq 256
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch.parallel import ring_attention as ra  # noqa: E402
from horovod_tpu_torch.parallel.ulysses import ulysses_attention  # noqa: E402,E501


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=8192)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cpu to compute on the CPU over gloo")
    args = ap.parse_args()

    hvd.init(device=args.device)
    dev, sp, r = hvd.device(), hvd.size(), hvd.rank()
    if args.seq % sp:
        raise SystemExit(f"--seq {args.seq} does not split over {sp}")
    local = args.seq // sp
    if r == 0:
        print(f"{sp} rank(s); {args.seq} tokens -> {local} per rank")
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    g = torch.Generator().manual_seed(0)   # the full q, k, v on every rank
    q, k, v = [torch.randn(args.batch, args.seq, args.heads,
                           args.head_dim, generator=g).to(dev, dtype)
               for _ in range(3)]
    shard = [t[:, r * local:(r + 1) * local].contiguous() for t in (q, k, v)]

    def bench(fn):
        out = fn(*shard, causal=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            out = fn(*shard, causal=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / 5 * 1e3

    out_r, ms_r = bench(ra.ring_attention)
    out_u, ms_u = bench(ulysses_attention)
    err = (out_r.float() - out_u.float()).abs().max()
    err = float(hvd.allreduce(err, op=hvd.Max))
    if r == 0:
        print(f"ring:    {ms_r:8.2f} ms")
        print(f"ulysses: {ms_u:8.2f} ms")
        print(f"max |ring - ulysses| = {err:.2e}")
    hvd.shutdown()


if __name__ == "__main__":
    main()
