"""ZeRO weight-update sharding on the port (the counterpart of
examples/zero_optimizer.py): train a small MLP data-parallel with each
rank holding 1/N of the AdamW state.

``ZeroShardedOptimizer`` reduce-scatters the gradients, steps the rank's
flat shard, and all-gathers the updated shards into the parameters: the
communication volume of the allreduce it replaces, N times less
optimizer memory.  ``--stage 2`` keeps the gradients as shards too.

    hvdrun-torch -np 4 python examples/torch_port/zero_optimizer.py
    python examples/torch_port/zero_optimizer.py --device cpu
"""

import argparse
import functools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--stage", type=int, default=1, choices=[1, 2])
    p.add_argument("--device", default=None,
                   help="cpu to compute on the CPU over gloo")
    args = p.parse_args()

    hvd.init(device=args.device)
    dev, n = hvd.device(), hvd.size()
    torch.manual_seed(0)   # the same weights on every rank
    model = torch.nn.Sequential(torch.nn.Linear(16, args.hidden),
                                torch.nn.Tanh(),
                                torch.nn.Linear(args.hidden, 1)).to(dev)
    opt = hvd.ZeroShardedOptimizer(
        model, functools.partial(torch.optim.AdamW, lr=1e-2,
                                 weight_decay=1e-4), stage=args.stage)
    g = torch.Generator().manual_seed(1 + hvd.rank())   # this rank's rows
    x = torch.randn(args.batch, 16, generator=g).to(dev)
    y = x[:, :4].sum(dim=1, keepdim=True)

    losses = []
    for _ in range(args.steps):
        loss = torch.nn.functional.mse_loss(model(x), y)
        loss.backward()
        if args.stage == 2:
            opt.reduce_grads()
        opt.step()
        opt.zero_grad()
        losses.append(float(hvd.allreduce(loss.detach(), op=hvd.Average)))
    n_params = sum(q.numel() for q in model.parameters())
    n_state = sum(t.numel() for s in opt.optimizer.state.values()
                  for t in s.values() if torch.is_tensor(t) and t.dim())
    if hvd.rank() == 0:
        print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}  (params "
              f"{n_params}, per-rank opt state {n_state} ~= "
              f"2x{n_params}/{n}; replicated adam would be 2x{n_params})")
    assert losses[-1] < losses[0]
    hvd.shutdown()


if __name__ == "__main__":
    main()
