"""MNIST-style MLP training on the port, fed by its sharded
``DataLoader`` (the counterpart of examples/jax_mnist.py; synthetic data,
no download).  Run in one process, or data-parallel:

    hvdrun-torch -np 2 python examples/torch_port/mnist.py
    python examples/torch_port/mnist.py --overlap --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import data as hvd_data  # noqa: E402
from horovod_tpu_torch.models import mlp  # noqa: E402


def synthetic_mnist(seed, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 28 * 28)).astype(np.float32)
    w_true = rng.standard_normal((28 * 28, 10)).astype(np.float32)
    return x, np.argmax(x @ w_true, axis=1)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--samples", type=int, default=512)
    p.add_argument("--hidden", type=int, default=512)
    p.add_argument("--overlap", action="store_true",
                   help="the bucketed gradient schedule: identical "
                        "losses, the wire starts from backward's hooks")
    p.add_argument("--device", default=None,
                   help="cpu to compute on the CPU over gloo")
    args = p.parse_args()

    hvd.init(device=args.device)
    dev = hvd.device()
    # Same seed on every rank: the weights start identical.
    params = mlp.init_params((784, args.hidden, args.hidden, 10),
                             torch.Generator().manual_seed(0), device=dev)
    leaves = [t.requires_grad_() for layer in params for t in layer.values()]
    # Scale the learning rate by the world, as the reference does.
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(leaves, lr=args.lr * hvd.size()),
        overlap=True if args.overlap else None)
    # Each rank its own samples, through the sharded input pipeline
    # (shuffle=False + DROP: the sequential full-batch feed).
    x, y = synthetic_mnist(1 + hvd.rank(), args.samples)
    loader = hvd_data.DataLoader(hvd_data.ArraySource(x, y),
                                 batch_size=args.batch, shuffle=False,
                                 policy=hvd_data.DROP, device=dev)
    for epoch in range(args.epochs):
        for xb, yb in loader:
            loss = mlp.loss_fn(params, xb, yb)
            loss.backward()
            opt.step()
            opt.zero_grad()
        mean = hvd.allreduce(loss.detach(), op=hvd.Average)
        if hvd.rank() == 0:
            print(f"epoch {epoch}: loss {float(mean):.4f}")
    loader.close()
    hvd.shutdown()


if __name__ == "__main__":
    main()
