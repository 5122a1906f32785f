"""Data-parallel training through ``horovod_tpu_torch.torch`` on
synthetic MNIST-shaped data (no download; the counterpart of
examples/pytorch_mnist.py):

    hvdrun-torch -np 2 python examples/torch_port/pytorch_mnist.py
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402
import torch.nn as nn  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import horovod_tpu_torch.torch as hvd  # noqa: E402


class Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(784, 128)
        self.fc2 = nn.Linear(128, 10)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x.flatten(1))))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--device", default=None,
                        help="cpu to compute on the CPU over gloo")
    args = parser.parse_args()

    hvd.init(device=args.device)
    dev = hvd.device()
    torch.manual_seed(1234)
    model = Net().to(dev)
    # Scale the learning rate by the world size; wrap the optimizer;
    # broadcast the initial state.
    optimizer = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=args.lr * hvd.size()),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

    # Synthetic data, a different shard on each rank.
    g = torch.Generator().manual_seed(hvd.rank())
    x = torch.randn(1024, 1, 28, 28, generator=g).to(dev)
    y = torch.randint(0, 10, (1024,), generator=g).to(dev)

    for epoch in range(args.epochs):
        for i in range(0, len(x), args.batch):
            optimizer.zero_grad()
            loss = F.cross_entropy(model(x[i:i + args.batch]),
                                   y[i:i + args.batch])
            loss.backward()
            optimizer.step()
        avg = hvd.allreduce(loss.detach(), op=hvd.Average,
                            name=f"loss.{epoch}")
        if hvd.rank() == 0:
            print(f"epoch {epoch}: loss {float(avg):.4f}")
    hvd.shutdown()


if __name__ == "__main__":
    main()
