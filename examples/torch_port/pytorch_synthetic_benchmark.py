"""Synthetic data-parallel training benchmark through
``horovod_tpu_torch.torch`` (the counterpart of
examples/pytorch_synthetic_benchmark.py): warm-up and timed batches,
gradients allreduced by ``DistributedOptimizer``'s hooks, img/sec.  It
computes on the card; a slot the launcher pins to the CPU (or
``--device cpu``) computes there:

    hvdrun-torch -np 1 python examples/torch_port/pytorch_synthetic_benchmark.py
    hvdrun-torch -np 2 --worker-platform cpu \
        python examples/torch_port/pytorch_synthetic_benchmark.py --num-iters 1
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402
import torch.nn as nn  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import horovod_tpu_torch.torch as hvd  # noqa: E402


class SmallConvNet(nn.Module):
    """Stand-in for a torchvision model (none is bundled)."""

    def __init__(self, num_classes=1000, width=32):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width, 3, stride=2, padding=1)
        self.conv2 = nn.Conv2d(width, width * 2, 3, stride=2, padding=1)
        self.pool = nn.AdaptiveAvgPool2d(1)
        self.fc = nn.Linear(width * 2, num_classes)

    def forward(self, x):
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x))
        return self.fc(self.pool(x).flatten(1))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--num-warmup-batches", type=int, default=2)
    p.add_argument("--num-batches-per-iter", type=int, default=5)
    p.add_argument("--num-iters", type=int, default=3)
    p.add_argument("--device", default=None,
                   help="cpu to compute on the CPU over gloo")
    args = p.parse_args()

    hvd.init(device=args.device)
    dev = hvd.device()
    torch.manual_seed(1234 + hvd.rank())

    model = SmallConvNet().to(dev)
    optimizer = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(optimizer, root_rank=0)

    data = torch.randn(args.batch_size, 3, args.image_size, args.image_size,
                       device=dev)
    target = torch.randint(0, 1000, (args.batch_size,), device=dev)

    def benchmark_step():
        optimizer.zero_grad()
        loss = F.cross_entropy(model(data), target)
        loss.backward()
        optimizer.step()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(args.num_warmup_batches):
        benchmark_step()
    sync()

    img_secs = []
    for i in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            benchmark_step()
        sync()
        rate = args.batch_size * args.num_batches_per_iter / \
            (time.perf_counter() - t0)
        img_secs.append(rate)
        if hvd.rank() == 0:
            print(f"iter {i}: {rate:.1f} img/sec per worker")

    if hvd.rank() == 0:
        avg = sum(img_secs) / len(img_secs)
        print(f"img/sec per worker: {avg:.1f} on {dev}")
        print(f"total img/sec on {hvd.size()} worker(s): "
              f"{avg * hvd.size():.1f}")
    hvd.shutdown()


if __name__ == "__main__":
    main()
