"""Elastic training through ``horovod_tpu_torch.torch`` (the counterpart
of examples/elastic_pytorch_train.py): the state commits every batch; on
a worker's failure or a host change the run loop restores the last
commit and re-forms the world.

    hvdrun-torch -np 2 --min-np 1 --max-np 4 \
        --host-discovery-script ./discover_hosts.sh \
        python examples/torch_port/elastic_pytorch_train.py
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


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--device", default=None,
                        help="cpu to compute on the CPU over gloo")
    args = parser.parse_args()

    hvd.init(device=args.device)
    dev = hvd.device()
    torch.manual_seed(42)

    model = nn.Sequential(nn.Linear(28 * 28, 128), nn.ReLU(),
                          nn.Linear(128, 10)).to(dev)
    optimizer = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05),
        named_parameters=model.named_parameters())

    data = torch.randn(512, 28 * 28).to(dev)
    target = torch.randint(0, 10, (512,)).to(dev)
    batch = 32

    state = hvd.elastic.TorchState(model=model, optimizer=optimizer,
                                   batch=0, epoch=0)

    @hvd.elastic.run
    def train(state):
        for epoch in range(state.epoch, args.epochs):
            shard = list(range(hvd.rank(), 512 // batch, hvd.size()))
            for i, b in enumerate(shard[state.batch:]):
                x = data[b * batch:(b + 1) * batch]
                y = target[b * batch:(b + 1) * batch]
                optimizer.zero_grad()
                F.cross_entropy(model(x), y).backward()
                optimizer.step()
                state.batch = state.batch + i + 1
                state.commit()
            state.batch = 0
            state.epoch = epoch + 1
            state.commit()
            if hvd.rank() == 0:
                with torch.no_grad():
                    loss = F.cross_entropy(model(data), target)
                print(f"epoch {epoch}: loss {loss:.4f} "
                      f"(world size {hvd.size()})")

    train(state)
    hvd.shutdown()


if __name__ == "__main__":
    main()
