"""Elastic data-parallel training on the port (the counterpart of
examples/elastic_jax_train.py): the state commits every step; when a
worker fails or the hosts change, the run loop restores the last commit
and the world re-forms.

    hvdrun-torch --min-np 2 --max-np 4 \
        --host-discovery-script ./discover_hosts.sh \
        python examples/torch_port/elastic_train.py
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import elastic  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--size", type=int, default=10,
                   help="elements of the weight vector")
    p.add_argument("--device", default=None,
                   help="cpu to compute on the CPU over gloo")
    args = p.parse_args()

    hvd.init(device=args.device)
    state = elastic.ObjectState(epoch=0,
                                weights=np.zeros(args.size, np.float32))

    @elastic.run
    def train(state):
        while state.epoch < args.epochs:
            # One "training step": average a synthetic gradient over the
            # current world; the world may change between commits.
            grad = torch.full((args.size,), float(hvd.rank() + 1),
                              device=hvd.device())
            avg = hvd.allreduce(grad, op=hvd.Average,
                                name=f"g.{state.epoch}")
            state.weights -= 0.01 * avg.cpu().numpy()
            state.epoch += 1
            state.commit()
            if hvd.rank() == 0:
                print(f"epoch {state.epoch}: world={hvd.size()} "
                      f"w0={state.weights[0]:.4f}")

    train(state)
    hvd.shutdown()


if __name__ == "__main__":
    main()
