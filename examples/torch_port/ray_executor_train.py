"""RayExecutor on the port (the counterpart of
examples/ray_executor_train.py): the executor places Ray actors,
assigns ranks, gives each its slot env, torch world and device (with
GPUs each actor computes on the card Ray gave it; without, on the CPU
over gloo) and runs the training function on each as a rank.

    python examples/torch_port/ray_executor_train.py --workers 2
    python examples/torch_port/ray_executor_train.py --device cpu

It needs a Ray cluster (or local ray).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def train_fn(size):
    import torch
    import horovod_tpu_torch as hvd

    hvd.init()
    # Every rank contributes its rank + 1; the average is the same on all.
    out = hvd.allreduce(torch.full((size,), float(hvd.rank() + 1),
                                   device=hvd.device()))
    print(f"rank {hvd.rank()}/{hvd.size()} on {hvd.device()}: "
          f"allreduce -> {float(out[0]):.2f}")
    hvd.shutdown()
    return float(out[0])


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--size", type=int, default=4,
                   help="elements of the allreduced tensor")
    p.add_argument("--device", default=None,
                   help="cpu: actors without GPUs, on the CPU over gloo")
    args = p.parse_args()

    from horovod_tpu_torch.ray import RayExecutor
    executor = RayExecutor(num_workers=args.workers,
                           use_gpu=args.device != "cpu")
    executor.start()
    try:
        print("results:", executor.run(train_fn, args=(args.size,)))
    finally:
        executor.shutdown()


if __name__ == "__main__":
    main()
