"""Worker bodies of the port's launcher tests
(test_torch_port_launch*.py).  Torch and the port only: the workers must
not import JAX.  Run by the launcher as

    python _torch_port_launch_workers.py static '<json arguments>'

or, for ``runner.run``, as the module-level functions below.  Every
worker takes the platform the launcher planned: ``init()`` with no
device, so a slot pinned to the CPU runs gloo.

* ``static`` — the reference's WORKER_SCRIPT (tests/test_runner.py:90-125):
  an allreduce of ``rank + 1``, an allgather of ``rank + 1`` rows, a
  broadcast from rank 0, checked in the worker; one JSON file a rank
  with its topology, device and whether the launch secret arrived.
* ``reinit`` — two static worlds one after the other in each worker.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)


def static_worker(outfile):
    import torch
    import horovod_tpu_torch as hvd

    torch.set_num_threads(1)   # the workers share the host's cores
    hvd.init()
    rank, size = hvd.rank(), hvd.size()
    out = hvd.allreduce(torch.full((8,), float(rank + 1)), op=hvd.Sum)
    assert torch.equal(out, torch.full((8,), float(sum(range(1, size + 1)))))
    g = hvd.allgather(torch.full((rank + 1, 2), float(rank)))
    assert g.shape[0] == sum(r + 1 for r in range(size))
    b = hvd.broadcast(torch.full((3,), float(rank)), root_rank=0)
    assert torch.equal(b, torch.zeros(3))
    with open(f"{outfile}.{rank}", "w") as f:
        json.dump({"rank": rank, "size": size,
                   "local_size": hvd.local_size(),
                   "cross_size": hvd.cross_size(),
                   "sum": float(out[0]), "device": str(hvd.device()),
                   "hostname": os.environ.get("HVD_TPU_HOSTNAME", ""),
                   "secret_present":
                       bool(os.environ.get("HVD_TPU_RENDEZVOUS_SECRET")),
                   "master_port": os.environ.get("MASTER_PORT"),
                   "rendezvous": os.environ.get("HVD_TPU_RENDEZVOUS_ADDR")},
                  f)
    hvd.shutdown()


def reinit_worker(outfile, delay_s):
    """Two static worlds in one launched process: init, an allreduce,
    shutdown, twice.  Rank 0 holds the first world's store ``delay_s``
    longer before it takes it down, so rank 1 asks for the second world
    while the first one's keys are still served."""
    import time

    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd

    torch.set_num_threads(1)
    destroy = dist.destroy_process_group

    def late_destroy(*a, **kw):
        time.sleep(delay_s)
        return destroy(*a, **kw)

    sums = []
    for world in range(2):
        hvd.init()
        rank = hvd.rank()
        if rank == 0 and world == 0:
            dist.destroy_process_group = late_destroy
        out = hvd.allreduce(torch.full((4,), float(rank + 1)), op=hvd.Sum)
        sums.append(float(out[0]))
        hvd.shutdown()
        dist.destroy_process_group = destroy
    with open(f"{outfile}.{rank}", "w") as f:
        json.dump({"rank": rank, "sums": sums}, f)


def rank_sum_fn(base):
    """The reference's ``_rank_sum_fn`` (tests/test_runner.py:208-214)."""
    import torch
    import horovod_tpu_torch as hvd

    torch.set_num_threads(1)
    hvd.init()
    out = hvd.allreduce(torch.tensor([float(hvd.rank() + base)]),
                        op=hvd.Sum, name="runfn")
    result = (float(out[0]), hvd.rank(), hvd.size(), hvd.device().type)
    hvd.shutdown()
    return result


def failing_fn():
    raise RuntimeError("worker boom")


if __name__ == "__main__":
    kind, args = sys.argv[1], json.loads(sys.argv[2])
    {"static": static_worker, "reinit": reinit_worker}[kind](**args)
