"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

One synchronous data-parallel training step of the flagship transformer
on NVIDIA Hopper GPUs: ``init()`` over ``torch.distributed`` (NCCL, or gloo
with ``device="cpu"``), gradient averaging through
``DistributedOptimizer``, and the transformer's attention on hand-written
CUDA flash-attention kernels.  Imports neither JAX nor ``horovod_tpu``.
"""

from .core.basics import (cross_rank, cross_size, device, init,
                          is_initialized, local_rank, local_size, rank,
                          shutdown, size)
from .core.exceptions import (HorovodInternalError, HorovodTpuError,
                              HostsUpdatedInterrupt, NotInitializedError)
from .ops.collective import (Adasum, Average, Max, Min, Product, ReduceOp,
                             Sum, allreduce, allreduce_, broadcast,
                             broadcast_, grouped_allreduce)
from .optimizers import (DistributedOptimizer, allreduce_gradients,
                         broadcast_optimizer_state, broadcast_parameters)
from .version import __version__
