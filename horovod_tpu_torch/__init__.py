"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

Synchronous data-parallel training of the flagship transformer on NVIDIA
Hopper GPUs: ``init()`` over ``torch.distributed`` (NCCL, or gloo with
``device="cpu"``), Horovod's collective API (sync and async, with the
fp16/bf16/int8/int4 compressed wire, Adasum), gradient reduction through
``DistributedOptimizer`` (error feedback on a quantized wire, bucketed
backward overlap, Adasum's delta model), ZeRO stages 1-3
(``ZeroShardedOptimizer``), ``sync_batch_norm``, the sharded checkpoint
engine (``checkpoint``, ``utils.checkpoint``), the input pipeline
(``data``), the ``DeviceMesh`` (``mesh()``, ``parallel.mesh``), the GSPMD
ZeRO plane (``gspmd``), sequence-parallel attention (ring and Ulysses,
``parallel``), and the transformer's attention on hand-written CUDA
flash-attention kernels.
Imports neither JAX nor ``horovod_tpu``.
"""

from .core.basics import (cross_rank, cross_size, device, init,
                          is_homogeneous, is_initialized, local_rank,
                          local_size, mesh, rank, shutdown, size)
from .core.exceptions import (DataStallError, HorovodInternalError,
                              HorovodTpuError, HostsUpdatedInterrupt,
                              NotInitializedError)
from .ops.collective import (Adasum, Average, Max, Min, Product, ReduceOp,
                             Sum, allgather, allgather_async, allreduce,
                             allreduce_, allreduce_async, alltoall,
                             alltoall_async, barrier, broadcast, broadcast_,
                             broadcast_async, grouped_allreduce, join, poll,
                             reducescatter, synchronize)
from .ops import gspmd, overlap
from .ops.compression import Compression
from .ops.sync_batch_norm import sync_batch_norm
from .optimizers import (DistributedOptimizer, ZeroShardedOptimizer,
                         allgather_object,
                         allreduce_gradients, broadcast_object,
                         broadcast_optimizer_state, broadcast_parameters,
                         grad, value_and_grad)
from . import parallel
from .parallel import mesh as mesh_lib
from .version import __version__
