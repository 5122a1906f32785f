"""The ``horovod.mxnet`` API on the port (port of horovod_tpu/mxnet/).

``DistributedOptimizer`` allreduces inside ``update``,
``DistributedTrainer`` is the Gluon trainer whose ``_allreduce_grads``
sums the gradients over the ranks, and the collectives and
``broadcast_parameters`` take NDArrays.  An NDArray crosses to the
port's collectives as a CPU torch tensor made from its numpy copy, and
back as an NDArray of its context and dtype: in an NCCL world the
collectives need the native controller, whose host plane takes CPU
tensors.

MXNet is optional: this module imports without it, and the first call
that needs an NDArray constructor raises ImportError.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.basics import (ccl_built, cross_rank, cross_size,  # noqa: F401
                           cuda_built, ddl_built, gloo_built, init,
                           is_initialized, local_rank, local_size,
                           mpi_built, mpi_threads_supported, nccl_built,
                           rank, rocm_built, shutdown, size)
from ..ops import collective as _C
from ..ops.collective import (Adasum, Average, Max, Min,  # noqa: F401
                              Product, Sum)
from ..optimizers import allgather_object, broadcast_object  # noqa: F401


def _mx():
    try:
        import mxnet
        return mxnet
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.mxnet requires the mxnet package; install "
            "mxnet or use the torch or tensorflow front ends") from e


def _to_torch(tensor) -> torch.Tensor:
    """An NDArray's values as a CPU tensor of its dtype."""
    return torch.from_numpy(np.ascontiguousarray(tensor.asnumpy()))


def _from_torch(out, like):
    mx = _mx()
    return mx.nd.array(out.numpy(), ctx=like.context, dtype=like.dtype)


def allreduce(tensor, average: Optional[bool] = None,
              name: Optional[str] = None, op: int = Average,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0):
    """Keeps the reference's legacy ``average`` flag beside the op."""
    if average is not None:
        op = Average if average else Sum
    out = _C.allreduce(_to_torch(tensor), op=op, name=name,
                       prescale_factor=prescale_factor,
                       postscale_factor=postscale_factor)
    return _from_torch(out, tensor)


def allreduce_(tensor, average: Optional[bool] = None,
               name: Optional[str] = None, op: int = Average):
    allreduce(tensor, average=average, name=name, op=op).copyto(tensor)
    return tensor


def grouped_allreduce(tensors, average: Optional[bool] = None,
                      name: Optional[str] = None, op: int = Average):
    if average is not None:
        op = Average if average else Sum
    outs = _C.grouped_allreduce([_to_torch(t) for t in tensors], op=op,
                                name=name or "grouped")
    return [_from_torch(o, t) for o, t in zip(outs, tensors)]


def allgather(tensor, name: Optional[str] = None):
    return _from_torch(_C.allgather(_to_torch(tensor), name=name), tensor)


def broadcast(tensor, root_rank: int = 0, name: Optional[str] = None):
    out = _C.broadcast(_to_torch(tensor), root_rank=root_rank, name=name)
    return _from_torch(out, tensor)


def broadcast_(tensor, root_rank: int = 0, name: Optional[str] = None):
    broadcast(tensor, root_rank=root_rank, name=name).copyto(tensor)
    return tensor


def alltoall(tensor, splits=None, name: Optional[str] = None):
    out, recv_splits = _C.alltoall(_to_torch(tensor), splits=splits,
                                   name=name)
    return _from_torch(out, tensor), recv_splits.numpy()


def join() -> int:
    return _C.join()


def barrier():
    _C.barrier()


def broadcast_parameters(params, root_rank: int = 0, prefix: str = ""):
    """Broadcast a Gluon ParameterDict (``Block.collect_params()``) or a
    plain {name: NDArray} dict from the root (reference
    mxnet/functions.py broadcast_parameters)."""
    if hasattr(params, "items"):
        items = sorted(params.items())
    else:
        raise ValueError("invalid params of type: %s" % type(params))
    for name, p in items:
        try:
            tensor = p.data() if hasattr(p, "data") and callable(p.data) else p
        except Exception as e:
            # Deferred-init Gluon parameters have nothing to sync yet; any
            # other failure must surface, or the ranks diverge.
            if type(e).__name__ == "DeferredInitializationError":
                continue
            raise
        broadcast_(tensor, root_rank=root_rank,
                   name=prefix + "bcast.param." + str(name))


class DistributedOptimizer:
    """Wraps an ``mx.optimizer.Optimizer``: gradients are allreduced
    before the wrapped update (reference mxnet/__init__.py:58-84)."""

    def __init__(self, optimizer, gradient_predivide_factor: float = 1.0,
                 op: int = Average):
        self._optimizer = optimizer
        self._predivide = gradient_predivide_factor
        self._op = op

    def __getattr__(self, item):
        return getattr(self.__dict__["_optimizer"], item)

    def _do_allreduce(self, index, grad):
        if size() == 1:
            return grad
        # The predivide splits the averaging division around the wire sum
        # (1/p before it, p after it): the result is the plain average.
        pre, post = 1.0 / self._predivide, self._predivide
        if isinstance(index, (tuple, list)):
            return [allreduce(g, op=self._op, name=f"grad.{i}",
                              prescale_factor=pre, postscale_factor=post)
                    for i, g in zip(index, grad)]
        return allreduce(grad, op=self._op, name=f"grad.{index}",
                         prescale_factor=pre, postscale_factor=post)

    def update(self, index, weight, grad, state):
        grad = self._do_allreduce(index, grad)
        self._optimizer.update(index, weight, grad, state)

    def update_multi_precision(self, index, weight, grad, state):
        grad = self._do_allreduce(index, grad)
        self._optimizer.update_multi_precision(index, weight, grad, state)

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def set_lr_mult(self, args_lr_mult):
        self._optimizer.set_lr_mult(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self._optimizer.set_wd_mult(args_wd_mult)


def DistributedTrainer(params, optimizer, optimizer_params=None,
                       gradient_predivide_factor: float = 1.0,
                       prefix: Optional[str] = None):
    """Gluon trainer whose ``_allreduce_grads`` sums the gradients over
    the ranks, with ``rescale_grad`` divided by ``size()`` so the sum is
    the global average (reference mxnet/__init__.py DistributedTrainer)."""
    mx = _mx()

    class _DistributedTrainer(mx.gluon.Trainer):
        def __init__(self):
            if isinstance(optimizer, DistributedOptimizer):
                raise ValueError(
                    "DistributedTrainer does not take DistributedOptimizer; "
                    "pass the bare optimizer")
            super().__init__(params, optimizer,
                             optimizer_params or {}, kvstore=None)
            self._scale /= size()
            self._prefix = prefix or ""
            self._predivide = gradient_predivide_factor

        def _allreduce_grads(self):
            if size() == 1:
                return
            pre, post = 1.0 / self._predivide, self._predivide
            for i, param in enumerate(self._params):
                if param.grad_req != "null":
                    for grad in param.list_grad():
                        allreduce(grad, op=Sum,
                                  name=f"{self._prefix}grad.{i}",
                                  prescale_factor=pre,
                                  postscale_factor=post).copyto(grad)

    return _DistributedTrainer()
