"""The ``horovod.torch`` API on the port (port of horovod_tpu/torch/).

``import horovod_tpu_torch.torch as hvd`` gives a PyTorch user of Horovod
the calls they know: ``hvd.DistributedOptimizer(opt,
named_parameters=model.named_parameters())`` with per-parameter
gradient hooks that fire asynchronous allreduces during backward and
wait for them in ``step()``, the differentiable collectives, their
in-place and ``*_async`` forms with ``poll``/``synchronize``,
``sparse_allreduce``, ``broadcast_parameters`` /
``broadcast_optimizer_state``, ``SyncBatchNorm`` and the elastic state.

Where the reference bridges CPU tensors to its runtime through numpy
views, the port hands torch tensors to its own collectives
(``ops.collective``): on the card a gradient goes to NCCL, or, with the
native controller attached (``init(use_controller=True)``), to the
negotiated device plane (``ops.eager``); it never crosses to the host.
The exceptions are the host plane's, as the eager plane documents them:
Adasum and bool allreduces under a controller.

A hook fires on autograd's thread with the stream that produced the
gradient current, and issues its collective on that stream: NCCL's work
stream, or the device executor's, waits on an event recorded there, so
no collective reads a gradient before it is written.

A tensor off the world's device (a CPU tensor in an NCCL world) is not
copied to the card: without a controller the collectives refuse it with
``ValueError``; with a controller it takes the host plane.  Optimizer
state that lives on the host by design (AdamW's ``step`` counts) travels
through the world's device in ``broadcast_optimizer_state``, as the
port's other state broadcasts do.
"""

from __future__ import annotations

import warnings
from contextlib import contextmanager as _contextmanager
from typing import Any, Dict, List, Optional, Tuple

import torch as _torch

from ..core.basics import (ccl_built, cross_rank, cross_size,  # noqa: F401
                           cuda_built, ddl_built, device, gloo_built, init,
                           is_initialized, local_rank, local_size,
                           mpi_built, mpi_threads_supported, nccl_built,
                           rank, rocm_built, shutdown, size)
from ..core import handles as _handles
from ..core.state import global_state
from ..ops import collective as _C
from ..ops.collective import (Adasum, Average, Max, Min,  # noqa: F401
                              Product, Sum)
from ..optimizers import allgather_object, broadcast_object  # noqa: F401
from .sync_batch_norm import SyncBatchNorm  # noqa: F401
from . import elastic  # noqa: F401  (hvd.elastic.TorchState, ElasticSampler)


class Compression:
    """Torch-side wire compression (reference torch/compression.py)."""

    class none:
        @staticmethod
        def compress(t):
            return t, None

        @staticmethod
        def decompress(t, ctx):
            return t

    class fp16:
        @staticmethod
        def compress(t):
            if t.dtype in (_torch.float32, _torch.float64):
                return t.half(), t.dtype
            return t, None

        @staticmethod
        def decompress(t, ctx):
            return t if ctx is None else t.to(ctx)

    class bf16:
        """bfloat16 wire compression (fp32's exponent range: no loss
        scaling needed, unlike fp16)."""

        @staticmethod
        def compress(t):
            if t.dtype in (_torch.float32, _torch.float64):
                return t.to(_torch.bfloat16), t.dtype
            return t, None

        @staticmethod
        def decompress(t, ctx):
            return t if ctx is None else t.to(ctx)


def _check_device(tensor: _torch.Tensor) -> None:
    """Refuse a tensor off the world's device when no controller can take
    it to the host plane: it is never copied to the card behind the
    caller's back."""
    dev = global_state.device
    if (dev is not None and dev.type != tensor.device.type
            and global_state.controller is None):
        raise ValueError(
            f"a {tensor.device.type} tensor handed to a world that "
            f"computes on {dev}: move it there first (tensor.to("
            f"hvd.device())), or attach the native controller "
            f"(init(use_controller=True)), whose host plane takes it")


def _allreduce_nograd(tensor: _torch.Tensor, op: int,
                      name: Optional[str], prescale_factor: float,
                      postscale_factor: float) -> _torch.Tensor:
    _check_device(tensor)
    return _C.allreduce(tensor.detach(), op=op, name=name,
                        prescale_factor=prescale_factor,
                        postscale_factor=postscale_factor)


class _AllreduceFn(_torch.autograd.Function):
    """Differentiable allreduce (reference HorovodAllreduce): the
    gradient of an allreduce is the same allreduce of the upstream
    gradient."""

    @staticmethod
    def forward(ctx, tensor, op, name, prescale_factor, postscale_factor):
        ctx.op = op
        ctx.prescale_factor = prescale_factor
        ctx.postscale_factor = postscale_factor
        return _allreduce_nograd(tensor, op, name, prescale_factor,
                                 postscale_factor)

    @staticmethod
    def backward(ctx, grad_output):
        return (_allreduce_nograd(grad_output, ctx.op, None,
                                  ctx.prescale_factor,
                                  ctx.postscale_factor),
                None, None, None, None)


def allreduce(tensor: _torch.Tensor, op: int = Average,
              name: Optional[str] = None,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0,
              compression=None) -> _torch.Tensor:
    """Out-of-place allreduce; differentiable (gradients allreduce with
    the same op).  ``compression`` casts around the transport."""
    comp = compression or Compression.none
    compressed, cctx = comp.compress(tensor)
    out = _AllreduceFn.apply(compressed, op, name, prescale_factor,
                             postscale_factor)
    return comp.decompress(out, cctx)


def allreduce_(tensor: _torch.Tensor, op: int = Average,
               name: Optional[str] = None) -> _torch.Tensor:
    with _torch.no_grad():
        tensor.copy_(_allreduce_nograd(tensor, op, name, 1.0, 1.0))
    return tensor


def _allgather_nograd(tensor: _torch.Tensor,
                      name: Optional[str]) -> _torch.Tensor:
    _check_device(tensor)
    t = tensor.detach()
    if t.dim() > 0:
        return _C.allgather(t, name=name)
    # A scalar gathers as one element a rank; a world of one keeps its
    # shape, as the reference's identity does.
    out = _C.allgather(t.reshape(1), name=name)
    return out.reshape(()) if _C.communicator_size() == 1 else out


class _AllgatherFn(_torch.autograd.Function):
    """Differentiable allgather: the gradient averages the upstream
    gradient across ranks, then slices out this rank's own rows
    (reference HorovodAllgather.backward)."""

    @staticmethod
    def forward(ctx, tensor, name):
        ctx.scalar = tensor.dim() == 0
        ctx.dim0 = 1 if ctx.scalar else tensor.shape[0]
        return _allgather_nograd(tensor, name)

    @staticmethod
    def backward(ctx, grad_output):
        g = _allreduce_nograd(grad_output, Average, None, 1.0, 1.0)
        r = rank()
        if ctx.scalar:
            return g.reshape(-1)[r:r + 1].reshape(()), None
        dims = _allgather_nograd(
            _torch.tensor([ctx.dim0], dtype=_torch.int64,
                          device=grad_output.device), None)
        offset = int(dims[:r].sum()) if r > 0 else 0
        return g.narrow(0, offset, ctx.dim0), None


def allgather(tensor: _torch.Tensor,
              name: Optional[str] = None) -> _torch.Tensor:
    return _AllgatherFn.apply(tensor, name)


def _broadcast_nograd(tensor: _torch.Tensor, root_rank: int,
                      name: Optional[str]) -> _torch.Tensor:
    _check_device(tensor)
    return _C.broadcast(tensor.detach(), root_rank=root_rank, name=name)


class _BroadcastFn(_torch.autograd.Function):
    """Differentiable broadcast: gradients flow back to the root — the
    averaged upstream gradient on the root, zero elsewhere (reference
    HorovodBroadcast.backward)."""

    @staticmethod
    def forward(ctx, tensor, root_rank, name):
        ctx.root_rank = root_rank
        return _broadcast_nograd(tensor, root_rank, name)

    @staticmethod
    def backward(ctx, grad_output):
        g = _allreduce_nograd(grad_output, Average, None, 1.0, 1.0)
        if rank() != ctx.root_rank:
            g = g * 0
        return g, None, None


def broadcast(tensor: _torch.Tensor, root_rank: int = 0,
              name: Optional[str] = None) -> _torch.Tensor:
    return _BroadcastFn.apply(tensor, root_rank, name)


def broadcast_(tensor: _torch.Tensor, root_rank: int = 0,
               name: Optional[str] = None) -> _torch.Tensor:
    with _torch.no_grad():
        tensor.copy_(_broadcast_nograd(tensor, root_rank, name))
    return tensor


def _alltoall_nograd(tensor: _torch.Tensor, splits, name: Optional[str]):
    _check_device(tensor)
    if _torch.is_tensor(splits):
        splits = splits.tolist()
    return _C.alltoall(tensor.detach(), splits=splits, name=name)


class _AlltoallFn(_torch.autograd.Function):
    """Differentiable alltoall: gradients route back with the received
    splits as the send splits (reference HorovodAlltoall.backward)."""

    @staticmethod
    def forward(ctx, tensor, splits, name):
        out, recv_splits = _alltoall_nograd(tensor, splits, name)
        ctx.recv_splits = recv_splits.tolist()
        ctx.mark_non_differentiable(recv_splits)
        return out, recv_splits

    @staticmethod
    def backward(ctx, grad_output, _grad_splits):
        g, _ = _alltoall_nograd(grad_output, ctx.recv_splits, None)
        return g, None, None


def alltoall(tensor: _torch.Tensor, splits=None, name: Optional[str] = None):
    return _AlltoallFn.apply(tensor, splits, name)


def _sparse_submit(t: _torch.Tensor, name: str):
    """Submit the two asynchronous allgathers of a coalesced sparse
    tensor's indices (int64) and values; each rank's row count may
    differ.  Returns a submission for ``_sparse_finish``."""
    _check_device(t)
    h_idx = _C.allgather_async(t.indices().t().contiguous(),
                               name=name + ".idx")
    h_val = _C.allgather_async(t.values().contiguous(), name=name + ".vals")
    return (h_idx, h_val, t.shape)


def _sparse_finish(submitted, op: int) -> _torch.Tensor:
    """Finish a ``_sparse_submit``: the gathered slices summed by
    ``coalesce`` on their device, divided for op=Average."""
    h_idx, h_val, shape = submitted
    indices = _C.synchronize(h_idx)
    values = _C.synchronize(h_val)
    out = _torch.sparse_coo_tensor(indices.t(), values,
                                   size=shape).coalesce()
    if op == Average:
        out = out / _C.communicator_size()
    return out


def sparse_allreduce(tensor: _torch.Tensor, name: Optional[str] = None,
                     op: int = Average) -> _torch.Tensor:
    """Allreduce a sparse COO tensor by allgathering its indices and
    values: the gathered slices are summed, averaged for op=Average."""
    if not tensor.is_sparse:
        raise ValueError("sparse_allreduce expects a sparse tensor")
    t = tensor.coalesce()
    return _sparse_finish(_sparse_submit(t, name or "sparse"), op)


def join() -> int:
    return _C.join()


def barrier():
    _C.barrier()


def poll(handle) -> bool:
    return _C.poll(handle)


def synchronize(handle):
    """Block on an async handle and return its result (reference
    torch/mpi_ops.py synchronize)."""
    return _C.synchronize(handle)


def allreduce_async(tensor: _torch.Tensor, op: int = Average,
                    name: Optional[str] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0) -> int:
    """Out-of-place async allreduce; returns a handle for
    ``poll``/``synchronize``."""
    _check_device(tensor)
    return _C.allreduce_async(tensor.detach(), op=op, name=name,
                              prescale_factor=prescale_factor,
                              postscale_factor=postscale_factor)


def allgather_async(tensor: _torch.Tensor,
                    name: Optional[str] = None) -> int:
    _check_device(tensor)
    return _C.allgather_async(tensor.detach(), name=name)


def broadcast_async(tensor: _torch.Tensor, root_rank: int = 0,
                    name: Optional[str] = None) -> int:
    _check_device(tensor)
    return _C.broadcast_async(tensor.detach(), root_rank=root_rank,
                              name=name)


def alltoall_async(tensor: _torch.Tensor, splits=None,
                   name: Optional[str] = None) -> int:
    _check_device(tensor)
    return _C.alltoall_async(tensor.detach(), splits=splits, name=name)


def _inplace_async(tensor: _torch.Tensor, inner: int) -> int:
    """A handle whose result lands in ``tensor`` at ``synchronize``: the
    collective ``inner`` is in flight meanwhile (on NCCL or the device
    plane for a tensor on the card; the reference is asynchronous only
    for CPU tensors under its controller)."""
    def wait():
        with _torch.no_grad():
            tensor.copy_(_C.synchronize(inner))
        return tensor
    return _handles.handle_manager.allocate(_handles.Handle(
        poll_fn=lambda: _C.poll(inner), wait_fn=wait))


def allreduce_async_(tensor: _torch.Tensor, op: int = Average,
                     name: Optional[str] = None,
                     prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0) -> int:
    return _inplace_async(tensor, allreduce_async(
        tensor, op, name, prescale_factor, postscale_factor))


def broadcast_async_(tensor: _torch.Tensor, root_rank: int = 0,
                     name: Optional[str] = None) -> int:
    return _inplace_async(tensor, broadcast_async(tensor, root_rank, name))


def _grouped_allreduce_nograd(tensors, op: int,
                              name: Optional[str]) -> List[_torch.Tensor]:
    for t in tensors:
        _check_device(t)
    outs = _C.grouped_allreduce([t.detach() for t in tensors], op=op,
                                name=name)
    return [o.to(t.dtype) for o, t in zip(outs, tensors)]


class _GroupedAllreduceFn(_torch.autograd.Function):
    """Differentiable grouped allreduce: upstream gradients
    grouped-allreduce with the same op."""

    @staticmethod
    def forward(ctx, op, name, *tensors):
        ctx.op = op
        return tuple(_grouped_allreduce_nograd(list(tensors), op, name))

    @staticmethod
    def backward(ctx, *grads):
        gs = _grouped_allreduce_nograd(list(grads), ctx.op, None)
        return (None, None, *gs)


def grouped_allreduce(tensors: List[_torch.Tensor], op: int = Average,
                      name: Optional[str] = None) -> List[_torch.Tensor]:
    """Allreduce a group together (its members fuse into one collective,
    or negotiate together under a controller); differentiable."""
    return list(_GroupedAllreduceFn.apply(op, name, *tensors))


def grouped_allreduce_(tensors: List[_torch.Tensor], op: int = Average,
                       name: Optional[str] = None) -> List[_torch.Tensor]:
    outs = _grouped_allreduce_nograd(tensors, op, name)
    with _torch.no_grad():
        for t, o in zip(tensors, outs):
            t.copy_(o)
    return tensors


def broadcast_parameters(params, root_rank: int = 0):
    """In-place broadcast of a state_dict or a named_parameters iterable
    (reference torch/functions.py broadcast_parameters)."""
    if isinstance(params, dict):
        items = sorted(params.items())
    else:
        items = list(params)
    for name, p in items:
        if _torch.is_tensor(p):
            broadcast_(p.data, root_rank=root_rank,
                       name="bcast.param." + name)


def broadcast_optimizer_state(optimizer: _torch.optim.Optimizer,
                              root_rank: int = 0):
    """Give every rank the root's optimizer hyperparameters and state: the
    layout and scalars pickled, the tensors broadcast in place, so a rank
    whose optimizer has no state yet takes the root's (reference
    torch/functions.py broadcast_optimizer_state)."""
    elastic._sync_optimizer(optimizer, root_rank)


class _Wrapper(_torch.optim.Optimizer):
    """What both wrappers share: the inner optimizer's surface, and a
    unique name for each parameter, ``named_parameters``' where given,
    else ``param.<group>.<index>``."""

    def __init__(self, optimizer, named_parameters=None):
        self._opt = optimizer
        self._names = {p: f"param.{i}.{j}"
                       for i, group in enumerate(optimizer.param_groups)
                       for j, p in enumerate(group["params"])}
        if named_parameters is not None:
            named = list(named_parameters)
            names = [n for n, _ in named]
            dups = {n for n in names if names.count(n) > 1}
            if dups:
                raise ValueError(f"duplicate parameter names: {dups}")
            self._names.update({p: n for n, p in named})

    def __getattr__(self, item):
        opt = self.__dict__.get("_opt")
        if opt is None:
            raise AttributeError(item)
        return getattr(opt, item)

    @property
    def param_groups(self):
        return self._opt.param_groups

    @property
    def state(self):
        return self._opt.state

    def state_dict(self, *args, **kwargs):
        return self._opt.state_dict(*args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        return self._opt.load_state_dict(*args, **kwargs)


class _DistributedOptimizer(_Wrapper):
    """Wraps a torch optimizer: a hook on each parameter fires its
    gradient's asynchronous allreduce as soon as backward has accumulated
    it; ``step()`` synchronizes, then delegates (reference
    torch/optimizer.py:128-325)."""

    def __init__(self, optimizer, named_parameters=None, op=Average,
                 compression=None, backward_passes_per_step=1,
                 prescale_factor=1.0, postscale_factor=1.0,
                 sparse_as_dense=False):
        super().__init__(optimizer, named_parameters)
        self.op = op
        self._compression = compression or Compression.none
        self._bpps = backward_passes_per_step
        self._prescale = prescale_factor
        self._postscale = postscale_factor
        self._sparse_as_dense = sparse_as_dense
        # param -> (handle | None | "sparse", wire-dtype grad, compression
        # ctx) as _allreduce_grad_async stores it.
        self._handles: Dict[_torch.nn.Parameter, Tuple[Any, Any, Any]] = {}
        self._hooks = []
        self._pass_counts: Dict[_torch.nn.Parameter, int] = {}
        self._synchronized = False
        self._should_synchronize = True
        self._register_hooks()

    def _register_hooks(self):
        for group in self._opt.param_groups:
            for p in group["params"]:
                if not p.requires_grad:
                    continue
                self._pass_counts[p] = 0
                self._hooks.append(
                    p.register_post_accumulate_grad_hook(self._hook))

    def _hook(self, p):
        if p in self._handles:
            raise AssertionError(
                "gradient reduced twice before step(); likely a double "
                "backward without backward_passes_per_step")
        self._pass_counts[p] += 1
        if self._pass_counts[p] == self._bpps:
            self._pass_counts[p] = 0
            self._handles[p] = self._allreduce_grad_async(p)

    def _trivial(self, scale: float) -> bool:
        """A world of one averaging with unit factors and no controller:
        the allreduce is the identity, and the reference skips it."""
        return (global_state.controller is None and global_state.size == 1
                and self.op == Average and self._prescale * scale == 1.0
                and self._postscale == 1.0)

    def _allreduce_grad_async(self, p):
        """Fire the allreduce of ``p.grad`` (on the stream that produced
        it).  Compression casts the payload to its wire dtype first;
        synchronize() decompresses into ``p.grad``.  Sparse gradients
        densify under ``sparse_as_dense`` or take the allgather path."""
        name = "grad." + self._names[p]
        scale = 1.0 / self._bpps if self._bpps > 1 else 1.0
        if p.grad.is_sparse:
            if self._sparse_as_dense:
                p.grad = p.grad.to_dense()
            else:
                # Scalar factors commute with the sparse sum.
                eff = self._prescale * scale * self._postscale
                t = p.grad.coalesce()
                if (global_state.controller is None
                        and global_state.size == 1
                        and self.op == Average and eff == 1.0):
                    return ("sparse", ("trivial", t, eff), None)
                return ("sparse", ("async", _sparse_submit(t, name), eff),
                        None)
        _check_device(p.grad)
        compressed, ctx = self._compression.compress(p.grad)
        if self._trivial(scale):
            return (None, compressed, ctx)
        h = _C.allreduce_async(compressed, op=self.op, name=name,
                               prescale_factor=self._prescale * scale,
                               postscale_factor=self._postscale)
        return (h, compressed, ctx)

    def synchronize(self):
        for p, (h, compressed, ctx) in list(self._handles.items()):
            if h == "sparse":
                kind, payload, eff = compressed
                out = payload if kind == "trivial" \
                    else _sparse_finish(payload, self.op)
                if eff != 1.0:
                    out = out * eff
                p.grad = out
                continue
            if h is not None:
                reduced = _C.synchronize(h)
                if reduced.is_cuda:
                    # Allocated on the hook's stream: keep its memory
                    # until this stream has read it.
                    reduced.record_stream(_torch.cuda.current_stream(
                        reduced.device))
                compressed = reduced
            if compressed is not p.grad:
                with _torch.no_grad():
                    p.grad.copy_(self._compression.decompress(compressed,
                                                              ctx))
        self._handles.clear()
        self._synchronized = True

    @_contextmanager
    def skip_synchronize(self):
        """Make the next step() skip synchronization — for the
        synchronize-then-clip-then-step pattern:

            optimizer.synchronize()
            torch.nn.utils.clip_grad_norm_(model.parameters(), 1.0)
            with optimizer.skip_synchronize():
                optimizer.step()
        """
        self._should_synchronize = False
        try:
            yield
        finally:
            self._should_synchronize = True

    def step(self, closure=None):
        if self._should_synchronize:
            if self._synchronized:
                warnings.warn(
                    "optimizer.step() called without skip_synchronize() "
                    "after optimizer.synchronize(); gradients are reduced "
                    "twice — wrap step() in optimizer.skip_synchronize()")
            self.synchronize()
        self._synchronized = False
        return self._opt.step(closure)

    def zero_grad(self, *args, **kwargs):
        if self._handles:
            raise AssertionError(
                "zero_grad() called with allreduce handles in flight; call "
                "step() or synchronize() first")
        return self._opt.zero_grad(*args, **kwargs)


class _DistributedAdasumOptimizer(_Wrapper):
    """Adasum's delta model (reference torch/optimizer.py:335-503):
    stateful optimizers emit updates that are not gradients, so each
    step() runs the local step, then moves every parameter from where it
    started by the Adasum of the ranks' deltas.  The deltas travel fp32
    or fp64."""

    def _ensure_names(self):
        """Parameters added after construction get positional names, the
        same on every rank."""
        for i, group in enumerate(self._opt.param_groups):
            for j, p in enumerate(group["params"]):
                self._names.setdefault(p, f"param.{i}.{j}")

    def step(self, closure=None):
        self._ensure_names()
        # Every parameter, not only those with gradients: a closure may
        # compute them inside the step, and every rank reduces the same
        # set of deltas.
        params = [p for group in self._opt.param_groups
                  for p in group["params"]]
        starts = {p: p.data.clone() for p in params}
        result = self._opt.step(closure)
        pending = []
        for p in params:
            delta = p.data - starts[p]
            if delta.dtype not in (_torch.float32, _torch.float64):
                delta = delta.float()
            _check_device(delta)
            pending.append((p, _C.allreduce_async(
                delta, op=Adasum, name="adasum.delta." + self._names[p])))
        for p, h in pending:
            p.data.copy_(starts[p] + _C.synchronize(h).to(p.dtype))
        return result

    def synchronize(self):
        """Deltas are reduced inside step(): nothing is in flight between
        steps."""

    def zero_grad(self, *args, **kwargs):
        return self._opt.zero_grad(*args, **kwargs)


def DistributedOptimizer(optimizer, named_parameters=None, op=Average,
                         compression=None, backward_passes_per_step=1,
                         prescale_factor=1.0, postscale_factor=1.0,
                         gradient_predivide_factor=1.0,
                         sparse_as_dense=False):
    if gradient_predivide_factor != 1.0:
        # The averaging division split around the wire sum: gradients
        # scale by 1/f before the sum and by f/size after it.
        if op != Average:
            raise ValueError(
                "gradient_predivide_factor requires op=Average")
        if prescale_factor != 1.0 or postscale_factor != 1.0:
            raise ValueError("gradient_predivide_factor and explicit "
                             "prescale/postscale factors are exclusive")
        if not is_initialized():
            from ..core.exceptions import NotInitializedError
            raise NotInitializedError()
        op = Sum
        prescale_factor = 1.0 / gradient_predivide_factor
        postscale_factor = gradient_predivide_factor / \
            _C.communicator_size()
    if op == Adasum:
        if backward_passes_per_step != 1:
            raise ValueError(
                "Adasum does not compose with backward_passes_per_step > 1 "
                "(reference restriction)")
        if compression is not None and compression is not Compression.none:
            raise ValueError(
                "Adasum requires fp32/fp64 deltas; wire compression is "
                "not supported")
        if prescale_factor != 1.0 or postscale_factor != 1.0:
            raise ValueError(
                "prescale/postscale factors are not supported with Adasum "
                "(deltas are combined, not summed)")
        return _DistributedAdasumOptimizer(
            optimizer, named_parameters=named_parameters)
    return _DistributedOptimizer(
        optimizer, named_parameters=named_parameters, op=op,
        compression=compression,
        backward_passes_per_step=backward_passes_per_step,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        sparse_as_dense=sparse_as_dense)
