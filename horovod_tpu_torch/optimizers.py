"""Distributed optimizer front-end (port of horovod_tpu/optimizers.py, the
synchronous data-parallel part).

* ``DistributedOptimizer`` wraps a ``torch.optim`` optimizer so that its
  ``step()`` first averages every gradient over the world, one collective
  per parameter in parameter order, then runs the inner step: the
  reference's per-leaf barrier schedule (``overlap=False``).  With
  ``backward_passes_per_step`` = N, N calls of ``step()`` accumulate the
  local gradients and only the Nth communicates and updates (reference
  ``_AggState``, optimizers.py:84-221).  ``compression=`` puts the
  gradients on a compressed wire; a quantized wire carries an
  error-feedback residual, as the reference's ``_AggState.residual``.
* ``allreduce_gradients``, ``grad``/``value_and_grad``,
  ``broadcast_parameters``, ``broadcast_optimizer_state``,
  ``broadcast_object`` and ``allgather_object`` (reference
  optimizers.py:76, :617-734).
"""

from __future__ import annotations

import pickle
from typing import Any, Callable, List, Mapping, Optional

import torch

from .ops import collective as C
from .ops import quantization as Q
from .ops.compression import NoneCompressor

_OVERLAP_NOT_PORTED = ("overlap= is not ported yet (ROADMAP.md queue 1: "
                       "overlap, Adasum and ZeRO)")


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a state dict, a module, (name, tensor) pairs or a
    plain sequence, in order."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.state_dict().values())
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Mapping):
        return [t for v in tree.values() for t in _tensors(v)]
    out: List[torch.Tensor] = []
    for item in tree:
        if isinstance(item, tuple) and len(item) == 2 and \
                isinstance(item[0], str):
            item = item[1]
        out.extend(_tensors(item))
    return out


def _tree_map(fn: Callable, tree):
    """``fn`` over the tensors of a tensor, a sequence or a dict (nested),
    keeping the structure; anything else passes through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def _allreduce_tree(tree, op, compression, prescale_factor=1.0,
                    postscale_factor=1.0):
    """Allreduce every tensor of ``tree`` (reference optimizers.py:38-73).
    A compressible leaf goes through ``allreduce(compression=)`` (the
    two-pass schedule, fp32 accumulation); the others compress →
    allreduce → decompress.  The session compression knob does not reach
    here: the compressor is the caller's, or none."""
    comp = C._resolve_compression(compression, session_default=False) \
        or NoneCompressor

    def one(x):
        if comp is not NoneCompressor and C._compressible(x, op):
            return C.allreduce(x, op, None, prescale_factor,
                               postscale_factor, compression=comp)
        cx, ctx = comp.compress(x)
        red = C.allreduce(cx, op, None, prescale_factor, postscale_factor,
                          compression=NoneCompressor)
        return comp.decompress(red, ctx)

    return _tree_map(one, tree)


def allreduce_gradients(grads, op: int = C.Average, compression=None):
    """Allreduce a tensor, a sequence or a dict of gradients; returns the
    same structure reduced (the reference's pytree in, pytree out)."""
    return _allreduce_tree(grads, op, compression)


class DistributedOptimizer:
    """Wrap ``optimizer`` for synchronous data-parallel training.

    Call ``step()`` after every backward pass and zero the gradients after
    it, as with the inner optimizer.  Attribute access other than
    ``step``, ``synchronize``, ``state_dict`` and ``load_state_dict`` goes
    to the inner optimizer (``param_groups``, ``state``, ``zero_grad``...).

    ``compression`` (``Compression.{fp16,bf16,int8,int4}`` or a name) is
    taken only from the caller; the ``HVD_TPU_COMPRESSION`` session default
    does not reach the optimizer.  With a quantized wire and Sum/Average,
    each parameter carries an fp32 error-feedback residual r: the step
    communicates g + r and keeps r = (g + r) − Q(g + r), Q the quantizer
    on the flat grid that starts at element 0 (``residual``).  With
    ``backward_passes_per_step`` > 1 the feedback applies on the step that
    communicates, after the 1/N scaling.  ``state_dict()`` carries the
    residual under ``"hvd_residual"`` beside the inner optimizer's state.
    """

    def __init__(self, optimizer: torch.optim.Optimizer,
                 op: int = C.Average, compression=None,
                 backward_passes_per_step: int = 1,
                 prescale_factor: float = 1.0,
                 postscale_factor: float = 1.0,
                 average_aggregated_gradients: bool = True):
        C._check_op(op)
        if int(backward_passes_per_step) < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self.optimizer = optimizer
        self.op = op
        self.compression = C._resolve_compression(compression,
                                                  session_default=False)
        self.backward_passes_per_step = int(backward_passes_per_step)
        self.prescale_factor = prescale_factor
        self.postscale_factor = postscale_factor
        self.average_aggregated_gradients = average_aggregated_gradients
        self._passes = 0
        self._acc: Optional[List[Optional[torch.Tensor]]] = None
        # Error feedback pairs with lossy quantized wires on a reduced
        # gradient; cast wires round-trip through fp32 accumulation.
        self._quant_spec = None
        self.residual: Optional[List[torch.Tensor]] = None
        if getattr(self.compression, "bits", None) is not None and \
                op in (C.Average, C.Sum):
            self._quant_spec = self.compression.spec()
            self.residual = [torch.zeros_like(p, dtype=torch.float32)
                             for p in self._params()]

    def __getattr__(self, name: str) -> Any:
        return getattr(self.__dict__["optimizer"], name)

    def _params(self) -> List[torch.nn.Parameter]:
        return [p for group in self.optimizer.param_groups
                for p in group["params"]]

    def _accumulate(self, params) -> None:
        if self._acc is None:
            self._acc = [None] * len(params)
        for i, p in enumerate(params):
            if p.grad is None:
                continue
            if self._acc[i] is None:
                self._acc[i] = p.grad.detach().clone()
            else:
                self._acc[i].add_(p.grad)

    def synchronize(self) -> None:
        """Reduce the gradients over the world, in place (with error
        feedback on a quantized wire)."""
        for i, p in enumerate(self._params()):
            if p.grad is None:
                continue
            if self.compression is None:
                C.allreduce_(p.grad, self.op, self.prescale_factor,
                             self.postscale_factor,
                             compression=NoneCompressor)
                continue
            g = p.grad
            if self._quant_spec is not None:
                r = self.residual[i]
                fed = g + r.to(g.dtype)
                if self.prescale_factor == 1.0:
                    # The first pass quantizes fed itself: what it sent is
                    # qdq(fed), so the residual needs no quantizer of its
                    # own.
                    red, sent = Q.compressed_allreduce(
                        fed, None, self.op, spec=self._quant_spec,
                        postscale=self.postscale_factor, return_sent=True)
                    r.copy_(fed.to(torch.float32) - sent.view_as(r))
                    p.grad.copy_(red)
                    continue
                f32 = fed.to(torch.float32)
                r.copy_(f32 - Q.qdq(f32, self._quant_spec))
                g = fed
            p.grad.copy_(_allreduce_tree(
                g, self.op, self.compression, self.prescale_factor,
                self.postscale_factor))

    def step(self, closure=None):
        bpps = self.backward_passes_per_step
        if bpps > 1:
            params = self._params()
            self._accumulate(params)
            self._passes += 1
            if self._passes < bpps:
                return None  # a skipped step leaves the parameters as they are
            scale = 1.0 / bpps if self.average_aggregated_gradients else 1.0
            for p, acc in zip(params, self._acc):
                if acc is not None:
                    p.grad = acc.mul_(scale)
            self._passes, self._acc = 0, None
        self.synchronize()
        return self.optimizer.step(closure)

    def state_dict(self) -> dict:
        """The inner optimizer's state dict, plus the error-feedback
        residual (one fp32 tensor per parameter) when there is one."""
        sd = self.optimizer.state_dict()
        if self.residual is not None:
            sd["hvd_residual"] = [r.clone() for r in self.residual]
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        """Restore a ``state_dict()``: the residual into this optimizer's,
        the rest into the inner optimizer unchanged."""
        state_dict = dict(state_dict)
        residual = state_dict.pop("hvd_residual", None)
        if residual is not None and self.residual is not None:
            if len(residual) != len(self.residual):
                raise ValueError(
                    f"state dict holds {len(residual)} residuals for "
                    f"{len(self.residual)} parameters")
            for r, saved in zip(self.residual, residual):
                r.copy_(saved)
        self.optimizer.load_state_dict(state_dict)


# ---------------------------------------------------------------------------
# Gradient-tape analog: functional transforms (reference :617-658)
# ---------------------------------------------------------------------------

def _grad_fn(fun: Callable, op, compression, argnums: int,
             overlap) -> Callable:
    if overlap:
        raise NotImplementedError(_OVERLAP_NOT_PORTED)

    def value_and_grads(*args, **kwargs):
        args = list(args)
        leaves: List[torch.Tensor] = []

        def leaf(t):
            t = t.detach().requires_grad_(True)
            leaves.append(t)
            return t

        args[argnums] = _tree_map(leaf, args[argnums])
        with torch.enable_grad():
            value = fun(*args, **kwargs)
            grads = iter(torch.autograd.grad(value, leaves))
        tree = _tree_map(lambda _: next(grads), args[argnums])
        return value.detach(), _allreduce_tree(tree, op, compression)
    return value_and_grads


def grad(fun: Callable, op: int = C.Average, compression=None,
         argnums: int = 0, overlap=None) -> Callable:
    """``fun``'s gradient with respect to ``args[argnums]`` (a tensor, a
    sequence or a dict of tensors), allreduced — the functional
    ``DistributedGradientTape``.  ``fun`` returns a scalar tensor."""
    vg = _grad_fn(fun, op, compression, argnums, overlap)
    return lambda *args, **kwargs: vg(*args, **kwargs)[1]


def value_and_grad(fun: Callable, op: int = C.Average, compression=None,
                   argnums: int = 0, overlap=None) -> Callable:
    """As :func:`grad`, returning ``(value, grads)``; the value is this
    rank's, detached."""
    return _grad_fn(fun, op, compression, argnums, overlap)


# ---------------------------------------------------------------------------
# Parameter / object broadcast (reference functions.py)
# ---------------------------------------------------------------------------

def broadcast_parameters(params, root_rank: int = 0):
    """Overwrite parameters in place with the root's values.  ``params`` is
    a module, a state dict, (name, tensor) pairs or a sequence of tensors;
    it is returned."""
    with torch.no_grad():
        for t in _tensors(params):
            C.broadcast_(t, root_rank)
    return params


def broadcast_optimizer_state(optimizer, root_rank: int = 0):
    """Overwrite the tensors of an optimizer's state in place with the
    root's (every rank must hold the same state structure — call it before
    the first step or after one).  Tensors that live off the communicator's
    device (AdamW's ``step`` counts on the CPU) travel through it."""
    from .core.state import global_state
    opt = getattr(optimizer, "optimizer", optimizer)
    dev = global_state.device
    with torch.no_grad():
        for p in [p for g in opt.param_groups for p in g["params"]]:
            st = opt.state.get(p, {})
            for key in sorted(st):
                val = st[key]
                if not isinstance(val, torch.Tensor):
                    continue
                if val.device == dev:
                    C.broadcast_(val, root_rank)
                else:
                    val.copy_(C.broadcast_(val.to(dev), root_rank))
    return optimizer


def _world() -> int:
    from .core.basics import size
    return size()


def _bytes_tensor(payload: bytes) -> torch.Tensor:
    from .core.basics import device
    return torch.frombuffer(bytearray(payload), dtype=torch.uint8).to(
        device())


def broadcast_object(obj: Any, root_rank: int = 0,
                     name: Optional[str] = None):
    """Pickle-based object broadcast (reference functions.py
    broadcast_object): the length first, then the payload, both as uint8
    tensors on the communicator's device.  Unpickles what the root sent,
    so every rank must trust the root."""
    del name
    if _world() == 1:
        return obj
    from .core.basics import device, rank
    if rank() == root_rank:
        buf = _bytes_tensor(pickle.dumps(obj))
        length = torch.tensor([buf.numel()], dtype=torch.int64,
                              device=device())
    else:
        buf = None
        length = torch.zeros(1, dtype=torch.int64, device=device())
    C.broadcast_(length, root_rank)
    if buf is None:
        buf = torch.empty(int(length.item()), dtype=torch.uint8,
                          device=device())
    C.broadcast_(buf, root_rank)
    return pickle.loads(buf.cpu().numpy().tobytes())


def allgather_object(obj: Any, name: Optional[str] = None) -> list:
    """Gather a picklable object from every member into a list, in rank
    order."""
    del name
    if _world() == 1:
        return [obj]
    payload = _bytes_tensor(pickle.dumps(obj))
    sizes = C.allgather(torch.tensor([payload.numel()], dtype=torch.int64,
                                     device=payload.device)).tolist()
    gathered = C.allgather(payload).cpu().numpy()
    out, off = [], 0
    for s in sizes:
        out.append(pickle.loads(gathered[off: off + s].tobytes()))
        off += s
    return out
