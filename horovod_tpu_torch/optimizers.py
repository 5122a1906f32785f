"""Distributed optimizer front-end (port of horovod_tpu/optimizers.py, the
synchronous data-parallel part).

* ``DistributedOptimizer`` wraps a ``torch.optim`` optimizer so that its
  ``step()`` first averages every gradient over the world, one collective
  per parameter in parameter order, then runs the inner step: the
  reference's per-leaf barrier schedule (``overlap=False``).  With
  ``backward_passes_per_step`` = N, N calls of ``step()`` accumulate the
  local gradients and only the Nth communicates and updates (reference
  ``_AggState``, optimizers.py:84-221).
* ``allreduce_gradients``, ``broadcast_parameters`` and
  ``broadcast_optimizer_state`` (reference optimizers.py:76, :665-694).
"""

from __future__ import annotations

from typing import Any, Iterable, List, Mapping, Optional

import torch

from .ops import collective as C


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


def allreduce_gradients(grads, op: int = C.Average, compression=None):
    """Allreduce a tensor, a sequence or a dict of gradients; returns the
    same structure reduced (the reference's pytree in, pytree out)."""
    if isinstance(grads, torch.Tensor):
        return C.allreduce(grads, op=op, compression=compression)
    if isinstance(grads, Mapping):
        return {k: allreduce_gradients(v, op, compression)
                for k, v in grads.items()}
    return type(grads)(allreduce_gradients(g, op, compression)
                       for g in grads)


class DistributedOptimizer:
    """Wrap ``optimizer`` for synchronous data-parallel training.

    Call ``step()`` after every backward pass and zero the gradients after
    it, as with the inner optimizer.  Attribute access other than ``step``
    goes to the inner optimizer (``param_groups``, ``state``,
    ``zero_grad``, ``state_dict``...).
    """

    def __init__(self, optimizer: torch.optim.Optimizer,
                 op: int = C.Average, compression=None,
                 backward_passes_per_step: int = 1,
                 prescale_factor: float = 1.0,
                 postscale_factor: float = 1.0,
                 average_aggregated_gradients: bool = True):
        C._check_supported(op, compression)
        if int(backward_passes_per_step) < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self.optimizer = optimizer
        self.op = op
        self.backward_passes_per_step = int(backward_passes_per_step)
        self.prescale_factor = prescale_factor
        self.postscale_factor = postscale_factor
        self.average_aggregated_gradients = average_aggregated_gradients
        self._passes = 0
        self._acc: Optional[List[Optional[torch.Tensor]]] = None

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
        """Average the gradients over the world, in place."""
        for p in self._params():
            if p.grad is not None:
                C.allreduce_(p.grad, self.op, self.prescale_factor,
                             self.postscale_factor)

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
