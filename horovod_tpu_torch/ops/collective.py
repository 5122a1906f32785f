"""Synchronous collectives over ``torch.distributed`` (port of the
allreduce / grouped_allreduce / broadcast part of horovod_tpu/ops/collective.py).

Reduce-op codes match the reference C API (operations.cc:911-913).  The
result contract is the reference's: ``out.dtype == in.dtype``; integer
``Average`` stays in the integer domain (sum, then floor-divide by the
world size); fractional pre/postscale factors on integers go through
float32 with one trailing cast (collective.py:365-413).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.basics import _check_init
from ..core.state import global_state


class ReduceOp(int):
    pass


Average = ReduceOp(0)
Sum = ReduceOp(1)
Adasum = ReduceOp(2)
Min = ReduceOp(3)
Max = ReduceOp(4)
Product = ReduceOp(5)

_DIST_OPS = {Sum: dist.ReduceOp.SUM, Average: dist.ReduceOp.SUM,
             Min: dist.ReduceOp.MIN, Max: dist.ReduceOp.MAX,
             Product: dist.ReduceOp.PRODUCT}


def _check_supported(op: int, compression) -> None:
    if compression is not None:
        raise NotImplementedError(
            "wire compression is not ported yet (ROADMAP.md queue 1: "
            "compression and quantization)")
    if op == Adasum:
        raise NotImplementedError(
            "Adasum is not ported yet (ROADMAP.md queue 1: overlap, Adasum "
            "and ZeRO)")
    if op not in _DIST_OPS:
        raise ValueError(f"unknown reduce op {op}")


def allreduce_(tensor: torch.Tensor, op: int = Average,
               prescale_factor: float = 1.0,
               postscale_factor: float = 1.0) -> torch.Tensor:
    """In-place allreduce of ``tensor`` across the world; returns it."""
    _check_init()
    _check_supported(op, None)
    is_int = not (tensor.is_floating_point() or tensor.is_complex())
    scaled = prescale_factor != 1.0 or postscale_factor != 1.0
    x = tensor.float() if (is_int and scaled) else tensor
    if prescale_factor != 1.0:
        x.mul_(prescale_factor)
    dist.all_reduce(x, op=_DIST_OPS[op])
    if op == Average:
        if is_int and not scaled:
            x.div_(global_state.size, rounding_mode="floor")
        else:
            x.div_(global_state.size)
    if postscale_factor != 1.0:
        x.mul_(postscale_factor)
    if x is not tensor:
        tensor.copy_(x.trunc() if is_int else x)
    return tensor


def allreduce(tensor: torch.Tensor, op: int = Average,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              name: Optional[str] = None, compression=None) -> torch.Tensor:
    """Allreduce a tensor across the world; returns a new tensor.  ``name``
    is accepted for API parity with the reference."""
    del name
    _check_supported(op, compression)
    return allreduce_(tensor.clone(), op, prescale_factor, postscale_factor)


def grouped_allreduce(tensors: Sequence[torch.Tensor], op: int = Average,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      name: Optional[str] = None,
                      compression=None) -> List[torch.Tensor]:
    """Allreduce a group together: members of one dtype and device are
    fused into one flat buffer and reduced by one collective (the
    reference's fusion of a group, operations.cc:1041-1048)."""
    del name
    _check_supported(op, compression)
    tensors = list(tensors)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    buckets = {}
    for i, t in enumerate(tensors):
        buckets.setdefault((t.dtype, t.device), []).append(i)
    for idx in buckets.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        allreduce_(flat, op, prescale_factor, postscale_factor)
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out


def broadcast_(tensor: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    """In-place broadcast of the root's value; returns ``tensor``."""
    _check_init()
    dist.broadcast(tensor, src=root_rank)
    return tensor


def broadcast(tensor: torch.Tensor, root_rank: int = 0,
              name: Optional[str] = None) -> torch.Tensor:
    """Broadcast the root member's value to all members; returns a new
    tensor."""
    del name
    return broadcast_(tensor.clone(), root_rank)
