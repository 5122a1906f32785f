"""Cross-replica synchronized batch normalization (port of
horovod_tpu/ops/sync_batch_norm.py).

The batch moments are averaged over the data-parallel ranks, so small
per-rank batches normalize as one global batch (reference
SyncBatchNormalization).  The average is a ``torch.autograd.Function``
whose backward averages the moments' cotangents over the same ranks, as
JAX's transpose of ``pmean`` does: gradients flow through the other ranks'
batches as they do in the reference.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from ..core.state import global_state
from . import collective as C
from . import quantization as Q


class _PMean(torch.autograd.Function):
    """Mean over the world; its backward is the same mean of the
    cotangent."""

    @staticmethod
    def _mean(x: torch.Tensor) -> torch.Tensor:
        x = x.clone()
        dist.all_reduce(x)
        return Q._div(x, global_state.size)

    @staticmethod
    def forward(ctx, x):
        return _PMean._mean(x)

    @staticmethod
    def backward(ctx, ct):
        return _PMean._mean(ct)


def sync_batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    running_mean: torch.Tensor, running_var: torch.Tensor,
                    axis_name="data", training: bool = True,
                    momentum: float = 0.9, eps: float = 1e-5
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Normalize ``x`` over all dims but the last, with the moments
    averaged across the data-parallel ranks.

    ``axis_name`` is the reference's: ``"data"`` (the default, the
    reference's data-parallel axis) or ``("local", "cross")`` average the
    moments over the world; ``None`` keeps each rank's own.  The moments
    are fp32; so is the normalization, cast back to ``x``'s dtype.

    Returns ``(normalized, new_running_mean, new_running_var)``, the
    running statistics detached.
    """
    if axis_name is not None and axis_name != "data":
        C._check_axis(axis_name)
    xf = x.float()
    dims = tuple(range(x.dim() - 1))
    if training:
        mean = xf.mean(dim=dims)
        mean_sq = (xf * xf).mean(dim=dims)
        if axis_name is not None and global_state.size > 1:
            mean, mean_sq = _PMean.apply(torch.stack([mean, mean_sq]))
        var = mean_sq - mean * mean
        new_mean = momentum * running_mean + (1 - momentum) * mean.detach()
        new_var = momentum * running_var + (1 - momentum) * var.detach()
    else:
        mean, var = running_mean, running_var
        new_mean, new_var = running_mean, running_var
    inv = torch.rsqrt(var + eps)
    out = (xf - mean) * inv * scale + bias
    return out.to(x.dtype), new_mean, new_var
