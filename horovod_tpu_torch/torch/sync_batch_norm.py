"""Synchronized batch normalization for the torch front end (port of
horovod_tpu/torch/sync_batch_norm.py).

The moments span every rank's batch: the forward allreduces the local
sums, sums of squares and counts (fp64, on the input's device), and the
backward allreduces the gradient statistics, so ``grad_input`` is what
one process would compute over the concatenated batch.  The functional
form with the moments averaged and running statistics returned is
``ops.sync_batch_norm``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.autograd.function import Function

from ..ops import collective as _C
from ..ops.collective import Sum


def _allreduce_sum(stats: torch.Tensor, name: str) -> torch.Tensor:
    return _C.allreduce(stats, op=Sum, name=name)


class _SyncBatchNormFn(Function):
    @staticmethod
    def forward(ctx, input, weight, bias, running_mean, running_var,
                eps, momentum, track_running_stats, name):
        c = input.shape[1]
        x = input.transpose(0, 1).reshape(c, -1)          # (C, N*spatial)
        local_count = x.shape[1]
        s = x.sum(dim=1)
        ssum = (x * x).sum(dim=1)

        stats = torch.cat([
            s.detach().double(), ssum.detach().double(),
            torch.tensor([float(local_count)], dtype=torch.float64,
                         device=input.device)])
        stats = _allreduce_sum(stats, name + ".fwd")
        count = float(stats[-1])
        mean = (stats[:c] / count).to(input.dtype)
        var = (stats[c:2 * c] / count).to(input.dtype) - mean * mean
        invstd = torch.rsqrt(var + eps)

        if track_running_stats and running_mean is not None:
            unbiased = var * count / max(count - 1.0, 1.0)
            running_mean.mul_(1 - momentum).add_(mean, alpha=momentum)
            running_var.mul_(1 - momentum).add_(unbiased, alpha=momentum)

        shape = [1, c] + [1] * (input.dim() - 2)
        xhat = (input - mean.view(shape)) * invstd.view(shape)
        out = xhat
        if weight is not None:
            out = out * weight.view(shape)
        if bias is not None:
            out = out + bias.view(shape)

        ctx.save_for_backward(input, weight, mean, invstd)
        ctx.count = count
        ctx.name = name
        ctx.has_bias = bias is not None
        return out

    @staticmethod
    def backward(ctx, grad_output):
        input, weight, mean, invstd = ctx.saved_tensors
        c = input.shape[1]
        shape = [1, c] + [1] * (input.dim() - 2)
        xhat = (input - mean.view(shape)) * invstd.view(shape)

        reduce_dims = [0] + list(range(2, input.dim()))
        sum_dy = grad_output.sum(dim=reduce_dims)
        sum_dy_xhat = (grad_output * xhat).sum(dim=reduce_dims)

        grad_weight = sum_dy_xhat if weight is not None else None
        grad_bias = sum_dy.clone() if ctx.has_bias else None

        stats = torch.cat([sum_dy.detach().double(),
                           sum_dy_xhat.detach().double()])
        stats = _allreduce_sum(stats, ctx.name + ".bwd")
        g_dy = stats[:c].to(input.dtype)
        g_dy_xhat = stats[c:].to(input.dtype)

        w = weight.view(shape) if weight is not None else 1.0
        n = ctx.count
        grad_input = (grad_output
                      - g_dy.view(shape) / n
                      - xhat * g_dy_xhat.view(shape) / n) \
            * invstd.view(shape) * w
        return (grad_input, grad_weight, grad_bias,
                None, None, None, None, None, None)


class SyncBatchNorm(nn.modules.batchnorm._BatchNorm):
    """Drop-in BatchNorm whose statistics span all ranks (reference
    torch/sync_batch_norm.py SyncBatchNorm).  In a world of one, and in
    eval mode, it is ``nn.BatchNorm``'s own forward."""

    _instances = 0

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._name = f"syncbn.{SyncBatchNorm._instances}"
        SyncBatchNorm._instances += 1

    def _check_input_dim(self, input):
        if input.dim() < 2:
            raise ValueError(
                f"expected at least 2D input (got {input.dim()}D)")

    def forward(self, input):
        self._check_input_dim(input)
        if not self.training or _C.communicator_size() == 1:
            return super().forward(input)
        if self.momentum is None:
            exponential_average_factor = 0.0
        else:
            exponential_average_factor = self.momentum
        return _SyncBatchNormFn.apply(
            input, self.weight, self.bias, self.running_mean,
            self.running_var, self.eps, exponential_average_factor,
            self.track_running_stats, self._name)
