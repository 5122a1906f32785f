"""Tensor (model) parallel building blocks: Megatron-style column/row
parallel projections over a mesh axis (port of
horovod_tpu/parallel/tensor_parallel.py).

* column-parallel: ``Y_shard = X @ W[:, shard]``, no communication; the
  activation comes out feature-sharded.
* row-parallel: ``Y = psum_over_axis(X_shard @ W[shard, :])``, one
  all-reduce (or a reduce-scatter over the sequence when the consumer is
  sequence-sharded: the Megatron-SP fusion).

``axis_name`` is a dimension of the runtime's ``mesh()``, a process
group, or None (the world), as for ``ring_attention``; on an axis of one
member every function is its local math.

The collectives are autograd Functions whose backward is the transpose
the reference's differentiation outside ``shard_map`` gives them:
all-gather and reduce-scatter transpose to each other, and an all-reduce
(psum) transposes to an all-reduce.  The last is not Megatron's identity
backward: every member's cotangent is its own, and the psum sums them.
"""

from __future__ import annotations

from typing import Optional

import torch

from .ring_attention import _group_of


def _size(group) -> int:
    import torch.distributed as dist
    return dist.get_world_size(group)


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The members' ``x`` concatenated along ``dim``, in member order."""
    import torch.distributed as dist
    rows = x.movedim(dim, 0).contiguous()
    out = rows.new_empty((_size(group) * rows.shape[0],) + rows.shape[1:])
    dist.all_gather_into_tensor(out, rows, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over the members of ``x``, this member's chunk along
    ``dim``."""
    import torch.distributed as dist
    rows = x.movedim(dim, 0).contiguous()
    out = rows.new_empty((rows.shape[0] // _size(group),) + rows.shape[1:])
    dist.reduce_scatter_tensor(out, rows, group=group)
    return out.movedim(0, dim)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


def psum(x: torch.Tensor, axis_name) -> torch.Tensor:
    """The sum of ``x`` over the axis; its backward sums the cotangents."""
    group = _group_of(axis_name)
    return x if _size(group) == 1 else _AllReduce.apply(x, group)


def column_parallel(x: torch.Tensor, w_shard: torch.Tensor,
                    b_shard: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., d_in) @ (d_in, d_out/P) -> (..., d_out/P); no communication."""
    y = x @ w_shard
    if b_shard is not None:
        y = y + b_shard
    return y


def row_parallel(x_shard: torch.Tensor, w_shard: torch.Tensor, axis_name,
                 b: Optional[torch.Tensor] = None,
                 scatter_sequence: bool = False) -> torch.Tensor:
    """(..., d_in/P) @ (d_in/P, d_out) -> psum -> (..., d_out).

    With ``scatter_sequence=True`` the psum becomes a reduce-scatter over
    the sequence dimension (dim -2), returning a sequence-sharded
    activation."""
    partial = x_shard @ w_shard
    group = _group_of(axis_name)
    if _size(group) == 1:
        y = partial
    elif scatter_sequence:
        y = _ReduceScatter.apply(partial, group, partial.ndim - 2)
    else:
        y = _AllReduce.apply(partial, group)
    if b is not None:
        y = y + b
    return y


def gather_sequence(x: torch.Tensor, axis_name, dim: int = 1
                    ) -> torch.Tensor:
    """All-gather a sequence-sharded activation back to full length along
    ``dim`` (entry into a tensor-parallel region)."""
    group = _group_of(axis_name)
    if _size(group) == 1:
        return x
    return _AllGather.apply(x, group, dim % x.ndim)


def vocab_parallel_logits(x: torch.Tensor, embed_shard: torch.Tensor,
                          axis_name) -> torch.Tensor:
    """Logits against a vocab-sharded embedding: each member holds
    vocab/P rows; the logits stay sharded on the vocab dim."""
    del axis_name
    return x @ embed_shard.t()


def vocab_parallel_cross_entropy(logits_shard: torch.Tensor,
                                 labels: torch.Tensor, vocab_shard_size: int,
                                 axis_name) -> torch.Tensor:
    """Cross entropy over vocab-sharded logits without gathering the full
    vocab: a max and two psums plus a masked label pick.

    The global max only shifts the logits, and the loss does not depend
    on the shift, so it is taken without a gradient (its exact one is
    zero)."""
    import torch.distributed as dist
    group = _group_of(axis_name)
    one = _size(group) == 1
    lo = (0 if one else dist.get_rank(group)) * vocab_shard_size
    lf = logits_shard.float()
    global_max = lf.detach().amax(-1)
    if not one:
        dist.all_reduce(global_max, op=dist.ReduceOp.MAX, group=group)
    shifted = lf - global_max[..., None]
    sum_exp = psum(shifted.exp().sum(-1), group)
    local_label = labels - lo
    in_shard = (local_label >= 0) & (local_label < vocab_shard_size)
    safe = local_label.clamp(0, vocab_shard_size - 1)
    picked = shifted.gather(-1, safe[..., None])[..., 0]
    label_logit = psum(torch.where(in_shard, picked, 0.0), group)
    return sum_exp.log() - label_logit
