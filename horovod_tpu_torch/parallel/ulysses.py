"""Ulysses sequence parallelism: all-to-all head/sequence resharding (port
of horovod_tpu/parallel/ulysses.py).

1. q/k/v arrive sequence-sharded: (B, S/P, H, D);
2. one all-to-all of the stacked q/k/v trades the sequence shards for head
   shards: (B, S, H/P, D), every member seeing the whole sequence for its
   heads;
3. ``full_attention`` runs locally (the flash kernels on the card);
4. one all-to-all of the output restores the sequence sharding.

Two collectives a call, against the ring's P hops; needs heads % P == 0.
The all-to-alls are differentiable: an all-to-all's transpose is the
inverse exchange, which the backward runs.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import ring_attention as ra


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of the rows of ``x`` (dim 0 = the axis size:
    row p to member p, row s of the result from member s), whose backward
    sends the gradient's rows back the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x, group):
    import torch.distributed as dist
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _seq_to_head_sharded(x, group, sp):
    # (..., B, S/P, H, D) → (..., B, S, H/P, D); leading stack dims allowed.
    *lead, b, s, h, d = x.shape
    n = len(lead)
    rows = x.reshape(*lead, b, s, sp, h // sp, d).movedim(n + 2, 0)
    rows = _AllToAll.apply(rows, group)          # row s: member s's seq
    return rows.movedim(0, n + 1).reshape(*lead, b, sp * s, h // sp, d)


def _head_to_seq_sharded(x, group, sp):
    # (..., B, S, H/P, D) → (..., B, S/P, H, D)
    *lead, b, s, hp, d = x.shape
    n = len(lead)
    rows = x.reshape(*lead, b, sp, s // sp, hp, d).movedim(n + 1, 0)
    rows = _AllToAll.apply(rows, group)          # row s: member s's heads
    return rows.movedim(0, n + 2).reshape(*lead, b, s // sp, sp * hp, d)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name=None, causal: bool = True,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over a sequence-sharded axis via head resharding.

    q, k, v: this member's (B, S_local, H, D) shards; returns its
    (B, S_local, H, D) output shard.  ``axis_name`` is a dimension of the
    runtime's ``mesh()``, a process group, or None (the world).  Requires
    H divisible by the axis size."""
    import torch.distributed as dist
    group = ra._group_of(axis_name)
    sp = dist.get_world_size(group)
    h = q.shape[2]
    if h % sp != 0:
        raise ValueError(
            f"ulysses_attention needs heads ({h}) divisible by the "
            f"sequence-parallel degree ({sp}); use ring_attention for "
            "head counts that don't divide")
    if sp == 1:
        return ra.full_attention(q, k, v, causal=causal, scale=scale)
    # One all-to-all for q/k/v stacked, one for the output.
    qkv = _seq_to_head_sharded(torch.stack([q, k, v]), group, sp)
    oh = ra.full_attention(qkv[0], qkv[1], qkv[2], causal=causal,
                           scale=scale)
    return _head_to_seq_sharded(oh, group, sp)
