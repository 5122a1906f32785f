"""Adasum adaptive summation (port of horovod_tpu/ops/adasum.py).

Two contributions combine as

    acoeff = 1 - dot / (2 ||a||^2),  bcoeff = 1 - dot / (2 ||b||^2)
    result = acoeff * a + bcoeff * b

so that nearly parallel gradients average and orthogonal ones add.  A
zero norm gives its coefficient 1.0 (a plain sum).  The math is fp32
whatever the input dtype; the result has the input's dtype.

``adasum_allreduce`` is the reference's vector-halving distance-doubling
(VHDD) ladder over ``torch.distributed``: at each level a member keeps half
of its segment, swaps the other half with partner ``index ^ d`` through
``dist.batch_isend_irecv``, and combines with coefficients of the
full vectors.  The (dot, ||a||^2, ||b||^2) partials of a level are summed
over the 2d members that hold pieces of the two vectors.  The reference
sums them with a grouped ``psum``; the port gathers every rank's three
partials over the world (``all_gather_into_tensor``, 12 bytes a rank) and
each rank sums its group's rows in rank order, so no subgroup is made per
level and every member of a group derives the same coefficients, bit for
bit.  After log2(P) levels a member holds 1/P of the result at the
bit-reversed position of its index; one all-gather reassembles it.  A
group whose size is not a power of two gathers the whole tensors and runs
``adasum_tree``, as the reference does.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.state import global_state
from . import quantization as Q


def _coefficients(dot, na, nb):
    one = torch.ones_like(dot)
    acoeff = torch.where(na > 0, 1.0 - dot / (2.0 * torch.where(na > 0, na,
                                                                one)), one)
    bcoeff = torch.where(nb > 0, 1.0 - dot / (2.0 * torch.where(nb > 0, nb,
                                                                one)), one)
    return acoeff, bcoeff


def adasum_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Combine two contributions with Adasum's coefficients (reference
    adasum.py:32)."""
    af, bf = a.float(), b.float()
    fa, fb = af.reshape(-1), bf.reshape(-1)
    acoeff, bcoeff = _coefficients(torch.dot(fa, fb), torch.dot(fa, fa),
                                   torch.dot(fb, fb))
    return (acoeff * af + bcoeff * bf).to(a.dtype)


def adasum_tree(stack: torch.Tensor) -> torch.Tensor:
    """Reduce a stacked (n, ...) tensor of contributions by Adasum's binary
    tree: pairs of neighbours first, then pairs of pairs; an odd one out
    rides up a level unpaired (reference adasum.py:46)."""
    items = list(stack.unbind(0))
    while len(items) > 1:
        nxt = [adasum_pair(items[i], items[i + 1])
               for i in range(0, len(items) - 1, 2)]
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0]


def _bit_reverse(i: int, bits: int) -> int:
    r = 0
    for b in range(bits):
        r = (r << 1) | ((i >> b) & 1)
    return r


def _exchange(send: torch.Tensor, peer: int) -> torch.Tensor:
    """Swap ``send`` with world rank ``peer``; returns what the peer
    sent."""
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, peer),
           dist.P2POp(dist.irecv, recv, peer)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv


def _vhdd(x: torch.Tensor, group, index: int, world_rank: Callable[[int],
          int], sharers: Callable[[int], List[int]]) -> torch.Tensor:
    """The VHDD ladder on flat fp32 ``x`` over ``group`` (of a power-of-two
    size P), whose member ``m`` is world rank ``world_rank(m)`` and this
    rank member ``index``; ``x`` is zero-padded to a multiple of P and the
    result cut back.  The partials of member ``m`` fold in those of the
    world ranks ``sharers(m)``, which hold the other fragments of the same
    vectors (the reference's ``shard_axis``)."""
    P = Q._size(group)
    levels = P.bit_length() - 1
    world = global_state.size
    n = x.numel()
    x = F.pad(x, (0, (-n) % P))
    for level in range(levels):
        d = 1 << level
        half = x.numel() // 2
        low = not (index >> level) & 1
        keep, send = (x[:half], x[half:]) if low else (x[half:], x[:half])
        recv = _exchange(send.contiguous(), world_rank(index ^ d))
        a, b = (keep, recv) if low else (recv, keep)
        partials = torch.stack([torch.dot(a, b), torch.dot(a, a),
                                torch.dot(b, b)])
        table = partials
        if world > 1:
            table = partials.new_empty(world * 3)
            dist.all_gather_into_tensor(table, partials)
        table = table.view(world, 3)
        first = index - index % (2 * d)
        rows = sorted(r for m in range(first, first + 2 * d)
                      for r in sharers(m))
        dot, na, nb = table[rows].sum(dim=0).unbind(0)
        acoeff, bcoeff = _coefficients(dot, na, nb)
        x = acoeff * a + bcoeff * b
    segs = Q._all_gather(x[None], group)
    return torch.cat([segs[_bit_reverse(s, levels)] for s in range(P)])[:n]


def adasum_allreduce(tensor: torch.Tensor) -> torch.Tensor:
    """Adasum over the world: the VHDD ladder, or gather + tree where the
    world is not a power of two.  Same shape and dtype as ``tensor``."""
    P = global_state.size
    if P == 1:
        return tensor.clone()
    if P & (P - 1):
        return adasum_tree(Q._all_gather(tensor[None], None))
    full = _vhdd(tensor.float().reshape(-1), None, global_state.rank,
                 lambda m: m, lambda m: [m])
    return full.reshape(tensor.shape).to(tensor.dtype)


def _local_mean(tensor: torch.Tensor, local, L: int) -> torch.Tensor:
    """fp32 mean of ``tensor`` over the ``local`` group of ``L`` members."""
    x = tensor.float().clone()
    dist.all_reduce(x, group=local)
    return Q._div(x, L)


def adasum_allreduce_hierarchical(tensor: torch.Tensor,
                                  spec: Optional[Q.QuantSpec] = None,
                                  wire_dtype=None) -> torch.Tensor:
    """Hierarchical Adasum over the two-level ``("local", "cross")``
    topology (reference adasum.py:164): an intra-node reduce-scatter (a
    sum), the VHDD ladder across nodes on the shards with the partials of
    the whole vectors (folded over the local members, which hold the other
    shards), an intra-node all-gather, and a division by L.  Adasum's
    coefficients do not change with the vectors' scale, so this is Adasum
    of the per-node means.

    ``spec`` (a quantized wire) or ``wire_dtype`` (bf16/fp16) puts the
    intra-node phases on the compressed wire, accumulating in fp32; the
    cross-node ladder stays fp32.  A cross level that is not a power of
    two combines the node means with ``adasum_tree`` (uncompressed only).
    """
    if spec is not None and wire_dtype is not None:
        raise ValueError("pass at most one of spec/wire_dtype")
    compressed = spec is not None or wire_dtype is not None
    local, cross = Q._group("local"), Q._group("cross")
    L, crossP = Q._size(local), Q._size(cross)
    if L == 1:
        return adasum_allreduce(tensor)
    if crossP == 1:
        return _local_mean(tensor, local, L).to(tensor.dtype)
    if crossP & (crossP - 1):
        if compressed:
            raise ValueError(
                "compressed hierarchical Adasum requires a power-of-two "
                "cross axis (the tree fallback combines whole vectors — "
                "there is no intra-node wire for the compression to ride)")
        node_means = Q._all_gather(_local_mean(tensor, local, L)[None],
                                   cross)
        return adasum_tree(node_means).to(tensor.dtype)
    gs = global_state
    n = tensor.numel()
    x = tensor.float().reshape(-1)
    align = L * (spec.block if spec is not None else 1)
    x = F.pad(x, (0, (-n) % align))
    rows = x.view(L, -1)
    if not compressed:
        shard = rows.new_empty(rows.shape[1])
        dist.reduce_scatter_tensor(shard, x, group=local)
    else:
        payload, scales = Q._rows_to_wire(rows, spec, wire_dtype)
        payload = Q._all_to_all(payload, local)
        if scales is not None:
            scales = Q._all_to_all(scales, local)
        shard = Q._wire_to_f32(payload, scales, spec,
                               rows.shape[1]).sum(dim=0)
    # The cross ladder over the cross group of this local index (the
    # shard padded to a multiple of the cross size inside); each member's
    # partials fold in those of its node's other local ranks.
    shard = _vhdd(shard, cross, gs.cross_rank,
                  lambda m: m * L + gs.local_rank,
                  lambda m: [m * L + i for i in range(L)])
    if not compressed:
        full = Q._all_gather(shard, local)
    elif spec is None:
        full = Q._all_gather(shard.to(wire_dtype), local).float()
    else:
        q2, s2 = Q.quantize(shard, spec)
        full = Q.dequantize(Q._all_gather(q2, local),
                            Q._all_gather(s2, local), spec,
                            L * shard.numel())
    return Q._div(full[:n], L).reshape(tensor.shape).to(tensor.dtype)
