"""Ring attention over a sequence-sharded axis, and unsharded attention
(port of horovod_tpu/parallel/ring_attention.py).

Layout: q, k, v are (batch, seq_local, heads, head_dim) shards of the
global (batch, seq_local * ring_size, heads, head_dim) arrays,
sequence-major across the axis: member i holds positions
[i * seq_local, (i + 1) * seq_local).  Q stays resident and K/V rotate
one member to the left a step, so that after t steps member i holds the
shard of member (i + t) mod sp.  The rotation is one ``batch_isend_irecv``
a step (NCCL P2P on the card, gloo on the CPU), whose sends and receives
are posted together.

Two paths per ring step, as in the reference:

* **the flash kernels** (CUDA tensors, or ``HVD_TPU_FLASH=1`` on CPU
  tensors, which then take the kernels' plain versions): each step runs
  ``flash_fwd`` over the resident Q and the visiting K/V at the global
  offsets, and the partials merge exactly in fp32 with
  ``combine_blocks``.  The backward is the reference's custom VJP
  (``_ring_flash_bwd``): a second walk runs ``flash_bwd_dq`` with the
  combined output and the global lse (so the kernel's δ = rowsum(dO∘O) is
  the reference's) and ``flash_bwd_dkv`` with that δ; dQ accumulates in
  fp32, and the fp32 dK/dV accumulators travel with their K/V shards a
  full revolution, landing on their owner.
* **the plain ring** (CPU tensors by default): the reference's blockwise
  online-softmax recurrence (``_ring_attention_xla``), differentiated by
  autograd; its rotation's backward rotates the gradient the other way.

The walk is written against a ``rotate`` callable: the P2P exchange of
:func:`ring_attention`, or, for one process holding every shard, a shift
of the list of shards (``_ring_attention_shards``), which runs a ring of
any size on one device.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence

import torch

from ..ops import flash_attention as fa

_NEG_INF = -1e30


def kernel_takes(q: torch.Tensor, k: Optional[torch.Tensor] = None) -> bool:
    """Whether the flash kernels can take these inputs: four-dimensional
    bfloat16 q (and k) with a head_dim in ``flash_attention.HEAD_DIMS``
    (the port's counterpart of the reference's ``_supported(q, k)``,
    horovod_tpu/ops/flash_attention.py)."""
    return all(t.dtype == torch.bfloat16 and len(t.shape) == 4
               and t.shape[-1] in fa.HEAD_DIMS
               for t in ((q,) if k is None else (q, k)))


def _flash_enabled(q: torch.Tensor, k: Optional[torch.Tensor] = None
                   ) -> bool:
    """Dispatch policy.  ``HVD_TPU_FLASH=0`` takes the plain path and
    ``HVD_TPU_FLASH=1`` the kernel (which raises on inputs it cannot
    take).  Otherwise a CUDA tensor takes the kernel where
    :func:`kernel_takes` holds and the plain path elsewhere (fp32, fp16,
    another head_dim), as the reference's auto mode checks ``_supported``
    first; a CPU tensor takes the plain path, as the reference's does off
    its accelerator, and under ``HVD_TPU_FLASH=1`` the kernel's plain
    version.  Only the ``HVD_TPU_`` name is read, as in the reference."""
    v = os.environ.get("HVD_TPU_FLASH", "auto")
    if v == "0":
        return False
    if v == "1":
        return True
    return q.device.type == "cuda" and kernel_takes(q, k)


# ---------------------------------------------------------------------------
# The rotation: a P2P exchange, or a shift of shards held in one process
# ---------------------------------------------------------------------------

class _P2PRing:
    """This rank alone (member ``index`` of ``sp``) on a process group:
    ``rotate`` sends each tensor to the member on the left and receives
    the right one's, all in one ``batch_isend_irecv``."""

    def __init__(self, group):
        import torch.distributed as dist
        self.group = group
        self.sp = dist.get_world_size(group)
        self.members = [dist.get_rank(group)]
        i = self.members[0]
        self.left = dist.get_global_rank(group, (i - 1) % self.sp) \
            if group is not None else (i - 1) % self.sp
        self.right = dist.get_global_rank(group, (i + 1) % self.sp) \
            if group is not None else (i + 1) % self.sp

    def rotate(self, shards: List[List[torch.Tensor]], back: bool = False
               ) -> List[List[torch.Tensor]]:
        """``shards[0]`` is this rank's tensors; returns the neighbour's
        (the right one's, or with ``back`` the left one's)."""
        import torch.distributed as dist
        send_to, recv_from = (self.right, self.left) if back else \
            (self.left, self.right)
        ops, out = [], []
        for t in shards[0]:
            t = t.contiguous()
            r = torch.empty_like(t)
            ops.append(dist.P2POp(dist.isend, t, send_to, self.group))
            ops.append(dist.P2POp(dist.irecv, r, recv_from, self.group))
            out.append(r)
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return [out]


class _LocalRing:
    """Every member's shards in this process: ``rotate`` hands member j
    the shards of member j + 1 (with ``back``, of j - 1)."""

    def __init__(self, sp: int):
        self.sp = sp
        self.members = list(range(sp))

    def rotate(self, shards, back: bool = False):
        step = -1 if back else 1
        return [shards[(j + step) % self.sp] for j in range(self.sp)]


def _group_of(axis_name):
    """The process group of ``axis_name``: None (the world), a group, or
    a dimension of the runtime's ``mesh()``."""
    import torch.distributed as dist
    if axis_name is None or isinstance(axis_name, dist.ProcessGroup):
        return axis_name
    from ..core.basics import mesh
    return mesh().get_group(axis_name)


# ---------------------------------------------------------------------------
# The flash walk and its backward
# ---------------------------------------------------------------------------

def _ring_flash_forward(ring, qs, ks, vs, causal, scale):
    """(out, lse) per member: sp steps of ``flash_fwd`` merged in fp32."""
    sq = qs[0].shape[1]
    sp = ring.sp
    o = [None] * len(qs)
    lse = [None] * len(qs)
    kv = [[k, v] for k, v in zip(ks, vs)]
    for t in range(sp):
        for j, i in enumerate(ring.members):
            o_t, lse_t = fa.flash_fwd(qs[j], kv[j][0], kv[j][1], causal,
                                      scale, i * sq, ((i + t) % sp) * sq)
            o_t = o_t.float()
            if o[j] is None:
                o[j], lse[j] = o_t, lse_t
            else:
                o[j], lse[j] = fa.combine_blocks(o[j], lse[j], o_t, lse_t)
        if t < sp - 1:
            kv = ring.rotate(kv)
    return [x.to(q.dtype) for x, q in zip(o, qs)], lse


def _ring_flash_backward(ring, qs, ks, vs, outs, lses, dos, causal, scale):
    """(dq, dk, dv) per member.  K/V stop after sp - 1 hops; the fp32
    dK/dV accumulators make the full revolution home."""
    sq = qs[0].shape[1]
    sp = ring.sp
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
          for q in qs]
    kv = [[k, v] for k, v in zip(ks, vs)]
    dkv = [[torch.zeros(k.shape, dtype=torch.float32, device=k.device),
            torch.zeros(k.shape, dtype=torch.float32, device=k.device)]
           for k in ks]
    for t in range(sp):
        for j, i in enumerate(ring.members):
            args = (causal, scale, i * sq, ((i + t) % sp) * sq)
            k_t, v_t = kv[j]
            dq_b, delta = fa.flash_bwd_dq(qs[j], k_t, v_t, dos[j], lses[j],
                                          outs[j], *args)
            dk_b, dv_b = fa.flash_bwd_dkv(qs[j], k_t, v_t, dos[j], lses[j],
                                          delta, *args)
            dq[j] += dq_b.float()
            dkv[j][0] += dk_b.float()
            dkv[j][1] += dv_b.float()
        if sp > 1 and t < sp - 1:     # all four in one exchange
            moved = ring.rotate([a + b for a, b in zip(kv, dkv)])
            kv, dkv = [m[:2] for m in moved], [m[2:] for m in moved]
        elif sp > 1:
            dkv = ring.rotate(dkv)
    return ([d.to(q.dtype) for d, q in zip(dq, qs)],
            [d[0].to(k.dtype) for d, k in zip(dkv, ks)],
            [d[1].to(v.dtype) for d, v in zip(dkv, vs)])


class _RingFlash(torch.autograd.Function):
    """The reference's ``_ring_flash`` custom VJP over the members'
    shards: inputs are every member's q, then k, then v."""

    @staticmethod
    def forward(ctx, ring, causal, scale, *qkv):
        n = len(ring.members)
        qs, ks, vs = qkv[:n], qkv[n:2 * n], qkv[2 * n:]
        outs, lses = _ring_flash_forward(ring, qs, ks, vs, causal, scale)
        ctx.ring, ctx.args = ring, (causal, scale)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *douts):
        n = len(ctx.ring.members)
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (saved[a * n:(a + 1) * n] for a in range(5))
        dos = [d.to(q.dtype) for d, q in zip(douts, qs)]
        dq, dk, dv = _ring_flash_backward(ctx.ring, qs, ks, vs, outs, lses,
                                          dos, *ctx.args)
        return (None, None, None, *dq, *dk, *dv)


# ---------------------------------------------------------------------------
# The plain ring (the reference's _ring_attention_xla)
# ---------------------------------------------------------------------------

def _block_attn(q, k, v, q_offset, kv_offset, causal, scale, m, l, o):
    """One blockwise step with online softmax accumulation; m, l:
    (B, H, Sq), o: (B, Sq, H, D), all fp32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = kv_offset + torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], _NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    # exp(_NEG_INF - _NEG_INF) would be 1: fully masked blocks stay 0.
    alpha = torch.where(m <= _NEG_INF / 2, 0.0, torch.exp(m - m_new))
    p = torch.where(s <= _NEG_INF / 2, 0.0, torch.exp(s - m_new[..., None]))
    l_new = l * alpha + p.sum(-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o_new = o * alpha.transpose(1, 2)[..., None] + pv
    return m_new, l_new, o_new


class _Rotate(torch.autograd.Function):
    """One hop of the plain ring: each member's K and V (inputs: every
    member's k, then every member's v) to the left; its backward sends
    the gradients back to the right."""

    @staticmethod
    def forward(ctx, ring, *kv):
        ctx.ring = ring
        return _rotate_pairs(ring, kv, back=False)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_rotate_pairs(ctx.ring, grads, back=True))


def _rotate_pairs(ring, kv, back):
    n = len(kv) // 2
    moved = ring.rotate([[kv[j], kv[n + j]] for j in range(n)], back=back)
    return tuple(m[0] for m in moved) + tuple(m[1] for m in moved)


def _ring_plain(ring, qs, ks, vs, causal, scale):
    sq = qs[0].shape[1]
    sp = ring.sp
    outs = []
    state = []
    for q in qs:
        b, _, h, d = q.shape
        state.append((torch.full((b, h, sq), _NEG_INF, device=q.device),
                      torch.zeros((b, h, sq), device=q.device),
                      torch.zeros((b, sq, h, d), device=q.device)))
    ks, vs = list(ks), list(vs)
    for t in range(sp):
        for j, i in enumerate(ring.members):
            state[j] = _block_attn(qs[j], ks[j], vs[j], i * sq,
                                   ((i + t) % sp) * sq, causal, scale,
                                   *state[j])
        if t < sp - 1:
            n = len(ks)
            moved = _Rotate.apply(ring, *ks, *vs)
            ks, vs = list(moved[:n]), list(moved[n:])
    for q, (_, l, o) in zip(qs, state):
        l = l.clamp_min(1e-20)
        outs.append((o / l.transpose(1, 2)[..., None]).to(q.dtype))
    return outs


def _ring(ring, qs, ks, vs, causal, scale):
    scale = 1.0 / math.sqrt(qs[0].shape[-1]) if scale is None \
        else float(scale)
    if _flash_enabled(qs[0], ks[0]):
        return list(_RingFlash.apply(ring, bool(causal), scale, *qs, *ks,
                                     *vs))
    return _ring_plain(ring, qs, ks, vs, causal, scale)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name=None, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over a sequence-sharded axis via K/V ring rotation.

    ``axis_name`` is a dimension of the runtime's ``mesh()``, a process
    group, or None (the world); every member calls it with its own
    (B, Sq, H, D) shards and gets its output shard."""
    return _ring(_P2PRing(_group_of(axis_name)), [q], [k], [v], causal,
                 scale)[0]


def _ring_attention_shards(qs: Sequence[torch.Tensor],
                           ks: Sequence[torch.Tensor],
                           vs: Sequence[torch.Tensor], causal: bool = True,
                           scale: Optional[float] = None
                           ) -> List[torch.Tensor]:
    """The ring over ``len(qs)`` members whose shards this process holds
    (member i: ``qs[i]``, ``ks[i]``, ``vs[i]``): the same walk and the same
    kernel launches as :func:`ring_attention` on that many ranks, the
    rotation a shift of the list.  Returns the members' output shards."""
    return _ring(_LocalRing(len(qs)), list(qs), list(ks), list(vs), causal,
                 scale)


# ---------------------------------------------------------------------------
# Unsharded attention
# ---------------------------------------------------------------------------

def reference_attention(q, k, v, causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain unsharded attention, fp32 inside — the numerics oracle."""
    b, sq, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = torch.arange(sq, device=q.device)
        k_pos = torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def full_attention(q, k, v, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Unsharded attention (same layout as ring attention): the flash
    kernels on CUDA tensors they can take, the plain path elsewhere and
    where ``HVD_TPU_FLASH=0`` says so (see ``_flash_enabled``)."""
    if _flash_enabled(q, k):
        return fa.flash_attention(q, k, v, causal=causal, scale=scale)
    return reference_attention(q, k, v, causal=causal, scale=scale)
