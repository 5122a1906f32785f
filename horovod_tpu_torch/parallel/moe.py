"""Expert parallelism: switch-style Mixture-of-Experts with all-to-all
token routing over a mesh axis (port of horovod_tpu/parallel/moe.py).

Top-k gating with capacity, a dispatch einsum into an (experts, capacity,
d) buffer of static shape, and two all-to-all exchanges over the expert
axis.  Dropped tokens (over capacity) pass through on the residual path,
standard Switch Transformer semantics.

The exchanges are differentiable, so the tokens and the gate get their
gradients through them.  They may ride the block-scaled int8/int4 wire
of ``ops/quantization.py`` (each destination row quantized on its own,
payload and fp32 scales as two all-to-alls); its gradient is the
reference's, which flows through the block scales only
(``xla_collectives.all_to_all_wire``).  Dispatch, the expert MLPs and
the combine compute in fp32, whatever the activations' dtype.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..ops.quantization import QuantSpec, wire_bytes
from .ring_attention import _group_of


class MoEParams(NamedTuple):
    gate: torch.Tensor    # (d_model, n_experts_total): replicated
    w_in: torch.Tensor    # (n_local, d_model, d_ff): sharded over the axis
    w_out: torch.Tensor   # (n_local, d_ff, d_model): sharded over the axis


class RoutingInfo(NamedTuple):
    """Static-shape routing decision for one batch of local tokens."""
    dispatch: torch.Tensor  # (T, E, C) fp32 in {0, 1}: token t → expert e slot c
    combine: torch.Tensor   # (T, E, C) fp32: dispatch weighted by gate prob
    aux_loss: torch.Tensor  # scalar fp32: load-balancing auxiliary loss
    dropped: torch.Tensor   # scalar fp32: (token, route) slots over capacity
    capacity: int           # static per-expert slot count


class MoEStats(NamedTuple):
    """Per-call accounting returned by ``moe_layer(..., return_stats=True)``."""
    aux_loss: torch.Tensor  # scalar fp32
    dropped: torch.Tensor   # scalar fp32: dropped (token, route) assignments
    routed: torch.Tensor    # scalar fp32: all (token, route) assignments (T*k)
    capacity: int


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default, the tanh approximation.
    return F.gelu(x, approximate="tanh")


def init_moe_params(generator: Optional[torch.Generator], d_model: int,
                    d_ff: int, n_experts_total: int, n_local: int,
                    dtype=torch.float32) -> MoEParams:
    """normal(0, 1/sqrt(d_model)) gate and w_in, normal(0, 1/sqrt(d_ff))
    w_out, drawn from ``generator`` (the reference's scales)."""
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(d_ff)

    def rand(*shape, scale):
        return (torch.randn(shape, generator=generator) * scale).to(dtype)

    return MoEParams(gate=rand(d_model, n_experts_total, scale=s_in),
                     w_in=rand(n_local, d_model, d_ff, scale=s_in),
                     w_out=rand(n_local, d_ff, d_model, scale=s_out))


def expert_capacity(tokens: int, n_experts: int, capacity_factor: float,
                    top_k: int = 1) -> int:
    """Per-expert slot count: ``ceil(tokens * top_k / n_experts * factor)``,
    clamped to at least 1 so a small ``capacity_factor`` (or tiny
    microbatch) never rounds the buffer to zero slots."""
    cap = int(math.ceil(tokens * top_k / n_experts * capacity_factor))
    return max(1, cap)


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest per row, ties to the lower
    index as ``lax.top_k`` breaks them (``torch.topk`` does not promise
    an order among ties)."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[:, :k], indices[:, :k]


def top_k_routing(logits: torch.Tensor, capacity: int,
                  top_k: int = 1) -> RoutingInfo:
    """Top-k token→expert routing with capacity and drop accounting.

    logits: (T, E) gating logits (softmax runs in fp32).  Slots are filled
    in token order, k-th choices after all (k-1)-th choices, so an expert
    that overflows on earlier choices drops later ones; each route's
    combine weight is its raw softmax probability."""
    t, e = logits.shape
    if top_k < 1 or top_k > e:
        raise ValueError(f"top_k must be in [1, {e}], got {top_k}")
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_i = _top_k(probs, top_k)                         # (T, k)

    dev = logits.device
    dispatch = torch.zeros((t, e, capacity), device=dev)
    combine = torch.zeros((t, e, capacity), device=dev)
    counts = torch.zeros((e,), device=dev)   # slots claimed so far per expert
    kept = torch.zeros((), device=dev)
    for j in range(top_k):
        onehot = F.one_hot(top_i[:, j], e).float()              # (T, E)
        position = onehot.cumsum(0) - 1.0 + counts[None, :]
        keep = (position < capacity) & (onehot > 0)             # (T, E)
        # jax.nn.one_hot gives a zero row for an index outside
        # [0, capacity); F.one_hot raises, so mask the index first.
        slot = torch.where(keep, position.long(), 0)
        pos_cap = F.one_hot(slot, capacity).float() * keep[..., None]
        dispatch = dispatch + pos_cap
        combine = combine + pos_cap * top_p[:, j][:, None, None]
        kept = kept + keep.float().sum()
        counts = counts + onehot.sum(0)

    routed = float(t * top_k)
    dropped = routed - kept
    # GShard/Switch load-balancing loss: fraction of routes per expert
    # (before drops) times mean gate prob, scaled by E (1.0 if uniform).
    frac = counts / routed
    aux = e * (frac * probs.mean(0)).sum()
    return RoutingInfo(dispatch=dispatch, combine=combine, aux_loss=aux,
                       dropped=dropped, capacity=capacity)


def dispatch_wire_bytes(ep: int, n_local: int, capacity: int, d_model: int,
                        quant: Optional[QuantSpec] = None) -> int:
    """Bytes one member puts on the wire for ONE dispatch (or combine)
    all-to-all.  Quantization is per destination row, so the quantized
    wire is ``ep`` independent payload+scales rows."""
    chunk = n_local * capacity * d_model
    if quant is None:
        return 4 * ep * chunk
    return ep * wire_bytes(chunk, quant)


def moe_layer(params: MoEParams, x: torch.Tensor, axis_name,
              capacity_factor: float = 1.25,
              activation: Callable = _gelu,
              top_k: int = 1,
              quant: Optional[QuantSpec] = None,
              return_stats: bool = False):
    """Apply an expert-parallel MoE MLP to this member's tokens.

    params: this member's shard (its ``n_local`` experts; the gate is the
    whole one).  x: (tokens, d_model).  ``axis_name``: the expert axis (a
    ``mesh()`` dimension, a process group, or None for the world; size P,
    E = P * n_local experts in all).  Returns (tokens, d_model) combined
    expert outputs in x's dtype (zeros for dropped tokens: the caller adds
    the residual), and with ``return_stats`` also :class:`MoEStats`."""
    from ..ops import xla_collectives as XC
    import torch.distributed as dist
    group = _group_of(axis_name)
    ep = dist.get_world_size(group)
    t, d = x.shape
    n_local = params.w_in.shape[0]
    n_experts = ep * n_local
    capacity = expert_capacity(t, n_experts, capacity_factor, top_k)

    # jnp promotes bf16 @ fp32 to fp32; torch would refuse the mix.
    xf = x.float()
    logits = xf @ params.gate.float()
    route = top_k_routing(logits, capacity, top_k)

    # dispatch: (T,E,C) x (T,d) -> (E,C,d), exchanged over the experts.
    x_send = torch.einsum("tec,td->ecd", route.dispatch, xf)
    x_send = x_send.reshape(ep, n_local, capacity, d)
    # Row p goes to member p; row s of the result came from member s.
    x_recv = XC.all_to_all_wire(x_send, group, quant)           # (P,L,C,d)
    tokens = x_recv.transpose(0, 1).reshape(n_local, ep * capacity, d)

    # The expert MLPs, batched over this member's experts.
    h = activation(torch.einsum("lcd,ldf->lcf", tokens,
                                params.w_in.float()))
    y = torch.einsum("lcf,lfd->lcd", h, params.w_out.float())

    # Return route: the reverse exchange, then the fp32 combine.
    y = y.reshape(n_local, ep, capacity, d).transpose(0, 1)
    y_back = XC.all_to_all_wire(y, group, quant)                # (P,L,C,d)
    y_back = y_back.reshape(n_experts, capacity, d)
    out = torch.einsum("tec,ecd->td", route.combine, y_back).to(x.dtype)
    if not return_stats:
        return out
    stats = MoEStats(aux_loss=route.aux_loss, dropped=route.dropped,
                     routed=torch.tensor(float(t * top_k), device=x.device),
                     capacity=capacity)
    return out, stats


def moe_load_balancing_loss(x: torch.Tensor, gate: torch.Tensor,
                            n_experts: int) -> torch.Tensor:
    """Switch Transformer auxiliary load-balancing loss (fraction routed
    times mean prob per expert, scaled by E)."""
    probs = torch.softmax((x.float() @ gate.float()), dim=-1)
    frac = F.one_hot(probs.argmax(-1), n_experts).float().mean(0)
    return n_experts * (frac * probs.mean(0)).sum()
