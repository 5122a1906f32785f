"""Flagship model: decoder-only Transformer LM, data-parallel training half
(port of horovod_tpu/models/transformer.py, dense, dp only).

The parameter tree and shapes are the reference's (``init_params``,
transformer.py:79-123): layer weights stacked as (n_pp, layers_per_stage,
…), in the (in, out) layout of its einsums, with ``wqkv``'s fused output
dim laid out (heads, 3, head_dim), heads outermost.  ``Transformer`` holds
that tree as parameters, so its ``state_dict`` keys are the tree's paths
(``embed``, ``layers.wqkv``, …) and ``convert.params_from_jax`` loads the
reference's parameters into it.

Compute dtype defaults to bfloat16; normalization, softmax, logits and
loss are fp32, with the tied fp32 embedding as the vocab head.
The configs carry only the fields this port reads; ``remat``, MoE routing
and pipeline scheduling are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.basics import DeviceLike, resolve_device
from ..ops.collective import Average, allreduce
from ..parallel import ring_attention as ra


class TransformerConfig(NamedTuple):
    vocab_size: int = 32768
    d_model: int = 512
    n_heads: int = 8
    d_ff: int = 2048
    n_layers: int = 8
    seq_len: int = 512
    n_experts: int = 0            # 0 → dense MLP (the only mode ported)
    attn_mode: str = "megatron"   # the only mode ported
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


class ParallelConfig(NamedTuple):
    """Only pp = mp = 1 is ported; the data-parallel width is the world
    size of ``init()``."""
    pp: int = 1
    mp: int = 1


def _check_ported(cfg: TransformerConfig, par: ParallelConfig) -> None:
    if cfg.n_experts:
        raise NotImplementedError("MoE layers are not ported yet (ROADMAP.md "
                                  "queue 1: ring, Ulysses, pp, tp and MoE)")
    if cfg.attn_mode != "megatron" or par.pp != 1 or par.mp != 1:
        raise NotImplementedError(
            f"attn_mode={cfg.attn_mode!r}, pp={par.pp}, mp={par.mp}: only "
            "data parallelism is ported (ROADMAP.md queue 1: ring, Ulysses, "
            "pp, tp and MoE)")


def init_params(cfg: TransformerConfig, par: Optional[ParallelConfig] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
    """The full parameter tree, fp32 on the CPU, drawn from ``generator``:
    normal(0, 0.02) weights, output projections scaled by
    1/sqrt(2 n_layers), ones for the norms (reference init_params)."""
    par = par or ParallelConfig()
    _check_ported(cfg, par)
    d, ff, v, s = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.seq_len
    h, hd = cfg.n_heads, cfg.head_dim
    n_pp, lps = par.pp, cfg.n_layers // par.pp
    std = 0.02
    out_std = std / math.sqrt(2 * cfg.n_layers)

    def rand(*shape, scale=std):
        return torch.randn(shape, generator=generator) * scale

    return {
        "embed": rand(v, d),
        "pos": rand(s, d),
        "final_norm": torch.ones(d),
        "layers": {
            "ln1": torch.ones(n_pp, lps, d),
            "ln2": torch.ones(n_pp, lps, d),
            "wqkv": rand(n_pp, lps, d, 3 * h * hd),
            "wo": rand(n_pp, lps, h * hd, d, scale=out_std),
            "w1": rand(n_pp, lps, d, ff),
            "w2": rand(n_pp, lps, ff, d, scale=out_std),
        },
    }


class Transformer(nn.Module):
    """The parameter tree of ``init_params`` as an ``nn.Module``.

    ``forward(tokens)`` gives fp32 logits, ``forward(tokens, labels)`` the
    mean next-token cross entropy.
    """

    def __init__(self, cfg: TransformerConfig,
                 par: Optional[ParallelConfig] = None, *, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        self.cfg, self.par = cfg, par or ParallelConfig()
        dev = resolve_device(device)
        tree = init_params(cfg, self.par,
                           torch.Generator().manual_seed(seed))
        self.embed = nn.Parameter(tree["embed"].to(dev))
        self.pos = nn.Parameter(tree["pos"].to(dev))
        self.final_norm = nn.Parameter(tree["final_norm"].to(dev))
        self.layers = nn.ParameterDict(
            {k: nn.Parameter(t.to(dev)) for k, t in tree["layers"].items()})

    def forward(self, tokens: torch.Tensor,
                labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        if labels is None:
            return serial_forward_logits(self.cfg, self, tokens)
        return serial_forward_loss(self.cfg, self, tokens, labels)


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)


def _attention_block(cfg: TransformerConfig, lp: Dict[str, torch.Tensor],
                     x: torch.Tensor) -> torch.Tensor:
    """Pre-norm causal self-attention; returns the residual branch.  ``lp``
    holds the layer's weights, matmul weights already in x's dtype."""
    h = _rmsnorm(x, lp["ln1"])
    qkv = h @ lp["wqkv"]
    b, s = qkv.shape[:2]
    qkv = qkv.view(b, s, cfg.n_heads, 3, cfg.head_dim)
    # Strided views: the kernels read them in place, no copy.
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    o = ra.full_attention(q, k, v, causal=True)
    return o.reshape(b, s, -1) @ lp["wo"]


def _mlp_block(cfg: TransformerConfig, lp: Dict[str, torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
    h = _rmsnorm(x, lp["ln2"])
    # jax.nn.gelu defaults to the tanh approximation; PyTorch's to erf.
    u = F.gelu(h @ lp["w1"], approximate="tanh")
    return u @ lp["w2"]


_MATMUL_WEIGHTS = ("wqkv", "wo", "w1", "w2")


def _layer_params(model: Transformer, dtype):
    """Per-layer parameter dicts, the matmul weights cast to the compute
    dtype: one cast and one unbind per stacked tensor (whose backward is one
    cast and one stack), not one of each per layer."""
    per = {}
    for k, t in model.layers.items():
        t = t.flatten(0, 1)
        per[k] = (t.to(dtype) if k in _MATMUL_WEIGHTS else t).unbind(0)
    n = len(next(iter(per.values())))
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


def serial_forward_logits(cfg: TransformerConfig, model: Transformer,
                          tokens: torch.Tensor) -> torch.Tensor:
    """Training-path forward: fp32 logits (B, S, V)."""
    s_in = tokens.shape[1]
    x = (model.embed[tokens] + model.pos[None, :s_in]).to(cfg.dtype)
    for lp in _layer_params(model, cfg.dtype):
        x = x + _attention_block(cfg, lp, x)
        x = x + _mlp_block(cfg, lp, x)
    hidden = _rmsnorm(x, model.final_norm)
    return hidden.float() @ model.embed.float().t()


def serial_forward_loss(cfg: TransformerConfig, model: Transformer,
                        tokens: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy, fp32."""
    logits = serial_forward_logits(cfg, model, tokens)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def forward_loss(cfg: TransformerConfig, par: ParallelConfig,
                 model: Transformer, tokens: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """The loss averaged over the data-parallel ranks, as the reference's
    ``pmean`` over dp gives it (transformer.py:280).  Its value is the dp
    mean; its gradient is this rank's own, so ``DistributedOptimizer``
    averages the gradients once, as before, and the update is the
    reference's.  At world 1 the value is the rank's loss."""
    _check_ported(cfg, par)
    return _dp_mean(serial_forward_loss(cfg, model, tokens, labels))


def _dp_mean(local: torch.Tensor) -> torch.Tensor:
    """``local``'s value averaged over the world, its gradient its own."""
    # local - local.detach() is exactly 0, so every rank holds the same
    # value, bit for bit.  The wire is exact whatever the session's
    # compression knob says, as the reference's compiled pmean is.
    return allreduce(local.detach(), op=Average, compression="none") + \
        (local - local.detach())


def make_train_step(cfg: TransformerConfig, par: ParallelConfig,
                    model: Transformer, optimizer) -> Callable:
    """``train_step(tokens, labels) -> loss``: forward, backward and one
    (distributed) optimizer step.  The loss returned is the dp mean of
    ``forward_loss``, detached, the same on every rank, as the reference's
    ``train_step`` returns it.

    ``optimizer`` is a ``DistributedOptimizer`` (or any optimizer) over
    ``model``'s parameters, updated in place, or a ``ZeroShardedOptimizer``
    built on ``model``: at stage 2 the step reduces the gradients into
    shards before the update; at stage 3 the forward runs on the gathered
    parameters (``torch.func.functional_call``) and the step updates the
    shards, not ``model``'s own parameters."""
    from ..optimizers import ZeroShardedOptimizer
    _check_ported(cfg, par)
    stage = optimizer.stage if isinstance(optimizer, ZeroShardedOptimizer) \
        else 0

    def loss_of(tokens, labels):
        if stage == 3:
            return _dp_mean(torch.func.functional_call(
                model, optimizer.gather_params(), (tokens, labels)))
        return forward_loss(cfg, par, model, tokens, labels)

    def train_step(tokens: torch.Tensor, labels: torch.Tensor):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_of(tokens, labels)
        loss.backward()
        if stage == 2:
            optimizer.reduce_grads()
        optimizer.step()
        return loss.detach()

    return train_step


def synthetic_batch(cfg: TransformerConfig, batch: int, seed: int = 1,
                    device: DeviceLike = None):
    """(tokens, labels), int64 (batch, seq_len): uniform tokens from a
    numpy generator, labels the tokens shifted left by one (wrapping)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, cfg.seq_len))
    labels = np.roll(tokens, -1, axis=1)
    dev = resolve_device(device)
    return (torch.from_numpy(tokens).to(dev),
            torch.from_numpy(labels).to(dev))


def train_flops_per_seq(cfg: TransformerConfig) -> float:
    """Matmul-FLOPs for one causal-LM training sequence (train = 3x fwd):
    per token 8d^2 (qkv + proj) + 4 d ff (mlp) per layer + 2dV vocab head;
    causal attention 2 S^2 d per layer per sequence."""
    d, L, s, v = cfg.d_model, cfg.n_layers, cfg.seq_len, cfg.vocab_size
    dense = s * (L * (8.0 * d * d + 4.0 * d * cfg.d_ff) + 2.0 * d * v)
    attn = L * 2.0 * s * s * d
    return 3.0 * (dense + attn)
