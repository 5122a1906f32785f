"""BERT encoder family: masked-LM pretraining, data and tensor parallel
(port of horovod_tpu/models/bert.py).

bf16 compute, fp32 normalization, softmax and loss; Megatron column/row
tensor parallelism over the ``mp`` axis of a ``(dp, mp)`` mesh
(``parallel.mesh.create_mesh({"dp": …, "mp": …})``), the batch over
``dp``; attention through ``ring_attention.full_attention(causal=False)``,
so bf16 at head_dim 64 runs the three hand-written flash kernels
(``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``) non-causally in every
layer.

The parameter tree and shapes are the reference's (layers stacked
``(n_layers, …)``, matmul weights in the (in, out) layout of its einsums,
``wqkv``'s fused output laid out (heads, 3, head_dim)); ``Bert`` holds it
(this rank's shard of it on a mesh), so ``convert.params_from_jax``
loads the reference's parameters into it.  ``make_loss_fn`` differentiates
the per-rank body as the reference differentiates its ``shard_map``
(``models/_mesh.py``).

Numerics as the reference's code (its docstring's "Post-LN" aside, the
block normalizes before attention and before the MLP): layer norm
without bias, eps 1e-6, in fp32; ``jax.nn.gelu``'s tanh approximation;
the dense MLM head takes bf16 logits, an fp32 logsumexp, and recomputes
the picked logit as a dot with fp32 accumulation; the gathered head
(``positions``) takes fp32 logits.  ``remat``: True recomputes each layer
in the backward; ``"dots"`` keeps the weight products and attention and
recomputes the fp32 layer-norm chains (each a ``checkpoint`` of its own,
so the matmuls' bf16 inputs and outputs are kept and the fp32
intermediates are not: the counterpart of the reference's
``dots_with_no_batch_dims_saveable``); False keeps everything.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..core.basics import DeviceLike, resolve_device
from ..parallel import ring_attention as ra
from ..parallel import tensor_parallel as tp
from . import _mesh
from .transformer import _layer_params, _split_heads

IGNORE_INDEX = -100
AXES = ("dp", "mp")


class BertConfig(NamedTuple):
    vocab_size: int = 30522
    d_model: int = 768
    n_heads: int = 12
    d_ff: int = 3072
    n_layers: int = 12
    seq_len: int = 512
    dtype: Any = torch.bfloat16
    # True/"full" = per-layer rematerialization; "dots" = recompute the
    # layer norms only; False = none.
    remat: Any = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def init_params(cfg: BertConfig, generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
    """The full parameter tree, fp32 on the CPU, drawn from ``generator``:
    normal(0, 0.02) weights, output projections scaled by
    1/sqrt(2 n_layers), ones for the norms, a zero MLM bias (the
    reference's init)."""
    d, ff, v, s = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.seq_len
    h, hd, n = cfg.n_heads, cfg.head_dim, cfg.n_layers
    std = 0.02

    def rand(*shape, scale=std):
        return torch.randn(shape, generator=generator) * scale

    return {
        "embed": rand(v, d),
        "pos": rand(s, d),
        "emb_norm": torch.ones(d),
        "layers": {
            "ln1": torch.ones(n, d),
            "ln2": torch.ones(n, d),
            "wqkv": rand(n, d, 3 * h * hd),
            "wo": rand(n, h * hd, d, scale=std / math.sqrt(2 * n)),
            "w1": rand(n, d, ff),
            "w2": rand(n, ff, d, scale=std / math.sqrt(2 * n)),
        },
        # MLM head: transform + norm; the logits tie the embedding.
        "mlm_dense": rand(d, d),
        "mlm_norm": torch.ones(d),
        "mlm_bias": torch.zeros(v),
    }


def param_specs(cfg: BertConfig) -> Dict[str, Any]:
    """Per leaf, the mesh axis sharding each dim (the reference's
    PartitionSpecs over (dp, mp)): attention and MLP Megatron column/row
    parallel over mp; embeddings and norms replicated."""
    del cfg
    return {
        "embed": (), "pos": (), "emb_norm": (),
        "layers": {
            "ln1": (), "ln2": (),
            "wqkv": (None, None, "mp"),
            "wo": (None, "mp", None),
            "w1": (None, None, "mp"),
            "w2": (None, "mp", None),
        },
        "mlm_dense": (), "mlm_norm": (), "mlm_bias": (),
    }


def shard_params(cfg: BertConfig, tree: Dict[str, Any], mesh
                 ) -> Dict[str, Any]:
    """This rank's shard of the full tree on a (dp, mp) mesh."""
    return _mesh.shard_tree(tree, param_specs(cfg), _mesh.MeshAxes(mesh, AXES))


def gather_params(cfg: BertConfig, shards, mesh) -> Dict[str, Any]:
    """The full tree on every rank (``shards`` a tree or a ``Bert``)."""
    return _mesh.gather_tree(_tree(shards), param_specs(cfg),
                             _mesh.MeshAxes(mesh, AXES))


_TOP = ("embed", "pos", "emb_norm", "mlm_dense", "mlm_norm", "mlm_bias")


def _tree(params) -> Dict[str, Any]:
    if isinstance(params, Bert):
        out = {k: getattr(params, k) for k in _TOP}
        out["layers"] = dict(params.layers.items())
        return out
    return params


class Bert(nn.Module):
    """The parameter tree of ``init_params`` as a module (with ``mesh``,
    this rank's shard of it).  ``forward(tokens, labels[, positions])``
    gives the MLM loss: the serial one, or on a mesh the replicated one
    through ``make_loss_fn`` (tokens this rank's dp rows)."""

    def __init__(self, cfg: BertConfig, *, seed: int = 0,
                 device: DeviceLike = None, mesh=None):
        super().__init__()
        self.cfg, self.mesh = cfg, mesh
        dev = resolve_device(device)
        tree = init_params(cfg, torch.Generator().manual_seed(seed))
        if mesh is not None:
            tree = shard_params(cfg, tree, mesh)
        for k in _TOP:
            setattr(self, k, nn.Parameter(tree[k].to(dev)))
        self.layers = nn.ParameterDict(
            {k: nn.Parameter(t.to(dev)) for k, t in tree["layers"].items()})

    def forward(self, tokens: torch.Tensor, labels: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.mesh is None:
            return serial_forward_loss(self.cfg, self, tokens, labels,
                                       positions)
        fn = make_loss_fn(self.cfg, self.mesh, gathered=positions is not None)
        batch = (tokens, labels) if positions is None \
            else (tokens, positions, labels)
        return fn(self, *batch)


# ---------------------------------------------------------------------------
# The encoder
# ---------------------------------------------------------------------------

def _layernorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default


def _residual_norm(x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor):
    x = x + y
    return x, _layernorm(x, scale)


def _checkpointed(on: bool, fn, *args):
    """``fn(*args)``, recomputed in the backward when ``on``."""
    if on:
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def _encoder_layer(cfg: BertConfig, mp, lp: Dict[str, torch.Tensor],
                   x: torch.Tensor) -> torch.Tensor:
    """One pre-LN block on x (B, S, d).  ``mp`` the tensor-parallel
    group (None: the serial oracle): wqkv/w1 are then column shards,
    wo/w2 row shards, their products summed over mp.  With remat "dots"
    the layer norms are recomputed in the backward."""
    dots = cfg.remat == "dots" and torch.is_grad_enabled()
    h = _checkpointed(dots, _layernorm, x, lp["ln1"])
    q, k, v = _split_heads(h @ lp["wqkv"], cfg.head_dim)
    o = ra.full_attention(q, k, v, causal=False)
    o = o.reshape(*x.shape[:2], -1)
    attn = o @ lp["wo"] if mp is None else \
        tp.row_parallel(o, lp["wo"], mp, scatter_sequence=False)
    x, h = _checkpointed(dots, _residual_norm, x, attn, lp["ln2"])
    u = _gelu(tp.column_parallel(h, lp["w1"]))
    mlp = u @ lp["w2"] if mp is None else \
        tp.row_parallel(u, lp["w2"], mp, scatter_sequence=False)
    return x + mlp


def _run_layers(cfg: BertConfig, layer_fn, layers, x: torch.Tensor):
    full = bool(cfg.remat) and cfg.remat != "dots" and \
        torch.is_grad_enabled()
    for lp in layers:
        x = _checkpointed(full, layer_fn, lp, x)
    return x


def _encode(cfg: BertConfig, params, tokens: torch.Tensor, mp
            ) -> torch.Tensor:
    emb = params["embed"][tokens] + params["pos"][None, :tokens.shape[1]]
    x = _layernorm(emb.to(cfg.dtype), params["emb_norm"])
    layers = _layer_params(params["layers"], cfg.dtype)
    return _run_layers(cfg, functools.partial(_encoder_layer, cfg, mp),
                       layers, x)


def _mlm_transform(params, hidden: torch.Tensor) -> torch.Tensor:
    """The MLM head's transform: dense in the activation dtype, gelu and
    norm in fp32."""
    h = hidden @ params["mlm_dense"].to(hidden.dtype)
    h = _gelu(h.float()).to(hidden.dtype)
    return _layernorm(h, params["mlm_norm"])


def _mlm_loss(params, hidden: torch.Tensor, labels: torch.Tensor):
    """(sum of the cross entropy where labels != IGNORE_INDEX, the count
    of those positions): the dense head, logits at every position."""
    h = _mlm_transform(params, hidden)
    logits = h @ params["embed"].to(h.dtype).t() + \
        params["mlm_bias"].to(h.dtype)
    lse = torch.logsumexp(logits.float(), dim=-1)
    safe = labels.clamp_min(0)
    # The picked logit as a dot with fp32 accumulation, not gathered from
    # the bf16 logits (whose rounding would land 1:1 in the loss): a
    # product of two bf16 values is exact in fp32.
    w = params["embed"][safe].to(h.dtype)
    picked = (h.float() * w.float()).sum(-1) + params["mlm_bias"][safe]
    mask = (labels != IGNORE_INDEX).float()
    return -((picked - lse) * mask).sum(), mask.sum()


def _mlm_loss_gathered(params, hidden: torch.Tensor, positions: torch.Tensor,
                       labels: torch.Tensor):
    """The cross entropy at ``positions`` (B, P) only (labels (B, P),
    IGNORE_INDEX at padded slots): the vocab projection on (B, P, d), its
    logits in fp32."""
    d = hidden.shape[-1]
    g = hidden.gather(1, positions.long()[..., None].expand(-1, -1, d))
    h = _mlm_transform(params, g)
    # bf16 operands, fp32 products and sums (preferred_element_type).
    logits = h.float() @ params["embed"].to(h.dtype).float().t()
    logp = F.log_softmax(logits + params["mlm_bias"], dim=-1)
    safe = labels.clamp_min(0)
    ll = logp.gather(-1, safe[..., None])[..., 0]
    mask = (labels != IGNORE_INDEX).float()
    return -(ll * mask).sum(), mask.sum()


def _loss_sums(cfg: BertConfig, params, tokens, labels, positions, mp):
    hidden = _encode(cfg, params, tokens, mp)
    if positions is None:
        return _mlm_loss(params, hidden, labels)
    return _mlm_loss_gathered(params, hidden, positions, labels)


def forward_loss(cfg: BertConfig, ax: _mesh.MeshAxes, params, tokens,
                 labels, positions=None) -> torch.Tensor:
    """The per-rank body on a (dp, mp) mesh: tokens (B_local, S), this
    rank's dp rows; without ``positions`` labels (B_local, S) with
    IGNORE_INDEX at unmasked positions (the dense head), with
    ``positions`` (B_local, P) labels (B_local, P) (the gathered head).
    The loss sums and counts are summed over dp: the replicated global
    mean.  Differentiate it through ``make_loss_fn``."""
    loss_sum, n = _loss_sums(cfg, params, tokens, labels, positions,
                             ax.group["mp"])
    dp = ax.group["dp"]
    return tp.psum(loss_sum, dp) / tp.psum(n, dp).clamp_min(1.0)


def serial_forward_loss(cfg: BertConfig, params, tokens, labels,
                        positions=None) -> torch.Tensor:
    """The unsharded oracle of the same math (``params`` a tree or a
    ``Bert`` without a mesh)."""
    loss_sum, n = _loss_sums(cfg, _tree(params), tokens, labels, positions,
                             None)
    return loss_sum / n.clamp_min(1.0)


def make_loss_fn(cfg: BertConfig, mesh, gathered: bool = False) -> Callable:
    """``loss_of(params, tokens, labels)`` (``gathered``: ``loss_of(params,
    tokens, positions, labels)``): the per-rank body on ``mesh``,
    differentiable as the reference's ``shard_map``.  ``params``: a
    ``Bert`` built on ``mesh`` or a shard tree cut for it; the batch this
    rank's dp rows.  After ``backward()`` each shard's ``.grad`` is the
    reference's gradient of that shard."""
    ax = _mesh.MeshAxes(mesh, AXES)
    specs = param_specs(cfg)

    def loss_of(params, *batch):
        if isinstance(params, Bert) and (params.mesh is None
                                          or params.mesh != mesh):
            raise ValueError("the model's shards were cut for another mesh "
                             f"({params.mesh}), not {mesh}")
        if gathered:
            tokens, positions, labels = batch
        else:
            (tokens, labels), positions = batch, None
        local = _mesh.enter_tree(_tree(params), specs, ax)
        loss = forward_loss(cfg, ax, local, tokens, labels, positions)
        return _mesh.leave(loss, ax)

    return loss_of


def make_train_step(cfg: BertConfig, model: Bert, optimizer,
                    gathered: bool = False) -> Callable:
    """``train_step(tokens, labels)`` (``gathered``: ``train_step(tokens,
    positions, labels)``) -> the loss, detached: forward, backward and one
    step of ``optimizer``, a plain torch optimizer over ``model``'s
    parameters (on a mesh its shards; the gradients are already the
    reference's), as the reference steps optax on its sharded tree.  The
    mesh is ``model.mesh``; without one the serial loss."""
    if model.mesh is not None:
        loss_of = make_loss_fn(cfg, model.mesh, gathered=gathered)
    elif gathered:
        def loss_of(params, tokens, positions, labels):
            return serial_forward_loss(cfg, params, tokens, labels,
                                       positions)
    else:
        def loss_of(params, tokens, labels):
            return serial_forward_loss(cfg, params, tokens, labels)

    def train_step(*batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_of(model, *batch)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


# ---------------------------------------------------------------------------
# Synthetic batches and FLOPs
# ---------------------------------------------------------------------------

def synthetic_batch(cfg: BertConfig, batch: int, mask_rate: float = 0.15,
                    seed: int = 1, device: DeviceLike = None):
    """(inputs, labels), int64 (batch, seq_len), from a numpy generator:
    tokens uniform in [1, vocab); ``mask_rate`` of the positions masked,
    their inputs the [MASK]-like id 0 and their labels the original id,
    IGNORE_INDEX elsewhere."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, (batch, cfg.seq_len))
    masked = rng.random((batch, cfg.seq_len)) < mask_rate
    inputs = np.where(masked, 0, tokens)
    labels = np.where(masked, tokens, IGNORE_INDEX)
    dev = resolve_device(device)
    return (torch.from_numpy(inputs).to(dev),
            torch.from_numpy(labels).to(dev))


def max_predictions(cfg: BertConfig, mask_rate: float = 0.15) -> int:
    """max_predictions_per_seq of the gathered head: the masked count
    rounded up to a multiple of 8 (76.8 -> 80 at seq 512) while that
    stays within 2x the exact count (short sequences keep their rate)."""
    exact = max(1, int(-(-cfg.seq_len * mask_rate // 1)))
    padded = int(-(-exact // 8) * 8)
    return min(padded if padded <= 2 * exact else exact, cfg.seq_len)


def synthetic_mlm_batch(cfg: BertConfig, batch: int, mask_rate: float = 0.15,
                        seed: int = 1, device: DeviceLike = None):
    """(inputs, positions, labels) for the gathered head: P =
    ``max_predictions`` distinct positions a row (the top P of random
    scores), those inputs the id 0, labels the original ids; int64."""
    n_pred = max_predictions(cfg, mask_rate)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, (batch, cfg.seq_len))
    scores = rng.random((batch, cfg.seq_len))
    positions = np.argsort(-scores, axis=-1, kind="stable")[:, :n_pred]
    labels = np.take_along_axis(tokens, positions, axis=1)
    inputs = tokens.copy()
    np.put_along_axis(inputs, positions, 0, axis=1)
    dev = resolve_device(device)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (inputs, positions, labels))


def train_flops_per_seq(cfg: BertConfig, n_pred: Optional[int] = None
                        ) -> float:
    """Matmul FLOPs of one MLM training sequence (train = 3x forward):
    per token per layer qkv 6d² + proj 2d² + MLP 4 d ff; attention
    4 S² d per layer; the head's transform 2d² and tied projection 2dV at
    each predicted position (S on the dense path, ``n_pred`` gathered).
    The live-MFU input: ``hvd.metrics.set_step_flops(batch *
    bert.train_flops_per_seq(cfg))``."""
    d, ff, L, s, v = (cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.seq_len,
                      cfg.vocab_size)
    enc = s * L * (8.0 * d * d + 4.0 * d * ff)
    attn = L * 4.0 * s * s * d
    pos = s if n_pred is None else n_pred
    head = pos * (2.0 * d * d + 2.0 * d * v)
    return 3.0 * (enc + attn + head)
