"""Flagship model: decoder-only Transformer LM composed with dp / pp / tp /
sp / ep (port of horovod_tpu/models/transformer.py, training).

The parameter tree and shapes are the reference's (``init_params``,
transformer.py:79-123): layer weights stacked as (n_pp, layers_per_stage,
…), in the (in, out) layout of its einsums, with ``wqkv``'s fused output
dim laid out (heads, 3, head_dim), heads outermost.  ``Transformer`` holds
that tree as parameters, so its ``state_dict`` keys are the tree's paths
(``embed``, ``layers.wqkv``, …) and ``convert.params_from_jax`` loads the
reference's parameters into it.

Two ways to train it:

* **data parallel** (``make_train_step(cfg, par, model, optimizer)``):
  every rank holds the whole tree, runs the serial forward on its rows
  and ``DistributedOptimizer`` (or ZeRO) averages the gradients over the
  world.  Dense MLPs only.
* **on a (dp, pp, mp) mesh** (``Transformer(cfg, par, mesh=)``, a
  ``DeviceMesh`` with those dimension names, then the same
  ``make_train_step`` with a plain optimizer): every rank holds its shard
  of the tree by ``param_specs`` and runs ``forward_loss``, the
  reference's per-device
  body: batch over dp, GPipe or 1F1B microbatches over pp, Megatron
  tp + SP (or ring / Ulysses attention) over mp, MoE experts over dp.
  ``make_loss_fn`` differentiates it as the reference differentiates its
  ``shard_map`` from outside: the loss's cotangent is divided by the
  mesh size and each parameter's gradient is summed over the mesh axes
  its spec leaves unnamed, so after ``loss.backward()`` every shard holds
  the reference's gradient of that shard.

Compute dtype defaults to bfloat16; normalization, softmax, logits and
loss are fp32, with the tied fp32 embedding as the vocab head.
``remat=True`` (the reference's default) recomputes each layer in the
backward.

Serving (``serving/`` builds its engine on them): ``init_kv_pages``, a
paged KV pool updated in place; ``prefill`` (one prompt, its attention
the ``flash_fwd`` kernel on a CUDA tensor), ``decode_step`` (every slot
one token) and ``decode_verify`` (every slot K tokens: chunked prefill,
prefix-cache suffixes, speculative verify), whose attention over the
gathered pages is torch ops, as the reference's is ``jnp``; the draft
helpers and ``decode_flops_per_token``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..core.basics import DeviceLike, resolve_device
from ..ops.collective import Average, allreduce
from ..parallel import moe as moe_lib
from ..parallel import pipeline as pp_lib
from ..parallel import ring_attention as ra
from ..parallel import tensor_parallel as tp
from ..parallel.ulysses import ulysses_attention
from . import _mesh

AXES = ("dp", "pp", "mp")
_NEG_INF = -1e30


class TransformerConfig(NamedTuple):
    vocab_size: int = 32768
    d_model: int = 512
    n_heads: int = 8
    d_ff: int = 2048
    n_layers: int = 8
    seq_len: int = 512
    n_experts: int = 0            # 0 → dense MLP; >0 → switch MoE
    capacity_factor: float = 1.25
    attn_mode: str = "megatron"   # "megatron" (tp heads) | "ring" | "ulysses" (sp)
    dtype: Any = torch.bfloat16
    remat: bool = True
    top_k: int = 1                # MoE routes per token

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


class ParallelConfig(NamedTuple):
    """The mesh's (dp, pp, mp) and the pipeline's microbatching.  The
    data-parallel path (no mesh) reads none of it: its width is the
    world size of ``init()``."""
    dp: int = 1
    pp: int = 1
    mp: int = 1                   # shared tensor/sequence axis
    n_microbatches: int = 1
    pp_schedule: str = "gpipe"    # "gpipe" | "1f1b" (bounded-stash backward)

    @property
    def axis_names(self) -> Tuple[str, str, str]:
        return AXES


def init_params(cfg: TransformerConfig, par: Optional[ParallelConfig] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
    """The full (unsharded) parameter tree, fp32 on the CPU, drawn from
    ``generator``: normal(0, 0.02) weights, output projections scaled by
    1/sqrt(2 n_layers), ones for the norms (reference init_params)."""
    par = par or ParallelConfig()
    d, ff, v, s = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.seq_len
    h, hd = cfg.n_heads, cfg.head_dim
    n_pp = par.pp
    if cfg.n_layers % n_pp != 0:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by pp {n_pp}")
    lps = cfg.n_layers // n_pp
    std = 0.02
    out_std = std / math.sqrt(2 * cfg.n_layers)

    def rand(*shape, scale=std):
        return torch.randn(shape, generator=generator) * scale

    params = {
        "embed": rand(v, d),
        "pos": rand(s, d),
        "final_norm": torch.ones(d),
        "layers": {
            "ln1": torch.ones(n_pp, lps, d),
            "ln2": torch.ones(n_pp, lps, d),
            "wqkv": rand(n_pp, lps, d, 3 * h * hd),
            "wo": rand(n_pp, lps, h * hd, d, scale=out_std),
        },
    }
    layers = params["layers"]
    if cfg.n_experts > 0:
        if cfg.n_experts % par.dp != 0:
            raise ValueError("n_experts must be divisible by dp (=ep) degree")
        e = cfg.n_experts
        layers["gate"] = rand(n_pp, lps, d, e)
        layers["w_in"] = rand(n_pp, lps, e, d, ff)
        layers["w_out"] = rand(n_pp, lps, e, ff, d, scale=out_std)
    else:
        layers["w1"] = rand(n_pp, lps, d, ff)
        layers["w2"] = rand(n_pp, lps, ff, d, scale=out_std)
    return params


def param_specs(cfg: TransformerConfig, par: ParallelConfig
                ) -> Dict[str, Any]:
    """The tree of ``init_params`` with, per leaf, the mesh axis that
    shards each of its dims (None: not sharded): the reference's
    PartitionSpecs as tuples."""
    megatron = cfg.attn_mode == "megatron"
    layers: Dict[str, Any] = {
        "ln1": ("pp",),
        "ln2": ("pp",),
        # Megatron: qkv column-parallel (heads over mp), wo row-parallel.
        # Ring/Ulysses: attention weights replicated over mp.
        "wqkv": ("pp", None, None, "mp") if megatron else ("pp",),
        "wo": ("pp", None, "mp", None) if megatron else ("pp",),
    }
    if cfg.n_experts > 0:
        layers["gate"] = ("pp",)
        layers["w_in"] = ("pp", None, "dp", None, None)   # experts over dp
        layers["w_out"] = ("pp", None, "dp", None, None)
    else:
        layers["w1"] = ("pp", None, None, "mp")
        layers["w2"] = ("pp", None, "mp", None)
    return {"embed": (), "pos": (), "final_norm": (), "layers": layers}


# ---------------------------------------------------------------------------
# The mesh: this rank's place on it, its shards of the tree
# ---------------------------------------------------------------------------

class _Axes(_mesh.MeshAxes):
    """This rank's place on a (dp, pp, mp) mesh: each axis's process
    group, size and this rank's index on it."""

    def __init__(self, mesh):
        super().__init__(mesh, AXES)

    def check(self, par: ParallelConfig) -> None:
        want = dict(dp=par.dp, pp=par.pp, mp=par.mp)
        if self.size != want:
            raise ValueError(f"the mesh is {self.size}, the config {want}")


_leaves = _mesh.leaves
_map = _mesh.map_tree


def _tree(params) -> Dict[str, Any]:
    """The parameter tree of a ``Transformer`` (or a tree itself)."""
    if isinstance(params, Transformer):
        return {"embed": params.embed, "pos": params.pos,
                "final_norm": params.final_norm,
                "layers": dict(params.layers.items())}
    return params


def shard_params(cfg: TransformerConfig, par: ParallelConfig,
                 tree: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's shard of the full tree (``init_params``' or
    ``convert.params_from_jax``'s, nested): each dim a spec names cut into
    the axis's size and the chunk at this rank's coordinate taken."""
    ax = _Axes(mesh)
    ax.check(par)
    return _mesh.shard_tree(tree, param_specs(cfg, par), ax)


def gather_params(cfg: TransformerConfig, par: ParallelConfig, shards,
                  mesh) -> Dict[str, Any]:
    """The inverse of :func:`shard_params`: every rank gets the full tree
    (all-gathers over the axes each spec names).  ``shards`` is a tree or
    a ``Transformer``; gradients gather with ``{k: p.grad}`` trees."""
    ax = _Axes(mesh)
    ax.check(par)
    return _mesh.gather_tree(_tree(shards), param_specs(cfg, par), ax)


class Transformer(nn.Module):
    """The parameter tree of ``init_params`` as an ``nn.Module`` (with
    ``mesh``, this rank's shard of it).

    ``forward(tokens)`` gives fp32 logits, ``forward(tokens, labels)`` the
    mean next-token cross entropy; on a mesh only the latter, through
    ``make_loss_fn`` (tokens and labels this rank's dp rows).
    """

    def __init__(self, cfg: TransformerConfig,
                 par: Optional[ParallelConfig] = None, *, seed: int = 0,
                 device: DeviceLike = None, mesh=None):
        super().__init__()
        self.cfg, self.par, self.mesh = cfg, par or ParallelConfig(), mesh
        dev = resolve_device(device)
        tree = init_params(cfg, self.par,
                           torch.Generator().manual_seed(seed))
        if mesh is not None:
            tree = shard_params(cfg, self.par, tree, mesh)
        self.embed = nn.Parameter(tree["embed"].to(dev))
        self.pos = nn.Parameter(tree["pos"].to(dev))
        self.final_norm = nn.Parameter(tree["final_norm"].to(dev))
        self.layers = nn.ParameterDict(
            {k: nn.Parameter(t.to(dev)) for k, t in tree["layers"].items()})

    def forward(self, tokens: torch.Tensor,
                labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.mesh is not None:
            if labels is None:
                raise ValueError("on a mesh the model computes the loss: "
                                 "pass labels")
            return make_loss_fn(self.cfg, self.par, self.mesh)(
                self, tokens, labels)
        if labels is None:
            return serial_forward_logits(self.cfg, self, tokens)
        return serial_forward_loss(self.cfg, self, tokens, labels)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)


def _split_heads(qkv: torch.Tensor, head_dim: int):
    """q, k, v of a fused projection (b, s, heads * 3 * head_dim), heads
    outermost: strided views, which the kernels read in place."""
    b, s = qkv.shape[:2]
    qkv = qkv.view(b, s, qkv.shape[-1] // (3 * head_dim), 3, head_dim)
    return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]


def _attention_block(cfg: TransformerConfig, lp: Dict[str, torch.Tensor],
                     x: torch.Tensor) -> torch.Tensor:
    """Pre-norm causal self-attention; returns the residual branch.  ``lp``
    holds the layer's weights, matmul weights already in x's dtype."""
    h = _rmsnorm(x, lp["ln1"])
    q, k, v = _split_heads(h @ lp["wqkv"], cfg.head_dim)
    o = ra.full_attention(q, k, v, causal=True)
    return o.reshape(*x.shape[:2], -1) @ lp["wo"]


def _mlp_block(cfg: TransformerConfig, lp: Dict[str, torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
    h = _rmsnorm(x, lp["ln2"])
    # jax.nn.gelu defaults to the tanh approximation; PyTorch's to erf.
    u = F.gelu(h @ lp["w1"], approximate="tanh")
    return u @ lp["w2"]


def _mesh_attention_block(cfg: TransformerConfig, ax: _Axes,
                          lp: Dict[str, torch.Tensor],
                          x: torch.Tensor) -> torch.Tensor:
    """x: (mb, s_local, d), sequence-sharded over mp.  Megatron gathers
    the sequence, runs its heads and reduce-scatters the sequence back;
    ring and Ulysses keep the sequence sharded through attention."""
    mp = ax.group["mp"]
    h = _rmsnorm(x, lp["ln1"])
    if cfg.attn_mode == "megatron":
        hg = tp.gather_sequence(h, mp, dim=1)                 # (mb, S, d)
        q, k, v = _split_heads(tp.column_parallel(hg, lp["wqkv"]),
                               cfg.head_dim)
        o = ra.full_attention(q, k, v, causal=True)
        return tp.row_parallel(o.reshape(*hg.shape[:2], -1), lp["wo"], mp,
                               scatter_sequence=True)
    q, k, v = _split_heads(h @ lp["wqkv"], cfg.head_dim)
    if cfg.attn_mode == "ulysses":
        o = ulysses_attention(q, k, v, mp, causal=True)
    elif cfg.attn_mode == "ring":
        o = ra.ring_attention(q, k, v, mp, causal=True)
    else:
        raise ValueError(f"unknown attn_mode {cfg.attn_mode!r} "
                         "(megatron | ring | ulysses)")
    return o.reshape(*x.shape[:2], -1) @ lp["wo"]


def _mesh_mlp_block(cfg: TransformerConfig, ax: _Axes,
                    lp: Dict[str, torch.Tensor],
                    x: torch.Tensor) -> torch.Tensor:
    h = _rmsnorm(x, lp["ln2"])
    if cfg.n_experts > 0:
        mb, s_local, d = h.shape
        params = moe_lib.MoEParams(gate=lp["gate"].float(), w_in=lp["w_in"],
                                   w_out=lp["w_out"])
        y = moe_lib.moe_layer(params, h.reshape(mb * s_local, d),
                              ax.group["dp"],
                              capacity_factor=cfg.capacity_factor,
                              top_k=cfg.top_k)
        return y.reshape(mb, s_local, d).to(x.dtype)
    mp = ax.group["mp"]
    hg = tp.gather_sequence(h, mp, dim=1)
    u = F.gelu(tp.column_parallel(hg, lp["w1"]), approximate="tanh")
    return tp.row_parallel(u, lp["w2"], mp, scatter_sequence=True)


_MATMUL_WEIGHTS = ("wqkv", "wo", "w1", "w2")


def _layer_params(stacks: Dict[str, torch.Tensor], dtype):
    """Per-layer parameter dicts of (n_layers, …) stacks, the dense matmul
    weights cast to the compute dtype: one cast and one unbind per stacked
    tensor (whose backward is one cast and one stack), not one of each per
    layer.  MoE weights stay fp32, as the reference's moe_layer takes
    them."""
    per = {k: (t.to(dtype) if k in _MATMUL_WEIGHTS else t).unbind(0)
           for k, t in stacks.items()}
    n = len(next(iter(per.values())))
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


def _run_layers(cfg: TransformerConfig, layer_fn, layers, x):
    """``layer_fn(lp, x)`` over the layers, each recomputed in the
    backward under ``cfg.remat``."""
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in layers:
        if remat:
            x = torch.utils.checkpoint.checkpoint(layer_fn, lp, x,
                                                  use_reentrant=False)
        else:
            x = layer_fn(lp, x)
    return x


# ---------------------------------------------------------------------------
# The data-parallel path: the serial forward on every rank
# ---------------------------------------------------------------------------

def serial_forward_logits(cfg: TransformerConfig, model: Transformer,
                          tokens: torch.Tensor) -> torch.Tensor:
    """Training-path forward of the whole tree: fp32 logits (B, S, V).
    Dense MLP only, as the reference's serial oracle."""
    if cfg.n_experts:
        raise ValueError("the serial forward covers the dense configuration;"
                         " MoE runs on a (dp, pp, mp) mesh (mesh=)")

    def layer(lp, x):
        x = x + _attention_block(cfg, lp, x)
        return x + _mlp_block(cfg, lp, x)

    s_in = tokens.shape[1]
    x = (model.embed[tokens] + model.pos[None, :s_in]).to(cfg.dtype)
    stacks = {k: t.flatten(0, 1) for k, t in model.layers.items()}
    x = _run_layers(cfg, layer, _layer_params(stacks, cfg.dtype), x)
    return _head(model, x)


def serial_forward_loss(cfg: TransformerConfig, model: Transformer,
                        tokens: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy, fp32."""
    logits = serial_forward_logits(cfg, model, tokens)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def _dp_mean(local: torch.Tensor) -> torch.Tensor:
    """``local``'s value averaged over the world, its gradient its own."""
    # local - local.detach() is exactly 0, so every rank holds the same
    # value, bit for bit.  The wire is exact whatever the session's
    # compression knob says, as the reference's compiled pmean is.
    return allreduce(local.detach(), op=Average, compression="none") + \
        (local - local.detach())


def _check_data_parallel(par: ParallelConfig) -> None:
    if par.pp != 1 or par.mp != 1:
        raise ValueError(f"pp={par.pp}, mp={par.mp}: pipeline and tensor "
                         "parallelism run on a (dp, pp, mp) mesh (mesh=)")


# ---------------------------------------------------------------------------
# The mesh path: the reference's per-device body
# ---------------------------------------------------------------------------

_pmean = _mesh.pmean


def _make_stage_fn(cfg: TransformerConfig, ax: _Axes):
    """stage_fn(stage_params, act) over this stage's layers."""

    def layer(lp, act):
        act = act + _mesh_attention_block(cfg, ax, lp, act)
        return act + _mesh_mlp_block(cfg, ax, lp, act)

    def stage_fn(stage_params, act):
        return _run_layers(cfg, layer,
                           _layer_params(stage_params, cfg.dtype), act)

    return stage_fn


def _mesh_forward_loss(cfg: TransformerConfig, par: ParallelConfig,
                       ax: _Axes, params: Dict[str, Any],
                       tokens: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    mp_size = ax.size["mp"]
    if cfg.seq_len % mp_size:
        raise ValueError(f"seq_len {cfg.seq_len} does not divide over "
                         f"mp={mp_size}")
    s_local = cfg.seq_len // mp_size
    lo = ax.index["mp"] * s_local
    seq = slice(lo, lo + s_local)
    # This mp member's sequence chunk of the (replicated) embedding.
    x = (params["embed"][tokens[:, seq]] + params["pos"][None, seq]).to(
        cfg.dtype)

    xs = pp_lib.stack_microbatches(x, par.n_microbatches)
    stage_params = {k: v[0] for k, v in params["layers"].items()}
    stage_fn = _make_stage_fn(cfg, ax)
    if par.pp_schedule == "1f1b":
        out = pp_lib.pipeline_apply_1f1b(stage_fn, stage_params, xs,
                                         ax.group["pp"])
    elif par.pp_schedule == "gpipe":
        out = pp_lib.pipeline_apply(stage_fn, stage_params, xs,
                                    ax.group["pp"], remat=cfg.remat)
    else:
        raise ValueError(
            f"unknown pp_schedule {par.pp_schedule!r} (gpipe | 1f1b)")
    hidden = _rmsnorm(pp_lib.unstack_microbatches(out),
                      params["final_norm"])
    logits = hidden.float() @ params["embed"].float().t()
    loss_local = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                 labels[:, seq].reshape(-1))
    # Mean over sequence chunks (mp) and batch shards (dp); the loss is
    # valid only on the last pipeline stage: a masked psum over pp.
    loss = _pmean(_pmean(loss_local, ax.group["mp"]), ax.group["dp"])
    if ax.size["pp"] == 1:
        return loss
    mask = pp_lib.last_stage_mask(ax.group["pp"], device=loss.device)
    return tp.psum(loss * mask, ax.group["pp"])


def forward_loss(cfg: TransformerConfig, par: ParallelConfig, model,
                 tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Without a mesh: the loss averaged over the data-parallel ranks,
    as the reference's ``pmean`` over dp gives it (transformer.py:280).
    Its value is the dp mean; its gradient is this rank's own, so
    ``DistributedOptimizer`` averages the gradients once, as before, and
    the update is the reference's.  At world 1 the value is the rank's
    loss.

    ``model`` a mesh ``Transformer``: the reference's per-device body on
    its shards, on ``model.mesh``, and this rank's dp rows: the
    replicated scalar loss.  Differentiate it through ``make_loss_fn``."""
    if getattr(model, "mesh", None) is not None:
        ax = _Axes(model.mesh)
        ax.check(par)
        return _mesh_forward_loss(cfg, par, ax, _tree(model), tokens, labels)
    _check_data_parallel(par)
    return _dp_mean(serial_forward_loss(cfg, model, tokens, labels))


def make_loss_fn(cfg: TransformerConfig, par: ParallelConfig, mesh
                 ) -> Callable:
    """``loss_of(params, tokens, labels)``: the per-rank body of
    :func:`forward_loss` on ``mesh``, differentiable as the reference's
    ``shard_map`` (check_vma=False) is from outside.  ``params``: a mesh
    ``Transformer`` built on ``mesh`` or a shard tree cut for it
    (``shard_params``); tokens and labels: this rank's dp rows, int64
    (B / dp, seq_len).  After ``loss.backward()`` each shard's ``.grad``
    is the reference's gradient of that shard: the local cotangent
    1/(dp·mp) on the last stage, and every gradient summed over the axes
    its spec leaves unnamed."""
    ax = _Axes(mesh)
    ax.check(par)
    specs = param_specs(cfg, par)

    def loss_of(params, tokens, labels):
        if isinstance(params, Transformer) and (
                params.mesh is None or params.mesh != mesh):
            raise ValueError("the model's shards were cut for another mesh "
                             f"({params.mesh}), not {mesh}")
        local = _mesh.enter_tree(_tree(params), specs, ax)
        loss = _mesh_forward_loss(cfg, par, ax, local, tokens, labels)
        return _mesh.leave(loss, ax)

    return loss_of


def make_train_step(cfg: TransformerConfig, par: ParallelConfig,
                    model: Transformer, optimizer) -> Callable:
    """``train_step(tokens, labels) -> loss``: forward, backward and one
    optimizer step.

    ``model.mesh`` None: the data-parallel step.
    The loss returned is the dp mean of ``forward_loss``, detached, the
    same on every rank, as the reference's ``train_step`` returns it.
    ``optimizer`` is a ``DistributedOptimizer`` (or any optimizer) over
    ``model``'s parameters, updated in place, or a ``ZeroShardedOptimizer``
    built on ``model``: at stage 2 the step reduces the gradients into
    shards before the update; at stage 3 the forward runs on the gathered
    parameters (``torch.func.functional_call``) and the step updates the
    shards, not ``model``'s own parameters.

    On a mesh (``model.mesh``, the one its shards were cut for; the
    reference's ``mesh`` argument has no counterpart, as the module holds
    it): ``model`` holds this rank's shards, tokens and labels are its dp
    rows, and ``optimizer`` is a plain torch optimizer over the shards
    (the gradients are already the reference's, reduced by
    ``make_loss_fn``), as the reference steps optax on its sharded tree."""
    if model.mesh is not None:
        loss_of = make_loss_fn(cfg, par, model.mesh)

        def mesh_step(tokens: torch.Tensor, labels: torch.Tensor):
            optimizer.zero_grad(set_to_none=True)
            loss = loss_of(model, tokens, labels)
            loss.backward()
            optimizer.step()
            return loss.detach()

        return mesh_step

    from ..optimizers import ZeroShardedOptimizer
    _check_data_parallel(par)
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


def _mlp_flops_per_token(cfg: TransformerConfig) -> float:
    """Per-token per-layer MLP matmul-FLOPs: dense 4 d ff; MoE routes
    top_k experts per token (top_k · 4 d ff) plus the 2 d E gate."""
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.n_experts > 0:
        return cfg.top_k * 4.0 * d * ff + 2.0 * d * cfg.n_experts
    return 4.0 * d * ff


def train_flops_per_seq(cfg: TransformerConfig) -> float:
    """Matmul-FLOPs for one causal-LM training sequence (train = 3x fwd):
    per token 8d^2 (qkv + proj) + the MLP's per layer + 2dV vocab head;
    causal attention 2 S^2 d per layer per sequence."""
    d, L, s, v = cfg.d_model, cfg.n_layers, cfg.seq_len, cfg.vocab_size
    dense = s * (L * (8.0 * d * d + _mlp_flops_per_token(cfg)) + 2.0 * d * v)
    attn = L * 2.0 * s * s * d
    return 3.0 * (dense + attn)


# ---------------------------------------------------------------------------
# Serving: prefill / decode over a paged KV cache (reference :380-708)
# ---------------------------------------------------------------------------
#
# The KV pool is ``{"k", "v"}``, each (n_layers, n_pages, page_size,
# n_heads, head_dim) in the compute dtype, updated IN PLACE (the reference
# donates it through every call and takes the result back).  Physical
# page 0 is the scratch page: unallocated page-table entries and inactive
# slots point at it, and it is never read unmasked, so it may hold any
# writer's values.
#
# JAX clamps an out-of-range gather index and drops an out-of-range
# scatter update; PyTorch raises (on CUDA a device-side assert, which
# kills the process).  Each place the reference leans on that is clamped
# here explicitly: token and position rows (``_rows``), the write page of
# a slot whose length has reached the table's extent (routed to scratch
# page 0, where the reference drops the write), and ``decode_verify``'s
# positions past the table (page 0, as the reference routes them).
#
# Numerics as the reference's: scores, softmax and PV in fp32 (masked
# scores -1e30), normalization and the vocab head fp32, cache pages in
# the compute dtype.  ``prefill``'s attention is ``full_attention``: the
# ``flash_fwd`` kernel on a CUDA tensor.

def init_kv_pages(cfg: TransformerConfig, n_pages: int, page_size: int,
                  device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The paged KV pool, zeros: ``k``/``v`` of shape (n_layers, n_pages,
    page_size, n_heads, head_dim) in the compute dtype on ``device``."""
    shape = (cfg.n_layers, int(n_pages), int(page_size), cfg.n_heads,
             cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def _flat_layers(params) -> Dict[str, torch.Tensor]:
    """The (n_pp, layers_per_stage, ...) layer stacks as (n_layers, ...)."""
    return {k: v.reshape((-1,) + tuple(v.shape[2:]))
            for k, v in _tree(params)["layers"].items()}


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` with JAX's gather semantics: a negative index counts
    from the end, then every index is clamped into range."""
    n = table.shape[0]
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return table[idx]


def _moe_mlp_serving(cfg: TransformerConfig, lp: Dict[str, torch.Tensor],
                     tok: torch.Tensor) -> torch.Tensor:
    """Per-token routed MoE MLP for serving, (T, d) → (T, d): fp32 router
    softmax, top-k (ties to the lower expert, as ``lax.top_k``), the raw
    top-k probabilities as combine weights, every expert evaluated, no
    capacity clamp (reference :427-456)."""
    e = cfg.n_experts
    tf = tok.float()
    probs = torch.softmax(tf @ lp["gate"].float(), dim=-1)       # (T, E)
    top_p, top_i = moe_lib._top_k(probs, cfg.top_k)
    w = torch.zeros_like(probs)
    for j in range(cfg.top_k):
        w = w + F.one_hot(top_i[:, j], e).to(probs.dtype) * top_p[:, j:j + 1]
    h = F.gelu(torch.einsum("td,edf->tef", tf, lp["w_in"].float()),
               approximate="tanh")
    y = torch.einsum("tef,efd->ted", h, lp["w_out"].float())
    return torch.einsum("te,ted->td", w, y).to(tok.dtype)


def _serving_layers(cfg: TransformerConfig, params):
    """Per-layer weights: dense matmul weights in the compute dtype (one
    cast a stack), the rest as stored."""
    return _layer_params(_flat_layers(params), cfg.dtype)


def _mlp(cfg: TransformerConfig, lp: Dict[str, torch.Tensor],
         x: torch.Tensor) -> torch.Tensor:
    """The MLP branch on (..., d): dense, or MoE routed per token."""
    if cfg.n_experts == 0:
        return _mlp_block(cfg, lp, x)
    h = _rmsnorm(x, lp["ln2"])
    return _moe_mlp_serving(cfg, lp, h.reshape(-1, h.shape[-1])
                            ).reshape(h.shape)


def _head(params, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits of the final-normed hidden states (the tied embed)."""
    tree = _tree(params)
    hidden = _rmsnorm(x, tree["final_norm"])
    return hidden.float() @ tree["embed"].float().t()


@torch.no_grad()
def prefill(cfg: TransformerConfig, params, tokens: torch.Tensor, length,
            kv: Dict[str, torch.Tensor], page_rows: torch.Tensor
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The causal forward over one padded prompt, writing K/V into the
    cache.  tokens: (S,) int, S a multiple of the page size (padding past
    ``length`` is arbitrary: causality keeps it out of every valid
    position's context); 1 <= length <= S; page_rows: (S // page_size,)
    physical pages receiving positions [0, S).  Returns (fp32 logits (V,)
    at position length - 1, kv)."""
    tree = _tree(params)
    s = tokens.shape[0]
    page_size = kv["k"].shape[2]
    n_rows, hd = s // page_size, cfg.head_dim
    x = (_rows(tree["embed"], tokens) + tree["pos"][:s]).to(cfg.dtype)[None]
    for l, lp in enumerate(_serving_layers(cfg, tree)):
        h = _rmsnorm(x, lp["ln1"])
        q, k, v = _split_heads(h @ lp["wqkv"], hd)
        kv["k"][l, page_rows] = k[0].reshape(n_rows, page_size,
                                             cfg.n_heads, hd)
        kv["v"][l, page_rows] = v[0].reshape(n_rows, page_size,
                                             cfg.n_heads, hd)
        o = ra.full_attention(q, k, v, causal=True)
        x = x + o.reshape(1, s, -1) @ lp["wo"]
        x = x + _mlp(cfg, lp, x)
    # lax.dynamic_index_in_dim clamps the index into range.
    last = min(max(int(length) - 1, 0), s - 1)
    return _head(tree, x[0, last]), kv


def _paged_attention(cfg: TransformerConfig, kv, l: int, q: torch.Tensor,
                     page_tables: torch.Tensor, mask: torch.Tensor
                     ) -> torch.Tensor:
    """q (B, K, H, hd) against each slot's gathered pages (after this
    call's writes); mask (B, K, max_len).  fp32 inside; (B, K, H, hd) out
    in q's dtype."""
    b = page_tables.shape[0]
    k_ctx = kv["k"][l][page_tables].reshape(b, -1, cfg.n_heads,
                                            cfg.head_dim)
    v_ctx = kv["v"][l][page_tables].reshape(b, -1, cfg.n_heads,
                                            cfg.head_dim)
    scale = 1.0 / (cfg.head_dim ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_ctx.float()) * scale
    s = s.masked_fill(~mask[:, None], _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v_ctx.float()).to(q.dtype)


def _paged_forward(cfg: TransformerConfig, params, tokens: torch.Tensor,
                   pos: torch.Tensor, write_page: torch.Tensor,
                   write_off: torch.Tensor, kv, page_tables: torch.Tensor
                   ) -> torch.Tensor:
    """The decode / verify body: tokens, pos, write_page, write_off all
    (B, K).  Each layer writes this call's K/V, then gathers (so a token
    attends to itself).  The mask reads ``pos`` as given, the positional
    table its clamped row.  Returns fp32 logits (B, K, V)."""
    tree = _tree(params)
    b, kq = tokens.shape
    hd = cfg.head_dim
    max_len = page_tables.shape[1] * kv["k"].shape[2]
    x = (_rows(tree["embed"], tokens) + _rows(tree["pos"], pos)).to(
        cfg.dtype)                                        # (B, K, d)
    k_pos = torch.arange(max_len, device=pos.device)
    mask = k_pos[None, None, :] <= pos[:, :, None]        # (B, K, max_len)
    for l, lp in enumerate(_serving_layers(cfg, tree)):
        h = _rmsnorm(x, lp["ln1"])
        q, k, v = _split_heads(h @ lp["wqkv"], hd)
        kv["k"][l, write_page, write_off] = k
        kv["v"][l, write_page, write_off] = v
        o = _paged_attention(cfg, kv, l, q, page_tables, mask)
        x = x + o.reshape(b, kq, -1) @ lp["wo"]
        x = x + _mlp(cfg, lp, x)
    return _head(tree, x)


@torch.no_grad()
def decode_step(cfg: TransformerConfig, params, tokens: torch.Tensor,
                lengths: torch.Tensor, kv: Dict[str, torch.Tensor],
                page_tables: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Advance every slot by one token against its paged cache.  tokens:
    (B,) the token each slot consumes (written at position lengths[b]);
    lengths: (B,) context sizes before the step; page_tables: (B,
    pages_per_slot), position p of slot b in page page_tables[b, p //
    page_size] at offset p % page_size.  Returns (fp32 logits (B, V), kv).
    Inactive slots point their row at scratch page 0.

    A slot whose length has reached the table's extent has no page to
    write: the reference's fill-mode gather makes its write page invalid
    and the scatter drops it; here it goes to scratch page 0.  Its
    position row is clamped, as JAX's gather clamps it."""
    page_size = kv["k"].shape[2]
    n_pages = page_tables.shape[1]
    lengths = lengths.long()
    idx = lengths // page_size
    page = page_tables.long().gather(1, idx.clamp(max=n_pages - 1)[:, None])
    page = torch.where(idx[:, None] < n_pages, page, 0)
    pos = lengths[:, None]
    logits = _paged_forward(cfg, params, tokens.long()[:, None], pos, page,
                            pos % page_size, kv, page_tables.long())
    return logits[:, 0], kv


@torch.no_grad()
def decode_verify(cfg: TransformerConfig, params, tokens: torch.Tensor,
                  lengths: torch.Tensor, kv: Dict[str, torch.Tensor],
                  page_tables: torch.Tensor
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Advance every slot by K tokens in one forward (chunked prefill,
    prefix-cache suffix prefill, speculative verify).  tokens: (B, K),
    token j of slot b written at position lengths[b] + j.  Returns (fp32
    logits (B, K, V), kv); logits[b, j] predicts the token after
    tokens[b, j].  Positions past a caller's valid chunk write K/V that
    stays masked until rewritten; positions at or past the table's extent
    write to scratch page 0 and read the last position row, as the
    reference routes them."""
    b, kq = tokens.shape
    n_pages = page_tables.shape[1]
    page_size = kv["k"].shape[2]
    max_len = n_pages * page_size
    tables = page_tables.long()
    pos = lengths.long()[:, None] + torch.arange(kq, device=tables.device)
    pos_c = pos.clamp(max=max_len - 1)
    page = tables.gather(1, pos_c // page_size)
    page = torch.where(pos < max_len, page, 0)
    return _paged_forward(cfg, params, tokens.long(), pos, page,
                          pos_c % page_size, kv, tables), kv


def draft_config(cfg: TransformerConfig, n_layers: int) -> TransformerConfig:
    """The speculative draft's config: the target's geometry at a
    layer-prefix depth (same vocab and positional table)."""
    if not (0 < n_layers <= cfg.n_layers):
        raise ValueError(
            f"draft n_layers {n_layers} not in 1..{cfg.n_layers}")
    return cfg._replace(n_layers=n_layers, remat=False)


def draft_params_from(params, n_layers: int) -> Dict[str, Any]:
    """The target's tree cut to its first ``n_layers`` layers, restacked
    as one stage, for :func:`draft_config`; the embeddings, positional
    table and final norm are shared, not copied."""
    tree = _tree(params)
    flat = _flat_layers(tree)
    total = next(iter(flat.values())).shape[0]
    if not (0 < n_layers <= total):
        raise ValueError(f"draft n_layers {n_layers} not in 1..{total}")
    out = dict(tree)
    out["layers"] = {k: v[:n_layers][None] for k, v in flat.items()}
    return out


def decode_flops_per_token(cfg: TransformerConfig, context: int) -> float:
    """Matmul-FLOPs of one decode step of one sequence at ``context``:
    projections, the vocab head and the query against the context (MoE:
    the routed top_k experts, not the all-experts product evaluated)."""
    d, L, v = cfg.d_model, cfg.n_layers, cfg.vocab_size
    dense = L * (8.0 * d * d + _mlp_flops_per_token(cfg)) + 2.0 * d * v
    return dense + L * 4.0 * context * d
