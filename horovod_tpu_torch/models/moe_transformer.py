"""The MoE workload: a decoder LM trained over a (dp, ep) mesh (port of
horovod_tpu/models/moe_transformer.py).

Expert parallelism as a mesh dimension of its own: ``ep`` owns the
experts, tokens cross it through the capacity-bounded all-to-all
dispatch and combine of ``parallel.moe.moe_layer``, and the loss carries
the router's load-balancing term and dropped-route accounting as
replicated step metrics.

Layout (the GShard arrangement): the batch sharded over the product of
``("dp", "ep")`` (the rank at (i, j) holds rows block i·ep + j); the
expert weights ``w_in``/``w_out`` over ``ep`` only (replicated over dp);
everything else replicated.  The dispatch may ride the int8/int4
block-scaled wire (``dispatch_bits``), differentiable as the reference's
(its gradient flows through the block scales); the combine accumulates
in fp32.  Attention is causal through ``full_attention``: bf16 at
head_dim 64 runs the three flash kernels in every layer.

``MoETransformer`` holds the reference's tree (layers stacked
``(n_layers, …)``, experts ``(n_layers, n_experts, …)``; on a mesh this
rank's shard), so ``convert.params_from_jax`` loads the reference's
parameters into it.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..core.basics import DeviceLike, resolve_device
from ..ops.quantization import QuantSpec
from ..parallel import moe as moe_lib
from ..parallel import ring_attention as ra
from ..parallel import tensor_parallel as tp
from . import _mesh
from . import transformer as tfm

AXES = ("dp", "ep")


class MoEConfig(NamedTuple):
    vocab_size: int = 32768
    d_model: int = 512
    n_heads: int = 8
    d_ff: int = 2048              # PER-EXPERT hidden width
    n_layers: int = 8
    seq_len: int = 512
    n_experts: int = 8
    top_k: int = 1
    capacity_factor: float = 1.25
    aux_weight: float = 0.01      # load-balancing loss coefficient
    dispatch_bits: int = 0        # 0 → fp32 wire; 8/4 → block-scaled
    dispatch_block: int = 256
    dtype: Any = torch.bfloat16
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def quant_spec(self) -> Optional[QuantSpec]:
        """The dispatch wire format, or None for fp32."""
        if self.dispatch_bits == 0:
            return None
        return QuantSpec(bits=self.dispatch_bits, block=self.dispatch_block)


class MoEParallelConfig(NamedTuple):
    dp: int = 1
    ep: int = 1

    @property
    def axis_names(self) -> Tuple[str, str]:
        return AXES


def init_params(cfg: MoEConfig, par: Optional[MoEParallelConfig] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
    """The full (unsharded) tree, fp32 on the CPU, from ``generator``:
    normal(0, 0.02) weights, output projections scaled by
    1/sqrt(2 n_layers), ones for the norms (the reference's init)."""
    par = par or MoEParallelConfig()
    d, ff, v, s, e = (cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.seq_len,
                      cfg.n_experts)
    h, hd, L = cfg.n_heads, cfg.head_dim, cfg.n_layers
    if e % par.ep != 0:
        raise ValueError(f"n_experts {e} not divisible by ep degree {par.ep}")
    std = 0.02

    def rand(*shape, scale=std):
        return torch.randn(shape, generator=generator) * scale

    return {
        "embed": rand(v, d),
        "pos": rand(s, d),
        "final_norm": torch.ones(d),
        "layers": {
            "ln1": torch.ones(L, d),
            "ln2": torch.ones(L, d),
            "wqkv": rand(L, d, 3 * h * hd),
            "wo": rand(L, h * hd, d, scale=std / math.sqrt(2 * L)),
            "gate": rand(L, d, e),
            "w_in": rand(L, e, d, ff),
            "w_out": rand(L, e, ff, d, scale=std / math.sqrt(2 * L)),
        },
    }


def param_specs(cfg: MoEConfig, par: MoEParallelConfig) -> Dict[str, Any]:
    """Per leaf, the mesh axis sharding each dim: experts over ``ep``, the
    rest replicated."""
    del cfg, par
    return {
        "embed": (), "pos": (), "final_norm": (),
        "layers": {"ln1": (), "ln2": (), "wqkv": (), "wo": (), "gate": (),
                   "w_in": (None, "ep"), "w_out": (None, "ep")},
    }


def _axes(par: MoEParallelConfig, mesh) -> _mesh.MeshAxes:
    ax = _mesh.MeshAxes(mesh, AXES)
    want = dict(dp=par.dp, ep=par.ep)
    if ax.size != want:
        raise ValueError(f"the mesh is {ax.size}, the config {want}")
    return ax


def shard_params(cfg: MoEConfig, par: MoEParallelConfig,
                 tree: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's shard of the full tree on a (dp, ep) mesh."""
    return _mesh.shard_tree(tree, param_specs(cfg, par), _axes(par, mesh))


def gather_params(cfg: MoEConfig, par: MoEParallelConfig, shards,
                  mesh) -> Dict[str, Any]:
    """The full tree on every rank (``shards`` a tree or a module)."""
    return _mesh.gather_tree(_tree(shards), param_specs(cfg, par),
                             _axes(par, mesh))


def _tree(params) -> Dict[str, Any]:
    if isinstance(params, MoETransformer):
        return {"embed": params.embed, "pos": params.pos,
                "final_norm": params.final_norm,
                "layers": dict(params.layers.items())}
    return params


class MoETransformer(nn.Module):
    """The tree of ``init_params`` as a module; with ``mesh`` (a (dp, ep)
    ``DeviceMesh``) this rank's shard of it, and ``forward(tokens,
    labels)`` gives ``(total loss, metrics)`` through ``make_loss_fn``.
    ``forward(tokens)`` gives the serial oracle's logits."""

    def __init__(self, cfg: MoEConfig, par: Optional[MoEParallelConfig] = None,
                 *, seed: int = 0, device: DeviceLike = None, mesh=None):
        super().__init__()
        self.cfg, self.par, self.mesh = cfg, par or MoEParallelConfig(), mesh
        dev = resolve_device(device)
        tree = init_params(cfg, self.par, torch.Generator().manual_seed(seed))
        if mesh is not None:
            tree = shard_params(cfg, self.par, tree, mesh)
        self.embed = nn.Parameter(tree["embed"].to(dev))
        self.pos = nn.Parameter(tree["pos"].to(dev))
        self.final_norm = nn.Parameter(tree["final_norm"].to(dev))
        self.layers = nn.ParameterDict(
            {k: nn.Parameter(t.to(dev)) for k, t in tree["layers"].items()})

    def forward(self, tokens: torch.Tensor,
                labels: Optional[torch.Tensor] = None):
        if labels is None:
            return serial_forward_logits(self.cfg, self, tokens)
        if self.mesh is None:
            raise ValueError("the MoE loss runs on a (dp, ep) mesh (mesh=)")
        return make_loss_fn(self.cfg, self.par, self.mesh)(self, tokens,
                                                           labels)


# ---------------------------------------------------------------------------
# The body
# ---------------------------------------------------------------------------

def _attention(cfg: MoEConfig, lp: Dict[str, torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
    """Local full-sequence causal attention; ``lp``'s matmul weights in
    x's dtype."""
    h = tfm._rmsnorm(x, lp["ln1"])
    q, k, v = tfm._split_heads(h @ lp["wqkv"], cfg.head_dim)
    o = ra.full_attention(q, k, v, causal=True)
    return o.reshape(*x.shape[:2], -1) @ lp["wo"]


def _layer(cfg: MoEConfig, group, lp: Dict[str, torch.Tensor],
           x: torch.Tensor):
    """One block: attention + the routed MoE MLP over ``group`` (the ep
    axis).  Returns (x, this layer's [aux_loss, dropped, routed])."""
    x = x + _attention(cfg, lp, x)
    h = tfm._rmsnorm(x, lp["ln2"])
    b, s, d = h.shape
    params = moe_lib.MoEParams(gate=lp["gate"].float(), w_in=lp["w_in"],
                               w_out=lp["w_out"])
    y, stats = moe_lib.moe_layer(
        params, h.reshape(b * s, d), group,
        capacity_factor=cfg.capacity_factor, top_k=cfg.top_k,
        quant=cfg.quant_spec(), return_stats=True)
    x = x + y.reshape(b, s, d).to(x.dtype)
    return x, torch.stack([stats.aux_loss, stats.dropped, stats.routed])


def _pmean2(x: torch.Tensor, ax: _mesh.MeshAxes) -> torch.Tensor:
    return _mesh.pmean(_mesh.pmean(x, ax.group["dp"]), ax.group["ep"])


def _psum2(x: torch.Tensor, ax: _mesh.MeshAxes) -> torch.Tensor:
    return tp.psum(tp.psum(x, ax.group["dp"]), ax.group["ep"])


def forward_loss(cfg: MoEConfig, par: MoEParallelConfig,
                 ax: _mesh.MeshAxes, params: Dict[str, Any],
                 tokens: torch.Tensor, labels: torch.Tensor
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The per-rank body on a (dp, ep) mesh.  tokens/labels: this rank's
    rows (B_local, S).  Returns (the replicated total loss, the replicated
    metrics): ``ce`` the mean cross entropy, ``aux`` the mean per-layer
    load-balancing loss, ``dropped``/``routed`` the step's global route
    counts.  Differentiate it through ``make_loss_fn``."""
    del par
    s_in = tokens.shape[1]
    x = (params["embed"][tokens] + params["pos"][None, :s_in]).to(cfg.dtype)
    layer = functools.partial(_layer, cfg, ax.group["ep"])
    remat = cfg.remat and torch.is_grad_enabled()
    per_layer = []
    for lp in tfm._layer_params(params["layers"], cfg.dtype):
        if remat:
            x, st = torch.utils.checkpoint.checkpoint(layer, lp, x,
                                                      use_reentrant=False)
        else:
            x, st = layer(lp, x)
        per_layer.append(st)
    per_layer = torch.stack(per_layer)                   # (L, 3)
    hidden = tfm._rmsnorm(x, params["final_norm"])
    logits = hidden.float() @ params["embed"].float().t()
    ll = F.log_softmax(logits, dim=-1).gather(-1, labels[..., None])[..., 0]
    ce = _pmean2(-ll.mean(), ax)
    # The aux loss comes from per-ep-member counts inside moe_layer:
    # averaged over the layers, then over the mesh.
    aux = _pmean2(per_layer[:, 0].mean(), ax)
    dropped = _psum2(per_layer[:, 1].sum().detach(), ax)
    routed = _psum2(per_layer[:, 2].sum().detach(), ax)
    total = ce + cfg.aux_weight * aux
    return total, {"ce": ce.detach(), "aux": aux.detach(),
                   "dropped": dropped, "routed": routed}


def make_loss_fn(cfg: MoEConfig, par: MoEParallelConfig, mesh) -> Callable:
    """``loss_of(params, tokens, labels) -> (total, metrics)``: the
    per-rank body on ``mesh``, differentiable as the reference's
    ``shard_map``: after ``total.backward()`` the experts' gradients are
    summed over dp and the rest over (dp, ep), as the reference's
    transposes give them.  ``params`` a mesh ``MoETransformer`` or a shard
    tree; tokens/labels this rank's rows."""
    ax = _axes(par, mesh)
    specs = param_specs(cfg, par)

    def loss_of(params, tokens, labels):
        if isinstance(params, MoETransformer) and (
                params.mesh is None or params.mesh != mesh):
            raise ValueError("the model's shards were cut for another mesh "
                             f"({params.mesh}), not {mesh}")
        local = _mesh.enter_tree(_tree(params), specs, ax)
        total, metrics = forward_loss(cfg, par, ax, local, tokens, labels)
        return _mesh.leave(total, ax), metrics

    return loss_of


def _wire_plan(cfg: MoEConfig, par: MoEParallelConfig, rows: int):
    """One step's dispatch wire bytes a member, fp32 and as sent: two
    exchanges a layer over ``rows`` local sequences."""
    from ..ops import xla_collectives as XC
    n_local_tok = rows * cfg.seq_len
    n_local_experts = cfg.n_experts // par.ep
    cap = moe_lib.expert_capacity(n_local_tok, cfg.n_experts,
                                  cfg.capacity_factor, cfg.top_k)
    raw = 2 * cfg.n_layers * moe_lib.dispatch_wire_bytes(
        par.ep, n_local_experts, cap, cfg.d_model, None)
    sent = 2 * cfg.n_layers * moe_lib.dispatch_wire_bytes(
        par.ep, n_local_experts, cap, cfg.d_model, cfg.quant_spec())
    return XC.StepWireBytes(raw=raw, sent=sent)


def make_train_step(cfg: MoEConfig, par: MoEParallelConfig,
                    model: MoETransformer, optimizer) -> Callable:
    """``train_step(tokens, labels) -> (loss, metrics)``, detached:
    forward, backward and one step of ``optimizer`` (a plain torch
    optimizer over the model's shards) on ``model.mesh``.  On a quantized
    dispatch wire each step also adds its analytic bytes, 2 · n_layers ·
    ``dispatch_wire_bytes`` a member, to the gspmd wire counters
    (``xla_collectives.record_wire_bytes``), as the reference's metered
    step does."""
    from ..ops import xla_collectives as XC
    if model.mesh is None:
        raise ValueError("the MoE step runs on a (dp, ep) mesh: build the "
                         "model with mesh=")
    loss_of = make_loss_fn(cfg, par, model.mesh)
    plans: Dict[int, Any] = {}

    def train_step(tokens: torch.Tensor, labels: torch.Tensor):
        optimizer.zero_grad(set_to_none=True)
        total, metrics = loss_of(model, tokens, labels)
        total.backward()
        optimizer.step()
        if cfg.quant_spec() is not None:
            rows = int(tokens.shape[0])
            plan = plans.get(rows)
            if plan is None:
                plan = plans[rows] = _wire_plan(cfg, par, rows)
            XC.record_wire_bytes(plan.raw, plan.sent)
        return total.detach(), metrics

    return train_step


def serial_forward_logits(cfg: MoEConfig, params,
                          tokens: torch.Tensor) -> torch.Tensor:
    """The unsharded per-token-routed oracle: fp32 logits (B, S, V).
    Routes top-k per token without the capacity clamp, so it equals the
    sharded forward exactly when nothing drops; shares serving's MoE MLP
    (``transformer._moe_mlp_serving``)."""
    tree = _tree(params)
    s_in = tokens.shape[1]
    x = (tree["embed"][tokens] + tree["pos"][None, :s_in]).to(cfg.dtype)
    for lp in tfm._layer_params(tree["layers"], cfg.dtype):
        x = x + _attention(cfg, lp, x)
        h = tfm._rmsnorm(x, lp["ln2"])
        b, s, d = h.shape
        y = tfm._moe_mlp_serving(cfg, lp, h.reshape(b * s, d))
        x = x + y.reshape(b, s, d)
    hidden = tfm._rmsnorm(x, tree["final_norm"])
    return hidden.float() @ tree["embed"].float().t()


def serial_forward_loss(cfg: MoEConfig, params, tokens: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Cross entropy of the no-capacity serial oracle (no aux term)."""
    logits = serial_forward_logits(cfg, params, tokens)
    ll = F.log_softmax(logits, dim=-1).gather(-1, labels[..., None])[..., 0]
    return -ll.mean()


def flops_matched_dense_config(cfg: MoEConfig) -> tfm.TransformerConfig:
    """The dense baseline with the same per-token matmul FLOPs: d_ff' =
    top_k · d_ff (the 2 d E gate is the only remainder)."""
    return tfm.TransformerConfig(
        vocab_size=cfg.vocab_size, d_model=cfg.d_model, n_heads=cfg.n_heads,
        d_ff=cfg.top_k * cfg.d_ff, n_layers=cfg.n_layers,
        seq_len=cfg.seq_len, n_experts=0, dtype=cfg.dtype, remat=cfg.remat)


def train_flops_per_seq(cfg: MoEConfig) -> float:
    """Matmul FLOPs of one training sequence (3x forward), counting the
    routed top_k experts and the gate per token."""
    return tfm.train_flops_per_seq(cfg)


def dispatch_wire_ratio(cfg: MoEConfig, par: MoEParallelConfig,
                        n_local_tokens: int) -> float:
    """fp32 over quantized bytes of one dispatch all-to-all (1.0 on the
    fp32 wire)."""
    spec = cfg.quant_spec()
    cap = moe_lib.expert_capacity(n_local_tokens, cfg.n_experts,
                                  cfg.capacity_factor, cfg.top_k)
    n_local = cfg.n_experts // par.ep
    fp32 = moe_lib.dispatch_wire_bytes(par.ep, n_local, cap, cfg.d_model,
                                       None)
    if spec is None:
        return 1.0
    return fp32 / moe_lib.dispatch_wire_bytes(par.ep, n_local, cap,
                                              cfg.d_model, spec)


def synthetic_batch(cfg: MoEConfig, batch: int, seed: int = 1,
                    device: DeviceLike = None):
    """(tokens, labels) as ``transformer.synthetic_batch`` makes them."""
    return tfm.synthetic_batch(cfg, batch, seed=seed, device=device)
