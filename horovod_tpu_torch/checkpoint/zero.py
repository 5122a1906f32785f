"""ZeRO optimizer state <-> sharded checkpoint engine bridge (port of
horovod_tpu/checkpoint/zero.py).

``ZeroShardedOptimizer`` state is rank-DISTINCT: each member of the
data-parallel axis owns one flat 1/N shard of every moment (and, at
stage 3, of every parameter).  ``broadcast_optimizer_state`` refuses it;
this module gives it a durable lifecycle in the reference's on-disk
format, so a step written by either package restores in the other:

* :func:`save_zero_state` — every rank writes its own shard file, rank 0
  commits the manifest last (engine protocol: a partial write is never
  restorable);
* :func:`restore_zero_state` — a step written at world N restores at
  world M: the flat buffers are reassembled from the N shards and
  re-sliced into M, then copied into the live shard tensors in place
  (the inner optimizer's ``param_groups`` keep their tensors).

Leaves are named and ordered as the reference's pytree of the same
state: ``.sizes[k]`` (the int32 true sizes), the inner optimizer's
state, then the error-feedback residual ``.residual[k]``; ``k`` is the
parameter's key path — ``['layers']['w1']`` for the parameter named
``layers.w1``, ``[3]`` for the fourth of an unnamed list — with dict
keys sorted at every level, as ``jax.tree_util`` flattens a dict.  The
inner optimizers map onto optax's state (the reference's engine is
restricted to elementwise inner transforms as well):

==========================  ==============================  ============================
torch                       torch state                     optax state
==========================  ==============================  ============================
``Adam``, ``AdamW``         ``step, exp_avg, exp_avg_sq``   ``.inner[0].count, .mu[k], .nu[k]``
``SGD(momentum=m)``, m > 0  ``momentum_buffer``             ``.inner[0].trace[k]``
``SGD`` (no momentum)       none                            none
==========================  ==============================  ============================

``count`` is int32 on disk; torch's ``step`` comes back in torch's own
dtype and on its own device.  Stage-3 parameters are saved as the
reference saves its ``shard_params`` state (:class:`ShardedParams`):
``.sizes[k]`` and the shards ``.inner[k]``, in a root of their own.
Tensors and arrays elsewhere in a state tree ride along as replicated
leaves under their own key paths.

The GSPMD plane's state (``ops.gspmd``) is planned as the reference plans
its own (zero.py:143-250): an ``OptimizerState`` alone (the uncompressed
step) as optax state, every leaf a full replicated value; wrapped in
``optimizers._ZeroState`` (a compressed wire) with ``.sizes``, its
parameter-shaped moments as full replicated values except a 1-D moment
whose length the world divides (a flat shard, as the reference's "global"
leaves), and its residual as per-rank flat runs.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import engine as E
from . import manifest as M

INNER_OPTIMIZERS = "torch.optim.Adam, torch.optim.AdamW and torch.optim.SGD"


def _zero_type():
    from ..optimizers import ZeroShardedOptimizer
    return ZeroShardedOptimizer


class ShardedParams:
    """A stage-3 ``ZeroShardedOptimizer``'s parameters as ZeRO state: its
    flat fp32 shards with the parameters' true sizes — the reference's
    ``_ZeroState`` from ``shard_params``, which it saves in a root of its
    own beside the optimizer state's."""

    def __init__(self, optimizer):
        if getattr(optimizer, "stage", None) != 3:
            raise ValueError("only a stage-3 ZeroShardedOptimizer keeps its "
                             "parameters as shards")
        self.optimizer = optimizer


def _gspmd_types():
    from ..ops.gspmd import OptimizerState
    from ..optimizers import _ZeroState
    return OptimizerState, _ZeroState


def _is_gspmd(x) -> bool:
    opt_state, zero_state = _gspmd_types()
    return isinstance(x, opt_state) or (
        isinstance(x, zero_state) and isinstance(x.inner, opt_state))


def _is_group(x) -> bool:
    return isinstance(x, (_zero_type(), ShardedParams)) or _is_gspmd(x)


def has_zero_leaves(tree) -> bool:
    """True iff ``tree`` is or holds a ``ZeroShardedOptimizer`` (or its
    stage-3 :class:`ShardedParams`): rank-distinct state that must go
    through this engine, never a broadcast or rank-0-writes path."""
    return any(_is_group(leaf) for _, leaf in _flatten(tree))


# ---------------------------------------------------------------------------
# Key paths without JAX: jax.tree_util.keystr's exact strings and order
# ---------------------------------------------------------------------------

def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """(key-path step, child) pairs of a container in flatten order, or
    None for a leaf or a ZeRO state."""
    return None if _is_group(tree) else _container_children(tree)


def _container_children(tree) -> Optional[List[Tuple[str, Any]]]:
    """(key-path step, child) pairs of a container in flatten order, or
    None for a leaf.  Dicts flatten in sorted key order, OrderedDicts in
    insertion order, named tuples by field, lists and tuples by index."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return None
    if isinstance(tree, OrderedDict):
        return [(f"[{k!r}]", v) for k, v in tree.items()]
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    if tree is None:
        return []
    return None


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [x for step, child in kids for x in _flatten(child, prefix + step)]


def _unflatten(tree, values: List[Any]):
    """``tree`` with its leaves replaced, in flatten order, by ``values``
    (consumed from the front)."""
    kids = _children(tree)
    if kids is None:
        return values.pop(0)
    new = [_unflatten(child, values) for _, child in kids]
    if isinstance(tree, dict):
        return type(tree)((k, v) for k, v in zip(
            tree if isinstance(tree, OrderedDict) else sorted(tree), new))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*new)
    if isinstance(tree, (list, tuple)):
        return type(tree)(new)
    return tree     # None


def param_keys(names: Optional[List[str]], n: int) -> List[Tuple[int, str]]:
    """(parameter index, key path) of ``n`` parameters in the reference's
    flatten order: ``names`` (``named_parameters()`` names) split at the
    dots into nested dict keys, sorted at every level; unnamed parameters
    are a list."""
    if names is None:
        return [(i, f"[{i}]") for i in range(n)]
    parts = [tuple(name.split(".")) for name in names]
    return [(i, "".join(f"[{p!r}]" for p in parts[i]))
            for i in sorted(range(n), key=lambda i: parts[i])]


# ---------------------------------------------------------------------------
# Leaf plan: each leaf's spec, this rank's host value, and its restore
# ---------------------------------------------------------------------------

class _Leaf(NamedTuple):
    spec: M.LeafSpec
    get: Callable[[], np.ndarray]          # this rank's host value
    put: Callable[[np.ndarray], Any]       # restore this rank's value


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array (one device-to-host copy).  numpy
    has no bfloat16, so a bf16 tensor becomes its raw 2-byte words
    (dtype ``V2``), the form the reference's ``np.savez`` gives a bf16
    array: the same bits on disk, stamped ``"bfloat16"``."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view("V2")
    return t.cpu().numpy()


def from_host(value) -> torch.Tensor:
    """A host array as a CPU tensor: raw 2-byte words (``V2``, as
    :func:`to_host` and the reference's shard files hold bf16) and
    ml_dtypes' ``bfloat16`` (a reference pickle) become bf16."""
    value = np.array(value)
    if value.dtype.kind == "V" and value.dtype.itemsize == 2:
        return torch.from_numpy(value.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(value)


def _copy_into(t: torch.Tensor, value: np.ndarray, what: str) -> torch.Tensor:
    """Copy a stored array into ``t`` in place; its shape must be
    ``t``'s."""
    value = np.asarray(value)
    if tuple(value.shape) != tuple(t.shape):
        raise ValueError(f"{what}: checkpoint value of shape "
                         f"{tuple(value.shape)} does not fit {tuple(t.shape)}")
    with torch.no_grad():
        t.copy_(from_host(value))
    return t


def _spec(path, kind, shape, dtype, true_size) -> M.LeafSpec:
    return M.LeafSpec(path=path, kind=kind, shape=list(shape), dtype=dtype,
                      true_size=int(true_size))


def _inner_kind(opt) -> str:
    """"adam", "trace" (SGD with momentum) or "none" (plain SGD)."""
    inner = opt.optimizer
    groups = inner.param_groups
    if isinstance(inner, (torch.optim.Adam, torch.optim.AdamW)):
        if any(g.get("amsgrad") for g in groups):
            raise ValueError("Adam(amsgrad=True) keeps a state optax's adam "
                             "has not; the sharded checkpoint maps "
                             + INNER_OPTIMIZERS)
        return "adam"
    if isinstance(inner, torch.optim.SGD):
        moms = {float(g.get("momentum", 0.0)) != 0.0 for g in groups}
        if len(moms) > 1:
            raise ValueError("SGD param groups with and without momentum "
                             "have no single optax state")
        return "trace" if moms.pop() else "none"
    raise ValueError(
        f"the sharded checkpoint maps {INNER_OPTIMIZERS} (momentum or not) "
        f"onto optax's state; {type(inner).__name__} has no mapping")


def _sizes_leaves(opt, prefix, keys) -> List[_Leaf]:
    out = []
    for i, k in keys:
        true = opt.params[i].numel()

        def put(v, i=i, true=true, k=k):
            if int(np.asarray(v)) != true:
                raise ValueError(f"parameter {k}: checkpoint size "
                                 f"{int(np.asarray(v))} != {true}")
        out.append(_Leaf(_spec(prefix + ".sizes" + k, M.REPLICATED, [],
                               "int32", 1),
                         lambda true=true: np.asarray(true, np.int32), put))
    return out


def _count_leaf(opt, path) -> _Leaf:
    inner = opt.optimizer

    def get():
        counts = {int(inner.state[s]["step"]) if "step" in inner.state.get(
            s, {}) else 0 for s in opt.shards}
        if len(counts) != 1:
            raise ValueError(f"the shards stepped {sorted(counts)} times: "
                             "optax keeps one count for all parameters")
        return np.asarray(counts.pop(), np.int32)

    def put(v):
        count = int(np.asarray(v))
        for g in inner.param_groups:
            on_device = g.get("capturable") or g.get("fused")
            for s in g["params"]:
                st = inner.state[s]
                if "step" in st:
                    st["step"].fill_(count)
                else:
                    dtype = torch.float64 if (
                        torch.get_default_dtype() == torch.float64
                        and not g.get("fused")) else torch.float32
                    st["step"] = torch.tensor(
                        float(count), dtype=dtype,
                        device=s.device if on_device else "cpu")
    return _Leaf(_spec(path, M.REPLICATED, [], "int32", 1), get, put)


def _state_leaves(opt, prefix, keys, field, tkey) -> List[_Leaf]:
    inner = opt.optimizer
    out = []
    for i, k in keys:
        shard = opt.shards[i]
        true = opt.params[i].numel()

        def get(shard=shard):
            t = inner.state.get(shard, {}).get(tkey)
            return to_host(t) if t is not None else \
                np.zeros(shard.shape, np.float32)

        def put(v, shard=shard, k=k):
            st = inner.state[shard]
            if st.get(tkey) is None:
                st[tkey] = torch.zeros_like(
                    shard, memory_format=torch.preserve_format)
            _copy_into(st[tkey], v, prefix + field + k)
        out.append(_Leaf(_spec(prefix + f".inner[0].{field}" + k,
                               M.SHARDED, [true], "float32", true), get, put))
    return out


def _group_leaves(group, prefix: str, world: int) -> List[_Leaf]:
    """The leaves of one ZeRO state, in the reference's order."""
    if _is_gspmd(group):
        return _gspmd_leaves(group, prefix, world)
    params_view = isinstance(group, ShardedParams)
    opt = group.optimizer if params_view else group
    keys = param_keys(opt.names, len(opt.params))
    leaves = _sizes_leaves(opt, prefix, keys)
    if params_view:
        for i, k in keys:
            true = opt.params[i].numel()
            shard = opt.shards[i]
            leaves.append(_Leaf(
                _spec(prefix + ".inner" + k, M.SHARDED, [true],
                      _dtype_name(shard.dtype), true),
                lambda shard=shard: to_host(shard),
                lambda v, shard=shard, k=k: _copy_into(shard, v, k)))
        return leaves
    kind = _inner_kind(opt)
    if kind == "adam":
        leaves.append(_count_leaf(opt, prefix + ".inner[0].count"))
        leaves += _state_leaves(opt, prefix, keys, "mu", "exp_avg")
        leaves += _state_leaves(opt, prefix, keys, "nu", "exp_avg_sq")
    elif kind == "trace":
        leaves += _state_leaves(opt, prefix, keys, "trace", "momentum_buffer")
    if opt.residual is not None:
        leaves += _residual_leaves(opt, prefix, keys, world)
    return leaves


def _residual_leaves(opt, prefix, keys, world) -> List[_Leaf]:
    """One flat fp32 run of TRUE elements per parameter and rank, globally
    (world * true,): true_size pins the step to the world that wrote it
    (reference zero.py:207-246)."""
    out = []
    for i, k in keys:
        true = opt.params[i].numel()
        r = opt.residual[i]
        out.append(_Leaf(
            _spec(prefix + ".residual" + k, M.SHARDED, [true * world],
                  "float32", true * world),
            lambda r=r: to_host(r),
            lambda v, r=r, k=k: _copy_into(r, v, ".residual" + k)))
    return out


def _moment_leaf(opt, i, path, tkey, flat: bool) -> _Leaf:
    """One GSPMD moment (a DTensor of the parameter's shape, ``Shard(0)``
    or replicated): a flat shard of the parameter's length when ``flat``,
    else the full value, which a rank holding rows reads from and writes
    to its rows."""
    shard, param = opt.shards[i], opt.params[i]
    true = param.numel()
    inner = opt.optimizer

    def live():
        st = inner.state[shard]
        if st.get(tkey) is None:
            st[tkey] = torch.zeros_like(shard)
        return st[tkey]

    def get():
        t = inner.state.get(shard, {}).get(tkey)
        if t is None:
            shape = shard.to_local().shape if flat else param.shape
            return np.zeros(tuple(shape), np.float32)
        return to_host(t.to_local() if flat else t.full_tensor())

    def put(v):
        local = live().to_local()
        v = np.asarray(v)
        if not flat and tuple(local.shape) != tuple(param.shape):
            rows = local.shape[0]
            v = v.reshape(tuple(param.shape))[opt.index * rows:
                                              (opt.index + 1) * rows]
        _copy_into(local, v.reshape(tuple(local.shape)), path)
    kind, shape = (M.SHARDED, [true]) if flat else \
        (M.REPLICATED, list(param.shape))
    return _Leaf(_spec(path, kind, shape, _dtype_name(shard.dtype), true),
                 get, put)


_MOMENTS = {"adam": (("mu", "exp_avg"), ("nu", "exp_avg_sq")),
            "trace": (("trace", "momentum_buffer"),), "none": ()}


def _gspmd_leaves(group, prefix: str, world: int) -> List[_Leaf]:
    """The leaves of a GSPMD state (see the module docstring)."""
    opt_state, _ = _gspmd_types()
    wrapped = not isinstance(group, opt_state)
    opt = group.inner if wrapped else group
    keys = list(enumerate(opt.keys))
    leaves, inner = [], prefix
    if wrapped:
        leaves += _sizes_leaves(opt, prefix, keys)
        inner = prefix + ".inner"
    kind = _inner_kind(opt)
    if kind == "adam":
        leaves.append(_count_leaf(opt, inner + "[0].count"))
    for field, tkey in _MOMENTS[kind]:
        for i, k in keys:
            p = opt.params[i]
            flat = wrapped and p.dim() == 1 and p.numel() % world == 0
            leaves.append(_moment_leaf(opt, i, inner + f"[0].{field}" + k,
                                       tkey, flat))
    if wrapped and group.residual is not None:
        leaves += _residual_leaves(opt, prefix, keys, world)
    return leaves


def _plain_leaf(path: str, leaf) -> _Leaf:
    """A tensor, array or scalar of the tree: replicated; a tensor is
    restored in place, anything else is returned as the stored array."""
    if isinstance(leaf, torch.Tensor):
        shape, dtype = list(leaf.shape), _dtype_name(leaf.dtype)
        get = lambda: to_host(leaf)  # noqa: E731
    else:
        host = np.asarray(leaf)
        shape, dtype, get = list(host.shape), str(host.dtype), lambda: host

    def put(v):
        v = np.asarray(v).reshape(shape)
        return _copy_into(leaf, v, path) if isinstance(leaf, torch.Tensor) \
            else v
    return _Leaf(_spec(path, M.REPLICATED, shape, dtype,
                       int(np.prod(shape)) if shape else 1), get, put)


def _plan(tree, world: int) -> List[Tuple[List[_Leaf], Any]]:
    """Per outer leaf of ``tree``: its engine leaves and the leaf."""
    out = []
    for path, leaf in _flatten(tree):
        if _is_group(leaf):
            out.append((_group_leaves(leaf, path, world), leaf))
        else:
            out.append(([_plain_leaf(path, leaf)], leaf))
    return out


def _group_axis(group) -> Tuple[int, int, Any]:
    """(world, index, axis) of one ZeRO state; a GSPMD state's axis is its
    mesh's shape, as ((name, size), ...)."""
    if isinstance(group, ShardedParams):
        group = group.optimizer
    elif _is_gspmd(group):
        opt = group if isinstance(group, _gspmd_types()[0]) else group.inner
        return opt.world, opt.index, tuple(
            (str(n), int(s)) for n, s in zip(opt.mesh.mesh_dim_names,
                                            opt.mesh.mesh.shape))
    return group.world, group.index, group.axis


def _axis_of(tree) -> Tuple[int, int, Any]:
    """(world, this rank's index, axis) of the ZeRO states in ``tree`` —
    the runtime's world when it holds none."""
    axes = {_group_axis(leaf) for _, leaf in _flatten(tree)
            if _is_group(leaf)}
    if len(axes) > 1:
        raise ValueError(f"ZeRO states over different axes {sorted(axes)} "
                         "in one checkpoint")
    if axes:
        return axes.pop()
    from ..core.state import global_state
    if global_state.initialized:
        return global_state.size, global_state.rank, None
    return 1, 0, None


def _mesh_shape(world: int, axis) -> dict:
    if axis is None:
        return {"data": world}
    if isinstance(axis[0], tuple):      # a GSPMD state's mesh
        return dict(axis)
    from ..core.state import global_state
    return {"local": global_state.local_size,
            "cross": global_state.cross_size}


# ---------------------------------------------------------------------------
# The run fingerprint (reference zero.py:405-447)
# ---------------------------------------------------------------------------

def _foreign_allowed() -> bool:
    return os.environ.get("HVD_TPU_CKPT_ALLOW_FOREIGN", "") == "1"


def _recorded_fingerprint(manifest: M.Manifest) -> str:
    """The manifest's stamped fingerprint; derived from its leaf specs
    for checkpoints written before the stamp existed (same hash)."""
    rec = (manifest.extra or {}).get(M.RUN_FINGERPRINT_KEY) or {}
    return rec.get("leaf_spec_sha256") or M.spec_fingerprint(
        manifest.leaves)


def _check_run_fingerprint(root: str, fp: str, direction: str) -> None:
    """Refuse to mix runs in one checkpoint directory.  Escape hatch:
    HVD_TPU_CKPT_ALLOW_FOREIGN=1."""
    latest = E.latest_step(root)
    if latest is None:
        return
    try:
        manifest = E.read_manifest(root, latest)
    except (OSError, ValueError, KeyError):
        return
    recorded = _recorded_fingerprint(manifest)
    if recorded == fp or _foreign_allowed():
        return
    raise ValueError(
        f"checkpoint directory {root} belongs to a different run: its "
        f"newest committed step has leaf-spec fingerprint "
        f"{recorded[:12]}..., this state fingerprints {fp[:12]}... "
        f"(different model/optimizer structure, dtypes or sizes).  "
        f"Refusing the cross-run {direction}: use a fresh "
        f"checkpoint_dir per training run, or set "
        f"HVD_TPU_CKPT_ALLOW_FOREIGN=1 to override.")


class ExtractedState(NamedTuple):
    """One commit's host-side payload: the leaf specs plus this rank's
    per-leaf arrays (reference ``ExtractedState``)."""

    specs: List[M.LeafSpec]
    rank_values: dict             # {rank: [per-leaf host arrays]}
    world: int
    fingerprint: str              # world-size-invariant leaf-spec sha256
    mesh_shape: dict              # {axis: size} of the extracting axis


def extract_zero_state(state) -> ExtractedState:
    """This rank's host values of ``state`` — a ``ZeroShardedOptimizer``,
    a :class:`ShardedParams`, or a tree (dicts, lists, tuples) holding
    them beside tensors and arrays, which ride along as replicated
    leaves: one device-to-host copy of each of its shards."""
    world, index, axis = _axis_of(state)
    leaves = [leaf for group, _ in _plan(state, world) for leaf in group]
    specs = [leaf.spec for leaf in leaves]
    return ExtractedState(
        specs=specs, rank_values={index: [leaf.get() for leaf in leaves]},
        world=world, fingerprint=M.spec_fingerprint(specs),
        mesh_shape=_mesh_shape(world, axis))


def fingerprint_extra(ext: ExtractedState,
                      extra: Optional[dict] = None) -> dict:
    """``extra`` with the run fingerprint stamped, as the reference
    stamps it: leaf-spec hash, mesh shape and world size."""
    extra = dict(extra or {})
    extra[M.RUN_FINGERPRINT_KEY] = {
        "leaf_spec_sha256": ext.fingerprint,
        "mesh_shape": dict(ext.mesh_shape),
        "world_size": ext.world,
    }
    return extra


def _barrier() -> None:
    from ..ops import collective as C
    C.barrier()


def save_extracted(root: str, ext: ExtractedState, step: int,
                   keep: Optional[int] = None,
                   extra: Optional[dict] = None) -> M.Manifest:
    """Write one committed step from an extracted payload.  Every rank
    calls it: each writes its own shard file, a barrier separates the
    writes from the manifest, rank 0 commits, and a second barrier makes
    the step durable on every rank's return."""
    _check_run_fingerprint(root, ext.fingerprint, direction="save")
    (index,) = ext.rank_values
    multi = ext.world > 1
    manifest = E.save_leaves(
        root, step, ext.specs, ext.rank_values, ext.world,
        committer=index == 0, extra=fingerprint_extra(ext, extra),
        barrier=_barrier if multi else None)
    if keep is not None and index == 0:
        E.gc_steps(root, keep=keep)
    if multi:
        _barrier()
    return manifest


def save_zero_state(root: str, state, step: int,
                    keep: Optional[int] = None,
                    extra: Optional[dict] = None) -> M.Manifest:
    """Write one committed checkpoint step of ``state`` (see
    :func:`extract_zero_state`) on every rank.  ``keep`` retains the
    newest ``keep`` steps; ``extra`` rides the manifest (the loaders'
    state under ``DATA_ITERS_KEY``)."""
    return save_extracted(root, extract_zero_state(state), step, keep=keep,
                          extra=extra)


def _refuse_cross_world_residual(manifest: M.Manifest, world: int) -> None:
    residual = [l.path for l in manifest.leaves
                if l.kind == M.SHARDED and ".residual[" in l.path]
    if residual and manifest.world_size != world:
        raise ValueError(
            f"step {manifest.step} holds error-feedback residuals "
            f"({residual[0]}, ...) written at world {manifest.world_size}; "
            f"they do not restore at world {world}: each rank's residual "
            "is the error of the gradients it quantized, so it has no "
            "reshard.  Restore at the writing world, or build the "
            "optimizer without the quantized wire's state")


def rebuild_restored(restored, like, source: str = "the checkpoint"):
    """Restore an opened step (``engine.RestoredStep`` or ``LazyStep``,
    opened for ``like``'s world) into ``like``: its ZeRO states and
    tensors in place, its other leaves replaced by the stored arrays;
    returns the rebuilt tree.

    Refuses, with ``ValueError``, a step whose leaf-spec fingerprint is
    not ``like``'s (another run; ``HVD_TPU_CKPT_ALLOW_FOREIGN=1``
    overrides) and a step with error-feedback residuals written at
    another world."""
    world, index, _ = _axis_of(like)
    manifest = restored.manifest
    _refuse_cross_world_residual(manifest, world)
    plan = _plan(like, manifest.world_size)
    leaves = [leaf for group, _ in plan for leaf in group]
    target_fp = M.spec_fingerprint([leaf.spec for leaf in leaves])
    saved_fp = _recorded_fingerprint(manifest)
    if saved_fp != target_fp and not _foreign_allowed():
        raise ValueError(
            f"{source} was written by a different run: checkpoint "
            f"leaf-spec fingerprint {saved_fp[:12]}... != restore "
            f"target's {target_fp[:12]}... (different model/optimizer "
            f"structure, dtypes or sizes).  Refusing the cross-run "
            f"restore: point checkpoint_dir at this run's directory, or "
            f"set HVD_TPU_CKPT_ALLOW_FOREIGN=1 to override.")
    if len(leaves) != len(manifest.leaves):
        raise ValueError(
            f"checkpoint at step {manifest.step} has "
            f"{len(manifest.leaves)} leaves but the restore target has "
            f"{len(leaves)}; structures must match")
    values = []
    saved = iter(manifest.leaves)
    for group, leaf in plan:
        out = leaf
        for target in group:
            spec = next(saved)
            if (spec.kind, spec.path) != (target.spec.kind,
                                          target.spec.path):
                raise ValueError(
                    f"leaf {spec.path} ({spec.kind}) does not match the "
                    f"target's {target.spec.path} ({target.spec.kind})")
            out = target.put(restored.shard_value(spec, index))
        values.append(leaf if _is_group(leaf) else out)
    return _unflatten(like, values)


def restore_zero_state(root: str, like, step: Optional[int] = None):
    """Restore the newest committed step under ``root`` (or ``step``)
    into ``like``, resharded for the current world; see
    :func:`rebuild_restored`.  Each rank reads one leaf at a time, and
    only the shards its new slice needs (``engine.open_step``)."""
    world = _axis_of(like)[0]
    if step is None:
        step = E.latest_step(root)
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint step under {root}")
    with E.open_step(root, step, world) as restored:
        return rebuild_restored(restored, like,
                                source=f"step {step} under {root}")
