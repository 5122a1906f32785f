"""The GSPMD ZeRO plane on a torch ``DeviceMesh`` (port of
horovod_tpu/ops/gspmd.py).

The reference annotates tensors with ``NamedSharding`` and lets the XLA
partitioner insert and schedule the ZeRO collectives.  The port holds the
same residency as DTensor placements on a ``DeviceMesh``: a leaf is
``Shard(0)`` over the data axis where its dim 0 divides the axis' world,
``Replicate()`` elsewhere (the reference's rule, which ``residency_report``
discloses).  Torch has no partitioner, so :func:`make_zero_train_step`
issues the collectives itself, one or two per parameter:

* stage >= 1: the optimizer is built on ``Shard(0)`` DTensors, so its
  moments are dim-0 shards; at stages 1-2 those are views of this rank's
  rows of the replicated parameter, updated in place and all-gathered
  back;
* stage 1: the gradients are all-reduced; stage 2: reduce-scattered to
  dim-0 shards before the update;
* stage 3: the parameters stay ``Shard(0)`` at rest; the forward gathers
  them (one ``all_gather_into_tensor`` each), whose backward
  reduce-scatters the gradients into shards.

A leaf whose dim 0 does not divide stays replicated everywhere: its
gradient is all-reduced and its update is the full one.  On a compressed
wire the reference's ``shard_map`` island is followed: per-rank gradients,
error feedback, ``allreduce_scheduled(Average)`` and the loss averaged over
the ranks; the state is wrapped in ``optimizers._ZeroState`` so that the
checkpoint engine carries the residual.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional

import torch

from ..core import config as _cfg
from ..parallel.mesh import DATA
from . import xla_collectives as XC

DATA_AXIS = DATA


def _dt():
    import torch.distributed.tensor as dt
    return dt


def _axis_world(mesh, axis) -> int:
    """Shard count of ``axis``: a mesh dimension's size, or the product of
    a tuple of them."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    world = 1
    for a in XC.axes_of(axis):
        world *= int(sizes[a])
    return world


def _axis_index(mesh, axis) -> int:
    """This rank's index on ``axis`` (a tuple: the first axis major)."""
    index = 0
    for a in XC.axes_of(axis):
        index = index * mesh.size(mesh.mesh_dim_names.index(a)) + \
            mesh.get_local_rank(a)
    return index


def _shardable(leaf, world: int) -> bool:
    shape = tuple(getattr(leaf, "shape", ()))
    return len(shape) >= 1 and shape[0] % world == 0 and shape[0] > 0


def leaf_spec(leaf, mesh, sharded: bool, axis=DATA_AXIS):
    """The placements of one leaf, one per mesh dimension: ``Shard(0)`` on
    the dimensions of ``axis`` (a name or a tuple, sharded in the mesh's
    dimension order) when requested and dim 0 divides, ``Replicate()``
    otherwise."""
    if sharded and _shardable(leaf, _axis_world(mesh, axis)):
        return _sharded(mesh, axis)
    return tuple(_dt().Replicate() for _ in mesh.mesh_dim_names)


def _sharded(mesh, axis):
    """``Shard(0)`` on the dimensions of ``axis``, ``Replicate()`` on the
    others."""
    dt = _dt()
    axes = XC.axes_of(axis)
    return tuple(dt.Shard(0) if name in axes else dt.Replicate()
                 for name in mesh.mesh_dim_names)


def _map(fn, tree):
    from .overlap import _tree_map
    return _tree_map(fn, tree)


def zero_shardings(tree, mesh, sharded: bool, axis=DATA_AXIS):
    """The placements of every leaf of ``tree`` (see :func:`leaf_spec`)."""
    return _map(lambda l: leaf_spec(l, mesh, sharded, axis), tree)


def place(tree, mesh, sharded: bool, axis=DATA_AXIS):
    """Every leaf as a DTensor at its ZeRO residency, from a copy of the
    full value this rank holds (every rank holds the same, as every rank
    holds the same parameters; nothing is sent)."""
    dt = _dt()

    def one(leaf):
        full = leaf.detach().to(mesh.device_type).clone()
        return dt.distribute_tensor(full, mesh,
                                    leaf_spec(leaf, mesh, sharded, axis),
                                    src_data_rank=None)
    return _map(one, tree)


def constrain(tree, mesh, sharded: bool, axis=DATA_AXIS):
    """Every leaf redistributed to its ZeRO residency: a slice where a
    replicated leaf becomes a shard, an all-gather the other way."""
    dt = _dt()

    def one(leaf):
        want = leaf_spec(leaf, mesh, sharded, axis)
        if not isinstance(leaf, dt.DTensor):
            return place(leaf, mesh, sharded, axis)
        return leaf if tuple(leaf.placements) == want else \
            leaf.redistribute(mesh, want)
    return _map(one, tree)


class _AdamView(NamedTuple):   # optax.ScaleByAdamState's fields
    count: Any
    mu: Any
    nu: Any


class _TraceView(NamedTuple):  # optax.TraceState
    trace: Any


class OptimizerState:
    """A torch optimizer over a placed parameter tree, as the GSPMD step
    holds it: ``optimizer`` is built on ``shards`` (per parameter, in the
    tree's flatten order: a ``Shard(0)`` DTensor of its rows where dim 0
    divides, else the parameter itself), ``params`` are the placed
    parameters and ``keys`` their key paths.  :meth:`tree` shows the state
    as the reference's optax state (``[0].count``, ``[0].mu[k]``, ...), for
    ``residency_report`` and the checkpoint engine; Adam, AdamW and SGD
    (with momentum or not) are mapped, as the checkpoint engine maps them
    for ``ZeroShardedOptimizer``."""

    def __init__(self, optimizer, tree, keys, params, shards, mesh, axis):
        self.optimizer = optimizer
        self.structure = tree
        self.keys = keys
        self.params = params
        self.shards = shards
        self.mesh, self.axis = mesh, axis
        self.world = _axis_world(mesh, axis)
        self.index = _axis_index(mesh, axis)
        self.residual = None

    def _moments(self, key):
        from ..checkpoint.zero import _unflatten
        dt = _dt()
        out = []
        for s in self.shards:
            t = self.optimizer.state.get(s, {}).get(key)
            out.append(t if t is not None else dt.zeros(
                s.shape, dtype=s.dtype, device_mesh=self.mesh,
                placements=s.placements))
        return _unflatten(self.structure, out)

    def count(self) -> int:
        steps = {int(self.optimizer.state[s]["step"])
                 if "step" in self.optimizer.state.get(s, {}) else 0
                 for s in self.shards}
        if len(steps) != 1:
            raise ValueError(f"the parameters stepped {sorted(steps)} times: "
                             "optax keeps one count for all parameters")
        return steps.pop()

    def tree(self) -> tuple:
        from ..checkpoint.zero import _inner_kind
        kind = _inner_kind(self)
        if kind == "adam":
            count = torch.tensor(self.count(), dtype=torch.int32,
                                 device=self.mesh.device_type)
            return (_AdamView(count, self._moments("exp_avg"),
                              self._moments("exp_avg_sq")),)
        if kind == "trace":
            return (_TraceView(self._moments("momentum_buffer")),)
        return ()


class ZeroStepFns(NamedTuple):
    """``init(params)`` places the parameters and builds the optimizer at
    their stage residency; ``step(params, opt_state, batch)`` runs one
    update in place and returns ``(params, opt_state, loss)``."""

    init: Any
    step: Any
    stage: int


def _grad(t: torch.Tensor) -> torch.Tensor:
    """``t``'s gradient; zeros where the loss does not reach it."""
    return torch.zeros_like(t) if t.grad is None else t.grad


class _GatherRows(torch.autograd.Function):
    """The stage-3 forward gather of one parameter's rows, whose backward
    reduce-scatters (Average) the full gradient into this rank's rows."""

    @staticmethod
    def forward(ctx, rows, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return XC.allgather_scheduled(rows, axis, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        from .collective import Average
        return (XC.reducescatter_scheduled(g, Average, ctx.axis,
                                           mesh=ctx.mesh), None, None)


def make_zero_train_step(loss_fn, optimizer_factory, mesh,
                         stage: Optional[int] = None, axis=DATA_AXIS,
                         compression=None) -> ZeroStepFns:
    """Build the GSPMD ZeRO training step.

    ``loss_fn(params, batch) -> scalar``: ``params`` a dict (nested or
    not) of full local tensors, ``batch`` this rank's share of the batch
    (the batch sharded over ``axis``).  The step averages the loss and the
    gradients over ``axis``, so ``loss_fn`` must average over the batch
    dimension: the global loss is then the mean of the ranks' losses (the
    reference's contract under compression; without compression the
    reference differentiates the global loss, the same function).
    ``optimizer_factory(params) -> torch.optim.Optimizer``, an elementwise
    one (SGD, Adam, AdamW: it sees dim-0 shards).  ``stage`` defaults to
    ``HVD_TPU_ZERO_STAGE``; ``axis`` is a mesh dimension, or a pair of
    them spanning a row-major mesh over the world (the compressed
    allreduce then chooses flat or hierarchical per leaf).

    ``compression`` (``Compression.{fp16,bf16,int8,int4}``, a name, or
    None → ``HVD_TPU_COMPRESSION``): the gradients go through
    ``xla_collectives.allreduce_scheduled``, error-feedback-corrected on a
    quantized wire, and ``init`` returns the optimizer state wrapped in
    ``_ZeroState``.  With the wire resolved to none the step is the
    uncompressed one, with no wrapper.
    """
    from .collective import Average
    from ..checkpoint.zero import _flatten, _unflatten
    from ..optimizers import _ZeroState, _feed_back

    stage = _cfg.zero_stage() if stage is None else int(stage)
    if stage not in (1, 2, 3):
        raise ValueError(f"ZeRO stage must be 1, 2 or 3, got {stage}")
    spec, wire_dtype = XC.resolve_wire(compression)
    compressed = spec is not None or wire_dtype is not None
    world = _axis_world(mesh, axis)
    index = _axis_index(mesh, axis)
    params_sharded = stage >= 3
    dt = _dt()
    if len(XC.axes_of(axis)) > 1:
        XC._joint(XC.axes_of(axis), mesh)    # a pair must span the mesh

    def rows_of(t: torch.Tensor) -> torch.Tensor:
        n = t.shape[0] // world
        return t.narrow(0, index * n, n)

    def init(params):
        placed = place(params, mesh, params_sharded, axis)
        paths = _flatten(placed)
        leaves = [leaf for _, leaf in paths]
        shards = []
        for leaf in leaves:
            if stage < 3 and _shardable(leaf, world):
                # This rank's rows of the replicated value, as a view: the
                # update writes them in place.
                leaf = dt.DTensor.from_local(
                    rows_of(leaf.to_local()), mesh,
                    leaf_spec(leaf, mesh, True, axis), run_check=False)
            shards.append(leaf)
        state = OptimizerState(optimizer_factory(shards), placed,
                               [p for p, _ in paths], leaves, shards, mesh,
                               axis)
        if not compressed:
            return placed, state
        residual = None
        if spec is not None:
            residual = _unflatten(placed, [dt.DTensor.from_local(
                torch.zeros(p.numel(), dtype=torch.float32,
                            device=p.to_local().device), mesh,
                _sharded(mesh, axis), run_check=False) for p in leaves])
            state.residual = [r.to_local() for _, r in _flatten(residual)]
        sizes = _unflatten(placed, [torch.tensor(
            p.numel(), dtype=torch.int32, device=p.to_local().device)
            for p in leaves])
        return placed, _ZeroState(inner=state, sizes=sizes,
                                  residual=residual)

    plan = {}

    def step(params, opt_state, batch):
        st = opt_state.inner if compressed else opt_state
        leaves = st.params
        sharded = [_shardable(p, world) for p in leaves]
        gathers, fulls = [], []
        for p, sh in zip(leaves, sharded):
            local = p.to_local()
            if stage == 3 and sh:
                rows = local.detach().requires_grad_(not compressed)
                gathers.append(rows)
                full = _GatherRows.apply(rows, axis, mesh) if not compressed \
                    else XC.allgather_scheduled(rows, axis, mesh=mesh)
                fulls.append(full.detach().requires_grad_()
                             if compressed else full)
            else:
                gathers.append(None)
                fulls.append(local.detach().requires_grad_())
        loss = loss_fn(_unflatten(params, list(fulls)), batch)
        loss.backward()
        for i, (s, sh) in enumerate(zip(st.shards, sharded)):
            if stage == 3 and sh and not compressed:
                # Reduce-scattered by the gather's backward.
                g = _grad(gathers[i])
            else:
                g = _grad(fulls[i])
                if spec is not None:
                    g = _feed_back(g, st.residual[i], spec)
                if sh and stage == 2 and not compressed:
                    g = XC.reducescatter_scheduled(g, Average, axis,
                                                   mesh=mesh)
                else:
                    g = XC.allreduce_scheduled(g, Average, axis, spec=spec,
                                               wire_dtype=wire_dtype,
                                               mesh=mesh)
                    if sh:
                        g = rows_of(g)
            s.grad = dt.DTensor.from_local(g.contiguous(), mesh, s.placements,
                                           run_check=False)
        st.optimizer.step()
        for s in st.shards:
            s.grad = None
        if stage < 3:
            with torch.no_grad():
                for p, s, sh in zip(leaves, st.shards, sharded):
                    if sh:
                        p.to_local().copy_(XC.allgather_scheduled(
                            s.to_local(), axis, mesh=mesh))
        loss = XC.allreduce_scheduled(loss.detach().float(), Average, axis,
                                      mesh=mesh)
        if compressed:
            if "wire" not in plan:
                axes = XC.axes_of(axis)
                lsz, csz = (mesh.size(mesh.mesh_dim_names.index(axes[0])),
                            mesh.size(mesh.mesh_dim_names.index(axes[1]))) \
                    if len(axes) == 2 else (world, 1)
                plan["wire"] = XC.plan_allreduce_step(
                    [p.numel() for p in leaves], local_size=lsz,
                    cross_size=csz, spec=spec, wire_dtype=wire_dtype)
            XC.record_wire_bytes(*plan["wire"])
        return params, opt_state, loss

    return ZeroStepFns(init=init, step=step, stage=stage)


def _paths(tree, prefix: str = "") -> List[tuple]:
    """(key path, leaf) of every tensor of ``tree`` in the reference's
    flatten order, an ``OptimizerState`` seen as its optax state."""
    from ..checkpoint.zero import _container_children
    if isinstance(tree, OptimizerState):
        return _paths(tree.tree(), prefix)
    kids = _container_children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [x for step, child in kids for x in _paths(child, prefix + step)]


def _nbytes(t) -> int:
    return int(t.numel()) * int(t.element_size())


def per_device_bytes(tree) -> dict:
    """{device: bytes this rank holds} over every leaf: a DTensor's local
    shard, a tensor whole, anything else with ``nbytes`` under "host".
    Every rank of a ZeRO state holds the same (shards divide evenly)."""
    dt = _dt()
    out: dict = {}
    for _, leaf in _paths(tree):
        if isinstance(leaf, dt.DTensor):
            local = leaf.to_local()
            dev, n = local.device, _nbytes(local)
        elif isinstance(leaf, torch.Tensor):
            dev, n = leaf.device, _nbytes(leaf)
        elif hasattr(leaf, "nbytes"):
            dev, n = "host", int(leaf.nbytes)
        else:
            continue
        out[dev] = out.get(dev, 0) + n
    return out


def residency_report(tree, mesh, axis=DATA_AXIS) -> dict:
    """Residency of a tree: total logical bytes, the most bytes a device
    of this rank holds, the 1/world ideal, and the leaves that could not
    shard (dim 0 not divisible), under the reference's key paths."""
    world = _axis_world(mesh, axis)
    total = 0
    unsharded = []
    for path, leaf in _paths(tree):
        n = _nbytes(leaf) if isinstance(leaf, torch.Tensor) else \
            int(getattr(leaf, "nbytes", 0))
        total += n
        if not _shardable(leaf, world):
            unsharded.append(path)
    per_dev = per_device_bytes(tree)
    max_dev = max(per_dev.values()) if per_dev else 0
    return {
        "total_bytes": total,
        "max_device_bytes": max_dev,
        "ideal_bytes": total // world,
        "ratio_to_ideal": (max_dev * world / total) if total else 0.0,
        "unsharded_leaves": unsharded,
        "world": world,
    }
