"""Quantized and topology-scheduled collectives of the GSPMD plane (port of
horovod_tpu/ops/xla_collectives.py; the name is kept so that a reader finds
its counterpart).

The reference's are jit-traceable ``jnp`` wrappers over named mesh axes
inside ``shard_map``; the port's run eagerly over the process groups of a
``DeviceMesh``'s dimensions.  Three layers, as in the reference:

* **Scheduled collectives** — :func:`allreduce_scheduled`,
  :func:`reducescatter_scheduled`, :func:`allgather_scheduled`,
  :func:`all_to_all_wire`.  ``axis`` is a dimension name of ``mesh``
  (default the runtime's ``mesh()``), a pair of them (jointly, the first
  major), ``"local"``/``"cross"`` of ``init()``'s two-level topology where
  the mesh has no dimension of that name, a ``ProcessGroup``, or ``None``
  (the world).  The compressed wires are ``ops.quantization``'s two-pass
  schedules; the fp32 wire is a plain ``all_reduce`` /
  ``reduce_scatter_tensor`` / ``all_gather_into_tensor``.  With a pair of
  axes, :func:`choose_schedule` picks flat or hierarchical per payload.
* **Analytic wire accounting** — :func:`plan_allreduce_step` and the
  ``*_wire_bytes`` functions, plain arithmetic equal to the reference's
  byte for byte; :func:`record_wire_bytes` keeps a running total per kind
  in this module (:func:`wire_totals`) and feeds the ``hvd_wire_*``
  metric families, as the reference does.
* **Wire resolution** — :func:`resolve_wire`.

The compressed schedules accumulate in fp32 and the wire dtype only
travels; the fp32 wire reduces in the tensor's own dtype, as the
reference's ``psum`` does.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..core import config as _cfg
from ..core.state import global_state
from . import quantization as Q
from .quantization import QuantSpec

Axis = Union[str, Sequence[str]]
_TWO_LEVEL = ("local", "cross")


def axes_of(axis: Axis) -> Tuple[str, ...]:
    """Normalize a mesh-axis argument to a tuple of axis names."""
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_arg(axis: Axis):
    """A bare name for a single axis, the tuple for a joint axis."""
    axes = axes_of(axis)
    return axes[0] if len(axes) == 1 else axes


def resolve_wire(compression):
    """``compression=`` (Compressor class, name, or None → the session
    knob) → ``(spec, wire_dtype)``.  Both None means the fp32 wire;
    otherwise exactly one is set."""
    from . import collective as C
    comp = C._resolve_compression(compression)
    if comp is None:
        return None, None
    if getattr(comp, "bits", None) is not None:
        return comp.spec(), None
    return None, comp.wire_dtype


def choose_schedule(kind: str, nbytes: int) -> str:
    """Flat vs hierarchical for one payload of ``kind`` ("allreduce" or
    "allgather"), the reference's precedence: the active dispatch table
    (``ops.dispatch``, probed or pinned at ``init()`` with a controller)
    for this payload first, then the explicit ``HVD_TPU_HIERARCHICAL_*``
    pin, then the boolean, else flat — the values ``init()`` read, or the
    environment before ``init()``."""
    from . import dispatch as D
    table = D.active_table()
    if table is not None and kind in D.KINDS:
        return table.choose(kind, int(nbytes))
    if global_state.initialized:
        pin = getattr(global_state, f"hierarchical_{kind}_pin", None)
        flag = getattr(global_state, f"hierarchical_{kind}", False)
    else:
        pin, flag = _cfg.hierarchical_pin(kind), _cfg.hierarchical(kind)
    if pin is not None:
        return "hier" if pin else "flat"
    return "hier" if flag else "flat"


# ---------------------------------------------------------------------------
# axes → process groups
# ---------------------------------------------------------------------------

def _mesh_of(mesh):
    if mesh is not None:
        return mesh
    from ..core.basics import mesh as runtime_mesh
    return runtime_mesh()


def _group(name, mesh=None):
    """The process group of one axis (see the module docstring); ``"local"``
    and ``"cross"`` stay names, which ``ops.quantization`` resolves."""
    if name is None or isinstance(name, dist.ProcessGroup):
        return name
    if mesh is None and name in _TWO_LEVEL:
        return name
    m = _mesh_of(mesh)
    if name in (m.mesh_dim_names or ()):
        return m.get_group(name)
    if name in _TWO_LEVEL:
        return name
    raise ValueError(f"axis {name!r} is not a dimension of the mesh "
                     f"{m.mesh_dim_names}")


def _joint(axes: Tuple[str, ...], mesh=None):
    """The group of a pair of axes taken jointly, the first major: the
    world, which the pair must span as the whole of a row-major mesh (its
    rank order is then the joint order)."""
    m = _mesh_of(mesh)
    if tuple(m.mesh_dim_names or ()) != axes or \
            m.size() != dist.get_world_size() or \
            m.mesh.flatten().tolist() != list(range(m.size())):
        raise ValueError(f"joint axis {axes} must be the whole of a "
                         "row-major mesh over the world")
    return None


def _check_sum_average(op: int, what: str) -> None:
    from . import collective as C
    if op not in (C.Sum, C.Average):
        raise ValueError(f"{what} supports Sum/Average")


# ---------------------------------------------------------------------------
# scheduled collectives
# ---------------------------------------------------------------------------

def allreduce_scheduled(x: torch.Tensor, op: int, axis: Axis,
                        spec: Optional[QuantSpec] = None, wire_dtype=None,
                        prescale: float = 1.0, postscale: float = 1.0,
                        mesh=None) -> torch.Tensor:
    """Allreduce over ``axis`` (a name or a pair).  With a pair and a
    "hier" schedule for this payload, the two-level
    ``compressed_allreduce_hierarchical``; else the flat two-pass schedule
    over the joint axis.  The fp32 wire (``spec`` and ``wire_dtype``
    None) is ``all_reduce`` over each axis in turn.  Out dtype = in
    dtype."""
    from . import collective as C
    axes = axes_of(axis)
    if spec is None and wire_dtype is None:
        _check_sum_average(op, "allreduce_scheduled")
        acc = x * prescale if prescale != 1.0 else x.clone()
        world = 1
        for a in axes:
            group = Q._group(_group(a, mesh))
            world *= Q._size(group)
            if group is not Q._SELF:
                dist.all_reduce(acc, group=group)
        if op == C.Average:
            acc = Q._div(acc, world)
        return (acc * postscale if postscale != 1.0 else acc).to(x.dtype)
    kw = dict(spec=spec, wire_dtype=wire_dtype, prescale=prescale,
              postscale=postscale)
    if len(axes) == 2 and \
            choose_schedule("allreduce", 4 * x.numel()) == "hier":
        return Q.compressed_allreduce_hierarchical(
            x, _group(axes[0], mesh), _group(axes[1], mesh), op, **kw)
    group = _group(axes[0], mesh) if len(axes) == 1 else _joint(axes, mesh)
    return Q.compressed_allreduce(x, group, op, **kw)


def reducescatter_scheduled(x: torch.Tensor, op: int, axis: Axis,
                            spec: Optional[QuantSpec] = None,
                            wire_dtype=None, mesh=None) -> torch.Tensor:
    """Reduce-scatter along dim 0 over ``axis`` (a pair runs the flat
    schedule over the joint axis: a single pass has no cross phase to
    restructure)."""
    from . import collective as C
    axes = axes_of(axis)
    group = _group(axes[0], mesh) if len(axes) == 1 else _joint(axes, mesh)
    if spec is not None or wire_dtype is not None:
        return Q.compressed_reducescatter(x, group, op, spec=spec,
                                          wire_dtype=wire_dtype)
    _check_sum_average(op, "reducescatter_scheduled")
    group = Q._group(group)
    world = Q._size(group)
    if x.dim() == 0 or x.shape[0] % world:
        raise ValueError(f"reducescatter dim0 {tuple(x.shape)[:1]} not "
                         f"divisible by {world}")
    if group is Q._SELF:
        acc = x.clone()
    else:
        acc = x.new_empty((x.shape[0] // world,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(acc, x.contiguous(), group=group)
    if op == C.Average:
        acc = Q._div(acc, world)
    return acc.to(x.dtype)


def allgather_scheduled(x: torch.Tensor, axis: Axis,
                        spec: Optional[QuantSpec] = None, wire_dtype=None,
                        mesh=None) -> torch.Tensor:
    """All-gather along dim 0 over ``axis``.  With a pair and a "hier"
    schedule for the full gathered payload, the payload is compressed once
    and gathered over the minor axis, then the major one; flat gathers
    once over the joint axis.  A gather has no error-feedback channel:
    the quantization loss lands on the consumer."""
    axes = axes_of(axis)
    if spec is None and wire_dtype is None:
        group = _group(axes[0], mesh) if len(axes) == 1 \
            else _joint(axes, mesh)
        return Q._all_gather(x, Q._group(group))
    groups = [_group(a, mesh) for a in axes]
    world = 1
    for g in groups:
        world *= Q._size(Q._group(g))
    if len(axes) == 2 and \
            choose_schedule("allgather", 4 * x.numel() * world) == "hier":
        return Q.compressed_allgather(x, tuple(groups), spec=spec,
                                      wire_dtype=wire_dtype)
    group = groups[0] if len(axes) == 1 else _joint(axes, mesh)
    return Q.compressed_allgather(x, group, spec=spec, wire_dtype=wire_dtype)


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all, whose backward sends the gradient's rows back
    the same way: an all-to-all is its own transpose."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return Q._all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return Q._all_to_all(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Row p of ``x`` (dim 0 = the group's size) to member p, row s of the
    result from member s; differentiable.  ``group`` is a process group,
    None (the world) or an axis of one member."""
    if Q._size(group) == 1:
        return x
    return _AllToAll.apply(x, group)


def all_to_all_wire(v: torch.Tensor, axis_name, quant: Optional[QuantSpec],
                    mesh=None) -> torch.Tensor:
    """Exchange the rows of ``v`` (leading dim = the axis size) over
    ``axis_name``: row p goes to member p, row s of the result came from
    member s.  On the quantized wire each row is quantized on its own
    (the receiver needs no metadata of another row) and the payload and
    the fp32 scales travel as two all-to-alls; the output is then fp32.
    The plain wire is differentiable; the quantized one is not yet."""
    group = Q._group(_group(axis_name, mesh))
    if quant is None:
        return all_to_all(v, group)
    if torch.is_grad_enabled() and v.requires_grad:
        raise NotImplementedError(
            "the quantized all-to-all wire has no gradient yet (ROADMAP.md "
            "queue 1 item 6, moe_transformer's dispatch_bits)")
    row_elems = int(v[0].numel())
    row_shape = tuple(v.shape[1:])
    pairs = [Q.quantize(row, quant) for row in v]
    q = Q._all_to_all(torch.stack([p[0] for p in pairs]), group)
    s = Q._all_to_all(torch.stack([p[1] for p in pairs]), group)
    return torch.stack([Q.dequantize(qi, si, quant, row_elems, row_shape,
                                     torch.float32)
                        for qi, si in zip(q, s)])


# ---------------------------------------------------------------------------
# analytic wire accounting (shapes only: the reference's arithmetic)
# ---------------------------------------------------------------------------

def _itemsize(wire_dtype) -> int:
    if isinstance(wire_dtype, torch.dtype):
        return wire_dtype.itemsize
    return int(np.dtype(wire_dtype).itemsize)


def wire_bytes_of(n: int, spec: Optional[QuantSpec] = None,
                  wire_dtype=None) -> int:
    """Bytes ``n`` fp32 elements occupy in the selected wire format
    (block padding ignored, like :func:`Q.wire_bytes`)."""
    if spec is not None:
        return Q.wire_bytes(n, spec)
    if wire_dtype is not None:
        return n * _itemsize(wire_dtype)
    return 4 * n


def allreduce_wire_bytes(n: int, spec: Optional[QuantSpec] = None,
                         wire_dtype=None) -> Tuple[int, int]:
    """Per-rank ``(raw, sent)`` bytes of one flat two-pass allreduce of
    ``n`` elements: both passes move the payload."""
    return 2 * 4 * n, 2 * wire_bytes_of(n, spec, wire_dtype)


def reducescatter_wire_bytes(n: int, spec: Optional[QuantSpec] = None,
                             wire_dtype=None) -> Tuple[int, int]:
    """Per-rank ``(raw, sent)`` of one reduce-scatter (first pass only)."""
    return 4 * n, wire_bytes_of(n, spec, wire_dtype)


def allgather_wire_bytes(n: int, spec: Optional[QuantSpec] = None,
                         wire_dtype=None) -> Tuple[int, int]:
    """Per-rank ``(raw, sent)`` of one all-gather of ``n`` local
    elements (compressed once, gathered once)."""
    return 4 * n, wire_bytes_of(n, spec, wire_dtype)


def hierarchical_allreduce_wire_bytes(n: int, local_size: int,
                                      cross_size: int,
                                      spec: Optional[QuantSpec] = None,
                                      wire_dtype=None) -> dict:
    """Bytes of one hierarchical allreduce of ``n`` elements over a
    (local, cross) = (L, C) pair, the arithmetic of
    ``Q.compressed_allreduce_hierarchical``: ``local`` both local phases
    (``2 × wire(n_pad)``), ``cross`` the cross-node two-pass allreduce of
    the 1/L shard (``2 × wire(shard)``), ``sent`` their sum, ``raw``
    ``2 × 4n``, and ``cross_flat`` what the flat schedule of the same
    wire pushes across nodes (``2 × wire(n_pad)``)."""
    block = spec.block if spec is not None else 1
    npad = n + (-n) % (local_size * block)
    shard = npad // local_size
    spad = shard + (-shard) % (cross_size * block)
    local_b = 2 * wire_bytes_of(npad, spec, wire_dtype)
    cross_b = 2 * wire_bytes_of(spad, spec, wire_dtype)
    return {
        "raw": 2 * 4 * n,
        "local": local_b,
        "cross": cross_b,
        "sent": local_b + cross_b,
        "cross_flat": 2 * wire_bytes_of(npad, spec, wire_dtype),
    }


class StepWireBytes(NamedTuple):
    """Per-rank analytic bytes one step puts on the wire."""
    raw: int
    sent: int


def plan_allreduce_step(sizes: Sequence[int], local_size: int = 1,
                        cross_size: int = 1,
                        spec: Optional[QuantSpec] = None,
                        wire_dtype=None) -> StepWireBytes:
    """Price one step's gradient allreduces: per leaf, the schedule
    :func:`choose_schedule` selects — the dispatch table's verdict for
    the leaf's fp32 bytes where one is active (hierarchical only where a
    real (local, cross) split exists), summed over the leaves."""
    raw = sent = 0
    hier_avail = local_size > 1 and cross_size > 1
    for n in sizes:
        n = int(n)
        r, s = allreduce_wire_bytes(n, spec, wire_dtype)
        if (spec is not None or wire_dtype is not None) and hier_avail \
                and choose_schedule("allreduce", 4 * n) == "hier":
            s = hierarchical_allreduce_wire_bytes(
                n, local_size, cross_size, spec, wire_dtype)["sent"]
        raw += r
        sent += s
    return StepWireBytes(raw=raw, sent=sent)


# kind → [raw, sent] bytes recorded so far in this process.
WIRE_TOTALS: Dict[str, list] = {}


def record_wire_bytes(raw: int, sent: int, kind: str = "gspmd") -> None:
    """Add one step's priced bytes to the running total of ``kind`` and
    to its wire-byte counters (``hvd_wire_bytes_{raw,sent}_total``,
    ``hvd_wire_compression_ratio``)."""
    if raw <= 0 or sent <= 0:
        return
    total = WIRE_TOTALS.setdefault(kind, [0, 0])
    total[0] += int(raw)
    total[1] += int(sent)
    from . import collective as C
    _ops, _bts, _lat, raw_c, sent_c, ratio_g = C._collective_metrics(kind)
    raw_c.inc(raw)
    sent_c.inc(sent)
    ratio_g.set(raw / sent)


def wire_totals(kind: str = "gspmd") -> StepWireBytes:
    """The (raw, sent) bytes :func:`record_wire_bytes` added up for
    ``kind``."""
    raw, sent = WIRE_TOTALS.get(kind, (0, 0))
    return StepWireBytes(raw=raw, sent=sent)
