"""Collectives over ``torch.distributed`` (port of
horovod_tpu/ops/collective.py): allreduce / grouped_allreduce / allgather /
broadcast / alltoall / reducescatter / join / barrier, their ``*_async``
forms with ``poll``/``synchronize``, and the ``compression=`` wire.

Reduce-op codes match the reference C API (operations.cc:911-913).  The
result contract is the reference's: ``out.dtype == in.dtype``; integer
``Average`` stays in the integer domain (sum, then floor-divide by the
world size); fractional pre/postscale factors on integers go through
float32 with one trailing cast (collective.py:365-413).

``axis_name`` is the reference's: ``None`` is the world, and
``("local", "cross")`` is the two-level topology ``init()`` made —
allreduce runs the hierarchical compressed schedule over it when the wire
is compressed (uncompressed, the sum over both levels is the world's), and
allgather gathers over cross, then local, ordering the pieces local-major
as the reference's joint mesh axis does.  broadcast, alltoall and
reducescatter count the joint axis' members in that order too: member j is
local rank j // cross_size of host j % cross_size.

``op=Adasum`` runs ``ops.adasum``: the VHDD ladder over the world, or the
hierarchical schedule over ``("local", "cross")``, the only axis whose
Adasum takes ``compression=`` (on its intra-node phases).

``compression`` (``Compression.{fp16,bf16,int8,int4}``, a name, or None for
the ``HVD_TPU_COMPRESSION`` session default) routes Sum/Average of floating
tensors through the two-pass schedules of ``ops.quantization``, whose
bytes on the wire are the compressed ones on both passes.  An explicit
compressor on an integer tensor or another op raises; the session default
leaves such calls alone.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..core import handles as _handles
from ..core.basics import _check_init
from ..core.state import global_state
from . import quantization as Q


class ReduceOp(int):
    pass


Average = ReduceOp(0)
Sum = ReduceOp(1)
Adasum = ReduceOp(2)
Min = ReduceOp(3)
Max = ReduceOp(4)
Product = ReduceOp(5)

_DIST_OPS = {Sum: dist.ReduceOp.SUM, Average: dist.ReduceOp.SUM,
             Min: dist.ReduceOp.MIN, Max: dist.ReduceOp.MAX,
             Product: dist.ReduceOp.PRODUCT}

_JOINT = ("local", "cross")


def _check_op(op: int) -> None:
    if op not in _DIST_OPS and op != Adasum:
        raise ValueError(f"unknown reduce op {op}")


def _check_axis(axis_name):
    """``None`` (the world) or ``("local", "cross")``."""
    if axis_name is None:
        return None
    if isinstance(axis_name, (tuple, list)) and tuple(axis_name) == _JOINT:
        return _JOINT
    raise ValueError("axis_name must be None or ('local', 'cross'), got "
                     f"{axis_name!r}")


def _joint_ranks() -> List[int]:
    """The world rank of each member of the ``("local", "cross")`` axis, in
    the axis' order: member j is local rank j // C of host j % C
    (local-major, as the reference's joint mesh axis counts).  Raises
    without the two-level topology."""
    Q._group("local")
    L, C = global_state.local_size, global_state.cross_size
    return [(j % C) * L + j // C for j in range(L * C)]


def _axis_ranks(axis) -> List[int]:
    """World ranks of the axis' members in the axis' order."""
    return list(range(global_state.size)) if axis is None else _joint_ranks()


def _axis_index(axis) -> int:
    """This rank's index on the axis."""
    return _axis_ranks(axis).index(global_state.rank)


def _to_world_order(rows: torch.Tensor, axis) -> torch.Tensor:
    """Rows indexed by axis member → rows indexed by world rank."""
    if axis is None:
        return rows
    member = {r: j for j, r in enumerate(_joint_ranks())}
    return rows[[member[w] for w in range(global_state.size)]]


def _axis_all_gather(x: torch.Tensor, axis) -> torch.Tensor:
    """Tiled all-gather along dim 0 over the axis, in the axis' order."""
    if axis is None:
        return Q._all_gather(x, None)
    for a in reversed(_JOINT):    # cross first: the pieces end local-major
        x = Q._all_gather(x, Q._group(a))
    return x


# ---------------------------------------------------------------------------
# wire compression
# ---------------------------------------------------------------------------

def _resolve_compression(compression, session_default: bool = True):
    """Normalize a ``compression=`` argument (Compressor class, name
    string, or None) to a real compressor class or None.  A None argument
    falls back to the session default (the ``HVD_TPU_COMPRESSION`` knob
    read by ``init()``) when ``session_default``."""
    from .compression import by_name
    if compression is None:
        if not session_default or global_state.compression == "none":
            return None
        compression = global_state.compression
    if isinstance(compression, str):
        compression = by_name(compression)
    if getattr(compression, "wire", "none") == "none":
        return None
    return compression


def _compressible(tensor: torch.Tensor, op: int) -> bool:
    """A lossy wire only composes with Sum/Average over floats."""
    return op in (Sum, Average) and tensor.is_floating_point()


def _check_compressible(tensor: torch.Tensor, op: int,
                        explicit: bool) -> bool:
    """Gate the compressed path.  An explicitly requested compressor on an
    incompatible op/dtype raises (a silent fp32 fallback would misstate
    the wire); the session default degrades silently — it must not break
    integer reductions or Min/Max that share the API."""
    ok = _compressible(tensor, op)
    if not ok and explicit:
        raise ValueError(
            "compression requires a floating tensor and op Sum/Average "
            f"(got dtype {tensor.dtype}, op {int(op)})")
    return ok


def _wire(tensor: torch.Tensor, op: int, compression):
    """The compressor this call runs through, or None."""
    comp = _resolve_compression(compression)
    if comp is not None and \
            _check_compressible(tensor, op, compression is not None):
        return comp
    return None


def _compressed_allreduce(tensor, op, axis, comp, prescale, postscale):
    spec = comp.spec()
    kw = dict(spec=spec, wire_dtype=None if spec is not None
              else comp.wire_dtype, prescale=prescale, postscale=postscale)
    if axis == _JOINT:
        return Q.compressed_allreduce_hierarchical(tensor, "local", "cross",
                                                   op, **kw)
    return Q.compressed_allreduce(tensor, None, op, **kw)


# ---------------------------------------------------------------------------
# allreduce
# ---------------------------------------------------------------------------

def _is_int(tensor: torch.Tensor) -> bool:
    return not (tensor.is_floating_point() or tensor.is_complex())


def _prepare(tensor, prescale, postscale):
    """The buffer the reduction runs on: ``tensor`` itself, or an fp32
    copy for an integer tensor with a scale factor; prescaled."""
    scaled = prescale != 1.0 or postscale != 1.0
    x = tensor.float() if (_is_int(tensor) and scaled) else tensor
    if prescale != 1.0:
        x.mul_(prescale)
    return x


def _finish(tensor, x, op, postscale):
    """Average and postscale ``x`` after its reduction; write it back into
    ``tensor`` (truncating to an integer dtype)."""
    if op == Average:
        if _is_int(x):
            x.div_(global_state.size, rounding_mode="floor")
        else:
            x.div_(global_state.size)
    if postscale != 1.0:
        x.mul_(postscale)
    if x is not tensor:
        tensor.copy_(x.trunc() if _is_int(tensor) else x)
    return tensor


def _allreduce_plain(tensor, op, prescale, postscale):
    x = _prepare(tensor, prescale, postscale)
    dist.all_reduce(x, op=_DIST_OPS[op])
    return _finish(tensor, x, op, postscale)


def _adasum(tensor, axis, compression, prescale, postscale):
    """Adasum of ``tensor`` over the axis (reference collective.py:386-405):
    an explicit compressor rides the hierarchical schedule's intra-node
    phases and needs the joint axis; the session default does not reach
    Adasum."""
    from . import adasum as A
    comp = _resolve_compression(compression, session_default=False)
    if comp is not None and axis != _JOINT:
        raise ValueError(
            "compression with op=Adasum requires a (local, cross) "
            "axis_name pair — the compressed wire rides the hierarchical "
            "schedule's intra-node phases")
    x = tensor * prescale if prescale != 1.0 else tensor
    if axis == _JOINT:
        spec = comp.spec() if comp is not None else None
        out = A.adasum_allreduce_hierarchical(
            x, spec=spec, wire_dtype=None if comp is None or spec is not None
            else comp.wire_dtype)
    else:
        out = A.adasum_allreduce(x)
    if postscale != 1.0:
        out = out * postscale
    return out.to(tensor.dtype)


def allreduce_(tensor: torch.Tensor, op: int = Average,
               prescale_factor: float = 1.0, postscale_factor: float = 1.0,
               axis_name=None, compression=None) -> torch.Tensor:
    """In-place allreduce of ``tensor`` across the world; returns it."""
    _check_init()
    _check_op(op)
    axis = _check_axis(axis_name)
    if op == Adasum:
        return tensor.copy_(_adasum(tensor, axis, compression,
                                    prescale_factor, postscale_factor))
    comp = _wire(tensor, op, compression)
    if comp is not None:
        return tensor.copy_(_compressed_allreduce(
            tensor, op, axis, comp, prescale_factor, postscale_factor))
    return _allreduce_plain(tensor, op, prescale_factor, postscale_factor)


def allreduce(tensor: torch.Tensor, op: int = Average, axis_name=None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              name: Optional[str] = None, compression=None) -> torch.Tensor:
    """Allreduce a tensor across the world; returns a new tensor.  ``name``
    is accepted for API parity with the reference."""
    del name
    _check_init()
    _check_op(op)
    axis = _check_axis(axis_name)
    if op == Adasum:
        return _adasum(tensor, axis, compression, prescale_factor,
                       postscale_factor)
    comp = _wire(tensor, op, compression)
    if comp is not None:
        return _compressed_allreduce(tensor, op, axis, comp,
                                     prescale_factor, postscale_factor)
    return _allreduce_plain(tensor.clone(), op, prescale_factor,
                            postscale_factor)


def grouped_allreduce(tensors: Sequence[torch.Tensor], op: int = Average,
                      axis_name=None, prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      name: Optional[str] = None,
                      compression=None) -> List[torch.Tensor]:
    """Allreduce a group together.  Uncompressed, members of one dtype and
    device are fused into one flat buffer and reduced by one collective
    (the reference's fusion of a group, operations.cc:1041-1048).  On a
    compressed wire each member goes alone, as in the reference
    (collective.py:636-643): fusing would move the quantization blocks.
    So does Adasum, whose coefficients are the whole tensor's."""
    del name
    _check_init()
    _check_op(op)
    _check_axis(axis_name)
    tensors = list(tensors)
    if op == Adasum or _resolve_compression(compression) is not None:
        return [allreduce(t, op, axis_name, prescale_factor,
                          postscale_factor, compression=compression)
                for t in tensors]
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    buckets = {}
    for i, t in enumerate(tensors):
        buckets.setdefault((t.dtype, t.device), []).append(i)
    for idx in buckets.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        _allreduce_plain(flat, op, prescale_factor, postscale_factor)
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out


# ---------------------------------------------------------------------------
# allgather / broadcast / alltoall / reducescatter
# ---------------------------------------------------------------------------

class _Done:
    """The ``Work`` of an exchange that needed no communication."""

    @staticmethod
    def wait():
        return True

    @staticmethod
    def is_completed():
        return True


def _issue_gather(x: torch.Tensor, group):
    """Gather ``x`` along dim 0 over ``group``, dim 0 allowed to differ:
    exchange the sizes (blocking), then issue the gather of copies padded
    to the largest with ``async_op=True`` (gloo and NCCL both need equal
    sizes).  Returns ``(work, finish)``; ``finish()`` after ``work.wait()``
    gives the concatenation."""
    if group is Q._SELF:
        return _Done, x.clone
    world = dist.get_world_size(group)
    x = x.contiguous()
    sizes = torch.empty(world, dtype=torch.int64, device=x.device)
    dist.all_gather_into_tensor(
        sizes, torch.tensor([x.shape[0]], dtype=torch.int64,
                            device=x.device), group=group)
    sizes = sizes.tolist()
    top = max(sizes)
    if x.shape[0] < top:
        x = torch.cat([x, x.new_zeros((top - x.shape[0],) + x.shape[1:])])
    out = x.new_empty((world * top,) + x.shape[1:])
    work = dist.all_gather_into_tensor(out, x, group=group, async_op=True)

    def finish():
        if min(sizes) == top:
            return out
        return torch.cat([out[i * top: i * top + s]
                          for i, s in enumerate(sizes)])
    return work, finish


def _gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    work, finish = _issue_gather(x, group)
    work.wait()
    return finish()


def allgather(tensor: torch.Tensor, axis_name=None,
              name: Optional[str] = None) -> torch.Tensor:
    """Gather tensors from all members, concatenated along dim 0; dim 0
    may differ between members (reference eager.py:814-847)."""
    del name
    _check_init()
    axis = _check_axis(axis_name)
    if tensor.dim() == 0:
        raise ValueError("allgather needs a tensor of at least one dimension")
    if axis is None:
        return _gather_rows(tensor, None)
    out = tensor
    for a in reversed(_JOINT):   # cross first: the pieces end local-major
        out = _gather_rows(out, Q._group(a))
    return out


def broadcast_(tensor: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    """In-place broadcast of the root's value; returns ``tensor``."""
    _check_init()
    dist.broadcast(tensor, src=root_rank)
    return tensor


def broadcast(tensor: torch.Tensor, root_rank: int = 0, axis_name=None,
              name: Optional[str] = None) -> torch.Tensor:
    """Broadcast the root member's value to all members; returns a new
    tensor.  Over ``("local", "cross")``, ``root_rank`` is the root's index
    on that axis."""
    del name
    _check_init()
    ranks = _axis_ranks(_check_axis(axis_name))
    if not 0 <= root_rank < len(ranks):
        raise ValueError(f"root_rank {root_rank} is not a member of the "
                         f"axis of {len(ranks)}")
    return broadcast_(tensor.clone(), ranks[root_rank])


def _split_sizes(tensor: torch.Tensor, splits, world: int) -> List[int]:
    """Validated per-member row counts: ``splits``, or dim 0 in equal
    parts."""
    rows = tensor.shape[0] if tensor.dim() else 0
    if splits is None:
        if tensor.dim() == 0 or rows % world:
            raise ValueError(
                f"alltoall dim0 {rows} not divisible by size {world}")
        return [rows // world] * world
    splits = [int(s) for s in splits]
    if len(splits) != world or min(splits) < 0 or sum(splits) > rows:
        raise ValueError(f"alltoall splits {splits} do not split dim0 "
                         f"{rows} into {world} parts")
    return splits


def _issue_alltoall(tensor: torch.Tensor, splits):
    """Exchange the split table (blocking), then issue
    ``all_to_all_single`` with split sizes and ``async_op=True``.  Returns
    ``(work, (received, received_splits))``."""
    world = global_state.size
    splits = _split_sizes(tensor, splits, world)
    x = tensor[:sum(splits)].contiguous()
    table = torch.empty(world * world, dtype=torch.int64, device=x.device)
    dist.all_gather_into_tensor(
        table, torch.tensor(splits, dtype=torch.int64, device=x.device))
    recv = table.view(world, world)[:, global_state.rank].tolist()
    out = x.new_empty((sum(recv),) + x.shape[1:])
    work = dist.all_to_all_single(out, x, output_split_sizes=recv,
                                  input_split_sizes=splits, async_op=True)
    return work, (out, torch.tensor(recv, dtype=torch.int32))


def alltoall(tensor: torch.Tensor, splits: Optional[Sequence[int]] = None,
             axis_name=None, name: Optional[str] = None):
    """Send dim-0 slice ``i`` (of ``splits[i]`` rows, equal by default) to
    member ``i``; returns ``(received, received_splits)``, the pieces in
    member order and an int32 CPU tensor of their row counts (reference
    eager.py:878-916).  Over ``("local", "cross")`` the members are the
    joint axis' and so is their order."""
    del name
    _check_init()
    axis = _check_axis(axis_name)
    if axis is None:
        work, result = _issue_alltoall(tensor, splits)
        work.wait()
        return result
    order = _joint_ranks()
    splits = _split_sizes(tensor, splits, len(order))
    pieces = tensor[:sum(splits)].split(splits)
    member = {r: j for j, r in enumerate(order)}
    world_order = [member[w] for w in range(len(order))]
    work, (out, recv) = _issue_alltoall(
        torch.cat([pieces[j] for j in world_order]),
        [splits[j] for j in world_order])
    work.wait()
    got = out.split(recv.tolist())
    return torch.cat([got[r] for r in order]), recv[order]


def reducescatter(tensor: torch.Tensor, op: int = Average, axis_name=None,
                  name: Optional[str] = None,
                  compression=None) -> torch.Tensor:
    """Reduce, then scatter equal dim-0 chunks (member i of the axis gets
    chunk i); dim 0 must divide by the world.  Sum reduces as Sum, every
    other op as Average, as the reference's eager path does
    (collective.py:745).  ``compression`` routes it through the one-pass
    compressed reduce-scatter (compressed wire, fp32 accumulation,
    full-precision output shard); an explicit compressor with an op other
    than Sum/Average raises."""
    del name
    _check_init()
    _check_op(op)
    axis = _check_axis(axis_name)
    world = global_state.size
    rows = tensor.shape[0] if tensor.dim() else 0
    if tensor.dim() == 0 or rows % world:
        raise ValueError(f"reducescatter dim0 {rows} not divisible by "
                         f"{world}")
    comp = _wire(tensor, op, compression)
    op = Sum if op == Sum else Average
    if axis is not None:
        chunks = tensor.reshape((world, rows // world) + tensor.shape[1:])
        tensor = _to_world_order(chunks, axis).reshape(tensor.shape)
    if comp is not None:
        spec = comp.spec()
        return Q.compressed_reducescatter(
            tensor, None, op, spec=spec,
            wire_dtype=None if spec is not None else comp.wire_dtype)
    out = tensor.new_empty((rows // world,) + tensor.shape[1:])
    dist.reduce_scatter_tensor(out, tensor.contiguous(),
                               op=dist.ReduceOp.SUM)
    if op == Average:
        if _is_int(out):
            out.div_(world, rounding_mode="floor")
        else:
            out.div_(world)
    return out


# ---------------------------------------------------------------------------
# join / barrier
# ---------------------------------------------------------------------------

def communicator_size() -> int:
    """Number of processes the collectives span."""
    _check_init()
    return global_state.size


def barrier() -> None:
    """Block until every rank has reached the barrier."""
    _check_init()
    dev = global_state.device
    if dev is not None and dev.type == "cuda":
        dist.barrier(device_ids=[dev.index])
    else:
        dist.barrier()


def join() -> int:
    """Signal this rank has no more data; returns the last rank to join.
    With no negotiating controller there is nothing pending to proxy, so
    join is a barrier that returns size - 1 (reference eager.py:940-952)."""
    barrier()
    return global_state.size - 1


# ---------------------------------------------------------------------------
# async handle API (reference torch/mpi_ops.py:843-882)
#
# Each *_async issues its collective with async_op=True and returns a
# handle; poll() is the Work's is_completed(), synchronize() waits and
# finishes the result (Average division, postscale, cuts).  A compressed
# allreduce runs the synchronous compressed path and wraps its result, as
# the reference does without a controller (collective.py:829-841).
# ---------------------------------------------------------------------------

def _allocate(work=None, finish=None, result=None) -> int:
    if work is None:
        return _handles.handle_manager.allocate(_handles.Handle(result=result))

    def wait():
        work.wait()
        return finish()
    return _handles.handle_manager.allocate(_handles.Handle(
        poll_fn=work.is_completed, wait_fn=wait))


def allreduce_async(tensor: torch.Tensor, op: int = Average,
                    name: Optional[str] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    compression=None) -> int:
    del name
    _check_init()
    _check_op(op)
    if op == Adasum:
        return _allocate(result=_adasum(tensor, None, compression,
                                        prescale_factor, postscale_factor))
    comp = _wire(tensor, op, compression)
    if comp is not None:
        return _allocate(result=_compressed_allreduce(
            tensor, op, None, comp, prescale_factor, postscale_factor))
    out = tensor.clone()
    x = _prepare(out, prescale_factor, postscale_factor)
    work = dist.all_reduce(x, op=_DIST_OPS[op], async_op=True)
    return _allocate(work, lambda: _finish(out, x, op, postscale_factor))


def allgather_async(tensor: torch.Tensor, name: Optional[str] = None) -> int:
    del name
    _check_init()
    if tensor.dim() == 0:
        raise ValueError("allgather needs a tensor of at least one dimension")
    return _allocate(*_issue_gather(tensor, None))


def broadcast_async(tensor: torch.Tensor, root_rank: int = 0,
                    name: Optional[str] = None) -> int:
    del name
    _check_init()
    out = tensor.clone()
    work = dist.broadcast(out, src=root_rank, async_op=True)
    return _allocate(work, lambda: out)


def alltoall_async(tensor: torch.Tensor, splits=None,
                   name: Optional[str] = None) -> int:
    del name
    _check_init()
    work, result = _issue_alltoall(tensor, splits)
    return _allocate(work, lambda: result)


def poll(handle: int) -> bool:
    """Whether the op behind ``handle`` has completed (never blocks)."""
    return _handles.handle_manager.poll(handle)


def synchronize(handle: int):
    """Wait for the op behind ``handle`` and return its result."""
    return _handles.handle_manager.synchronize(handle)
