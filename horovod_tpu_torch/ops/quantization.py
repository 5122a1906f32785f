"""Block-scaled quantization and the two-pass compressed collectives
(port of horovod_tpu/ops/quantization.py).

The wire formats of the quantized collective engine (EQuARX,
arXiv:2506.17615): per-block absmax-scaled int8, and int4 packed two per
byte, as torch ops on whatever device the tensor lives on.  The codecs
give the reference's bytes, on the CPU and on the card alike:
``torch.round`` rounds half to even as ``jnp.round`` does, the scale is an
fp32 ``absmax / qmax`` division, blocks are divided by it (not multiplied
by its reciprocal), and an all-zero block gets scale 1.0.

The wire dtype is never the accumulation dtype.  Every schedule reduces in
fp32 and touches the wire dtype only for transport:

two-pass compressed allreduce::

    quantize ──all_to_all_single──▶ dequantize + fp32 accumulate
                                         │ requantize
                                         ▼
              output ◀──all_gather_into_tensor── quantized reduced shard

Both passes move the quantized payload (plus one fp32 scale per ``block``
elements, which travels in a second call); the first pass alone is the
compressed reducescatter.  A cast wire (bf16/fp16) follows the same
schedule with a dtype cast instead of quantize.

The reference runs these schedules over named mesh axes inside
``shard_map``; the port runs them over ``torch.distributed`` process
groups.  An axis is ``None`` (the world), a ``ProcessGroup``, or one of the
names ``"local"`` / ``"cross"``: the groups of the two-level topology that
``init()`` makes (rank = cross_rank × local_size + local_rank).

The reference's ``qdq_np`` and ``qdq_host`` keep host numpy arrays off the
JAX backend; the port has one torch ``qdq`` for every device and no
counterpart of them.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core import config as _cfg
from ..core.state import global_state

DEFAULT_BLOCK = _cfg.DEFAULT_QUANT_BLOCK


class QuantSpec(NamedTuple):
    """Static description of a quantized wire format."""
    bits: int                   # 8 or 4 (int4 packs two values per byte)
    block: int = DEFAULT_BLOCK  # elements per absmax scale


def default_block() -> int:
    """The session quant block: the value ``init()`` read, else the
    ``HVD_TPU_QUANT_BLOCK`` knob (normalized in core/config.py)."""
    if global_state.initialized:
        return global_state.quant_block
    return _cfg.quant_block()


def _qmax(bits: int) -> int:
    # Symmetric range: int4 uses [-7, 7] so negation round-trips and the
    # packed nibble 0x8 (= -8) never appears.
    return 127 if bits == 8 else 7


def wire_bytes(n: int, spec: QuantSpec) -> int:
    """Bytes on the wire for n fp32 elements under ``spec`` (payload +
    one fp32 scale per block, padding ignored)."""
    payload = n if spec.bits == 8 else (n + 1) // 2
    return payload + 4 * math.ceil(n / spec.block)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(…, block) int8 in [-7, 7] → (…, block/2) int8, two's-complement
    nibbles packed low nibble first."""
    u = q.view(torch.uint8) & 0xF
    return (u[..., 0::2] | (u[..., 1::2] << 4)).view(torch.int8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: (…, block/2) int8 → (…, block) int8."""
    u = p.view(torch.uint8)
    nib = torch.stack([u & 0xF, u >> 4], dim=-1).reshape(
        p.shape[:-1] + (-1,)).to(torch.int16)
    return torch.where(nib >= 8, nib - 16, nib).to(torch.int8)


def _div(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` rounded as one IEEE division on every device.  Divided by
    a Python number, a CUDA tensor is multiplied by the number's
    reciprocal instead, one ulp off the division in some elements; a
    0-dim tensor on x's device keeps the division."""
    return x / x.new_full((), d)


def quantize(x: torch.Tensor, spec: QuantSpec):
    """Flatten + pad ``x`` and quantize per absmax block.

    Returns ``(q, scales)``: ``q`` int8 of shape (nblocks, block) — or
    (nblocks, block/2) for int4 — and fp32 ``scales`` of shape (nblocks,).
    """
    qmax = _qmax(spec.bits)
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % spec.block
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.view(-1, spec.block)
    absmax = blocks.abs().amax(dim=-1)
    scales = torch.where(absmax > 0, _div(absmax, qmax),
                         torch.ones_like(absmax))
    q = torch.round(blocks / scales[:, None]).clamp_(-qmax, qmax)
    q = q.to(torch.int8)
    if spec.bits == 4:
        q = pack_int4(q)
    return q, scales


def dequantize(q: torch.Tensor, scales: torch.Tensor, spec: QuantSpec,
               n: int, shape=None, dtype=None) -> torch.Tensor:
    """Blocks → flat fp32 of the first ``n`` elements (then optional
    reshape/cast).  ``n`` must be the pre-pad flat length."""
    if spec.bits == 4:
        q = unpack_int4(q)
    x = q.to(torch.float32) * scales[..., None]
    x = x.reshape(-1)[:n]
    if shape is not None:
        x = x.reshape(shape)
    if dtype is not None:
        x = x.to(dtype)
    return x


def qdq(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Quantize → dequantize round trip (same shape/dtype): the local
    quantization operator Q.  Error-feedback residuals are x - Q(x)."""
    q, s = quantize(x, spec)
    return dequantize(q, s, spec, x.numel(), x.shape, x.dtype)


# ---------------------------------------------------------------------------
# KV-page migration codec: the serving wire format, serialized to bytes
# ---------------------------------------------------------------------------

def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.from_numpy(np.ascontiguousarray(x))


def encode_pages(x, spec: Optional[QuantSpec]):
    """Serialize a page tensor (torch or numpy) for the migration wire.

    Returns ``(payload, scales)`` bytes: block-scaled int8/int4 under
    ``spec``, or (fp32 little-endian, b"") when ``spec`` is None — the
    reference's bytes for the same values."""
    t = _as_tensor(x)
    if spec is None:
        return t.to(torch.float32).cpu().contiguous().numpy().tobytes(), b""
    q, s = quantize(t, spec)
    return q.cpu().numpy().tobytes(), s.cpu().numpy().tobytes()


def decode_pages(payload: bytes, scales: bytes, spec: Optional[QuantSpec],
                 n: int, shape=None) -> torch.Tensor:
    """Inverse of :func:`encode_pages` → fp32 CPU tensor of the first ``n``
    elements (optionally reshaped)."""
    if spec is None:
        x = torch.from_numpy(np.frombuffer(payload, dtype=np.float32)[:n]
                             .copy())
        return x.reshape(shape) if shape is not None else x
    s = torch.from_numpy(np.frombuffer(scales, dtype=np.float32).copy())
    q = torch.from_numpy(np.frombuffer(payload, dtype=np.int8).copy())
    packed = spec.block if spec.bits == 8 else spec.block // 2
    return dequantize(q.view(-1, packed), s, spec, n, shape)


def page_wire_bytes(n: int, spec: Optional[QuantSpec]) -> int:
    """Bytes :func:`encode_pages` puts on the wire for ``n`` elements
    (block padding included — the exact serialized size)."""
    if spec is None:
        return 4 * n
    nblocks = math.ceil(n / spec.block)
    per_block = spec.block if spec.bits == 8 else spec.block // 2
    return nblocks * per_block + 4 * nblocks


# ---------------------------------------------------------------------------
# Schedules over process groups
# ---------------------------------------------------------------------------

class _SelfAxis:
    """An axis of one member (``local_size`` or ``cross_size`` is 1): its
    collectives are identities."""


_SELF = _SelfAxis()


def _group(axis):
    """The process group of an axis: ``None`` is the world, a group is
    itself, ``"local"``/``"cross"`` are the two-level groups of
    ``init()`` (the world itself where one level spans it, ``_SELF`` where
    the level has one member)."""
    if axis is None or isinstance(axis, dist.ProcessGroup):
        return axis
    if axis not in ("local", "cross"):
        raise ValueError(f"unknown axis {axis!r}: expected None, a process "
                         "group, 'local' or 'cross'")
    gs = global_state
    if not gs.two_level:
        raise ValueError(
            f"axis {axis!r} needs the two-level topology: every rank at "
            "cross_rank × local_size + local_rank of one cross_size × "
            "local_size grid (the same number of ranks on every host)")
    size = gs.local_size if axis == "local" else gs.cross_size
    if size == 1:
        return _SELF
    if size == gs.size:
        return None
    return gs.local_group if axis == "local" else gs.cross_group


def _size(group) -> int:
    return 1 if group is _SELF else dist.get_world_size(group)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Tiled all_to_all: row d of ``x`` goes to member d, row s of the
    result came from member s."""
    if group is _SELF:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Tiled all_gather: the members' ``x`` concatenated along dim 0."""
    if group is _SELF:
        return x
    x = x.contiguous()
    out = x.new_empty((_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def _check_wire(spec, wire_dtype) -> None:
    if (spec is None) == (wire_dtype is None):
        raise ValueError("exactly one of spec/wire_dtype must be set")


def _check_reduce_op(op: int, what: str) -> None:
    from . import collective as C
    if op not in (C.Sum, C.Average):
        raise ValueError(
            f"compressed {what} supports Sum/Average only (a lossy wire "
            f"does not compose with op {int(op)})")


def _rows_to_wire(rows: torch.Tensor, spec: Optional[QuantSpec], wire_dtype):
    """(world, s) fp32 → wire representation: (payload, scales|None)."""
    if spec is None:
        return rows.to(wire_dtype), None
    q, scales = quantize(rows, spec)          # rows are block-aligned
    return q.view(rows.shape[0], -1), scales.view(rows.shape[0], -1)


def _wire_to_f32(payload: torch.Tensor, scales, spec: Optional[QuantSpec],
                 elems: int) -> torch.Tensor:
    """(world, …) wire → (world, elems) fp32 contributions."""
    if spec is None:
        return payload.to(torch.float32)
    world = payload.shape[0]
    packed = spec.block if spec.bits == 8 else spec.block // 2
    return dequantize(payload.reshape(-1, packed), scales.reshape(-1),
                      spec, world * elems).view(world, elems)


def _reduced_shard(x: torch.Tensor, axis, op: int, spec, wire_dtype,
                   prescale: float, keep_sent: bool = False):
    """First pass of the two-pass schedule: quantize (or cast) the local
    tensor, all_to_all the destination shards, dequantize + fp32
    accumulate.

    Returns ``(acc, n, world, sent)``: this member's reduced fp32 shard of
    the flattened-and-padded input (length padded to world × block), the
    true flat length, the axis size, and, when ``keep_sent``, the flat
    fp32 value of what this member sent (else None)."""
    from . import collective as C
    group = _group(axis)
    world = _size(group)
    flat = x.reshape(-1).to(torch.float32)
    if prescale != 1.0:
        flat = flat * prescale
    n = flat.numel()
    pad = (-n) % (world * (spec.block if spec is not None else 1))
    if pad:
        flat = F.pad(flat, (0, pad))
    rows = flat.view(world, -1)               # row d = destination member d
    payload, scales = _rows_to_wire(rows, spec, wire_dtype)
    sent = _wire_to_f32(payload, scales, spec, rows.shape[1]).view(-1)[:n] \
        if keep_sent else None
    payload = _all_to_all(payload, group)
    if scales is not None:
        scales = _all_to_all(scales, group)
    acc = _wire_to_f32(payload, scales, spec, rows.shape[1]).sum(dim=0)
    if op == C.Average:
        acc = _div(acc, world)
    return acc, n, world, sent


def compressed_allreduce(x: torch.Tensor, axis_name, op: int,
                         spec: Optional[QuantSpec] = None, wire_dtype=None,
                         prescale: float = 1.0, postscale: float = 1.0,
                         return_sent: bool = False):
    """Two-pass compressed allreduce over ``axis_name``.

    ``spec`` selects a quantized wire; ``wire_dtype`` (bf16/fp16) selects
    a cast wire — exactly one must be given.  Supports Sum/Average (the
    only ops a lossy wire composes with).  Output dtype == input dtype.

    ``return_sent`` also returns what this member put on the first pass'
    wire, as flat fp32: with a quantized wire that is ``qdq`` of the
    prescaled input, bit for bit, since the rows are padded to
    world × block and their blocks are those of the flat grid that starts
    at element 0 — the operator of the error-feedback residual.
    """
    _check_wire(spec, wire_dtype)
    _check_reduce_op(op, "allreduce")
    acc, n, world, sent = _reduced_shard(x, axis_name, op, spec, wire_dtype,
                                         prescale, keep_sent=return_sent)
    group = _group(axis_name)
    # Pass 2: requantize (or recast) the reduced shard and gather.
    if spec is None:
        out = _all_gather(acc.to(wire_dtype), group).to(torch.float32)[:n]
    else:
        q2, s2 = quantize(acc, spec)
        out = dequantize(_all_gather(q2, group), _all_gather(s2, group),
                         spec, world * acc.numel())[:n]
    if postscale != 1.0:
        out = out * postscale
    out = out.reshape(x.shape).to(x.dtype)
    return (out, sent) if return_sent else out


def compressed_allreduce_hierarchical(x: torch.Tensor, local_axis,
                                      cross_axis, op: int,
                                      spec: Optional[QuantSpec] = None,
                                      wire_dtype=None,
                                      prescale: float = 1.0,
                                      postscale: float = 1.0) -> torch.Tensor:
    """Two-level compressed allreduce over a (local, cross) axis pair
    (arXiv:1810.11112 composed with the compressed wire):

    * phase 1: compressed reduce-scatter over ``local_axis`` (each member
      ends with 1/L of the node sum, accumulated fp32);
    * phase 2: the two-pass compressed allreduce of that shard across
      ``cross_axis`` — only 1/L of the tensor crosses nodes;
    * phase 3: one compressed all-gather over ``local_axis``.

    Same contract as :func:`compressed_allreduce`.  A level of one member
    falls back to the flat schedule over the other.
    """
    from . import collective as C
    _check_wire(spec, wire_dtype)
    _check_reduce_op(op, "allreduce")
    local = _group(local_axis)
    L, crossP = _size(local), _size(_group(cross_axis))
    flat_args = dict(spec=spec, wire_dtype=wire_dtype, prescale=prescale,
                     postscale=postscale)
    if L == 1:
        return compressed_allreduce(x, cross_axis, op, **flat_args)
    if crossP == 1:
        return compressed_allreduce(x, local_axis, op, **flat_args)
    # Phase 1 (Sum — one Average divide at the end keeps the fp32
    # accumulation exact through the phases).
    acc, n, _, _ = _reduced_shard(x, local_axis, C.Sum, spec, wire_dtype,
                                  prescale)
    # Phase 2: cross-node two-pass allreduce of the fp32 shard.
    shard = compressed_allreduce(acc, cross_axis, C.Sum, spec=spec,
                                 wire_dtype=wire_dtype)
    # Phase 3: compressed intra-node all-gather of the reduced shard.
    if spec is None:
        full = _all_gather(shard.to(wire_dtype), local).to(torch.float32)
    else:
        q, s = quantize(shard, spec)
        full = dequantize(_all_gather(q, local), _all_gather(s, local), spec,
                          L * shard.numel())
    out = full[:n]
    if op == C.Average:
        out = _div(out, L * crossP)
    if postscale != 1.0:
        out = out * postscale
    return out.reshape(x.shape).to(x.dtype)


def compressed_allgather(x: torch.Tensor, axis_name,
                         spec: Optional[QuantSpec] = None,
                         wire_dtype=None) -> torch.Tensor:
    """Compressed all-gather over ``axis_name`` (an axis, or a pair of
    names such as ``("local", "cross")``, major first): every member ends
    with the dim-0 concatenation of the members' tensors, in the joint
    axis' order, in the input dtype.

    The payload is compressed once at the source and decompressed once at
    the destination: one quantize→dequantize round trip, with no
    error-feedback channel.  For a pair it gathers over the minor axis
    first and then the major one, the payload riding both hops untouched
    (only 1/L of the bytes cross the outer level) — the reference's nested
    schedule.
    """
    _check_wire(spec, wire_dtype)
    axes = tuple(axis_name) if isinstance(axis_name, (tuple, list)) \
        else (axis_name,)
    hops = [_group(a) for a in reversed(axes)]
    world = math.prod(_size(g) for g in hops)

    def gather(t):
        for g in hops:
            t = _all_gather(t, g)
        return t

    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    if spec is None:
        full = gather(flat.to(wire_dtype)).to(torch.float32).view(world, n)
    else:
        q, s = quantize(flat, spec)
        npad = n + (-n) % spec.block
        packed = spec.block if spec.bits == 8 else spec.block // 2
        full = dequantize(gather(q).reshape(-1, packed), gather(s).reshape(-1),
                          spec, world * npad).view(world, npad)[:, :n]
    if x.dim() == 0:
        return full.reshape(world).to(x.dtype)
    return full.reshape((world * x.shape[0],) + tuple(x.shape[1:])).to(x.dtype)


def compressed_reducescatter(x: torch.Tensor, axis_name, op: int,
                             spec: Optional[QuantSpec] = None,
                             wire_dtype=None) -> torch.Tensor:
    """Compressed reduce-scatter: dim-0 chunk ``i`` of the reduction goes
    to member ``i`` — the first pass of the two-pass allreduce, with the
    destination rows being the reducescatter chunks themselves (each
    padded to the block, so blocks never straddle chunks).

    Dim 0 must divide by the axis size; accumulation is fp32; out dtype ==
    in dtype.
    """
    from . import collective as C
    _check_wire(spec, wire_dtype)
    _check_reduce_op(op, "reducescatter")
    group = _group(axis_name)
    world = _size(group)
    rows = x.shape[0] if x.dim() else 0
    if x.dim() == 0 or rows % world:
        raise ValueError(
            f"reducescatter dim0 {rows} not divisible by {world}")
    chunk = rows // world
    elems = chunk * (x.numel() // rows if rows else 0)
    flat = x.to(torch.float32).reshape(world, elems)
    if spec is not None:
        pad = (-elems) % spec.block
        if pad:
            flat = F.pad(flat, (0, pad))
    payload, scales = _rows_to_wire(flat, spec, wire_dtype)
    payload = _all_to_all(payload, group)
    if scales is not None:
        scales = _all_to_all(scales, group)
    acc = _wire_to_f32(payload, scales, spec, flat.shape[1]).sum(dim=0)
    acc = acc[:elems]
    if op == C.Average:
        acc = _div(acc, world)
    return acc.reshape((chunk,) + tuple(x.shape[1:])).to(x.dtype)
