"""Bucketed gradient schedules (port of the non-native part of
horovod_tpu/ops/overlap.py).

Instead of one collective per gradient tensor, the tensors are
partitioned into size-bounded **buckets** and each bucket moves in one
collective: in reverse-autodiff order for gradients (the order backward
produces them), in forward order for the ZeRO-3 parameter gather.

* :func:`bucketed_allreduce_tree` reduces a tree of tensors bucket by
  bucket; ``DistributedOptimizer(overlap=…)`` launches the same bucket
  collectives from post-accumulate-grad hooks as backward completes each
  bucket.
* :func:`sync_in_backward` wraps tensors in one ``torch.autograd.Function``
  identity per bucket whose backward is that bucket's allreduce, so
  differentiating through the wrapped tensors gives reduced gradients
  (``grad(overlap=…)``).
* :func:`bucketed_reducescatter_tree` is ZeRO's gradient reduce-scatter,
  one exchange per bucket, and :func:`gather_in_forward` the ZeRO-3
  parameter gather: a Function per bucket whose forward all-gathers flat
  shards into full tensors and whose backward reduce-scatters the
  cotangents into shard gradients.

Bit parity: every tensor is padded to a multiple of the quantization block
before it enters a bucket's flat buffer, so no block straddles two tensors
and each element meets the same arithmetic — blocks, fp32 accumulation
order, requantization — as in the per-tensor schedule, on the cast
(bf16/fp16) and quantized (int8/int4) wires, the error-feedback residual
included.  On the uncompressed wire an element's value is the sum the
backend's allreduce or reduce-scatter forms, whose order may depend on the
element's offset in the buffer: bit-equal at two ranks (and one), equal to
fp32 summation-order rounding beyond.
"""

from __future__ import annotations

import math
from typing import (Any, Callable, List, NamedTuple, Optional, Sequence,
                    Tuple)

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core import config as _cfg


# ---------------------------------------------------------------------------
# trees of tensors
# ---------------------------------------------------------------------------

def _tree_map(fn: Callable, tree):
    """``fn`` over the tensors of a tensor, a sequence or a dict (nested),
    keeping the structure; anything else passes through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def _tree_leaves(tree) -> List[torch.Tensor]:
    leaves: List[torch.Tensor] = []
    _tree_map(leaves.append, tree)
    return leaves


def _tree_replace(tree, values: Sequence[torch.Tensor]):
    """``tree`` with its tensors replaced by ``values``, in order."""
    it = iter(values)
    return _tree_map(lambda _: next(it), tree)


# ---------------------------------------------------------------------------
# bucket planning
# ---------------------------------------------------------------------------

class BucketPlan(NamedTuple):
    """A partition of a leaf list into buckets in launch order: ``buckets``
    holds tuples of leaf indices, the first bucket first."""

    buckets: Tuple[Tuple[int, ...], ...]
    bucket_bytes: int
    n_leaves: int

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)


def _leaf_nbytes(leaf) -> int:
    return math.prod(leaf.shape) * leaf.dtype.itemsize


def plan_buckets(leaves: Sequence, bucket_bytes: Optional[int] = None,
                 order: str = "backward") -> BucketPlan:
    """Partition ``leaves`` (anything with ``shape`` and a torch ``dtype``)
    into size-bounded buckets in launch order.

    ``order="backward"``: the last leaves (whose gradients backward makes
    first) fill the first bucket.  ``order="forward"``: the first leaves
    (which forward uses first) do.  A bucket closes when the next leaf
    would take it past ``bucket_bytes`` or has another dtype (a bucket is
    one flat buffer); a leaf larger than the bound gets a bucket of its
    own."""
    bb = int(default_bucket_bytes() if bucket_bytes is None
             else bucket_bytes)
    if bb <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bb}")
    if order not in ("backward", "forward"):
        raise ValueError(f"order must be backward|forward, got {order!r}")
    buckets: List[Tuple[int, ...]] = []
    cur: List[int] = []
    cur_bytes, cur_dtype = 0, None
    idx = reversed(range(len(leaves))) if order == "backward" \
        else range(len(leaves))
    for i in idx:
        nb, dt = _leaf_nbytes(leaves[i]), leaves[i].dtype
        if cur and (dt != cur_dtype or cur_bytes + nb > bb):
            buckets.append(tuple(cur))
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nb
        cur_dtype = dt
    if cur:
        buckets.append(tuple(cur))
    return BucketPlan(tuple(buckets), bb, len(leaves))


def per_leaf_plan(n: int) -> BucketPlan:
    """One bucket per leaf, in leaf order: the per-tensor schedule."""
    return BucketPlan(tuple((i,) for i in range(n)), 0, n)


def default_bucket_bytes() -> int:
    """The session bucket size (``HVD_TPU_OVERLAP_BUCKET_BYTES``)."""
    return _cfg.overlap_bucket_bytes()


def resolve_bucket_bytes(overlap) -> Optional[int]:
    """Normalize an ``overlap=`` argument to bucket bytes, or None (off).

    ``None`` defers to the session (``HVD_TPU_OVERLAP`` on/off, sized by
    ``HVD_TPU_OVERLAP_BUCKET_BYTES``); ``True`` buckets at the session
    size; ``False`` or 0 is off; a positive int is the size in bytes."""
    if overlap is None:
        return default_bucket_bytes() if _cfg.overlap() else None
    if overlap is False:
        return None
    if overlap is True:
        return default_bucket_bytes()
    n = int(overlap)
    return n if n > 0 else None


# ---------------------------------------------------------------------------
# one bucket's collectives
# ---------------------------------------------------------------------------

def _active_comp(comp, leaf, op):
    """The compressor this bucket rides, or None (no wire, or a dtype/op
    a lossy wire cannot carry)."""
    from . import collective as C
    if comp is None or getattr(comp, "wire", "none") == "none":
        return None
    return comp if C._compressible(leaf, op) else None


def _concat_flat(leaves, align: int) -> torch.Tensor:
    """The leaves raveled and concatenated, each zero-padded to a multiple
    of ``align`` (so no quantization block straddles two leaves); always a
    new tensor."""
    return torch.cat([F.pad(x.reshape(-1), (0, (-x.numel()) % align))
                      for x in leaves])


def _split_back(buf: torch.Tensor, leaves, align: int,
                dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """Inverse of :func:`_concat_flat`: each leaf's slice, in its shape and
    dtype (or ``dtype``)."""
    outs, off = [], 0
    for x in leaves:
        n = x.numel()
        outs.append(buf[off: off + n].view(x.shape).to(dtype or x.dtype))
        off += n + (-n) % align
    return outs


def _record_stream(t: torch.Tensor) -> None:
    """Tell the caching allocator that the current stream uses ``t``,
    which another stream (a hook's) may have allocated."""
    if t.is_cuda:
        t.record_stream(torch.cuda.current_stream(t.device))


def issue_bucket_allreduce(leaves, op, axis, comp, prescale: float = 1.0,
                           postscale: float = 1.0, keep_sent: bool = False):
    """Start one bucket's allreduce.  Returns ``(work, finish)``:
    ``finish()`` after ``work.wait()`` gives ``(reduced leaves, sent)``,
    ``sent`` the per-leaf flat fp32 values the first pass of a quantized
    wire sent when ``keep_sent`` (world axis, no prescale), else None.

    The uncompressed wire issues ``dist.all_reduce(async_op=True)``; a
    compressed wire runs its two-pass schedule now (its ``work`` is done).
    """
    from . import collective as C
    from . import quantization as Q
    if op == C.Adasum:
        # Adasum weighs by whole-tensor norms: concatenating leaves would
        # change the result, not only the schedule.
        raise ValueError("bucketed overlap does not compose with op=Adasum "
                         "(norm-weighted reduction is not concatenation-"
                         "invariant)")
    comp = _active_comp(comp, leaves[0], op)
    if comp is None:
        buf = _concat_flat(leaves, 1)
        x = C._prepare(buf, prescale, postscale)
        work = dist.all_reduce(x, op=C._DIST_OPS[op], async_op=True)

        def finish():
            _record_stream(x)
            return _split_back(C._finish(buf, x, op, postscale), leaves,
                               1), None
        return work, finish
    spec = comp.spec()
    align = spec.block if spec is not None else 1
    buf = _concat_flat(leaves, align)
    kw = dict(spec=spec, wire_dtype=None if spec is not None
              else comp.wire_dtype, prescale=prescale, postscale=postscale)
    sent = None
    if axis is not None:
        red = Q.compressed_allreduce_hierarchical(buf, "local", "cross", op,
                                                  **kw)
    elif keep_sent and spec is not None:
        red, sent = Q.compressed_allreduce(buf, None, op, return_sent=True,
                                           **kw)
        sent = _split_back(sent, leaves, align, torch.float32)
    else:
        red = Q.compressed_allreduce(buf, None, op, **kw)
    result = (_split_back(red, leaves, align), sent)
    return C._Done, lambda: result


def _rows_of(x: torch.Tensor, world: int) -> torch.Tensor:
    """``x`` raveled, zero-padded to a multiple of ``world``, as (world, k):
    row i is member i's shard."""
    flat = x.reshape(-1)
    return F.pad(flat, (0, (-flat.numel()) % world)).view(world, -1)


def bucket_reducescatter(leaves, op, axis, comp) -> List[torch.Tensor]:
    """One bucket's reduce-scatter, one exchange: each leaf's flat shard
    ``[i*k, (i+1)*k)`` of its zero-padded ravel, ``k = ceil(n / world)``,
    for member i of the axis — per element the arithmetic of
    ``reducescatter`` on each padded leaf (per-leaf quantization rows,
    fp32 accumulation)."""
    from . import collective as C
    from . import quantization as Q
    world = len(C._axis_ranks(axis))
    comp = _active_comp(comp, leaves[0], op)
    rows = [_rows_of(x, world) for x in leaves]
    ks = [r.shape[1] for r in rows]
    if comp is None:
        cat = C._to_world_order(torch.cat(rows, dim=1), axis)
        red = cat.new_empty(cat.shape[1])
        dist.reduce_scatter_tensor(red, cat.reshape(-1))
        if op == C.Average:
            if C._is_int(red):
                red.div_(world, rounding_mode="floor")
            else:
                red.div_(world)
        return list(red.split(ks))
    spec = comp.spec()
    if spec is None:
        # Cast wire, fp32 accumulation: compressed_reducescatter's
        # arithmetic, one exchange for the bucket.
        payload = torch.cat([r.float().to(comp.wire_dtype) for r in rows],
                            dim=1)
        payload = Q._all_to_all(C._to_world_order(payload, axis), None)
        acc = Q._div(payload.float().sum(dim=0), world) if op == C.Average \
            else payload.float().sum(dim=0)
        return [a.to(x.dtype) for a, x in zip(acc.split(ks), leaves)]
    # Quantized wire: each leaf's rows on their own block grid (no block
    # straddles a leaf or a row), one payload and one scale exchange.
    payloads, scales, metas = [], [], []
    for r in rows:
        padded = F.pad(r.float(), (0, (-r.shape[1]) % spec.block))
        p, s = Q._rows_to_wire(padded, spec, None)
        payloads.append(p)
        scales.append(s)
        metas.append((padded.shape[1], p.shape[1], s.shape[1]))
    cat_p = Q._all_to_all(C._to_world_order(torch.cat(payloads, dim=1),
                                            axis), None)
    cat_s = Q._all_to_all(C._to_world_order(torch.cat(scales, dim=1),
                                            axis), None)
    outs, poff, soff = [], 0, 0
    for x, k, (k_pad, pk, nb) in zip(leaves, ks, metas):
        acc = Q._wire_to_f32(cat_p[:, poff: poff + pk],
                             cat_s[:, soff: soff + nb], spec,
                             k_pad).sum(dim=0)[:k]
        if op == C.Average:
            acc = Q._div(acc, world)
        outs.append(acc.to(x.dtype))
        poff += pk
        soff += nb
    return outs


def bucket_allgather(shards, likes, axis, comp=None) -> List[torch.Tensor]:
    """One bucket's all-gather: the members' flat shards concatenated,
    gathered once over the axis (in its order), and each leaf's full value
    cut out of the (world, sum k) result, in the shape and dtype of its
    ``like``.  ``comp`` puts the gather on a compressed wire: quantized
    (or cast) once, dequantized once, with no error feedback."""
    from . import collective as C
    from . import quantization as Q
    world = len(C._axis_ranks(axis))
    ks = [s.numel() for s in shards]
    cat = torch.cat([s.reshape(-1) for s in shards])
    n = cat.numel()
    if comp is not None and cat.is_floating_point():
        spec = comp.spec()
        if spec is not None:
            q, s = Q.quantize(cat, spec)
            npad = n + (-n) % spec.block
            full = Q.dequantize(C._axis_all_gather(q, axis),
                                C._axis_all_gather(s, axis), spec,
                                world * npad).view(world, npad)[:, :n]
        else:
            full = C._axis_all_gather(cat.to(comp.wire_dtype), axis) \
                .float().view(world, n)
    else:
        full = C._axis_all_gather(cat, axis).view(world, n)
    outs, off = [], 0
    for like, k in zip(likes, ks):
        flat = full[:, off: off + k].reshape(-1)
        outs.append(flat[:math.prod(like.shape)].view(like.shape)
                    .to(like.dtype))
        off += k
    return outs


# ---------------------------------------------------------------------------
# trees, bucket by bucket
# ---------------------------------------------------------------------------

def bucketed_allreduce_tree(tree, op=None, axis_name=None, compression=None,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0,
                            bucket_bytes: Optional[int] = None):
    """Reduce the tensors of a tree (a tensor, a sequence or a dict) one
    bucket at a time in backward order: every bucket's collective is
    issued before the first is awaited.  Same values as reducing each
    tensor alone (see the module's parity note)."""
    from . import collective as C
    op = C.Average if op is None else op
    axis = C._check_axis(axis_name)
    comp = C._resolve_compression(compression, session_default=False)
    leaves = _tree_leaves(tree)
    plan = plan_buckets(leaves, bucket_bytes)
    issued = [(idxs, issue_bucket_allreduce(
        [leaves[i] for i in idxs], op, axis, comp, prescale_factor,
        postscale_factor)) for idxs in plan.buckets]
    out: List[Any] = [None] * len(leaves)
    for idxs, (work, finish) in issued:
        work.wait()
        for i, v in zip(idxs, finish()[0]):
            out[i] = v
    return _tree_replace(tree, out)


def bucketed_reducescatter_tree(grads, op=None, axis_name=None,
                                compression=None,
                                bucket_bytes: Optional[int] = None):
    """ZeRO's gradient reduce-scatter with one exchange per bucket: the
    tree with each tensor replaced by this member's flat shard (length
    ``ceil(n / world)``), equal to ``reducescatter`` of each zero-padded
    ravel.  Sum/Average only."""
    from . import collective as C
    op = C.Average if op is None else op
    if op not in (C.Sum, C.Average):
        raise ValueError("bucketed reducescatter supports Sum/Average")
    axis = C._check_axis(axis_name)
    comp = C._resolve_compression(compression, session_default=False)
    leaves = _tree_leaves(grads)
    out: List[Any] = [None] * len(leaves)
    for idxs in plan_buckets(leaves, bucket_bytes).buckets:
        for i, v in zip(idxs, bucket_reducescatter(
                [leaves[i] for i in idxs], op, axis, comp)):
            out[i] = v
    return _tree_replace(grads, out)


class _SyncBucket(torch.autograd.Function):
    """Identity on a bucket's tensors whose backward is ``reduce`` of the
    bucket's cotangents: autograd reaches it once every cotangent of the
    bucket is complete."""

    @staticmethod
    def forward(ctx, reduce, *xs):
        ctx.reduce = reduce
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *cts):
        return (None,) + tuple(ctx.reduce(list(cts)))


def sync_in_backward(params, op=None, axis_name=None, compression=None,
                     prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0,
                     bucket_bytes: Optional[int] = None):
    """Wrap the tensors of ``params`` so that differentiating through the
    wrapped tensors gives gradients already allreduced, each bucket's
    collective run inside the backward as soon as the bucket is complete
    (``grad(overlap=…)`` applies it)."""
    from . import collective as C
    op = C.Average if op is None else op
    axis = C._check_axis(axis_name)
    comp = C._resolve_compression(compression, session_default=False)
    leaves = _tree_leaves(params)

    def reduce(cts):
        work, finish = issue_bucket_allreduce(cts, op, axis, comp,
                                              prescale_factor,
                                              postscale_factor)
        work.wait()
        return finish()[0]

    out: List[Any] = [None] * len(leaves)
    for idxs in plan_buckets(leaves, bucket_bytes).buckets:
        for i, v in zip(idxs, _SyncBucket.apply(
                reduce, *[leaves[i] for i in idxs])):
            out[i] = v
    return _tree_replace(params, out)


class _GatherBucket(torch.autograd.Function):
    """Flat shards → full tensors (``gather``), whose backward
    reduce-scatters the full cotangents into shard gradients
    (``scatter``)."""

    @staticmethod
    def forward(ctx, gather, scatter, *shards):
        ctx.scatter = scatter
        ctx.dtypes = [s.dtype for s in shards]
        return tuple(gather(list(shards)))

    @staticmethod
    def backward(ctx, *cts):
        grads = ctx.scatter(list(cts))
        return (None, None) + tuple(g.to(dt)
                                    for g, dt in zip(grads, ctx.dtypes))


def gather_in_forward(shards_tree, like, op=None, axis_name=None,
                      compression=None, bucket_bytes: Optional[int] = None,
                      prefetch: Optional[bool] = None,
                      quantize_gather: Optional[bool] = None):
    """ZeRO-3's parameter gather: full tensors, in the shapes and dtypes
    of ``like``'s tensors (the parameters, or meta tensors), from this
    member's flat shards, one all-gather per bucket in forward order.
    Differentiating through the result reduce-scatters the cotangents per
    bucket (on ``compression``'s wire), so gradients arrive as shards.

    ``prefetch=False`` (default ``HVD_TPU_ZERO_PREFETCH``, on) gathers all
    parameters in one bucket.  ``quantize_gather`` (default
    ``HVD_TPU_ZERO_QUANT_GATHER``, off) puts the gather itself on
    ``compression``'s wire: one quantize-dequantize round trip a step,
    which does not accumulate (the shards stay full precision)."""
    from . import collective as C
    op = C.Average if op is None else op
    axis = C._check_axis(axis_name)
    comp = C._resolve_compression(compression, session_default=False)
    prefetch = _cfg.zero_prefetch() if prefetch is None else prefetch
    bucket_bytes = default_bucket_bytes() if bucket_bytes is None \
        else bucket_bytes
    quantize_gather = _cfg.zero_quant_gather() if quantize_gather is None \
        else quantize_gather
    gather_comp = comp if quantize_gather else None
    shards = _tree_leaves(shards_tree)
    likes = _tree_leaves(like)
    if len(shards) != len(likes):
        raise ValueError(f"gather_in_forward: {len(shards)} shards for "
                         f"{len(likes)} template leaves; the shards must "
                         "mirror the parameters")
    if not prefetch:
        bucket_bytes = sum(_leaf_nbytes(x) for x in likes) + 1
    out: List[Any] = [None] * len(shards)
    for idxs in plan_buckets(likes, bucket_bytes, order="forward").buckets:
        bl = [likes[i] for i in idxs]
        fulls = _GatherBucket.apply(
            lambda s, bl=bl: bucket_allgather(s, bl, axis, gather_comp),
            lambda cts: bucket_reducescatter(cts, op, axis, comp),
            *[shards[i] for i in idxs])
        for i, v in zip(idxs, fulls):
            out[i] = v
    return _tree_replace(shards_tree, out)


# ---------------------------------------------------------------------------
# post-accumulate-grad hooks
# ---------------------------------------------------------------------------

_TOO_MANY_PASSES = (
    "Gradients were computed more than backward_passes_per_step times "
    "before call to step(). Increase backward_passes_per_step to "
    "accumulate gradients locally.")


class GradHooks:
    """Calls ``launch(b)`` from a post-accumulate-grad hook as soon as
    every parameter of bucket ``b`` of ``plan`` holds its gradient for the
    pass, while ``active()`` says the pass communicates.  A parameter whose
    gradient accumulates a second time in that pass raises, as Horovod
    does: its bucket has left with the first pass' value.

    The hooks run on autograd's thread, whose current stream need not be
    the one that produced a gradient: each hook records an event on its
    stream, and before ``launch(b)`` the current stream waits on the
    events of the bucket."""

    def __init__(self, params: Sequence[torch.Tensor], plan: BucketPlan,
                 launch: Callable[[int], None],
                 active: Callable[[], bool] = lambda: True):
        self.plan = plan
        self._launch, self._active = launch, active
        self._bucket_of = {i: b for b, idxs in enumerate(plan.buckets)
                           for i in idxs}
        self._ready = [0] * plan.n_buckets
        self._seen: set = set()
        self._events = {}
        self.launched: List[int] = []
        self._handles = [p.register_post_accumulate_grad_hook(
            self._hook(i)) for i, p in enumerate(params) if p.requires_grad]

    def _hook(self, i: int):
        def hook(p):
            if not self._active():
                return
            if i in self._seen:
                raise RuntimeError(_TOO_MANY_PASSES)
            self._seen.add(i)
            if p.is_cuda:
                event = torch.cuda.Event()
                event.record()
                self._events[i] = event
            b = self._bucket_of[i]
            self._ready[b] += 1
            if self._ready[b] == len(self.plan.buckets[b]):
                if p.is_cuda:
                    stream = torch.cuda.current_stream(p.device)
                    for j in self.plan.buckets[b]:
                        stream.wait_event(self._events[j])
                self.launched.append(b)
                self._launch(b)
        return hook

    def reset(self) -> None:
        """Forget the pass: the next backward starts counting anew."""
        self._ready = [0] * self.plan.n_buckets
        self._seen.clear()
        self._events.clear()
        self.launched = []

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
