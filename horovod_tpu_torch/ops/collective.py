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

With the native controller attached (``init(use_controller=True)``), a
call over the world goes to ``ops.eager``: ``name=`` is its negotiation
key (auto-named in call order when None), a name enqueued twice while in
flight raises ``DuplicateNameError``, and ranks may issue calls in any
order.  There ``compression=`` follows the reference's eager rules
(collective.py:480-600): a cast wire compresses around the negotiated
call; a quantized wire rounds the contribution and the result to its
grid, and the bytes are compressed by the coordinator's stamped wire
format inside the executor.  Calls over ``("local", "cross")`` stay on
the groups of the two-level topology, as without a controller.

``compression`` (``Compression.{fp16,bf16,int8,int4}``, a name, or None for
the ``HVD_TPU_COMPRESSION`` session default) routes Sum/Average of floating
tensors through the two-pass schedules of ``ops.quantization``, whose
bytes on the wire are the compressed ones on both passes.  An explicit
compressor on an integer tensor or another op raises; the session default
leaves such calls alone.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core import failure as _failure
from ..core import handles as _handles
from ..core.basics import _check_init
from ..core.state import global_state
from ..debug import flight as _flight
from ..metrics.attribution import (add_source_drain, attribution,
                                   in_compute_span)
from ..metrics.registry import DEFAULT_TIME_BUCKETS, registry
from ..utils.profiler import op_range
from . import dispatch as _dispatch
from . import eager as E
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
# telemetry (reference collective.py:51-248)
# ---------------------------------------------------------------------------

# Per-kind metric children cached after first use (the registry lookup
# costs a lock and a dict walk; the cached child is an attribute read).
_coll_metrics = {}

# Per-(kind, schedule) exposed-comm seconds: the dispatch plane's
# attribution surface.
_sched_metrics = {}


def _schedule_seconds(kind: str, schedule: str):
    rec = _sched_metrics.get((kind, schedule))
    if rec is None:
        rec = registry().counter(
            "hvd_collective_schedule_seconds_total",
            "Eager collective wall seconds by the dispatch table's "
            "schedule choice (flat vs hier) — exposed-comm attribution "
            "per schedule", kind=kind, schedule=schedule)
        _sched_metrics[(kind, schedule)] = rec
    return rec


def _collective_metrics(kind: str):
    rec = _coll_metrics.get(kind)
    if rec is None:
        reg = registry()
        rec = (
            reg.counter("hvd_collective_ops_total",
                        "Eager collective operations", kind=kind),
            reg.counter("hvd_collective_bytes_total",
                        "Eager collective payload bytes", kind=kind),
            reg.histogram("hvd_collective_latency_seconds",
                          "Eager collective wall time (enqueue to "
                          "result)", buckets=DEFAULT_TIME_BUCKETS,
                          kind=kind),
            reg.counter("hvd_wire_bytes_raw_total",
                        "Pre-compression payload bytes offered to the "
                        "wire", kind=kind),
            reg.counter("hvd_wire_bytes_sent_total",
                        "Payload bytes after the selected wire format",
                        kind=kind),
            reg.gauge("hvd_wire_compression_ratio",
                      "raw/sent wire-byte ratio of the most recent op",
                      kind=kind),
        )
        _coll_metrics[kind] = rec
    return rec


# Overlap-submission marker: a collective submitted by an overlap queue
# lands in both the latency histogram and the queue's own exposed
# seconds; its latency also goes to
# hvd_overlap_fallback_latency_seconds_total, which the step attribution
# subtracts so overlap-managed wire time counts once.
_overlap_submit = threading.local()
_overlap_fallback_lat = None


@contextlib.contextmanager
def overlap_submit_scope():
    """Mark this thread as inside an overlap queue's submission
    (ops/overlap.py ``EagerBucketQueue.launch``)."""
    prev = getattr(_overlap_submit, "active", False)
    _overlap_submit.active = True
    try:
        yield
    finally:
        _overlap_submit.active = prev


def _overlap_fallback_metric():
    global _overlap_fallback_lat
    if _overlap_fallback_lat is None:
        _overlap_fallback_lat = registry().counter(
            "hvd_overlap_fallback_latency_seconds_total",
            "Latency-histogram seconds recorded by overlap-submitted "
            "sync-fallback collectives — the overlap share the step "
            "attribution subtracts from the histogram delta so "
            "overlap-managed wire time is counted once")
    return _overlap_fallback_lat


def _nbytes(tensor) -> Optional[int]:
    if isinstance(tensor, torch.Tensor):
        return tensor.numel() * tensor.element_size()
    return getattr(tensor, "nbytes", None)


def _wire_sent_bytes(tensor, comp, nbytes: Optional[int]) -> Optional[int]:
    """Bytes the wire moves for ``tensor``: a cast wire's narrower words;
    a quantized wire's packed blocks and scales where the port's two-pass
    schedule sends them (no controller); else the payload itself (under
    a controller a quantized wire rounds values on the eager call and
    the executor prices the stamped wire, as in the reference)."""
    if nbytes is None or comp is None or \
            not isinstance(tensor, torch.Tensor) or \
            not tensor.is_floating_point():
        return nbytes
    if comp.bits is None:
        return tensor.numel() * comp.wire_dtype.itemsize
    if global_state.controller is None:
        return Q.wire_bytes(tensor.numel(), comp.spec())
    return nbytes


# CUDA-event latency.  A collective on CUDA tensors returns once it is
# enqueued, so a host clock around it would read about zero.  Its latency
# is the time the compute stream was held by it instead: a pair of CUDA
# events on the current stream around the call (around the wait, for an
# asynchronous one), observed once the end event has completed.  The
# step attribution drains the completed pairs before each read
# (``metrics.attribution.add_source_drain``); a pair not yet complete
# waits for a later drain.  Past ``_PENDING_DRAIN`` pairs (a loop that
# closes no steps) each new pair drains the completed ones first.  A pair
# recorded inside a compute span is also reported to the attribution,
# which takes it out of the span's seconds (the span waited for it).
_pending = collections.deque()
_PENDING_DRAIN = 256


def drain_device_latency() -> int:
    """Observe the latency of every completed CUDA-event pair, oldest
    first, stopping at the first that has not completed.  Returns how
    many are still pending."""
    while _pending:
        start, end, lat, sched, fallback, in_span = _pending[0]
        if not end.query():
            break
        _pending.popleft()
        dt = start.elapsed_time(end) / 1e3
        lat.observe(dt)
        if sched is not None:
            sched.inc(dt)
        if fallback:
            _overlap_fallback_metric().inc(dt)
        if in_span:
            attribution().note_comm_in_span(dt)
    return len(_pending)


add_source_drain(drain_device_latency)


# Comm-side chaos (HVD_TPU_CHAOS_COMM_DELAY_MS): the wire analog of the
# input pipeline's HVD_TPU_CHAOS_INPUT_DELAY_MS drill.  Every eager
# collective pays a fixed host delay before it is issued, inside its
# measured span, so that the step attribution sees comm_exposed grow and
# the drift diagnosis can name a comm regression (reference
# ops/collective.py:140-165).  Read once and cached; reset_comm_chaos()
# re-reads the knob.  Inert unless the knob is set.
_comm_chaos_delay: Optional[float] = None


def _chaos_comm_delay_s() -> float:
    global _comm_chaos_delay
    if _comm_chaos_delay is None:
        from ..core import config
        d = max(0.0, config.get_float(config.CHAOS_COMM_DELAY_MS, 0.0)) / 1e3
        _comm_chaos_delay = d
        if d:
            # Recorded at activation: the drift diagnosis's causal window
            # must hold the cause.
            _flight.record("net.chaos_delay", "eager", delay_ms=d * 1e3)
    return _comm_chaos_delay


def reset_comm_chaos() -> None:
    """Re-read HVD_TPU_CHAOS_COMM_DELAY_MS at the next collective."""
    global _comm_chaos_delay
    _comm_chaos_delay = None


def _comm_chaos() -> None:
    delay = _chaos_comm_delay_s()
    if delay:
        time.sleep(delay)


class _OpRecord:
    """One eager collective's telemetry: the ``collective.enqueue``
    event when it starts, the counters and the latency when its result
    is ready, and the ``collective.done`` event."""

    __slots__ = ("kind", "name", "nbytes", "sent", "sched", "metrics",
                 "fallback", "t0", "cuda", "start", "held")

    def __init__(self, kind: str, name, tensor, comp=None):
        self.kind = kind
        self.name = name
        self.nbytes = _nbytes(tensor)
        self.sent = _wire_sent_bytes(tensor, comp, self.nbytes)
        self.metrics = _collective_metrics(kind)
        self.fallback = getattr(_overlap_submit, "active", False)
        ann = self.nbytes
        if ann is not None and kind == "allgather":
            ann = ann * global_state.size
        self.sched = _dispatch.annotate(kind, ann)
        self.cuda = isinstance(tensor, torch.Tensor) and tensor.is_cuda
        self.start = None
        self.held = 0.0
        # The enqueue event is what a hang report quotes: an op stuck
        # before ``done`` leaves it dangling.
        fields = {"op": kind, "bytes": self.nbytes}
        if comp is not None:
            fields["wire"] = comp.wire
        if self.sched is not None:
            fields["schedule"] = self.sched
        _flight.record("collective.enqueue", name, **fields)
        self.t0 = time.perf_counter()

    def hold(self):
        """Start timing a stretch that holds the caller: the call, or
        the wait of an asynchronous op."""
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        return time.perf_counter()

    def release(self, t: float) -> None:
        """End the stretch that ``hold`` returned ``t`` for."""
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            _pending.append((self.start, end, self.metrics[2],
                             _schedule_seconds(self.kind, self.sched)
                             if self.sched is not None else None,
                             self.fallback, in_compute_span()))
            if len(_pending) > _PENDING_DRAIN:
                drain_device_latency()
        else:
            self.held += time.perf_counter() - t

    def done(self) -> None:
        ops, bts, lat, raw_c, sent_c, ratio_g = self.metrics
        ops.inc()
        if self.nbytes:
            bts.inc(float(self.nbytes))
            raw_c.inc(float(self.nbytes))
            if self.sent:
                sent_c.inc(float(self.sent))
                ratio_g.set(self.nbytes / self.sent)
        if not self.cuda:
            lat.observe(self.held)
            if self.sched is not None:
                _schedule_seconds(self.kind, self.sched).inc(self.held)
            if self.fallback:
                _overlap_fallback_metric().inc(self.held)
        _flight.record("collective.done", self.name, op=self.kind,
                       dur_s=time.perf_counter() - self.t0)


@contextlib.contextmanager
def _op_range(kind: str, name, tensor, comp=None):
    """Profiler span and metrics around one synchronous eager collective
    (upstream Horovod's NVTX op range, operations.cc:1018-1033): an NVTX
    range and ``record_function`` named ``hvd.<kind>.<name>``, the
    ``hvd_collective_*`` and ``hvd_wire_*`` families and the
    ``collective.enqueue`` / ``collective.done`` flight events.  A
    failed elastic world raises ``HorovodInternalError`` here
    (``core/failure.py``)."""
    rec = _OpRecord(kind, name, tensor, comp)
    try:
        with op_range(f"hvd.{kind}.{name or 'unnamed'}", rec.nbytes), \
                _failure.guard():
            t = rec.hold()
            try:
                _comm_chaos()
                yield
            finally:
                rec.release(t)
    finally:
        rec.done()


@contextlib.contextmanager
def _issue_range(rec: _OpRecord):
    """The profiler span around an asynchronous collective's issue; on
    the host clock its seconds count toward the latency (on CUDA the
    wait's events do)."""
    with op_range(f"hvd.{rec.kind}.{rec.name or 'unnamed'}", rec.nbytes), \
            _failure.guard():
        t = time.perf_counter()
        _comm_chaos()
        yield
        if not rec.cuda:
            rec.held += time.perf_counter() - t


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
# the negotiated plane (a controller is attached)
# ---------------------------------------------------------------------------

def _negotiated(axis) -> bool:
    """Whether a call over ``axis`` goes through the native controller."""
    return global_state.controller is not None and axis is None


def _negotiated_wire(tensor, op, compression):
    """The compressor of a negotiated reduction, or None (numpy arrays
    take none)."""
    if isinstance(tensor, np.ndarray):
        return None
    return _wire(tensor, op, compression)


def _qdq(x: torch.Tensor, spec) -> torch.Tensor:
    """``x`` in fp32, rounded to the quantized wire's grid (flat blocks
    from element 0)."""
    flat = x.reshape(-1).to(torch.float32)
    return Q.qdq(flat, spec).view(x.shape)


def _negotiated_allreduce(tensor, op, prescale, postscale, name,
                          compression) -> int:
    """The handle of a negotiated allreduce; a cast wire compresses
    around it, a quantized wire rounds the contribution and the result to
    its grid."""
    comp = _negotiated_wire(tensor, op, compression)
    if comp is None:
        return E.allreduce_async(tensor, op, name, prescale, postscale)
    if comp.bits is None:
        cx, ctx = comp.compress(tensor)
        inner = E.allreduce_async(cx, op, name, prescale, postscale)

        def finish():
            return comp.decompress(synchronize(inner), ctx)
    else:
        spec = comp.spec()
        inner = E.allreduce_async(_qdq(tensor, spec), op, name, prescale,
                                  postscale)

        def finish():
            return _qdq(synchronize(inner), spec).to(tensor.dtype)
    return _handles.handle_manager.allocate(_handles.Handle(
        poll_fn=lambda: poll(inner), wait_fn=finish))


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


def _call_wire(tensor, op, axis, compression):
    """The wire compressor of one allreduce call (None for Adasum, whose
    compression rides its own schedule)."""
    if _negotiated(axis):
        return _negotiated_wire(tensor, op, compression)
    if op == Adasum:
        return None
    return _wire(tensor, op, compression)


def allreduce_(tensor: torch.Tensor, op: int = Average,
               prescale_factor: float = 1.0, postscale_factor: float = 1.0,
               axis_name=None, compression=None) -> torch.Tensor:
    """In-place allreduce of ``tensor`` across the world; returns it."""
    _check_init()
    _check_op(op)
    axis = _check_axis(axis_name)
    comp = _call_wire(tensor, op, axis, compression)
    with _op_range("allreduce", None, tensor, comp=comp):
        if _negotiated(axis):
            return tensor.copy_(synchronize(_negotiated_allreduce(
                tensor, op, prescale_factor, postscale_factor, None,
                compression)))
        if op == Adasum:
            return tensor.copy_(_adasum(tensor, axis, compression,
                                        prescale_factor, postscale_factor))
        if comp is not None:
            return tensor.copy_(_compressed_allreduce(
                tensor, op, axis, comp, prescale_factor, postscale_factor))
        return _allreduce_plain(tensor, op, prescale_factor,
                                postscale_factor)


def allreduce(tensor: torch.Tensor, op: int = Average, axis_name=None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              name: Optional[str] = None, compression=None) -> torch.Tensor:
    """Allreduce a tensor across the world; returns a new tensor.  ``name``
    is the negotiation key under a controller."""
    _check_init()
    _check_op(op)
    axis = _check_axis(axis_name)
    comp = _call_wire(tensor, op, axis, compression)
    with _op_range("allreduce", name, tensor, comp=comp):
        if _negotiated(axis):
            return synchronize(_negotiated_allreduce(
                tensor, op, prescale_factor, postscale_factor, name,
                compression))
        if op == Adasum:
            return _adasum(tensor, axis, compression, prescale_factor,
                           postscale_factor)
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
    So does Adasum, whose coefficients are the whole tensor's.  Under a
    controller every member is enqueued as ``{name}.{i}`` before any is
    waited on, and the runtime fuses them (reference
    collective.py:580-600); a quantized wire rounds each member to its
    grid first."""
    _check_init()
    _check_op(op)
    axis = _check_axis(axis_name)
    tensors = list(tensors)
    if _negotiated(axis):
        comp = _resolve_compression(compression)
        if comp is not None and comp.bits is not None:
            tensors = [_qdq(t, comp.spec()).to(t.dtype)
                       if _compressible(t, op) else t for t in tensors]
        return E.grouped_allreduce(tensors, op, name, prescale_factor,
                                   postscale_factor)
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
        with _op_range("allreduce", name, flat):
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
    _check_init()
    axis = _check_axis(axis_name)
    if len(tensor.shape) == 0:
        raise ValueError("allgather needs a tensor of at least one dimension")
    with _op_range("allgather", name, tensor):
        if _negotiated(axis):
            return E.allgather(tensor, name=name)
        if axis is None:
            return _gather_rows(tensor, None)
        out = tensor
        for a in reversed(_JOINT):   # cross first: pieces end local-major
            out = _gather_rows(out, Q._group(a))
        return out


def broadcast_(tensor: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    """In-place broadcast of the root's value; returns ``tensor``."""
    _check_init()
    with _op_range("broadcast", None, tensor):
        return _broadcast_(tensor, root_rank)


def _broadcast_(tensor: torch.Tensor, root_rank: int) -> torch.Tensor:
    if _negotiated(None):
        return tensor.copy_(E.broadcast(tensor, root_rank))
    dist.broadcast(tensor, src=root_rank)
    return tensor


def broadcast(tensor: torch.Tensor, root_rank: int = 0, axis_name=None,
              name: Optional[str] = None) -> torch.Tensor:
    """Broadcast the root member's value to all members; returns a new
    tensor.  Over ``("local", "cross")``, ``root_rank`` is the root's index
    on that axis."""
    _check_init()
    axis = _check_axis(axis_name)
    ranks = _axis_ranks(axis)
    if not 0 <= root_rank < len(ranks):
        raise ValueError(f"root_rank {root_rank} is not a member of the "
                         f"axis of {len(ranks)}")
    with _op_range("broadcast", name, tensor):
        if _negotiated(axis):
            return E.broadcast(tensor, root_rank, name=name)
        return _broadcast_(tensor.clone(), ranks[root_rank])


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
    _check_init()
    axis = _check_axis(axis_name)
    with _op_range("alltoall", name, tensor):
        return _alltoall(tensor, splits, axis, name)


def _alltoall(tensor, splits, axis, name):
    if _negotiated(axis):
        return E.alltoall(tensor, splits, name=name)
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
    than Sum/Average raises.  Under a controller it is the negotiated
    allreduce's chunk (reference eager.py:917-927), a quantized wire
    rounding each destination chunk to its own grid."""
    _check_init()
    _check_op(op)
    axis = _check_axis(axis_name)
    world = global_state.size
    rows = tensor.shape[0] if len(tensor.shape) else 0
    if len(tensor.shape) == 0 or rows % world:
        raise ValueError(f"reducescatter dim0 {rows} not divisible by "
                         f"{world}")
    comp = _negotiated_wire(tensor, op, compression) if _negotiated(axis) \
        else _wire(tensor, op, compression)
    with _op_range("reducescatter", name, tensor, comp=comp):
        return _reducescatter(tensor, op, axis, name, compression, comp)


def _reducescatter(tensor, op, axis, name, compression, comp):
    world = global_state.size
    rows = tensor.shape[0]
    if _negotiated(axis):
        if comp is None:
            return E.reducescatter(tensor, op, name=name)
        if comp.bits is None:
            cx, ctx = comp.compress(tensor)
            return comp.decompress(E.reducescatter(cx, op, name=name), ctx)
        chunks = tensor.reshape((world, -1))
        x = torch.stack([_qdq(c, comp.spec()) for c in chunks])
        return E.reducescatter(x.view(tensor.shape), op,
                               name=name).to(tensor.dtype)
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
    """Block until every rank has reached the barrier (a negotiated
    barrier under a controller)."""
    _check_init()
    if _negotiated(None):
        E.barrier()
        return
    dev = global_state.device
    with _failure.guard():
        if dev is not None and dev.type == "cuda":
            dist.barrier(device_ids=[dev.index])
        else:
            dist.barrier()


def join() -> int:
    """Signal this rank has no more data; returns the last rank to join.
    Under a controller the joined rank's peers go on with zeros in its
    place until every rank has joined.  With no negotiating controller
    there is nothing pending to proxy, so join is a barrier that returns
    size - 1 (reference eager.py:940-952)."""
    _check_init()
    if _negotiated(None):
        return E.join()
    barrier()
    return global_state.size - 1


# ---------------------------------------------------------------------------
# async handle API (reference torch/mpi_ops.py:843-882)
#
# Each *_async issues its collective with async_op=True and returns a
# handle; poll() is the Work's is_completed(), synchronize() waits and
# finishes the result (Average division, postscale, cuts).  A compressed
# allreduce runs the synchronous compressed path and wraps its result, as
# the reference does without a controller (collective.py:829-841).  Under
# a controller the op is in flight in the native runtime after *_async
# returns; poll() asks the runtime, synchronize() finishes the op.
# ---------------------------------------------------------------------------

class _TimedWork:
    """A ``Work`` whose ``wait()`` closes the op's telemetry record."""

    __slots__ = ("work", "rec", "waited")

    def __init__(self, work, rec: _OpRecord):
        self.work, self.rec, self.waited = work, rec, False

    def wait(self):
        if self.waited:
            with _failure.guard():
                return self.work.wait()
        self.waited = True
        t = self.rec.hold()
        try:
            with _failure.guard():
                return self.work.wait()
        finally:
            self.rec.release(t)
            self.rec.done()

    def is_completed(self):
        return self.work.is_completed()


def _allocate(work=None, finish=None, result=None,
              rec: Optional[_OpRecord] = None) -> int:
    """A handle: of a ready ``result``, or of ``work`` whose ``finish()``
    gives the result after ``work.wait()``; ``rec`` (the op's telemetry)
    times the wait and closes at it."""
    if work is None:
        return _handles.handle_manager.allocate(_handles.Handle(result=result))
    if rec is not None:
        work = _TimedWork(work, rec)

    def wait():
        with _failure.guard():
            work.wait()
        return finish()
    return _handles.handle_manager.allocate(_handles.Handle(
        poll_fn=work.is_completed, wait_fn=wait))


def _sync_result(kind: str, name, tensor, comp, fn) -> int:
    """The handle of an asynchronous call that runs synchronously."""
    with _op_range(kind, name, tensor, comp=comp):
        return _allocate(result=fn())


def allreduce_async(tensor: torch.Tensor, op: int = Average,
                    name: Optional[str] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    compression=None) -> int:
    _check_init()
    _check_op(op)
    if _negotiated(None):
        return _negotiated_allreduce(tensor, op, prescale_factor,
                                     postscale_factor, name, compression)
    if op == Adasum:
        return _sync_result("allreduce", name, tensor, None, lambda: _adasum(
            tensor, None, compression, prescale_factor, postscale_factor))
    comp = _wire(tensor, op, compression)
    if comp is not None:
        return _sync_result(
            "allreduce", name, tensor, comp, lambda: _compressed_allreduce(
                tensor, op, None, comp, prescale_factor, postscale_factor))
    rec = _OpRecord("allreduce", name, tensor)
    with _issue_range(rec):
        out = tensor.clone()
        x = _prepare(out, prescale_factor, postscale_factor)
        work = dist.all_reduce(x, op=_DIST_OPS[op], async_op=True)
    return _allocate(work, lambda: _finish(out, x, op, postscale_factor),
                     rec=rec)


def allgather_async(tensor: torch.Tensor, name: Optional[str] = None) -> int:
    _check_init()
    if len(tensor.shape) == 0:
        raise ValueError("allgather needs a tensor of at least one dimension")
    if _negotiated(None):
        return E.allgather_async(tensor, name=name)
    rec = _OpRecord("allgather", name, tensor)
    with _issue_range(rec):
        work, finish = _issue_gather(tensor, None)
    return _allocate(work, finish, rec=rec)


def broadcast_async(tensor: torch.Tensor, root_rank: int = 0,
                    name: Optional[str] = None) -> int:
    _check_init()
    if _negotiated(None):
        return E.broadcast_async(tensor, root_rank, name=name)
    rec = _OpRecord("broadcast", name, tensor)
    with _issue_range(rec):
        out = tensor.clone()
        work = dist.broadcast(out, src=root_rank, async_op=True)
    return _allocate(work, lambda: out, rec=rec)


def alltoall_async(tensor: torch.Tensor, splits=None,
                   name: Optional[str] = None) -> int:
    _check_init()
    if _negotiated(None):
        return E.alltoall_async(tensor, splits, name=name)
    rec = _OpRecord("alltoall", name, tensor)
    with _issue_range(rec):
        work, result = _issue_alltoall(tensor, splits)
    return _allocate(work, lambda: result, rec=rec)


def poll(handle: int) -> bool:
    """Whether the op behind ``handle`` has completed (never blocks)."""
    return _handles.handle_manager.poll(handle)


def synchronize(handle: int):
    """Wait for the op behind ``handle`` and return its result."""
    return _handles.handle_manager.synchronize(handle)
