"""Eager collectives through the native controller (port of
horovod_tpu/ops/eager.py).

The reference's eager contract is "any rank may enqueue named tensors in
any order": a background controller negotiates readiness and a data plane
executes (operations.cc:919-1226, controller.cc:69-449).  The port has the
reference's three eager regimes:

1. **Controller attached** (``init(use_controller=True)`` or
   ``HVD_TPU_CONTROLLER_ADDR``): this module.  Every collective is a named
   request to the native runtime, which negotiates it across ranks, fuses
   ready requests up to the fusion threshold and hands each response to a
   plane.  Torch tensors on the runtime's device take the **device plane**:
   the executor below packs the response's tensors into one fusion buffer
   on the device, runs **one** collective on the controller's own process
   group, and unpacks — NCCL over CUDA tensors, or gloo over CPU tensors
   under ``init(device="cpu")``.  numpy arrays (and every tensor when
   ``HVD_TPU_EAGER_DEVICE_PLANE=0``) take the runtime's TCP ring, the
   **host plane**; ``op=Adasum`` takes it too, whose ring runs the
   reference's VHDD Adasum.
2. **A torch world and no controller**: ``ops.collective`` issues the
   collectives itself, SPMD — every rank must issue the same collectives
   in the same order.
3. **A single process**: a world of one, where each collective is the
   identity.

The executor runs on the runtime's background thread in coordinator
response order, which is the same on every rank however the ranks
enqueued.  Its collective depends only on the response (sizes, dtype, op,
scales, root), so a joined rank with no entry of its own takes part with
zeros.  On the card it keeps CUDA's per-thread state to itself: it sets
the device, runs on its own stream after an event each submit recorded
behind the tensor's producers, and hands each result back with an event
the caller's stream waits on.  Its process group is made at ``init()`` on
every rank and used by nothing else, so no NCCL communicator sees two
threads.  As in Horovod, a submitted tensor is read while the op is in
flight: the caller leaves it unmodified until the handle is
synchronized.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core import handles as _handles
from ..core.state import global_state
from ..debug import flight as _flight

_AVERAGE, _SUM, _ADASUM, _MIN, _MAX, _PRODUCT = range(6)
_DIST_OPS = {_AVERAGE: dist.ReduceOp.SUM, _SUM: dist.ReduceOp.SUM,
             _MIN: dist.ReduceOp.MIN, _MAX: dist.ReduceOp.MAX,
             _PRODUCT: dist.ReduceOp.PRODUCT}
_ALLREDUCE, _ALLGATHER, _BROADCAST, _ALLTOALL = range(4)


def _controller():
    return global_state.controller


def device_plane_enabled() -> bool:
    """``HVD_TPU_EAGER_DEVICE_PLANE=0`` sends every tensor to the host
    plane."""
    return os.environ.get("HVD_TPU_EAGER_DEVICE_PLANE", "1") != "0"


def _is_device_tensor(tensor) -> bool:
    """A torch tensor on the runtime's device (the card, or the CPU under
    ``init(device="cpu")``)."""
    dev = global_state.device
    return isinstance(tensor, torch.Tensor) and dev is not None and \
        tensor.device.type == dev.type


def world_lines_up(ctl) -> bool:
    """Whether the torch world spans the controller's and every rank sits
    at its controller rank: the executor indexes rank tables (allgather
    dims, the alltoall split matrix, the broadcast root) by torch rank."""
    return dist.is_initialized() and \
        dist.get_world_size() == ctl.size() and \
        dist.get_rank() == ctl.rank() and \
        global_state.controller_group is not None


def _negotiated_device_ready(ctl) -> bool:
    return device_plane_enabled() and world_lines_up(ctl)


def _on_device_plane(tensor, ctl) -> bool:
    return _is_device_tensor(tensor) and _negotiated_device_ready(ctl)


def _reduces_on_device(tensor, op: int, ctl) -> bool:
    """Adasum (the ring's VHDD Adasum) and bool allreduces take the host
    plane."""
    return int(op) != _ADASUM and _on_device_plane(tensor, ctl) and \
        tensor.dtype != torch.bool


# ---------------------------------------------------------------------------
# the device executor
# ---------------------------------------------------------------------------

def _wire_spec(comp: str):
    """(spec, wire_dtype) of a stamped wire format."""
    from .compression import by_name
    c = by_name(comp)
    return c.spec(), (None if c.bits is not None else c.wire_dtype)


def _wire_bytes_sent(n: int, comp: str, raw: int) -> int:
    if comp == "none":
        return raw
    if comp in ("bf16", "fp16"):
        return 2 * n
    from .quantization import wire_bytes
    return wire_bytes(n, _wire_spec(comp)[0])


def _is_int(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A flat uint8 view of ``t``'s elements (a copy when not
    contiguous)."""
    return t.reshape(-1).contiguous().view(torch.uint8)


def _negotiated_executor(ctl):
    """The device-plane executor of one controller: ``impl`` runs one
    negotiated (possibly fused) response, ``impl.validate`` every check
    that can fail before the collective (PREPARE), so a doomed rank fails
    every rank cleanly instead of stranding them inside it."""
    streams = {}

    def _stream(dev):
        if dev.type != "cuda":
            return contextlib.nullcontext(), None
        torch.cuda.set_device(dev)
        s = streams.get(dev.index)
        if s is None:
            s = streams[dev.index] = torch.cuda.Stream(device=dev)
        return torch.cuda.stream(s), s

    def _allreduce(names, sizes, dtype, op, prescale, postscale, local,
                   group, P, dev):
        comp = ctl.wire_compression()
        total = sum(sizes)
        if op not in (_AVERAGE, _SUM) or not dtype.is_floating_point or \
                total == 0:
            comp = "none"
        scaled = prescale != 1.0 or postscale != 1.0
        acc = torch.float32 if comp != "none" or (
            _is_int(dtype) and scaled) else dtype
        # The fusion buffer: each name's elements at its offset, in the
        # response's name order; a name this rank did not submit (a
        # joined rank) is zeros.
        buf = torch.empty(total, dtype=acc, device=dev)
        off = 0
        for nm, n in zip(names, sizes):
            seg = buf[off: off + n]
            if nm in local:
                seg.copy_(local[nm].reshape(-1))
            else:
                seg.zero_()
            off += n
        raw = total * dtype.itemsize
        if comp != "none":
            from . import quantization as Q
            spec, wire_dtype = _wire_spec(comp)
            buf = Q.compressed_allreduce(buf, group, op, spec=spec,
                                         wire_dtype=wire_dtype,
                                         prescale=prescale,
                                         postscale=postscale)
        else:
            if prescale != 1.0:
                buf.mul_(prescale)
            dist.all_reduce(buf, op=_DIST_OPS[op], group=group)
            if op == _AVERAGE:
                if _is_int(acc):
                    buf.div_(P, rounding_mode="floor")
                else:
                    buf.div_(P)
            if postscale != 1.0:
                buf.mul_(postscale)
        ctl.record_response(len(names), raw,
                            _wire_bytes_sent(total, comp, raw))
        out, off = {}, 0
        for nm, n in zip(names, sizes):
            if nm in local:
                seg = buf[off: off + n].view(local[nm].shape)
                if seg.dtype != dtype:
                    seg = (seg.trunc() if _is_int(dtype) else seg).to(dtype)
                out[nm] = seg
            off += n
        return out

    def _broadcast(names, sizes, dtype, root, local, group, dev):
        total = sum(sizes)
        buf = torch.zeros(total * dtype.itemsize, dtype=torch.uint8,
                          device=dev)
        off = 0
        for nm, n in zip(names, sizes):
            if nm in local:
                buf[off: off + n * dtype.itemsize].copy_(_bytes(local[nm]))
            off += n * dtype.itemsize
        dist.broadcast(buf, src=root, group=group)
        ctl.record_response(len(names), buf.numel(), buf.numel())
        out, off = {}, 0
        for nm, n in zip(names, sizes):
            w = n * dtype.itemsize
            if nm in local:
                out[nm] = buf[off: off + w].view(dtype).view(
                    local[nm].shape)
            off += w
        return out

    def _allgather(name, sizes, dtype, local, group, P, me, dev):
        dims, row = sizes[:P], sizes[P]
        item = dtype.itemsize
        top = max(dims) * row * item
        mine = local.get(name)
        send = torch.zeros(top, dtype=torch.uint8, device=dev)
        if mine is not None and mine.numel():
            send[: mine.numel() * item].copy_(_bytes(mine))
        recv = torch.empty(P * top, dtype=torch.uint8, device=dev)
        if top:
            dist.all_gather_into_tensor(recv, send, group=group)
        ctl.record_response(1, sum(dims) * row * item,
                            sum(dims) * row * item, staged=False)
        if mine is None:
            return {}
        parts = [recv[r * top: r * top + dims[r] * row * item]
                 for r in range(P)]
        flat = torch.cat(parts) if P > 1 else parts[0]
        return {name: flat.view(dtype).view(
            (sum(dims),) + tuple(mine.shape[1:]))}

    def _alltoall(name, sizes, dtype, local, group, P, me, dev):
        mat, row = sizes[: P * P], sizes[P * P]
        w = row * dtype.itemsize
        send = [mat[me * P + d] * w for d in range(P)]
        recv_rows = [mat[s * P + me] for s in range(P)]
        mine = local.get(name)
        x = torch.zeros(sum(send), dtype=torch.uint8, device=dev)
        if mine is not None and sum(send):
            x.copy_(_bytes(mine)[: sum(send)])
        out = torch.empty(sum(recv_rows) * w, dtype=torch.uint8, device=dev)
        dist.all_to_all_single(out, x, output_split_sizes=[
            r * w for r in recv_rows], input_split_sizes=send, group=group)
        ctl.record_response(1, sum(send), sum(send), staged=False)
        if mine is None:
            return {}
        got = out.view(dtype).view((sum(recv_rows),) + tuple(mine.shape[1:]))
        return {name: (got, torch.tensor(recv_rows, dtype=torch.int32))}

    def impl(rtype, names, sizes, dtype, op, root, prescale, postscale,
             inputs):
        dev = global_state.device
        group = global_state.controller_group
        P, me = ctl.size(), ctl.rank()
        # One event per negotiated response, on the background thread: a
        # collective that never returns leaves this one dangling, naming
        # the batch that hung (the wire as the reference stamps it).
        wire = "none"
        if rtype == _ALLREDUCE and int(op) in (_AVERAGE, _SUM) and \
                dtype.is_floating_point and sum(sizes):
            wire = ctl.wire_compression()
        _flight.record("negotiate.execute", names[0] if names else None,
                       rtype=rtype, n=len(names), wire=wire)
        ctx, stream = _stream(dev)
        with ctx:
            local = {}
            for nm, (t, event) in inputs.items():
                if stream is not None:
                    if event is not None:
                        stream.wait_event(event)
                    # The caching allocator must not hand the staged
                    # input out again while this stream still reads it.
                    t.record_stream(stream)
                local[nm] = t
            if rtype == _ALLREDUCE:
                out = _allreduce(names, sizes, dtype, int(op), prescale,
                                 postscale, local, group, P, dev)
            elif rtype == _BROADCAST:
                out = _broadcast(names, sizes, dtype, int(root), local,
                                 group, dev)
            elif rtype == _ALLGATHER:
                out = _allgather(names[0], sizes, dtype, local, group, P,
                                 me, dev)
            else:
                out = _alltoall(names[0], sizes, dtype, local, group, P, me,
                                dev)
            done = None
            if stream is not None:
                done = torch.cuda.Event()
                done.record(stream)
                ctl.note_done(done)
        return {nm: (r, done) for nm, r in out.items()}

    def validate(rtype, names, sizes, dtype, op, root, inputs):
        """PREPARE: everything that would make ``impl`` fail before its
        collective."""
        if not device_plane_enabled():
            raise RuntimeError("device plane disabled on this rank "
                               "(HVD_TPU_EAGER_DEVICE_PLANE=0)")
        if not world_lines_up(ctl):
            raise RuntimeError(
                "device plane unavailable: the torch world does not span "
                "and line up with the controller's")
        if rtype not in (_ALLREDUCE, _ALLGATHER, _BROADCAST, _ALLTOALL):
            raise ValueError(
                f"device plane does not execute request type {rtype}")
        if rtype == _ALLREDUCE and (int(op) == _ADASUM or
                                    dtype == torch.bool):
            raise ValueError("device plane: Adasum and bool allreduce run "
                             "on the host plane")
        dev = global_state.device
        for nm, (t, _event) in inputs.items():
            if t.dtype != dtype or t.device.type != dev.type:
                raise TypeError(
                    f"device plane: {nm} is {t.dtype} on {t.device}, the "
                    f"response is {dtype} on {dev}")
        if rtype in (_ALLREDUCE, _BROADCAST):
            for nm, n in zip(names, sizes):
                if nm in inputs and inputs[nm][0].numel() != n:
                    raise ValueError(f"device plane: {nm} has "
                                     f"{inputs[nm][0].numel()} elements, "
                                     f"the response {n}")

    impl.validate = validate
    return impl


# ---------------------------------------------------------------------------
# the API under a controller
# ---------------------------------------------------------------------------

def _ctl(fn, *args, **kwargs):
    """Run a controller call, mapping the runtime's failures to
    ``HorovodInternalError`` (the reference's mapping, torch/mpi_ops.py
    synchronize); ``DuplicateNameError`` passes as it is."""
    from ..core.exceptions import HorovodInternalError
    from ..native.controller import NativeError
    try:
        return fn(*args, **kwargs)
    except NativeError as e:
        raise HorovodInternalError(str(e)) from e


def to_host(tensor):
    """``(array, back)``: the host plane's numpy array for ``tensor`` and
    the function that turns a result into the caller's type (a bfloat16
    tensor crosses as its 2-byte words)."""
    if isinstance(tensor, np.ndarray):
        return tensor, lambda a: a
    from ..native.controller import BF16_WORDS
    t = tensor.detach().contiguous().cpu()
    dev = tensor.device
    if t.dtype == torch.bfloat16:
        def back(a):
            words = np.ascontiguousarray(a).view(np.int16)
            return torch.from_numpy(words).view(torch.bfloat16).to(dev)
        return t.view(torch.int16).numpy().view(BF16_WORDS), back
    return t.numpy(), lambda a: torch.from_numpy(np.asarray(a)).to(dev)


def _handle(ctl, h, finish) -> int:
    return _handles.handle_manager.allocate(_handles.Handle(
        poll_fn=lambda: ctl.poll(h), wait_fn=lambda: _ctl(finish)))


def _done(handle: int):
    return _handles.handle_manager.synchronize(handle)


def allreduce_async(tensor, op: int, name: Optional[str] = None,
                    prescale: float = 1.0, postscale: float = 1.0) -> int:
    """Enqueue; the returned handle's ``synchronize`` gives the result, a
    new tensor (or numpy array).  The op is in flight while the caller
    computes."""
    ctl = _controller()
    if _reduces_on_device(tensor, op, ctl):
        h, nm = _ctl(ctl.allreduce_device_submit, tensor, op=int(op),
                     prescale=prescale, postscale=postscale, name=name)
        return _handle(ctl, h, lambda: ctl.device_finish(h, nm))
    arr, back = to_host(tensor)
    h, _arr, out = _ctl(ctl.allreduce_submit, arr, op=int(op),
                        prescale=prescale, postscale=postscale, name=name)
    return _handle(ctl, h, lambda: back(ctl.allreduce_finish(h, out)))


def allreduce(tensor, op: int, name: Optional[str] = None,
              prescale: float = 1.0, postscale: float = 1.0):
    return _done(allreduce_async(tensor, op, name, prescale, postscale))


def grouped_allreduce(tensors: Sequence, op: int,
                      name: Optional[str] = None, prescale: float = 1.0,
                      postscale: float = 1.0) -> list:
    """Every member enqueued before any is waited on, as ``{name}.{i}``,
    so the runtime fuses them (reference collective.py:580-600)."""
    ctl = _controller()
    base = name or ctl._auto_name("grouped", None).decode()
    handles = [allreduce_async(t, op, name=f"{base}.{i}", prescale=prescale,
                               postscale=postscale)
               for i, t in enumerate(tensors)]
    return [_done(h) for h in handles]


def allreduce_device_async(tensor, op: int, name: Optional[str] = None,
                           prescale: float = 1.0, postscale: float = 1.0):
    """Submit on the device plane and return a zero-argument finisher:
    the runtime negotiates and fuses while the caller computes."""
    ctl = _controller()
    h, nm = _ctl(ctl.allreduce_device_submit, tensor, op=int(op),
                 prescale=prescale, postscale=postscale, name=name)
    return lambda: _ctl(ctl.device_finish, h, nm)


def allgather_async(tensor, name: Optional[str] = None) -> int:
    ctl = _controller()
    if _on_device_plane(tensor, ctl) and tensor.dim() >= 1:
        h, nm = _ctl(ctl.allgather_device_submit, tensor, name=name)
        return _handle(ctl, h, lambda: ctl.device_finish(h, nm))
    arr, back = to_host(tensor)
    h, arr = _ctl(ctl.allgather_submit, arr, name=name)
    return _handle(ctl, h, lambda: back(ctl.allgather_finish(h, arr)))


def allgather(tensor, name: Optional[str] = None):
    return _done(allgather_async(tensor, name))


def broadcast_async(tensor, root_rank: int,
                    name: Optional[str] = None) -> int:
    ctl = _controller()
    if _on_device_plane(tensor, ctl):
        h, nm = _ctl(ctl.broadcast_device_submit, tensor,
                     root_rank=root_rank, name=name)
        return _handle(ctl, h, lambda: ctl.device_finish(h, nm))
    arr, back = to_host(tensor)
    h, _arr, out = _ctl(ctl.broadcast_submit, arr, root_rank=root_rank,
                        name=name)
    return _handle(ctl, h, lambda: back(ctl.broadcast_finish(h, out)))


def broadcast(tensor, root_rank: int, name: Optional[str] = None):
    return _done(broadcast_async(tensor, root_rank, name))


def alltoall_async(tensor, splits=None, name: Optional[str] = None) -> int:
    """The handle's result is ``(received, received_splits)``: the pieces
    in rank order and an int32 tensor (an array on the host plane, for a
    numpy input) of their row counts."""
    ctl = _controller()
    if _on_device_plane(tensor, ctl) and tensor.dim() >= 1:
        h, nm = _ctl(ctl.alltoall_device_submit, tensor, splits=splits,
                     name=name)
        return _handle(ctl, h, lambda: ctl.device_finish(h, nm))
    arr, back = to_host(tensor)
    h, arr = _ctl(ctl.alltoall_submit, arr, splits=splits, name=name)

    def finish():
        out, got = ctl.alltoall_finish(h, arr)
        if isinstance(tensor, np.ndarray):
            return out, got
        return back(out), torch.from_numpy(got)
    return _handle(ctl, h, finish)


def alltoall(tensor, splits: Optional[Sequence[int]] = None,
             name: Optional[str] = None):
    return _done(alltoall_async(tensor, splits, name))


def reducescatter(tensor, op: int, name: Optional[str] = None):
    """Allreduce, then this rank's equal dim-0 chunk (reference
    eager.py:917-927); Sum reduces as Sum, every other op as Average."""
    ctl = _controller()
    P = ctl.size()
    rows = tensor.shape[0] if len(tensor.shape) else 0
    if not len(tensor.shape) or rows % P:
        raise ValueError(f"reducescatter dim0 {rows} not divisible by {P}")
    reduced = allreduce(tensor, _SUM if int(op) == _SUM else _AVERAGE,
                        name=name)
    chunk = rows // P
    return reduced[ctl.rank() * chunk: (ctl.rank() + 1) * chunk]


def barrier() -> None:
    _ctl(_controller().barrier)


def join() -> int:
    """This rank has no more data: its peers' collectives go on with zeros
    for it until every rank has joined; returns the last rank to join."""
    return _ctl(_controller().join)
