"""ctypes bindings to the native runtime (port of
horovod_tpu/native/controller.py).

``NativeController`` drives the port's copy of the C++ runtime
(``native/src``): a background thread negotiates named tensors with the
coordinator, fuses ready ones up to the fusion threshold, skips the
negotiation of repeated names through the response cache, warns on
stalls and writes the timeline.  Two planes execute the negotiated
responses:

* the **host plane**: numpy arrays take the runtime's TCP ring, exactly
  as in the reference; a bfloat16 payload crosses as its 2-byte words
  (``BF16_WORDS``, dtype code 8), since the port has no ``ml_dtypes``;
* the **device plane**: torch tensors on the runtime's device are staged
  by name with no host copy, and the executor ``ops.eager`` registers
  runs each (possibly fused) response on the background thread — NCCL
  over CUDA tensors, or gloo over CPU tensors with ``init(device="cpu")``.

The reference's autotuner (its tick and tuned apply) is not ported:
``HVD_TPU_AUTOTUNE`` raises.  The controller records into the metrics
registry and the flight recorder as the reference's does: the
``hvd_native_*`` families, and from the executor ``hvd_fusion_batch_names``,
``hvd_device_plane_bytes_total``, ``hvd_wire_bytes_{raw,sent}_total
{kind="device_plane"}`` and ``hvd_response_cache_{hits,misses}_total``
(the native response cache's, since the port's executor compiles
nothing); the ``native.attach`` and ``collective.error`` events.
``stats()`` keeps this controller's own counts, which the families
only mirror.
"""

from __future__ import annotations

import ctypes
import json
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import config as _cfg
from ..core.exceptions import DuplicateNameError
from . import _build

# A bfloat16 payload on the host plane: its 2-byte words, marked so that
# a genuine int16 array (which the runtime does not take) is refused.
BF16_WORDS = np.dtype(np.int16, metadata={"bfloat16": True})

_DTYPE_CODES = {
    np.dtype(np.uint8): 0,
    np.dtype(np.int8): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.int64): 3,
    np.dtype(np.float16): 4,
    np.dtype(np.float32): 5,
    np.dtype(np.float64): 6,
    np.dtype(np.bool_): 7,
}
_BF16_CODE = 8

TORCH_CODES = {torch.uint8: 0, torch.int8: 1, torch.int32: 2,
               torch.int64: 3, torch.float16: 4, torch.float32: 5,
               torch.float64: 6, torch.bool: 7, torch.bfloat16: 8}
CODE_TO_TORCH = {v: k for k, v in TORCH_CODES.items()}

# Device-executor callback (runtime.h DeviceExecutorFn): one negotiated,
# possibly fused response on the background thread, in coordinator order.
# PREPARE(0) stages and runs every check that can fail locally, EXECUTE(1)
# runs the collective after every rank's PREPARE agreed, ABORT(2) drops
# what PREPARE staged when a peer's failed.
_PHASE_PREPARE, _PHASE_EXECUTE, _PHASE_ABORT = 0, 1, 2
_DEVICE_EXEC_FN = ctypes.CFUNCTYPE(
    ctypes.c_int,                        # return: 0 ok
    ctypes.c_int,                        # phase (DeviceExecPhase)
    ctypes.c_int, ctypes.c_int,          # request_type, n
    ctypes.POINTER(ctypes.c_char_p),     # names
    ctypes.POINTER(ctypes.c_int64),      # sizes (element counts)
    ctypes.c_int, ctypes.c_int,          # dtype code, reduce op
    ctypes.c_int,                        # root_rank
    ctypes.c_double, ctypes.c_double,    # prescale, postscale
    ctypes.POINTER(ctypes.c_char), ctypes.c_int)  # err buf, err cap

_lib = None
_lib_lock = threading.Lock()


def load_library():
    """The runtime, built at first use (``native/_build.py``).  Loaded
    with ``CDLL``, so every call releases the GIL: the background thread
    needs it to run the device executor while a caller waits."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build.build())
        i64, dbl, cint, cstr = (ctypes.c_int64, ctypes.c_double,
                                ctypes.c_int, ctypes.c_char_p)
        p64, vp = ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p
        sig = {
            "hvd_native_init": (cint, [cint, cint, cstr, i64, dbl, dbl, dbl,
                                       cstr, i64]),
            "hvd_native_rank": (cint, []),
            "hvd_native_size": (cint, []),
            "hvd_native_allreduce": (i64, [cstr, vp, vp, cint, p64, cint,
                                           cint, dbl, dbl]),
            "hvd_native_allgather": (i64, [cstr, vp, cint, p64, cint]),
            "hvd_native_broadcast": (i64, [cstr, vp, vp, cint, p64, cint,
                                           cint]),
            "hvd_native_alltoall": (i64, [cstr, vp, cint, p64, cint, p64,
                                          cint]),
            "hvd_native_allreduce_device": (i64, [cstr, cint, p64, cint,
                                                  cint, dbl, dbl]),
            "hvd_native_broadcast_device": (i64, [cstr, cint, p64, cint,
                                                  cint]),
            "hvd_native_allgather_device": (i64, [cstr, cint, p64, cint]),
            "hvd_native_alltoall_device": (i64, [cstr, cint, p64, cint, p64,
                                                 cint]),
            "hvd_native_poll": (cint, [i64]),
            "hvd_native_wait": (cint, [i64]),
            "hvd_native_result_dims": (cint, [i64, p64, cint]),
            "hvd_native_result_copy": (cint, [i64, vp, i64]),
            "hvd_native_release": (None, [i64]),
            "hvd_native_join": (cint, []),
            "hvd_native_barrier": (cint, []),
            "hvd_native_last_error": (cstr, []),
            "hvd_native_stalled_json": (cint, [ctypes.POINTER(ctypes.c_char),
                                               cint]),
            "hvd_native_start_timeline": (None, [cstr]),
            "hvd_native_stop_timeline": (None, []),
            "hvd_native_set_schedule_table": (
                None, [cint, p64, ctypes.POINTER(ctypes.c_int32), cint]),
            "hvd_native_set_cache_enabled": (None, [cint]),
            "hvd_native_set_wire_compression": (None, [cint]),
            "hvd_native_wire_compression": (cint, []),
            "hvd_native_set_topology": (None, [cint, cint, cint]),
            "hvd_native_last_allgather_schedule": (cint, []),
            "hvd_native_last_allreduce_schedule": (cint, []),
            "hvd_native_last_allreduce_fanout": (cint, []),
            "hvd_native_last_bcast_schedule": (cint, []),
            "hvd_native_last_fused_names": (i64, []),
            "hvd_native_cache_hits": (i64, []),
            "hvd_native_adasum_scratch_peak": (i64, []),
            "hvd_native_adasum_scratch_reset": (None, []),
            "hvd_native_net_counters": (cint, [p64, cint]),
            "hvd_native_set_device_executor": (None, [_DEVICE_EXEC_FN]),
            "hvd_native_shutdown": (None, []),
        }
        for name, (restype, argtypes) in sig.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return lib


def _dtype_code(arr: np.ndarray) -> int:
    if arr.dtype.metadata and arr.dtype.metadata.get("bfloat16"):
        return _BF16_CODE
    code = _DTYPE_CODES.get(arr.dtype)
    if code is None:
        raise TypeError(f"unsupported dtype {arr.dtype} for native path")
    return code


def _shape_arg(shape) -> Tuple[int, ctypes.Array]:
    shape = tuple(shape)
    return len(shape), (ctypes.c_int64 * max(len(shape), 1))(
        *(shape or (1,)))


class NativeError(RuntimeError):
    """The runtime failed an operation (transport, peer, executor)."""


class NativeController:
    """Negotiated eager collectives through the native runtime."""

    def __init__(self, rank: int, size: int, coord_addr: str,
                 local_size: int = 1):
        cfg = _cfg.ControllerConfig.from_env()
        if cfg.autotune:
            raise NotImplementedError(
                "HVD_TPU_AUTOTUNE: the autotuner is ROADMAP queue 1 item 10 "
                "and not ported yet; unset the knob")
        self._lib = load_library()
        rc = self._lib.hvd_native_init(
            rank, size, coord_addr.encode(), cfg.fusion_threshold_bytes,
            cfg.cycle_time_ms,
            1e9 if cfg.stall_check_disable
            else cfg.stall_warning_time_seconds,
            cfg.stall_shutdown_time_seconds, cfg.timeline_filename.encode(),
            cfg.cache_capacity)
        if rc != 0:
            raise NativeError(self._last_error())
        self.config = cfg
        self._local_size = local_size
        # The runtime's counter outlives a shutdown and re-init.
        self._cache_hits0 = int(self._lib.hvd_native_cache_hits())
        self._lib.hvd_native_set_topology(
            local_size, int(cfg.hierarchical_allreduce),
            int(cfg.hierarchical_allgather))
        # Seed the wire format from HVD_TPU_COMPRESSION: only the
        # coordinator's call takes effect, and every rank adopts its
        # choice from the response stream.
        from ..ops.compression import WIRE_CODES
        self._lib.hvd_native_set_wire_compression(
            WIRE_CODES.get(cfg.compression, 0))
        self._counters = {}
        self._dispatch_table = None
        from ..debug import flight as _flight
        _flight.set_identity(rank=rank, world=size)
        _flight.record("native.attach", None, rank=rank, size=size,
                       coord_addr=coord_addr)
        # Metric children cached on the instance (``_wait`` runs per op).
        from ..metrics.registry import registry as _metrics_registry
        reg = _metrics_registry()
        self._m_ops = reg.counter(
            "hvd_native_ops_total",
            "Completed native-runtime eager operations")
        self._m_fused = reg.gauge(
            "hvd_native_last_fused_names",
            "Names in the most recent fused allreduce Response")
        self._m_hits = reg.counter(
            "hvd_response_cache_hits_total",
            "Device-plane response-signature cache hits")
        self._m_misses = reg.counter(
            "hvd_response_cache_misses_total",
            "Device-plane response-signature cache misses (compiles)")
        self._m_batch = reg.histogram(
            "hvd_fusion_batch_names",
            "Tensors per negotiated device-plane Response (fusion batch)",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
        self._m_staged = reg.counter(
            "hvd_device_plane_bytes_total",
            "Payload bytes executed on the negotiated device plane")
        self._m_raw = reg.counter(
            "hvd_wire_bytes_raw_total",
            "Pre-compression payload bytes offered to the wire",
            kind="device_plane")
        self._m_sent = reg.counter(
            "hvd_wire_bytes_sent_total",
            "Payload bytes after the selected wire format",
            kind="device_plane")
        self._stats_lock = threading.Lock()
        self._stats = {"enqueued": 0, "responses": 0, "names": 0,
                       "names_per_response": {}, "bytes_raw": 0,
                       "bytes_sent": 0}
        self._hits_seen = 0
        self._enqueued_seen = 0
        # Device plane: tensors staged by name with the event that orders
        # them after their producers; results handed back with theirs.
        self._device_lock = threading.Lock()
        self._device_inputs = {}
        self._device_results = {}
        self._device_cb = None
        self._device_exec_impl = None
        self._device_plan = None
        # Registered now: every rank must take part in a device response
        # (joined ranks with zero proxies) even if it submitted nothing.
        from ..ops.eager import _negotiated_executor
        self.set_device_executor(_negotiated_executor(self))

    @classmethod
    def from_env(cls, rank: Optional[int] = None, size: Optional[int] = None,
                 local_size: int = 1) -> "NativeController":
        """The controller of ``HVD_TPU_CONTROLLER_ADDR``; its rank and size
        from ``CONTROLLER_RANK``/``CONTROLLER_SIZE``, else the arguments,
        else ``RANK``/``SIZE``."""
        addr = _cfg.get_env(_cfg.CONTROLLER_ADDR)
        if not addr:
            raise NativeError("HVD_TPU_CONTROLLER_ADDR not set")

        def pick(knob, given, fallback, default):
            val = _cfg.get_int(knob)
            if val is not None:
                return val
            if given is not None:
                return given
            val = _cfg.get_int(fallback)
            return default if val is None else val

        return cls(pick(_cfg.CONTROLLER_RANK, rank, _cfg.RANK, 0),
                   pick(_cfg.CONTROLLER_SIZE, size, _cfg.SIZE, 1), addr,
                   local_size=local_size)

    def _last_error(self) -> str:
        return (self._lib.hvd_native_last_error() or b"").decode()

    def _enqueue_error(self):
        err = self._last_error()
        if "already in flight" in err:
            return DuplicateNameError(err)
        return NativeError(err)

    def _enqueued(self, h: int) -> int:
        if h < 0:
            raise self._enqueue_error()
        with self._stats_lock:
            self._stats["enqueued"] += 1
        return h

    def _auto_name(self, kind: str, name: Optional[str]) -> bytes:
        if name is not None:
            return name.encode()
        # Deterministic auto names: call order must match across ranks,
        # the reference's handle-indexed auto names.
        n = self._counters.get(kind, 0)
        self._counters[kind] = n + 1
        return f"{kind}.noname.{n}".encode()

    def _wait(self, handle: int):
        if self._lib.hvd_native_wait(handle) != 0:
            err = self._last_error()
            self._lib.hvd_native_release(handle)
            from ..debug import flight as _flight
            _flight.record("collective.error", None, error=err[:256])
            raise NativeError(err)
        self._m_ops.inc()
        self._m_fused.set(self._lib.hvd_native_last_fused_names())

    # -- counters -----------------------------------------------------------

    def record_response(self, n_names: int, raw: int, sent: int,
                        staged: bool = True) -> None:
        """The executor's account of one device response, counted in
        ``stats()``.  The registry gets its fusion batch and, for the
        allreduce and broadcast responses (``staged``), its payload bytes
        raw and on the wire, as the reference's executor counts them."""
        with self._stats_lock:
            s = self._stats
            s["responses"] += 1
            s["names"] += n_names
            hist = s["names_per_response"]
            hist[n_names] = hist.get(n_names, 0) + 1
            s["bytes_raw"] += int(raw)
            s["bytes_sent"] += int(sent)
            hits = self.cache_hits()
            d_hits = hits - self._hits_seen
            d_enq = s["enqueued"] - self._enqueued_seen
            self._hits_seen, self._enqueued_seen = hits, s["enqueued"]
        if d_hits > 0:
            self._m_hits.inc(d_hits)
        if d_enq > d_hits:
            self._m_misses.inc(d_enq - d_hits)
        self._m_batch.observe(n_names)
        if staged:
            self._m_staged.inc(float(raw))
            self._m_raw.inc(float(raw))
            self._m_sent.inc(float(sent))

    def cache_hits(self) -> int:
        """Tensors this rank announced as a response-cache bit instead of
        a full request, since this controller's init."""
        return int(self._lib.hvd_native_cache_hits()) - self._cache_hits0

    def stats(self) -> dict:
        """Counters since init: response-cache hits and misses (announced
        tensors that did not hit), device responses, names per response
        (a histogram), and payload bytes raw and sent on the device
        plane."""
        hits = self.cache_hits()
        with self._stats_lock:
            s = dict(self._stats,
                     names_per_response=dict(
                         self._stats["names_per_response"]))
        s["cache_hits"] = hits
        s["cache_misses"] = s["enqueued"] - hits
        return s

    def set_wire_compression(self, name: str) -> None:
        """Stamp the wire format of later device responses ("none", "bf16",
        "fp16", "int8", "int4"): only the coordinator's call takes effect,
        and every rank adopts it from the response stream at a round's
        start (the reference's tuned apply, controller.py:409-412)."""
        from ..ops.compression import WIRE_CODES
        self._lib.hvd_native_set_wire_compression(WIRE_CODES[name])

    def wire_compression(self) -> str:
        """The response-stream-adopted wire format ("none" until the first
        round after the coordinator stamped one)."""
        from ..ops.compression import WIRE_CODES
        names = {v: k for k, v in WIRE_CODES.items()}
        return names.get(int(self._lib.hvd_native_wire_compression()),
                         "none")

    # -- device plane -------------------------------------------------------

    def set_device_executor(self, impl) -> None:
        """Register the device-plane executor.  ``impl(request_type, names,
        sizes, dtype, op, root_rank, prescale, postscale, inputs)`` runs one
        negotiated response and returns {name: (result, event)} for the
        locally submitted names; ``impl.validate`` runs in PREPARE."""
        self._device_exec_impl = impl
        if self._device_cb is not None:
            return
        controller = self

        def _cb(phase, rtype, n, names_p, sizes_p, dtype_code, op, root,
                prescale, postscale, err, err_cap):
            try:
                if phase == _PHASE_ABORT:
                    controller._device_plan = None
                    return 0
                if phase == _PHASE_PREPARE:
                    names = [names_p[i].decode() for i in range(n)]
                    # allreduce/broadcast: element counts per name;
                    # allgather: per-rank dims + row_elems; alltoall: the
                    # P x P split matrix + row_elems.
                    P = controller.size()
                    n_sizes = {1: P + 1, 3: P * P + 1}.get(rtype, n)
                    sizes = [int(sizes_p[i]) for i in range(n_sizes)]
                    dtype = CODE_TO_TORCH[dtype_code]
                    with controller._device_lock:
                        inputs = {nm: controller._device_inputs[nm]
                                  for nm in names
                                  if nm in controller._device_inputs}
                    controller._device_exec_impl.validate(
                        rtype, names, sizes, dtype, op, root, inputs)
                    controller._device_plan = (
                        rtype, names, sizes, dtype, op, root, prescale,
                        postscale, inputs)
                    return 0
                plan = controller._device_plan
                controller._device_plan = None
                if plan is None:
                    raise RuntimeError(
                        "device executor: EXECUTE without a prepared plan")
                results = controller._device_exec_impl(*plan)
                with controller._device_lock:
                    controller._device_results.update(results)
                return 0
            except BaseException as e:  # noqa: BLE001 — must not unwind into C
                msg = repr(e).encode()[: max(err_cap - 1, 0)]
                ctypes.memmove(err, msg + b"\x00", len(msg) + 1)
                return 1

        self._device_cb = _DEVICE_EXEC_FN(_cb)
        self._lib.hvd_native_set_device_executor(self._device_cb)

    def _stage(self, kind: str, tensor: torch.Tensor,
               name: Optional[str]) -> str:
        """Stage ``tensor`` under its name with an event after its
        producers on the submitting thread's stream."""
        if tensor.dtype not in TORCH_CODES:
            raise TypeError(
                f"unsupported dtype {tensor.dtype} for the device plane")
        nm = self._auto_name(kind, name).decode()
        event = None
        if tensor.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(tensor.device))
        with self._device_lock:
            # Checked here, not only in the runtime: staging over an
            # in-flight name would take its input away.
            if nm in self._device_inputs or nm in self._device_results:
                raise DuplicateNameError(
                    f"a tensor named {nm} is already in flight; use "
                    "distinct names for concurrent ops")
            self._device_inputs[nm] = (tensor, event)
        return nm

    def _submitted(self, h: int, nm: str) -> Tuple[int, str]:
        if h < 0:
            with self._device_lock:
                self._device_inputs.pop(nm, None)
            raise self._enqueue_error()
        return self._enqueued(h), nm

    def allreduce_device_submit(self, tensor: torch.Tensor, op: int = 1,
                                prescale: float = 1.0,
                                postscale: float = 1.0,
                                name: Optional[str] = None
                                ) -> Tuple[int, str]:
        nm = self._stage("allreduce", tensor, name)
        ndim, shape = _shape_arg(tensor.shape)
        return self._submitted(self._lib.hvd_native_allreduce_device(
            nm.encode(), ndim, shape, TORCH_CODES[tensor.dtype], int(op),
            prescale, postscale), nm)

    def broadcast_device_submit(self, tensor: torch.Tensor,
                                root_rank: int = 0,
                                name: Optional[str] = None
                                ) -> Tuple[int, str]:
        nm = self._stage("broadcast", tensor, name)
        ndim, shape = _shape_arg(tensor.shape)
        return self._submitted(self._lib.hvd_native_broadcast_device(
            nm.encode(), ndim, shape, TORCH_CODES[tensor.dtype],
            int(root_rank)), nm)

    def allgather_device_submit(self, tensor: torch.Tensor,
                                name: Optional[str] = None
                                ) -> Tuple[int, str]:
        nm = self._stage("allgather", tensor, name)
        ndim, shape = _shape_arg(tensor.shape)
        return self._submitted(self._lib.hvd_native_allgather_device(
            nm.encode(), ndim, shape, TORCH_CODES[tensor.dtype]), nm)

    def alltoall_device_submit(self, tensor: torch.Tensor,
                               splits: Optional[Sequence[int]] = None,
                               name: Optional[str] = None
                               ) -> Tuple[int, str]:
        splits = self._splits(tensor.shape, splits)
        nm = self._stage("alltoall", tensor, name)
        sp = (ctypes.c_int64 * len(splits))(*splits)
        ndim, shape = _shape_arg(tensor.shape)
        return self._submitted(self._lib.hvd_native_alltoall_device(
            nm.encode(), ndim, shape, TORCH_CODES[tensor.dtype], sp,
            len(splits)), nm)

    def device_finish(self, h: int, name: str):
        """Wait for a ``*_device_submit`` handle and take its result; on
        the card, the caller's stream waits for the executor's."""
        try:
            self._wait(h)
        except NativeError:
            with self._device_lock:
                self._device_inputs.pop(name, None)
                self._device_results.pop(name, None)
            raise
        self._lib.hvd_native_release(h)
        with self._device_lock:
            self._device_inputs.pop(name, None)
            out, event = self._device_results.pop(name, (None, None))
        if event is not None:
            cuda = [t for t in (out if isinstance(out, tuple) else (out,))
                    if t.is_cuda]
            stream = torch.cuda.current_stream(cuda[0].device)
            stream.wait_event(event)
            for t in cuda:
                t.record_stream(stream)
        return out

    def allreduce_device(self, tensor, op: int = 1, prescale: float = 1.0,
                         postscale: float = 1.0, name: Optional[str] = None):
        return self.device_finish(*self.allreduce_device_submit(
            tensor, op=op, prescale=prescale, postscale=postscale,
            name=name))

    def broadcast_device(self, tensor, root_rank: int = 0,
                         name: Optional[str] = None):
        return self.device_finish(*self.broadcast_device_submit(
            tensor, root_rank=root_rank, name=name))

    def allgather_device(self, tensor, name: Optional[str] = None):
        return self.device_finish(*self.allgather_device_submit(
            tensor, name=name))

    def alltoall_device(self, tensor, splits=None,
                        name: Optional[str] = None):
        """Returns (received, received_splits) like the host plane."""
        return self.device_finish(*self.alltoall_device_submit(
            tensor, splits=splits, name=name))

    # -- host plane ---------------------------------------------------------

    def _splits(self, shape, splits) -> list:
        size = self.size()
        if splits is None:
            rows = shape[0] if len(shape) else 0
            if rows % size != 0:
                raise ValueError("alltoall dim0 not divisible by size")
            return [rows // size] * size
        return [int(s) for s in splits]

    def allreduce_async_(self, arr: np.ndarray, out: np.ndarray,
                         op: int = 1, prescale: float = 1.0,
                         postscale: float = 1.0,
                         name: Optional[str] = None) -> int:
        """In-place-capable async allreduce (``arr`` and ``out`` may
        alias); the caller keeps both alive until ``wait``."""
        ndim, shape = _shape_arg(arr.shape)
        return self._enqueued(self._lib.hvd_native_allreduce(
            self._auto_name("allreduce", name),
            arr.ctypes.data_as(ctypes.c_void_p),
            out.ctypes.data_as(ctypes.c_void_p), ndim, shape,
            _dtype_code(arr), int(op), prescale, postscale))

    def wait(self, handle: int):
        self._wait(handle)
        self._lib.hvd_native_release(handle)

    def poll(self, handle: int) -> bool:
        return bool(self._lib.hvd_native_poll(handle))

    def allreduce_submit(self, arr: np.ndarray, op: int = 1,
                         prescale: float = 1.0, postscale: float = 1.0,
                         name: Optional[str] = None
                         ) -> Tuple[int, np.ndarray, np.ndarray]:
        """Enqueue an allreduce; returns (handle, in_buf, out_buf), which
        the caller keeps alive until ``allreduce_finish``."""
        arr = np.asarray(arr, order="C")
        out = np.empty_like(arr)
        h = self.allreduce_async_(arr, out, op=op, prescale=prescale,
                                  postscale=postscale, name=name)
        return h, arr, out

    def allreduce_finish(self, h: int, out: np.ndarray) -> np.ndarray:
        self.wait(h)
        return out

    def allreduce(self, arr: np.ndarray, op: int = 1,
                  prescale: float = 1.0, postscale: float = 1.0,
                  name: Optional[str] = None) -> np.ndarray:
        h, _arr, out = self.allreduce_submit(arr, op=op, prescale=prescale,
                                             postscale=postscale, name=name)
        return self.allreduce_finish(h, out)

    def allgather_submit(self, arr: np.ndarray,
                         name: Optional[str] = None
                         ) -> Tuple[int, np.ndarray]:
        arr = np.asarray(arr, order="C")
        ndim, shape = _shape_arg(arr.shape)
        return self._enqueued(self._lib.hvd_native_allgather(
            self._auto_name("allgather", name),
            arr.ctypes.data_as(ctypes.c_void_p), ndim, shape,
            _dtype_code(arr))), arr

    def allgather_finish(self, h: int, arr: np.ndarray) -> np.ndarray:
        self._wait(h)
        dims = (ctypes.c_int64 * self.size())()
        self._lib.hvd_native_result_dims(h, dims, self.size())
        out = np.empty((sum(dims),) + arr.shape[1:], dtype=arr.dtype)
        self._lib.hvd_native_result_copy(
            h, out.ctypes.data_as(ctypes.c_void_p), max(out.nbytes, 1))
        self._lib.hvd_native_release(h)
        return out

    def allgather(self, arr: np.ndarray,
                  name: Optional[str] = None) -> np.ndarray:
        return self.allgather_finish(*self.allgather_submit(arr, name=name))

    def broadcast_submit(self, arr: np.ndarray, root_rank: int = 0,
                         name: Optional[str] = None
                         ) -> Tuple[int, np.ndarray, np.ndarray]:
        arr = np.asarray(arr, order="C")
        out = arr.copy()
        ndim, shape = _shape_arg(arr.shape)
        h = self._enqueued(self._lib.hvd_native_broadcast(
            self._auto_name("broadcast", name),
            arr.ctypes.data_as(ctypes.c_void_p),
            out.ctypes.data_as(ctypes.c_void_p), ndim, shape,
            _dtype_code(arr), int(root_rank)))
        return h, arr, out

    def broadcast_finish(self, h: int, out: np.ndarray) -> np.ndarray:
        self.wait(h)
        return out

    def broadcast(self, arr: np.ndarray, root_rank: int = 0,
                  name: Optional[str] = None) -> np.ndarray:
        h, _arr, out = self.broadcast_submit(arr, root_rank=root_rank,
                                             name=name)
        return self.broadcast_finish(h, out)

    def alltoall_submit(self, arr: np.ndarray,
                        splits: Optional[Sequence[int]] = None,
                        name: Optional[str] = None
                        ) -> Tuple[int, np.ndarray]:
        arr = np.asarray(arr, order="C")
        splits = self._splits(arr.shape, splits)
        sp = (ctypes.c_int64 * len(splits))(*splits)
        ndim, shape = _shape_arg(arr.shape)
        return self._enqueued(self._lib.hvd_native_alltoall(
            self._auto_name("alltoall", name),
            arr.ctypes.data_as(ctypes.c_void_p), ndim, shape,
            _dtype_code(arr), sp, len(splits))), arr

    def alltoall_finish(self, h: int, arr: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
        self._wait(h)
        size = self.size()
        dims = (ctypes.c_int64 * size)()
        self._lib.hvd_native_result_dims(h, dims, size)
        recv_splits = np.array(list(dims), dtype=np.int32)
        out = np.empty((int(recv_splits.sum()),) + arr.shape[1:],
                       dtype=arr.dtype)
        self._lib.hvd_native_result_copy(
            h, out.ctypes.data_as(ctypes.c_void_p), max(out.nbytes, 1))
        self._lib.hvd_native_release(h)
        return out, recv_splits

    def alltoall(self, arr: np.ndarray,
                 splits: Optional[Sequence[int]] = None,
                 name: Optional[str] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        return self.alltoall_finish(*self.alltoall_submit(
            arr, splits=splits, name=name))

    def join(self) -> int:
        return self._lib.hvd_native_join()

    def barrier(self):
        if self._lib.hvd_native_barrier() != 0:
            raise NativeError(self._last_error())

    # -- inspection and schedule ---------------------------------------------

    def last_fused_names(self) -> int:
        """Names in the most recent (possibly fused) allreduce response."""
        return self._lib.hvd_native_last_fused_names()

    def stalled(self) -> list:
        """Stall-inspector snapshot (coordinator only; [] elsewhere):
        tensors past the warning window, each with ``name``, request
        ``type``, ``age_s`` and the ``missing`` / ``submitted`` ranks."""
        n = self._lib.hvd_native_stalled_json(None, 0)
        buf = ctypes.create_string_buffer(max(n + 1, 3))
        self._lib.hvd_native_stalled_json(buf, len(buf))
        try:
            return json.loads(buf.value.decode() or "[]")
        except ValueError:
            # The table changed between the sizing and the filling call.
            return []

    def set_schedule_table(self, kind, max_bytes, hierarchical) -> None:
        """Install one op kind's per-payload dispatch table on the
        coordinator: payloads up to ``max_bytes[i]`` use the hierarchical
        schedule iff ``hierarchical[i]`` (ascending bounds, the last
        INT64_MAX)."""
        if not isinstance(kind, int):
            from ..ops.dispatch import KIND_CODES
            kind = KIND_CODES[kind]
        n = len(max_bytes)
        mb = (ctypes.c_int64 * n)(*[int(b) for b in max_bytes])
        ch = (ctypes.c_int32 * n)(*[1 if c else 0 for c in hierarchical])
        self._lib.hvd_native_set_schedule_table(kind, mb, ch, n)

    def adopt_dispatch_table(self, table) -> None:
        """Install a probe-built ``DispatchTable`` on the coordinator."""
        self._dispatch_table = table
        if self.rank() != 0:
            return
        from ..ops import dispatch as _dispatch
        for kind in _dispatch.KINDS:
            self.set_schedule_table(kind, *table.to_native(kind))

    def set_cache_enabled(self, enabled: bool) -> None:
        """The response cache on or off (coordinator-distributed)."""
        self._lib.hvd_native_set_cache_enabled(1 if enabled else 0)

    def last_allgather_schedule(self) -> int:
        """0 = flat ring, 1 = hierarchical (chain fan-out), 2 =
        hierarchical (CMA star fan-out): the most recent allgather."""
        return self._lib.hvd_native_last_allgather_schedule()

    def last_allreduce_schedule(self) -> int:
        """0 = flat, 1 = hierarchical: the most recent allreduce."""
        return self._lib.hvd_native_last_allreduce_schedule()

    def last_allreduce_fanout(self) -> int:
        """0 = flat/none, 1 = chain, 2 = CMA star: the phase-3 fan-out of
        the most recent hierarchical allreduce."""
        return self._lib.hvd_native_last_allreduce_fanout()

    def last_bcast_schedule(self) -> int:
        """0 = none yet, 1 = pipelined chain, 2 = CMA star."""
        return self._lib.hvd_native_last_bcast_schedule()

    def schedules(self) -> dict:
        return {"allreduce": self.last_allreduce_schedule(),
                "allgather": self.last_allgather_schedule(),
                "broadcast": self.last_bcast_schedule()}

    def adasum_scratch_peak(self) -> int:
        """Peak scratch bytes of the host Adasum path since the last
        reset."""
        return int(self._lib.hvd_native_adasum_scratch_peak())

    def adasum_scratch_reset(self) -> None:
        self._lib.hvd_native_adasum_scratch_reset()

    NET_COUNTER_FIELDS = ("retries", "reconnects", "renegotiations",
                          "resets_avoided", "chaos_injected",
                          "recovering_now", "last_recovery_age_ms")

    def net_counters(self) -> dict:
        """The wire fabric's escalation-ladder counters (``net.cc``):
        recovery attempts, resumed reconnects, ring renegotiations,
        collectives completed after a recovery, chaos injections, the
        channels recovering now and the age of the last recovery in ms
        (-1 = never).  Process-cumulative; ``net.sync_native_metrics``
        folds them into the registry."""
        buf = (ctypes.c_int64 * len(self.NET_COUNTER_FIELDS))()
        n = self._lib.hvd_native_net_counters(buf, len(buf))
        return {k: int(buf[i]) for i, k in
                enumerate(self.NET_COUNTER_FIELDS[:n])}

    def rank(self) -> int:
        return self._lib.hvd_native_rank()

    def size(self) -> int:
        return self._lib.hvd_native_size()

    def start_timeline(self, filename: str):
        self._lib.hvd_native_start_timeline(filename.encode())

    def stop_timeline(self):
        self._lib.hvd_native_stop_timeline()

    def shutdown(self):
        """Leave the runtime; blocks until every rank has asked to."""
        self._lib.hvd_native_shutdown()
