"""The TensorFlow 2 front end on the port (port of
horovod_tpu/tensorflow/).

The collectives (differentiable, ``IndexedSlices`` through the allgather
path), the ``*_op`` queries, ``broadcast_variables``,
``DistributedGradientTape``, ``DistributedOptimizer`` (with local
gradient aggregation over ``backward_passes_per_step`` and Adasum's
delta model) and ``SyncBatchNormalization``.

TensorFlow runs on the CPU only here: its tensors cross as numpy arrays
to CPU torch tensors and through the port's collectives, in a gloo world
(``init(device="cpu")``, or a slot that ``hvdrun-torch --worker-platform
cpu`` pinned to the CPU) or on the native controller's planes.  Inside
``tf.function`` a collective lowers to the compiled custom op
(``ops/hvd_tf_ops.cc``, the reference's source with op names of its
own), which calls the port's native runtime when a controller is
attached, or else to a ``tf.py_function`` bridge into the same calls.
The op library is built with g++ and TensorFlow's ``sysconfig`` flags
into ``horovod_tpu_torch/_build/tf_ops/`` at first use, under a lock.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional

import numpy as np
import tensorflow as _tf
import torch

from ..core.basics import (ccl_built, cross_rank, cross_size,  # noqa: F401
                           cuda_built, ddl_built, gloo_built, init,
                           is_initialized, local_rank, local_size,
                           mpi_built, mpi_threads_supported, nccl_built,
                           rank, rocm_built, shutdown, size)
from ..ops import collective as _C
from ..ops.collective import (Adasum, Average, Max, Min,  # noqa: F401
                              Product, Sum)
from ..optimizers import allgather_object, broadcast_object


def broadcast_object_fn(root_rank: int = 0, session=None,
                        name: Optional[str] = None):
    """A reusable object broadcast (reference tensorflow/functions.py
    broadcast_object_fn; ``session`` is accepted for the signature)."""
    def _bcast(obj):
        return broadcast_object(obj, root_rank=root_rank, name=name)
    return _bcast


class Compression:
    class none:
        @staticmethod
        def compress(t):
            return t, None

        @staticmethod
        def decompress(t, ctx):
            return t

    class fp16:
        @staticmethod
        def compress(t):
            if t.dtype in (_tf.float32, _tf.float64):
                return _tf.cast(t, _tf.float16), t.dtype
            return t, None

        @staticmethod
        def decompress(t, ctx):
            return t if ctx is None else _tf.cast(t, ctx)

    class bf16:
        """bfloat16 wire compression (fp32's exponent range: no loss
        scaling needed, unlike fp16)."""

        @staticmethod
        def compress(t):
            if t.dtype in (_tf.float32, _tf.float64):
                return _tf.cast(t, _tf.bfloat16), t.dtype
            return t, None

        @staticmethod
        def decompress(t, ctx):
            return t if ctx is None else _tf.cast(t, ctx)


# ---------------------------------------------------------------------------
# numpy <-> the port's collectives
# ---------------------------------------------------------------------------

def _np(t) -> np.ndarray:
    return t.numpy() if hasattr(t, "numpy") else np.asarray(t)


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor holding a copy of ``arr`` (0-d stays 0-d; a bfloat16
    array crosses as its 2-byte words)."""
    arr = np.array(arr, copy=True, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _to_np(t: torch.Tensor, like: np.dtype) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(like)
    return t.numpy()


def _np_allreduce(x, op, name, prescale_factor, postscale_factor):
    x = np.asarray(x)
    return _to_np(_C.allreduce(_to_torch(x), op=op, name=name,
                               prescale_factor=prescale_factor,
                               postscale_factor=postscale_factor), x.dtype)


def _np_allgather(x, name):
    x = np.asarray(x)
    t = _to_torch(x)
    if t.dim() > 0:
        return _to_np(_C.allgather(t, name=name), x.dtype)
    # A scalar gathers as one element a rank; a world of one keeps its
    # shape, as the reference's identity does.
    out = _to_np(_C.allgather(t.reshape(1), name=name), x.dtype)
    return out.reshape(()) if _C.communicator_size() == 1 else out


def _np_broadcast(x, root_rank, name):
    x = np.asarray(x)
    return _to_np(_C.broadcast(_to_torch(x), root_rank=root_rank,
                               name=name), x.dtype)


def _np_alltoall(x, splits, name):
    x = np.asarray(x)
    if splits is not None:
        splits = [int(s) for s in np.asarray(splits).ravel()]
    out, recv = _C.alltoall(_to_torch(x), splits=splits, name=name)
    return _to_np(out, x.dtype), recv.numpy()


def _to_tf(out):
    """numpy -> tf, keeping 0-d arrays 0-d (scalar variables assign)."""
    return _tf.convert_to_tensor(np.asarray(out))


def _is_symbolic(t) -> bool:
    """True inside a traced tf.function, where .numpy() is unavailable."""
    return isinstance(t, _tf.Tensor) and not hasattr(t, "numpy")


# ---------------------------------------------------------------------------
# the compiled custom op
# ---------------------------------------------------------------------------

OPS_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ops",
                       "hvd_tf_ops.cc")


def _ops_build_dir() -> str:
    from ..ops._build import BUILD_DIR
    return os.path.join(BUILD_DIR, "tf_ops")


def _ops_flags():
    return (list(_tf.sysconfig.get_compile_flags()),
            list(_tf.sysconfig.get_link_flags()))


def custom_ops_path() -> str:
    """Where the op library for this source and this TensorFlow goes:
    keyed by a hash of the source, the TensorFlow version and its
    flags."""
    import hashlib
    cflags, lflags = _ops_flags()
    h = hashlib.sha256()
    with open(OPS_SRC, "rb") as f:
        h.update(f.read())
    h.update(_tf.__version__.encode())
    h.update(" ".join(cflags + lflags).encode())
    return os.path.join(_ops_build_dir(),
                        f"hvd_tf_ops-{h.hexdigest()[:16]}.so")


def build_custom_ops() -> str:
    """The op library's path, built first unless it is current: g++ into
    a fresh directory under an ``fcntl`` lock, renamed into place, so
    concurrent workers build it once and nothing is written beside the
    source.  A failed build raises."""
    import fcntl
    import shutil
    import subprocess
    import tempfile
    out = custom_ops_path()
    if os.path.isfile(out):
        return out
    os.makedirs(_ops_build_dir(), exist_ok=True)
    with open(os.path.join(_ops_build_dir(), ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.isfile(out):
            return out
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found; the TF custom op is built "
                               "from tensorflow/ops/hvd_tf_ops.cc")
        cflags, lflags = _ops_flags()
        tmp = tempfile.mkdtemp(dir=_ops_build_dir())
        try:
            so = os.path.join(tmp, "hvd_tf_ops.so")
            proc = subprocess.run(
                [cxx, "-O2", "-fPIC", "-shared", "-o", so, OPS_SRC,
                 *cflags, *lflags, "-ldl"],
                capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"building the TF custom op failed (rc "
                                   f"{proc.returncode}):\n"
                                   f"{proc.stderr[-8000:]}")
            os.replace(so, out)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return out


_custom_ops: Any = None


def _load_custom_ops():
    """The compiled TF custom-op library: AsyncOpKernels that enqueue on
    the port's native runtime (GIL-free, SavedModel-serializable, usable
    under ``tf.function(input_signature=...)``).  It dlopens the runtime
    ``HVD_TPU_NATIVE_LIB`` names, set here to the port's own build, so
    in process it reaches the controller the Python side attached.
    Falls back to the py_function bridge, with a warning, when the build
    or the load fails."""
    global _custom_ops
    if _custom_ops is not None:
        return _custom_ops or None
    from ..native import _build as native_build
    from ..utils import logging as log
    try:
        so = build_custom_ops()
        os.environ["HVD_TPU_NATIVE_LIB"] = native_build.build()
        _custom_ops = _tf.load_op_library(so)
    except Exception as e:  # noqa: BLE001
        log.warning("TF custom-op bridge unavailable (%s); graph "
                    "collectives fall back to tf.py_function", e)
        _custom_ops = False
        return None
    return _custom_ops


_warned_py_function_fallback = False


def _note_py_function_fallback(tensor):
    """Log once when a graph collective lowers to py_function although the
    compiled op exists (an unsupported dtype, or a tensor the CPU-only
    kernels cannot serve)."""
    global _warned_py_function_fallback
    if _warned_py_function_fallback or _load_custom_ops() is None:
        return
    _warned_py_function_fallback = True
    from ..utils import logging as log
    dev = getattr(tensor, "device", "") or "<unplaced>"
    log.warning(
        "graph collective lowered to the tf.py_function bridge "
        "(dtype=%s, device=%s): the compiled custom op serves CPU-placed "
        "tensors of %d dtypes only. py_function is GIL-bound and not "
        "SavedModel-serializable.", tensor.dtype, dev,
        len(_CUSTOM_OP_DTYPES))


def _graph_bridge(np_fn, tensor, out_shape=None):
    """Run the numpy-bridged collective from graph mode when the compiled
    op cannot serve: ``tf.py_function`` calls back into the eager
    bridge."""
    from ..core.state import global_state
    if global_state.controller is not None:
        _note_py_function_fallback(tensor)
    out = _tf.py_function(lambda x: np_fn(x.numpy()), [tensor],
                          tensor.dtype)
    out.set_shape(tensor.shape if out_shape is None else out_shape)
    return out


_warned_trace_before_init = False

# The compiled ops' registered T attr; anything else (bool) stays on the
# py_function bridge.
_CUSTOM_OP_DTYPES = frozenset({
    _tf.uint8, _tf.int8, _tf.int32, _tf.int64, _tf.half, _tf.float32,
    _tf.float64, _tf.bfloat16})


def _native_graph_ready() -> bool:
    """Whether graph collectives lower to the compiled op, decided at
    tf.function trace time: trace after ``init()``, or the graph keeps the
    py_function bridge."""
    from ..core.state import global_state
    if global_state.controller is not None:
        return _load_custom_ops() is not None
    if not global_state.initialized:
        global _warned_trace_before_init
        if not _warned_trace_before_init:
            _warned_trace_before_init = True
            from ..utils import logging as log
            log.warning(
                "tf.function traced a collective before hvd.init(): the "
                "graph keeps the py_function bridge. Call hvd.init() "
                "before tracing to use the compiled op.")
    return False


def _allreduce_impl(t, op: int, name: Optional[str],
                    prescale_factor: float, postscale_factor: float):
    if _is_symbolic(t):
        if _native_graph_ready() and t.dtype in _CUSTOM_OP_DTYPES:
            return _load_custom_ops().hvd_tpu_torch_allreduce(
                t, op_code=int(op), prescale=prescale_factor,
                postscale=postscale_factor, tensor_name=name or "")
        return _graph_bridge(
            lambda x: _np_allreduce(x, op, name, prescale_factor,
                                    postscale_factor), t)
    return _to_tf(_np_allreduce(_np(t), op, name, prescale_factor,
                                postscale_factor))


def allreduce(tensor, op: int = Average, name: Optional[str] = None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              compression=None):
    """Allreduce; differentiable (the gradient is the same allreduce of
    the upstream gradient).  ``IndexedSlices`` go through the allgather
    path (reference tensorflow/__init__.py:92-108)."""
    if isinstance(tensor, _tf.IndexedSlices):
        nm = name or "slices"
        values = allgather(tensor.values, name=nm + ".values")
        indices = allgather(tensor.indices, name=nm + ".indices")
        if op == Average:
            values = values / _C.communicator_size()
        return _tf.IndexedSlices(values, indices,
                                 dense_shape=tensor.dense_shape)
    comp = compression or Compression.none
    t, ctx = comp.compress(tensor)

    @_tf.custom_gradient
    def _fn(x):
        y = _allreduce_impl(x, op, name, prescale_factor,
                            postscale_factor)

        def grad(dy):
            return _allreduce_impl(dy, op, None, prescale_factor,
                                   postscale_factor)
        return y, grad
    return comp.decompress(_fn(_tf.convert_to_tensor(t)), ctx)


def _allgather_impl(tensor, name: Optional[str]):
    if _is_symbolic(tensor):
        if _native_graph_ready() and tensor.dtype in _CUSTOM_OP_DTYPES:
            return _load_custom_ops().hvd_tpu_torch_allgather(
                tensor, tensor_name=name or "")
        return _graph_bridge(
            lambda x: _np_allgather(x, name), tensor,
            out_shape=_tf.TensorShape([None] + list(tensor.shape)[1:]))
    return _to_tf(_np_allgather(_np(tensor), name))


def allgather(tensor, name: Optional[str] = None):
    """Allgather along dim 0; differentiable (the gradient averages the
    upstream gradient across ranks and slices out this rank's rows)."""

    @_tf.custom_gradient
    def _fn(x):
        y = _allgather_impl(x, name)

        def grad(dy):
            g = _allreduce_impl(dy, Average, None, 1.0, 1.0)
            r = rank()
            if x.shape.rank == 0:
                return _tf.reshape(_tf.reshape(g, [-1])[r], [])
            d = _tf.reshape(_tf.shape(x, out_type=_tf.int64)[0], [1])
            dims = _allgather_impl(d, None)
            offset = _tf.reduce_sum(dims[:r]) if r > 0 \
                else _tf.constant(0, _tf.int64)
            return g[offset:offset + d[0]]
        return y, grad
    return _fn(_tf.convert_to_tensor(tensor))


def _broadcast_impl(tensor, root_rank: int, name: Optional[str]):
    if _is_symbolic(tensor):
        if _native_graph_ready() and tensor.dtype in _CUSTOM_OP_DTYPES:
            return _load_custom_ops().hvd_tpu_torch_broadcast(
                tensor, root_rank=root_rank, tensor_name=name or "")
        return _graph_bridge(
            lambda x: _np_broadcast(x, root_rank, name), tensor)
    return _to_tf(_np_broadcast(_np(tensor), root_rank, name))


def broadcast(tensor, root_rank: int = 0, name: Optional[str] = None):
    """Broadcast from the root; differentiable (the gradient is the
    averaged upstream gradient on the root, zero elsewhere)."""

    @_tf.custom_gradient
    def _fn(x):
        y = _broadcast_impl(x, root_rank, name)

        def grad(dy):
            g = _allreduce_impl(dy, Average, None, 1.0, 1.0)
            if rank() != root_rank:
                g = g * 0
            return g
        return y, grad
    return _fn(_tf.convert_to_tensor(tensor))


def _splits_tensor(splits):
    if splits is None:
        return _tf.constant([], dtype=_tf.int64)
    return _tf.cast(_tf.convert_to_tensor(splits), _tf.int64)


def _alltoall_impl(tensor, splits, name: Optional[str]):
    if _is_symbolic(tensor):
        if _native_graph_ready() and tensor.dtype in _CUSTOM_OP_DTYPES:
            return _load_custom_ops().hvd_tpu_torch_alltoall(
                tensor, _splits_tensor(splits), tensor_name=name or "")

        # The splits travel as an input (empty means None): a symbolic
        # splits tensor captured by a closure could not be read when the
        # py_function runs.
        def np_fn(x, s):
            sp = None if s.shape[0] == 0 else s.numpy().tolist()
            out, recv = _np_alltoall(x.numpy(), sp, name)
            return out, np.asarray(recv, dtype=np.int32)

        out, recv = _tf.py_function(np_fn, [tensor, _splits_tensor(splits)],
                                    [tensor.dtype, _tf.int32])
        out.set_shape(_tf.TensorShape([None] + list(tensor.shape)[1:]))
        recv.set_shape(_tf.TensorShape([None]))
        return out, recv
    out, recv_splits = _np_alltoall(_np(tensor), splits, name)
    return _to_tf(out), _to_tf(recv_splits)


def alltoall(tensor, splits=None, name: Optional[str] = None):
    """Alltoall with optional uneven splits; differentiable in the tensor
    (the gradient routes back with the received splits as the send
    splits)."""

    @_tf.custom_gradient
    def _fn(x):
        out, recv = _alltoall_impl(x, splits, name)

        def grad(dy, _dy_recv):
            back = recv if _is_symbolic(recv) else np.asarray(recv)
            g, _ = _alltoall_impl(dy, back, None)
            return g
        return (out, recv), grad
    return _fn(_tf.convert_to_tensor(tensor))


def join() -> int:
    return _C.join()


def barrier():
    _C.barrier()


def _query_op(kind: str, value, name):
    lib = _load_custom_ops()
    if lib is None:
        return _tf.constant(value(), dtype=_tf.int32, name=name)
    return getattr(lib, f"hvd_tpu_torch_{kind}")(name=name)


def size_op(name: Optional[str] = None):
    """The world size read from the live runtime when the graph runs
    (reference HorovodSize): an elastic graph bakes no traced size.  A
    constant without the compiled op library."""
    return _query_op("size", size, name)


def rank_op(name: Optional[str] = None):
    return _query_op("rank", rank, name)


def local_rank_op(name: Optional[str] = None):
    return _query_op("local_rank", local_rank, name)


def local_size_op(name: Optional[str] = None):
    return _query_op("local_size", local_size, name)


def broadcast_variables(variables: List, root_rank: int = 0):
    """Assign every variable the root's value."""
    for i, v in enumerate(variables):
        v.assign(broadcast(v, root_rank=root_rank, name=f"bv.{i}"))


def grouped_allreduce(tensors, op: int = Average,
                      name: Optional[str] = None):
    return [allreduce(t, op=op,
                      name=None if name is None else f"{name}.{i}")
            for i, t in enumerate(tensors)]


class DistributedGradientTape:
    """Wraps tf.GradientTape; gradient() allreduces the results (reference
    tensorflow/__init__.py:723-814)."""

    def __init__(self, tape: _tf.GradientTape, op: int = Average,
                 compression=None, sparse_as_dense: bool = False):
        self._tape = tape
        self._op = op
        self._compression = compression
        self._sparse_as_dense = sparse_as_dense

    def __enter__(self):
        self._tape.__enter__()
        return self

    def __exit__(self, *args):
        return self._tape.__exit__(*args)

    def __getattr__(self, item):
        return getattr(self.__dict__["_tape"], item)

    def gradient(self, target, sources, output_gradients=None):
        grads = self._tape.gradient(target, sources, output_gradients)
        out = []
        for i, g in enumerate(grads):
            if g is None:
                out.append(None)
                continue
            if isinstance(g, _tf.IndexedSlices) and self._sparse_as_dense:
                g = _tf.convert_to_tensor(g)
            out.append(allreduce(g, op=self._op, name=f"tape.grad.{i}",
                                 compression=self._compression))
        return out


class _LocalGradientAggregationHelper:
    """Accumulate gradients locally for N backward passes, communicating
    (and applying) only every Nth step (reference
    gradient_aggregation.py).  The state lives in ``tf.Variable``s and the
    every-Nth gate is a ``tf.cond``, so the logic survives ``tf.function``
    tracing."""

    def __init__(self, passes: int):
        self.passes = int(passes)
        self.counter = None
        self._acc: dict = {}

    def _init_state(self, gv):
        if self.counter is None:
            self.counter = _tf.Variable(
                0, trainable=False, dtype=_tf.int64,
                name="hvd_agg_counter")
        for i, (g, _v) in enumerate(gv):
            if g is not None and i not in self._acc:
                self._acc[i] = _tf.Variable(
                    _tf.zeros_like(g), trainable=False,
                    name=f"hvd_agg_{i}")

    def apply(self, super_apply, grads_and_vars, reduce_fn):
        gv = list(grads_and_vars)
        self._init_state(gv)
        for i, (g, _v) in enumerate(gv):
            if g is not None:
                self._acc[i].assign_add(_tf.convert_to_tensor(g))
        self.counter.assign_add(1)

        def _communicate_and_apply():
            reduced = []
            for i, (g, v) in enumerate(gv):
                if g is None:
                    reduced.append((None, v))
                    continue
                avg = self._acc[i] / _tf.cast(self.passes, g.dtype)
                reduced.append((reduce_fn(avg, i), v))
            super_apply(reduced)
            for i, (g, _v) in enumerate(gv):
                if g is not None:
                    self._acc[i].assign(_tf.zeros_like(self._acc[i]))
            return _tf.constant(True)

        return _tf.cond(
            _tf.equal(self.counter % self.passes, 0),
            _communicate_and_apply,
            lambda: _tf.constant(False))


def _make_adasum_delta_optimizer(optimizer, compression):
    """Adasum's delta model (reference tensorflow/__init__.py:502-596):
    each apply_gradients snapshots the weights, runs the local step, and
    moves every weight from where it started by the Adasum of the ranks'
    deltas."""

    class _AdasumWrapped(optimizer.__class__):
        def apply_gradients(self_, grads_and_vars, *args, **kwargs):
            gv = [(g, v) for g, v in grads_and_vars if g is not None]
            starts = [_tf.identity(v) for _g, v in gv]
            result = super(_AdasumWrapped, self_).apply_gradients(
                gv, *args, **kwargs)
            comp = compression or Compression.none
            for i, ((_g, v), w0) in enumerate(zip(gv, starts)):
                d, ctx = comp.compress(v - w0)
                d = allreduce(d, op=Adasum, name=f"adasum.delta.{i}")
                v.assign(w0 + comp.decompress(d, ctx))
            return result

    return _AdasumWrapped.from_config(optimizer.get_config())


def DistributedOptimizer(optimizer, op: int = Average, compression=None,
                         backward_passes_per_step: int = 1,
                         name: Optional[str] = None):
    """Wrap a keras optimizer: apply_gradients allreduces first.  With
    ``backward_passes_per_step`` > 1 the gradients accumulate locally and
    communication and the update happen every Nth call.  ``op=Adasum``
    takes the delta model."""
    if op == Adasum:
        if backward_passes_per_step != 1:
            raise ValueError(
                "Adasum does not compose with backward_passes_per_step > 1 "
                "(reference restriction)")
        if compression is not None and compression is not Compression.none:
            raise ValueError(
                "Adasum requires fp32/fp64 deltas; wire compression is "
                "not supported")
        return _make_adasum_delta_optimizer(optimizer, None)

    class _Wrapped(optimizer.__class__):
        _hvd_agg = (_LocalGradientAggregationHelper(backward_passes_per_step)
                    if backward_passes_per_step > 1 else None)

        def apply_gradients(self_, grads_and_vars, *args, **kwargs):
            def _reduce(g, i):
                return allreduce(g, op=op, name=f"opt.grad.{i}",
                                 compression=compression)

            def _super_apply(reduced):
                return super(_Wrapped, self_).apply_gradients(
                    reduced, *args, **kwargs)

            gv = list(grads_and_vars)
            if self_._hvd_agg is not None:
                return self_._hvd_agg.apply(_super_apply, gv, _reduce)
            return _super_apply(
                [(None if g is None else _reduce(g, i), v)
                 for i, (g, v) in enumerate(gv)])

    return _Wrapped.from_config(optimizer.get_config())


class SyncBatchNormalization(_tf.keras.layers.BatchNormalization):
    """Batch normalization with the moments averaged over the ranks
    (reference tensorflow/sync_batch_norm.py).  The reference hooks Keras
    2's ``_calculate_mean_and_var``; Keras 3 computes the moments in
    ``_moments``, which the port hooks as well."""

    def _sync(self, mean, var):
        if size() > 1:
            mean_sq = var + _tf.square(mean)
            mean = allreduce(mean, op=Average, name=self.name + ".mean")
            mean_sq = allreduce(mean_sq, op=Average,
                                name=self.name + ".meansq")
            var = mean_sq - _tf.square(mean)
        return mean, var

    def _calculate_mean_and_var(self, x, axes, keep_dims):
        mean, var = super()._calculate_mean_and_var(x, axes, keep_dims)
        return self._sync(mean, var)

    def _moments(self, inputs, mask):
        mean, var = super()._moments(inputs, mask)
        return self._sync(mean, var)


from . import elastic  # noqa: E402,F401  (hvd.elastic.TensorFlowState etc.)
