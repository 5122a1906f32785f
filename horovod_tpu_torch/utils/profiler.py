"""Profiler trace ranges on the GPU (port of horovod_tpu/utils/profiler.py).

Upstream Horovod wraps every enqueued collective in an NVTX range so
Nsight shows per-op spans (nvtx_op_range.h, operations.cc:1018-1033),
switched off by ``HOROVOD_DISABLE_NVTX_RANGES``.  The reference, on the
TPU, used ``jax.profiler.TraceAnnotation``; the port goes back to NVTX,
and adds a ``torch.profiler.record_function`` so the same span lands in a
``torch.profiler`` trace beside the kernels it launched:

* ``op_range(name, payload_bytes=…)`` — context manager for one
  collective: an NVTX range once CUDA is initialised, and a
  ``record_function`` while a ``torch.profiler`` profile is recording.
* ``start_trace(logdir)`` / ``stop_trace()`` — programmatic capture: a
  ``torch.profiler.profile`` of the CPU and (when there is one) CUDA
  activities; stopping writes a Chrome trace into ``logdir`` and returns
  its path.  ``torch.profiler`` records one profile at a time, so these
  do not nest inside another profile.
* ``data_wait`` / ``data_wait_stats`` — the input pipeline's blocking
  waits, timed into the ``hvd_data_wait_*`` metrics.

Disable knob: ``HVD_TPU_DISABLE_TRACE_RANGES=1`` (upstream's
``HOROVOD_DISABLE_NVTX_RANGES``, common.h:96).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Optional

import torch


def _enabled() -> bool:
    return os.environ.get("HVD_TPU_DISABLE_TRACE_RANGES", "") != "1" and \
        os.environ.get("HOROVOD_DISABLE_NVTX_RANGES", "") != "1"


def _recording() -> bool:
    """Whether a ``torch.profiler`` profile is recording on this
    thread's process (``record_function`` is only worth its dispatcher
    call then)."""
    return torch.autograd.profiler._is_profiler_enabled


@contextlib.contextmanager
def op_range(name: str, payload_bytes: Optional[int] = None):
    """Annotate one collective on the profiler timeline.  Cheap when
    ranges are disabled, CUDA is not initialised and nothing records.

    Only the annotation's setup is guarded: exceptions raised by the
    wrapped block propagate untouched."""
    if not _enabled():
        yield
        return
    label = name if payload_bytes is None else \
        f"{name}#bytes={payload_bytes}"
    nvtx = torch.cuda.is_initialized()
    rf = torch.profiler.record_function(label) if _recording() else None
    if nvtx:
        torch.cuda.nvtx.range_push(label)
    try:
        if rf is None:
            yield
        else:
            with rf:
                yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class _WaitSpan:
    """Filled in when the ``data_wait`` block exits."""

    seconds: float = 0.0


_dw_metrics = None
_dw_lock = threading.Lock()


def _data_wait_metrics():
    """The registry-backed storage of the data-wait stats, so the
    cross-rank aggregation and the Prometheus surface see the numbers
    ``data_wait_stats()`` reports."""
    global _dw_metrics
    if _dw_metrics is None:
        with _dw_lock:
            if _dw_metrics is None:
                from ..metrics.registry import (DEFAULT_TIME_BUCKETS,
                                                registry)
                reg = registry()
                _dw_metrics = (
                    reg.counter("hvd_data_wait_seconds_total",
                                "Cumulative input-pipeline wait"),
                    reg.counter("hvd_data_wait_spans_total",
                                "Number of input-pipeline wait spans"),
                    reg.gauge("hvd_data_wait_last_seconds",
                              "Most recent input-pipeline wait"),
                    reg.histogram("hvd_data_wait_seconds",
                                  "Input-pipeline wait per span",
                                  buckets=DEFAULT_TIME_BUCKETS),
                )
    return _dw_metrics


@contextlib.contextmanager
def data_wait(name: str = "data_wait"):
    """Annotate and time one step's blocking wait on the input pipeline.

    The span shows on the profiler timeline (as ``op_range``), so an
    input-bound step is distinct from a compute-bound one, and its
    duration feeds the ``hvd_data_wait_*`` metrics that
    ``data_wait_stats()`` reports and the step attribution reads.  Yields
    a :class:`_WaitSpan` whose ``seconds`` is set on exit."""
    span = _WaitSpan()
    t0 = time.perf_counter()
    try:
        with op_range(name):
            yield span
    finally:
        span.seconds = time.perf_counter() - t0
        total, count, last, hist = _data_wait_metrics()
        total.inc(span.seconds)
        count.inc()
        last.set(span.seconds)
        hist.observe(span.seconds)


def data_wait_stats() -> dict:
    """Cumulative data-wait spans: count / total_s / last_s (+ mean_s),
    read from the ``hvd_data_wait_*`` metrics; reset with
    :func:`reset_data_wait_stats`."""
    total, count, last, _hist = _data_wait_metrics()
    out = {"count": int(count.value), "total_s": total.value,
           "last_s": last.value}
    out["mean_s"] = out["total_s"] / out["count"] if out["count"] else 0.0
    return out


def reset_data_wait_stats() -> None:
    for metric in _data_wait_metrics():
        metric.reset()


_trace: Optional[tuple] = None
_trace_lock = threading.Lock()


def start_trace(logdir: str) -> None:
    """Begin a ``torch.profiler`` capture of the CPU and CUDA activities,
    written into ``logdir`` by :func:`stop_trace`."""
    global _trace
    with _trace_lock:
        if _trace is not None:
            raise RuntimeError("a trace is already being captured "
                               "(stop_trace first)")
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        _trace = (prof, logdir)


def stop_trace() -> Optional[str]:
    """End the capture and write its Chrome trace,
    ``<logdir>/trace_<pid>_<ns>.json``; returns that path (None when no
    capture was running)."""
    global _trace
    with _trace_lock:
        if _trace is None:
            return None
        prof, logdir = _trace
        _trace = None
    prof.__exit__(None, None, None)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace for the duration of the block."""
    start_trace(logdir)
    try:
        yield
    finally:
        stop_trace()
