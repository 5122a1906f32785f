"""Background prefetch: overlap host batch prep + the copy to the device
with the step (port of horovod_tpu/data/prefetch.py).

A daemon producer thread drives the underlying batch iterator through a
bounded queue; the training thread pops ready batches.  With a transfer
function applied *in the producer* (the loader's copy to the card on a
side CUDA stream), the copy of batch *i+1* runs while batch *i*'s step
executes — a queue depth of 2 gives the classic double buffering.  A
``finish`` function runs in the consumer on each batch it hands out (the
loader's: make the current stream wait for the batch's copy).

Every blocking wait of the consumer is a ``utils.profiler.data_wait``
span, which feeds the ``hvd_data_wait_*`` metrics the step attribution
reads as its ``input`` component; a stall warning counts in
``hvd_data_stall_warnings_total``; waits, stalls and a dead producer are
flight events.  ``HVD_TPU_CHAOS_INPUT_DELAY_MS`` slows every batch by a
fixed host latency: the input-regression drill of the drift diagnosis
(``debug/regression.py``).

Correctness properties the tests pin down:

* **Exception propagation** — a producer crash re-raises in the
  consumer, never a silent hang.
* **Stall detection** — the consumer logs a warning after the stall
  warning window and, when a hard timeout is configured, raises
  :class:`~horovod_tpu_torch.core.exceptions.DataStallError` instead of
  blocking forever.
* **Clean shutdown** — ``close()`` wakes a blocked producer, joins the
  thread, and is idempotent.
* **Consumer-accurate state** — each queued batch carries the sampler
  snapshot taken right after it was drawn, so ``consumer_state()``
  reflects what the *training thread* has consumed, not how far ahead
  the producer ran.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Callable, Iterator, Optional

from ..core.exceptions import DataStallError
from ..debug import flight as _flight
from ..utils import profiler

_log = logging.getLogger(__name__)

_BATCH = "batch"
_END = "end"
_ERROR = "error"


def _chaos_input_delay_s() -> float:
    """Deterministic input-pipeline slowdown injection
    (``HVD_TPU_CHAOS_INPUT_DELAY_MS``, read at iterator construction): every
    batch pays this extra host latency in the producer (prefetch) or inside
    the wait span (inline), so that the drift detector sees an input
    regression (reference data/prefetch.py:46-55)."""
    from ..core import config
    return max(0.0, config.get_float(config.CHAOS_INPUT_DELAY_MS, 0.0)) / 1e3


class InlineIterator:
    """The prefetch-off twin: same interface, no thread.

    Pulls batches synchronously, applies the same transfer and finish
    functions and records the same consumer-position state snapshots, so
    ``DataLoader`` (and its checkpoint/restore path) is agnostic to
    whether prefetch is on.
    """

    def __init__(self, it: Iterator[Any],
                 transfer: Optional[Callable[[Any], Any]] = None,
                 state_fn: Optional[Callable[[], Any]] = None,
                 finish: Optional[Callable[[Any], Any]] = None):
        self._it = it
        self._transfer = transfer
        self._finish = finish
        self._state_fn = state_fn
        self._last_state: Any = None
        self._finished = False
        self._closed = False
        self._chaos_delay_s = _chaos_input_delay_s()
        if self._chaos_delay_s:
            _flight.record("data.chaos_delay", "inline",
                           delay_ms=self._chaos_delay_s * 1e3)

    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        if self._closed:
            # A stale iterator must not keep consuming the shared
            # sampler after the loader closed/rewound it — that would
            # silently drop the batches it steals (the prefetch twin
            # refuses identically).
            raise RuntimeError("inline data iterator is closed")
        # The span covers the whole host cost of the batch: what an
        # unpipelined step pays.
        with profiler.data_wait():
            if self._chaos_delay_s:
                time.sleep(self._chaos_delay_s)
            try:
                item = next(self._it)
            except StopIteration:
                # Natural exhaustion advanced the epoch inside the
                # generator — capture the post-advance state (the
                # prefetch path's _END message), or the loader's close()
                # rewind would undo the epoch change.
                if self._state_fn is not None:
                    self._last_state = self._state_fn()
                self._finished = True
                raise
            state = self._state_fn() if self._state_fn is not None \
                else None
            if self._transfer is not None:
                item = self._transfer(item)
        if self._finish is not None:
            item = self._finish(item)
        self._last_state = state
        return item

    def consumer_state(self) -> Any:
        return self._last_state

    def close(self) -> None:
        self._closed = True


class PrefetchIterator:
    """Bounded-queue background prefetch over a batch iterator."""

    def __init__(self, it: Iterator[Any], *, depth: int = 2,
                 transfer: Optional[Callable[[Any], Any]] = None,
                 state_fn: Optional[Callable[[], Any]] = None,
                 finish: Optional[Callable[[Any], Any]] = None,
                 stall_warning_s: float = 60.0,
                 stall_timeout_s: float = 0.0,
                 name: str = "prefetch"):
        if depth < 1:
            raise ValueError(f"queue depth must be >= 1, got {depth}")
        self._it = it
        self._transfer = transfer
        self._finish = finish
        self._state_fn = state_fn
        self._stall_warning_s = float(stall_warning_s)
        self._stall_timeout_s = float(stall_timeout_s)
        self._name = name
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._closed = False
        self._finished = False
        self._last_state: Any = None
        self.max_queued = 0  # high-water mark, for overlap diagnostics
        self._chaos_delay_s = _chaos_input_delay_s()
        if self._chaos_delay_s:
            _flight.record("data.chaos_delay", name,
                           delay_ms=self._chaos_delay_s * 1e3)
        self._thread = threading.Thread(
            target=self._produce, name=f"hvd-tpu-{name}", daemon=True)
        self._thread.start()

    # -- producer (background thread) --------------------------------------
    def _put(self, item) -> bool:
        """Enqueue, waking up for close(); False when asked to stop."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                self.max_queued = max(self.max_queued, self._q.qsize())
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        try:
            for item in self._it:
                if self._chaos_delay_s:
                    time.sleep(self._chaos_delay_s)
                state = self._state_fn() \
                    if self._state_fn is not None else None
                if self._transfer is not None:
                    item = self._transfer(item)
                if not self._put((_BATCH, item, state)):
                    return
            state = self._state_fn() if self._state_fn is not None else None
            self._put((_END, None, state))
        except BaseException as exc:  # noqa: BLE001 — relayed to consumer
            self._put((_ERROR, exc, None))

    # -- consumer (training thread) ----------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        if self._closed:
            raise RuntimeError(f"{self._name}: iterator is closed")
        waited = 0.0
        warned = False
        with profiler.data_wait():
            while True:
                try:
                    kind, payload, state = self._q.get(timeout=0.5)
                    break
                except queue.Empty:
                    waited += 0.5
                    if not self._thread.is_alive() and self._q.empty():
                        # Producer died without posting an END/ERROR —
                        # only possible if it was killed abruptly.
                        _flight.record("data.producer_dead", self._name,
                                       waited_s=waited)
                        self.close()
                        raise DataStallError(
                            f"{self._name}: producer thread died without "
                            "reporting a result")
                    if not warned and self._stall_warning_s > 0 \
                            and waited >= self._stall_warning_s:
                        warned = True
                        _log.warning(
                            "%s: input pipeline stalled — no batch for "
                            "%.0fs (source blocked or filesystem slow?)",
                            self._name, waited)
                        _flight.record("data.stall_warning", self._name,
                                       waited_s=waited)
                        from ..metrics.registry import registry
                        registry().counter(
                            "hvd_data_stall_warnings_total",
                            "Input-pipeline stall warnings").inc()
                    if 0 < self._stall_timeout_s <= waited:
                        _flight.record("data.stall_timeout", self._name,
                                       waited_s=waited)
                        self.close()
                        raise DataStallError(
                            f"{self._name}: no batch within the "
                            f"{self._stall_timeout_s:.0f}s stall window")
        if waited:
            # Slow path only (the queue stayed empty for a 0.5 s poll):
            # a run of data.wait events names an input-bound rank.
            _flight.record("data.wait", self._name, waited_s=waited)
        if kind == _ERROR:
            self.close()
            raise payload
        if kind == _END:
            self._last_state = state
            self._finished = True
            self.close()
            raise StopIteration
        if self._finish is not None:
            payload = self._finish(payload)
        self._last_state = state
        return payload

    def consumer_state(self) -> Any:
        """Sampler snapshot for the last batch the CONSUMER received —
        the checkpoint-correct position even while the producer has run
        several batches ahead."""
        return self._last_state

    # -- lifecycle ----------------------------------------------------------
    def close(self, join_timeout_s: float = 5.0) -> None:
        """Stop the producer and join its thread.  Idempotent; after it
        returns no live producer thread remains."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        # Drain so a producer blocked on put() observes the stop event.
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        if self._thread.is_alive():
            self._thread.join(timeout=join_timeout_s)
            if self._thread.is_alive():
                _log.warning("%s: producer thread did not exit within "
                             "%.0fs of close()", self._name, join_timeout_s)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close(join_timeout_s=0.5)
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
