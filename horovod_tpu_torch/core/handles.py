"""Async handle management (port of horovod_tpu/core/handles.py).

Analog of the reference's Torch ``HandleManager`` (torch/handle_manager.cc:60,
torch/mpi_ops.py:843-882): ``*_async`` ops return an integer handle;
``poll(handle)`` checks completion; ``synchronize(handle)`` blocks and returns
the result.  In the port a handle wraps a ``torch.distributed`` ``Work``
issued with ``async_op=True`` (its poll is ``Work.is_completed()``), or the
finished result of a call that ran synchronously.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional


class Handle:
    """One in-flight eager op.  ``poll_fn`` answers "has the op completed?"
    without finalizing it; ``wait_fn`` blocks, finalizes (releases native
    resources) and returns the result — it runs exactly once even if poll
    already reported completion."""

    __slots__ = ("_result", "_error", "_finalized", "_poll_fn", "_wait_fn")

    def __init__(self,
                 result: Any = None,
                 poll_fn: Optional[Callable[[], bool]] = None,
                 wait_fn: Optional[Callable[[], Any]] = None):
        self._result = result
        self._error: Optional[BaseException] = None
        self._finalized = wait_fn is None
        self._poll_fn = poll_fn
        self._wait_fn = wait_fn

    def poll(self) -> bool:
        if self._finalized:
            return True
        if self._poll_fn is None:
            return True
        return bool(self._poll_fn())

    def wait(self) -> Any:
        if not self._finalized:
            try:
                self._result = self._wait_fn()
            except Exception as e:  # surfaced on this and later waits
                self._error = e
            # KeyboardInterrupt/SystemExit propagate un-finalized: the op is
            # still pending and a later wait must retry (and release native
            # resources) rather than replay a stale interrupt.
            self._finalized = True
        if self._error is not None:
            raise self._error
        return self._result


class HandleManager:
    def __init__(self):
        self._lock = threading.Lock()
        self._next = 0
        self._handles: Dict[int, Handle] = {}

    def allocate(self, handle: Handle) -> int:
        with self._lock:
            hid = self._next
            self._next += 1
            self._handles[hid] = handle
            return hid

    def get(self, hid: int) -> Handle:
        with self._lock:
            if hid not in self._handles:
                raise ValueError(f"unknown handle {hid}")
            return self._handles[hid]

    def poll(self, hid: int) -> bool:
        return self.get(hid).poll()

    def synchronize(self, hid: int) -> Any:
        handle = self.get(hid)
        result = handle.wait()
        with self._lock:
            self._handles.pop(hid, None)
        return result


handle_manager = HandleManager()
