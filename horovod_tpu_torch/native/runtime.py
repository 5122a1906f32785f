"""Attach the native (C++) runtime (port of horovod_tpu/native/runtime.py).

The reference's ``attach`` returns None when the runtime cannot be built
or reached, so its jobs carry on without negotiation.  The port's raises
instead: a controller that was asked for and is missing would leave ranks
issuing collectives in different orders with nothing to line them up.
"""

from __future__ import annotations

from typing import Optional


def attach(rank: Optional[int] = None, size: Optional[int] = None,
           coord_addr: Optional[str] = None, local_size: int = 1):
    """The native controller for this process: of ``coord_addr`` when
    given, else of ``HVD_TPU_CONTROLLER_ADDR`` (``NativeController.
    from_env``).  Raises when the runtime cannot be built, reached or
    initialized."""
    from .controller import NativeController
    if coord_addr is not None:
        return NativeController(0 if rank is None else rank,
                                1 if size is None else size, coord_addr,
                                local_size=local_size)
    return NativeController.from_env(rank, size, local_size=local_size)
