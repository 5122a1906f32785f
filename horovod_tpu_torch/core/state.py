"""Global runtime state (the port's counterpart of horovod_tpu/core/state.py).

The reference's state owns a JAX mesh; the port's owns the process-level
topology (rank/size/local/cross, reference common.h:119-123), the device
this process computes on, and whether ``init()`` created the
``torch.distributed`` process group (and so must destroy it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class GlobalState:
    initialized: bool = False
    rank: int = 0
    size: int = 1
    local_rank: int = 0
    local_size: int = 1
    cross_rank: int = 0
    cross_size: int = 1
    device: Optional[torch.device] = None
    owns_process_group: bool = False

    def reset(self) -> None:
        self.__init__()


global_state = GlobalState()
