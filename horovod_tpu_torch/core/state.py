"""Global runtime state (the port's counterpart of horovod_tpu/core/state.py).

The reference's state owns a JAX mesh; the port's owns the process-level
topology (rank/size/local/cross, reference common.h:119-123), the process
groups of the two-level (local, cross) topology, the device this process
computes on, the ``DeviceMesh`` (built on first use of ``mesh()``) and the
axis hint ``init()`` took for it, the session wire and schedule knobs
``init()`` read, the native controller ``init()`` attached with the process
group of its device executor, whether ``init()`` created the
``torch.distributed`` process group (and so must destroy it), and the
elastic bookkeeping: whether the driver spawned this worker and the
rendezvous round its world belongs to.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from . import config as _cfg


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
    # Whether every rank sits at cross_rank × local_size + local_rank of
    # one cross_size × local_size grid (agreed by all ranks in init()), and
    # this rank's groups of that grid; None unless local_size > 1 and
    # cross_size > 1.
    two_level: bool = False
    local_group: Any = None
    cross_group: Any = None
    compression: str = "none"   # HVD_TPU_COMPRESSION, normalized
    quant_block: int = _cfg.DEFAULT_QUANT_BLOCK  # HVD_TPU_QUANT_BLOCK
    # HVD_TPU_HIERARCHICAL_ALLREDUCE / _ALLGATHER: the values and the pins
    # (None = knob unset) that choose_schedule reads.
    hierarchical_allreduce: bool = False
    hierarchical_allgather: bool = False
    hierarchical_allreduce_pin: Optional[bool] = None
    hierarchical_allgather_pin: Optional[bool] = None
    mesh: Any = None            # torch DeviceMesh; built lazily by mesh()
    # The native controller of the eager negotiated plane (None = not
    # attached) and the process group its device executor alone runs on.
    controller: Any = None
    controller_group: Any = None
    mesh_axes_hint: Optional[tuple] = None
    # HVD_TPU_METRICS_SYNC_STEPS as init() read it (0 = never sync), and
    # HVD_TPU_METRICS_TREE (the host-sharded sync through the observers).
    metrics_sync_steps: int = 0
    metrics_tree: bool = False
    # Elastic bookkeeping (HVD_TPU_ELASTIC). elastic_round survives
    # reset() so a re-init can demand a *newer* rendezvous round than the
    # one that just failed (so does the topology above).
    elastic_enabled: bool = False
    elastic_round: int = -1

    def reset(self) -> None:
        """Forget the world, keeping what outlives it: the elastic round
        (a re-init demands a newer one) and the last world's topology,
        which the reference's reset keeps too (a worker's main reads its
        rank after the user's function shut its world down,
        spark/elastic_exec.py).  ``rank()`` and the other queries still
        refuse to answer until the next ``init()``."""
        keep = {k: getattr(self, k) for k in _KEPT_BY_RESET}
        self.__init__()
        self.__dict__.update(keep)


_KEPT_BY_RESET = ("elastic_round", "rank", "size", "local_rank",
                  "local_size", "cross_rank", "cross_size")


global_state = GlobalState()
