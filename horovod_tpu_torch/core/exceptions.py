"""Framework exceptions (the port's own copy of horovod_tpu/core/exceptions.py).

Capability parity with the reference's ``horovod/common/exceptions.py:18-32``:
``HorovodInternalError`` aborts the current training iteration and triggers an
elastic restore; ``HostsUpdatedInterrupt`` re-runs rendezvous without restoring
state (the host set changed but no worker failed).
"""


class HorovodTpuError(Exception):
    """Base class for all framework errors."""


class HorovodInternalError(HorovodTpuError):
    """Internal error requiring a reset of the collective runtime."""


class HostsUpdatedInterrupt(HorovodTpuError):
    """The set of hosts changed; re-rendezvous without restoring state.

    ``skip_sync`` mirrors the reference: when True the rejoining workers do
    not need a state broadcast because no state was lost.
    """

    def __init__(self, skip_sync: bool = False):
        super().__init__()
        self.skip_sync = skip_sync


class NotInitializedError(HorovodTpuError):
    """An API that requires ``init()`` was called before initialization."""

    def __init__(self, what: str = "operation"):
        super().__init__(
            f"{what} called before horovod_tpu_torch.init(); call init() "
            "first")


class DuplicateNameError(HorovodTpuError):
    """Two in-flight eager collectives used the same tensor name.

    Mirrors the reference's DUPLICATE_NAME_ERROR (common.h:169).
    """


class DataStallError(HorovodTpuError):
    """The input pipeline produced no batch within the stall window.

    The data-plane analog of the coordinator's stall inspector
    (stall_inspector.h): a warning is logged after the warning window,
    and when ``HVD_TPU_DATA_STALL_TIMEOUT_SECONDS`` > 0 the consumer
    raises this error instead of blocking forever on a wedged producer
    (dead filesystem, livelocked source, crashed loader thread).
    """
