"""``hvd.debug`` — post-mortem observability (port of
horovod_tpu/debug/__init__.py): the flight recorder.

* :mod:`~horovod_tpu_torch.debug.flight` — per-rank ring buffer of
  structured events from every subsystem that can block a step; dump via
  :func:`dump` or SIGUSR1.

The rest of the reference's surface — the ``/debug/*`` HTTP endpoint
(``serve``, ``serve_and_publish``), the hang watchdog
(``start_stall_watchdog``), the fleet trace merge and the drift-triggered
regression report — comes with ROADMAP queue 1 item 9b; those entry
points raise until then.  ``estimate_clock_offset`` aligns the recorder's
clock against the rendezvous KV server's.
"""

from . import flight
from .flight import (FlightRecorder, dump, estimate_clock_offset,
                     install_signal_handler, record, recorder, set_enabled,
                     snapshot)

_ITEM_9B = ("comes with debug/http.py, hang.py and regression.py "
            "(ROADMAP queue 1 item 9b)")


def serve(port: int = 0, host: str = "0.0.0.0"):
    """The per-rank debug HTTP endpoint (item 9b)."""
    raise NotImplementedError(f"debug.serve {_ITEM_9B}")


def serve_and_publish(rank=None, rdv_addr=None, port: int = 0):
    """The debug endpoint, published to the rendezvous KV (item 9b)."""
    raise NotImplementedError(f"debug.serve_and_publish {_ITEM_9B}")


def stop_serving():
    """No debug endpoint runs before item 9b: nothing to stop."""


def start_stall_watchdog(controller, **kwargs):
    """The coordinator's hang-escalation watchdog (item 9b)."""
    raise NotImplementedError(f"debug.start_stall_watchdog {_ITEM_9B}")


def stop_stall_watchdog():
    """No watchdog runs before item 9b: nothing to stop."""


def last_regression_report():
    """The most recent drift-triggered regression report (item 9b)."""
    raise NotImplementedError(f"debug.last_regression_report {_ITEM_9B}")


def build_regression_report(event, **kwargs):
    """A regression report for a DriftEvent (item 9b)."""
    raise NotImplementedError(f"debug.build_regression_report {_ITEM_9B}")


__all__ = [
    "flight", "FlightRecorder", "record", "recorder", "snapshot", "dump",
    "set_enabled", "install_signal_handler", "estimate_clock_offset",
    "serve", "serve_and_publish", "stop_serving",
    "start_stall_watchdog", "stop_stall_watchdog",
    "last_regression_report", "build_regression_report",
]
