"""``hvd.debug`` — post-mortem observability (port of
horovod_tpu/debug/__init__.py): flight recorder, distributed hang
diagnosis, fleet-merged traces and drift-triggered regression reports.

The diagnosis half of observability (``hvd.metrics`` is the live half):

* :mod:`~horovod_tpu_torch.debug.flight` — per-rank ring buffer of
  structured events from every subsystem that can block a step; dump via
  :func:`dump`, SIGUSR1, or ``GET /debug/flight``.
* :mod:`~horovod_tpu_torch.debug.http` — ``/debug/flight``,
  ``/debug/regression``, ``/debug/stacks``, ``/debug/fleet_scalars``
  and ``/healthz`` on the shared BackgroundHTTPServer scaffold (also
  mounted on the metrics server when one is running).
* :mod:`~horovod_tpu_torch.debug.hang` — coordinator watchdog that
  escalates a native stall-inspector warning into
  ``hang_report_<step>.json`` naming the stuck collective, the missing
  ranks, and each missing rank's last flight events with an
  input/compute/checkpoint-bound attribution.
* :mod:`~horovod_tpu_torch.debug.merge` — ``python -m
  horovod_tpu_torch.debug.merge`` merges per-rank dumps (+ the native
  Chrome timeline) into one clock-aligned trace with a process row per
  rank.
* :mod:`~horovod_tpu_torch.debug.regression` — drift-triggered
  regression diagnosis: when the metrics plane's drift detector confirms
  a sustained step-time regression, ``perf_regression_step<N>.json``
  correlates the onset against the flight-recorded causal event stream
  and names the suspect subsystem.  Read the latest via
  :func:`last_regression_report`.
"""

from . import flight
from .flight import (FlightRecorder, dump, estimate_clock_offset,
                     install_signal_handler, record, recorder, set_enabled,
                     snapshot)


def serve(port: int = 0, host: str = "0.0.0.0"):
    """Start the per-rank debug HTTP endpoint (idempotent)."""
    from . import http as _http
    return _http.serve(port=port, host=host)


def serve_and_publish(rank=None, rdv_addr=None, port: int = 0):
    """Start the debug endpoint and publish its address to the
    rendezvous KV for the coordinator's hang watchdog."""
    from . import http as _http
    return _http.serve_and_publish(rank=rank, rdv_addr=rdv_addr, port=port)


def stop_serving():
    from . import http as _http
    _http.stop_serving()


def start_stall_watchdog(controller, **kwargs):
    """Start the coordinator-side hang-escalation watchdog."""
    from . import hang as _hang
    return _hang.start_stall_watchdog(controller, **kwargs)


def stop_stall_watchdog():
    from . import hang as _hang
    _hang.stop_stall_watchdog()


def last_regression_report():
    """The most recent drift-triggered regression report (None before
    the first confirmed drift)."""
    from . import regression as _regression
    return _regression.last_report()


def build_regression_report(event, **kwargs):
    """Assemble a regression report for a DriftEvent (normally invoked
    by the drift detector; exposed for tooling and tests)."""
    from . import regression as _regression
    return _regression.build_regression_report(event, **kwargs)


__all__ = [
    "flight", "FlightRecorder", "record", "recorder", "snapshot", "dump",
    "set_enabled", "install_signal_handler", "estimate_clock_offset",
    "serve", "serve_and_publish", "stop_serving",
    "start_stall_watchdog", "stop_stall_watchdog",
    "last_regression_report", "build_regression_report",
]
