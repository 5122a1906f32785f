"""Bridge to the native wire fabric's escalation-ladder counters (port of
horovod_tpu/net/native.py).

The C side (``native/src/net.cc``) counts retries, reconnects,
renegotiations and resets avoided as it climbs the ladder;
``NativeController.net_counters`` reads them and this module folds them
into the metrics registry (``hvd_net_*_total{plane="native"}``) and the
flight recorder (``net.reconnect``, ``net.renegotiate``,
``net.recovery``), and gives :func:`status`'s verdict: "retrying,
deadline not yet reached" against no recent recovery.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

_FIELDS = ("retries", "reconnects", "renegotiations", "resets_avoided",
           "chaos_injected", "recovering_now", "last_recovery_age_ms")

# How recent native recovery activity must be (ms) for status() to call
# the fabric "retrying" rather than idle.
RECENT_RECOVERY_MS = 30000.0

_sync_lock = threading.Lock()
_last_synced: Dict[str, int] = {}


def native_counters() -> Optional[Dict[str, int]]:
    """The native ladder's counters, or None when no native controller is
    attached."""
    from ..core.state import global_state
    ctl = getattr(global_state, "controller", None)
    if ctl is None or not hasattr(ctl, "net_counters"):
        return None
    try:
        return ctl.net_counters()
    except Exception:  # noqa: BLE001 — observability never kills training
        return None


def sync_native_metrics() -> Optional[Dict[str, int]]:
    """Fold the native counters into the registry (the delta since the
    last sync) and record flight events for new reconnects and
    renegotiations; returns the counters."""
    counters = native_counters()
    if counters is None:
        return None
    from ..debug import flight as _flight
    from ..metrics.registry import registry as _registry
    reg = _registry()
    with _sync_lock:
        ladder_new: Dict[str, int] = {}
        for field, metric in (
                ("retries", "hvd_net_retries_total"),
                ("reconnects", "hvd_net_reconnects_total"),
                ("renegotiations", "hvd_net_renegotiations_total"),
                ("resets_avoided", "hvd_net_resets_avoided_total"),
                ("chaos_injected", "hvd_net_chaos_injected_total")):
            cur = int(counters.get(field, 0))
            prev = _last_synced.get(field, 0)
            if cur > prev:
                reg.counter(metric,
                            "Wire-fabric recovery counters by plane",
                            plane="native").inc(cur - prev)
                if field == "reconnects":
                    _flight.record("net.reconnect", None,
                                   total=cur, new=cur - prev)
                elif field == "renegotiations":
                    _flight.record("net.renegotiate", None,
                                   total=cur, new=cur - prev)
                elif field != "chaos_injected":
                    # Retries and resets avoided that never escalated to
                    # a reconnect: one net.recovery event carries them.
                    ladder_new[field] = cur - prev
            _last_synced[field] = cur
        if ladder_new:
            _flight.record("net.recovery", None, **ladder_new)
        reg.gauge("hvd_net_recovering_now",
                  "Channels currently mid-recovery").set(
            float(counters.get("recovering_now", 0)))
    return counters


def reset_sync_state() -> None:
    """Forget the delta baseline (the native counters are
    process-cumulative)."""
    with _sync_lock:
        _last_synced.clear()


def status() -> Dict[str, object]:
    """One view of the wire fabric: the native ladder's counters, the
    HTTP retries, and ``retrying`` — True while a channel is
    mid-recovery or recovered within :data:`RECENT_RECOVERY_MS`."""
    from ..metrics.registry import registry as _registry
    native = sync_native_metrics()
    http_retries = _registry().counter(
        "hvd_net_retries_total",
        "Wire-fabric recovery attempts by plane", plane="http").value
    retrying = False
    if native is not None:
        age = native.get("last_recovery_age_ms", -1)
        retrying = (native.get("recovering_now", 0) > 0
                    or (0 <= age < RECENT_RECOVERY_MS))
    return {
        "native": native,
        "http_retries": int(http_retries),
        "retrying": retrying,
        "verdict": ("retrying, deadline not yet reached" if retrying
                    else "no recent wire recovery activity"),
    }
