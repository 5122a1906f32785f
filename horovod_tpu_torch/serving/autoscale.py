"""Replica autoscaling — queue-depth/SLO pressure → elastic resizes (port
of horovod_tpu/serving/autoscale.py).

The decision half, :func:`desired_np`, is pure and golden-testable:
given the current width and the replica's live pressure signals (queue
depth per replica vs the target, TTFT p95 vs the SLO, SLO burn) it
returns the width the service *should* run at.  :class:`Autoscaler`
executes those decisions against the ``ElasticDriver`` public resize
carve-out (``request_resize(np, reason)``,
``runner/elastic_driver.py``), with cooldown hysteresis so pressure
noise cannot flap the fleet.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from ..core import config as _config


def desired_np(current_np: int, min_np: int, max_np: int,
               queue_depth: int, target_queue: float,
               ttft_p95: float = 0.0, slo_ttft_s: float = 0.0,
               occupancy: float = 0.0, burn_rate: float = 0.0,
               burn_threshold: float = 1.0) -> int:
    """The width the service should run at.  Scale up one replica when
    the queue holds more than ``target_queue`` requests per replica OR
    TTFT p95 exceeds the SLO OR any tenant's error-budget burn rate
    (``burn_rate`` — the max across tenants, from serving/slo.py) is
    at/over its threshold; scale down one only when the queue is
    empty, the decode slots have real headroom (``occupancy`` — the
    occupied-slot fraction — under half: a saturated replica whose
    queue merely drained between ticks is NOT idle), the SLO (when
    set) has comfortable headroom (< half), and no tenant is burning
    anywhere near threshold (< half).  One step at a time — the
    cooldown between calls is the ramp limiter."""
    up = (queue_depth > target_queue * current_np
          or (slo_ttft_s > 0 and ttft_p95 > slo_ttft_s)
          or burn_rate >= burn_threshold)
    down = (queue_depth == 0 and occupancy < 0.5
            and (slo_ttft_s <= 0 or ttft_p95 < 0.5 * slo_ttft_s)
            and burn_rate < 0.5 * burn_threshold)
    want = current_np + (1 if up else (-1 if down else 0))
    return max(min_np, min(max_np, want))


class Autoscaler:
    """Drives ``driver.request_resize`` from a status callback.

    ``status_fn()`` returns ``{"np": current width, "queue_depth": int,
    "ttft_p95": seconds, "occupancy": occupied-slot fraction,
    "burn_rate": max per-tenant SLO burn rate}`` (missing keys default
    sanely).  ``driver`` is anything with the ElasticDriver resize
    carve-out.  Unset arguments read ``HVD_TPU_SERVING_TARGET_QUEUE``,
    ``…_SLO_TTFT_S``, ``…_SCALE_COOLDOWN_S`` and
    ``HVD_TPU_SLO_BURN_THRESHOLD``; every value is clamped as the
    reference clamps it."""

    def __init__(self, driver, status_fn: Callable[[], Dict],
                 min_np: int = 1, max_np: int = 1,
                 target_queue: Optional[float] = None,
                 slo_ttft_s: Optional[float] = None,
                 cooldown_s: Optional[float] = None,
                 burn_threshold: Optional[float] = None):
        self.driver = driver
        self.status_fn = status_fn
        self.min_np = int(min_np)
        self.max_np = int(max_np)
        self.target_queue = max(0.5, (
            _config.serving_target_queue() if target_queue is None
            else float(target_queue)))
        self.slo_ttft_s = max(0.0, (
            _config.serving_slo_ttft_s() if slo_ttft_s is None
            else float(slo_ttft_s)))
        self.cooldown_s = max(0.0, (
            _config.serving_scale_cooldown_s() if cooldown_s is None
            else float(cooldown_s)))
        self.burn_threshold = max(0.01, (
            _config.slo_burn_threshold() if burn_threshold is None
            else float(burn_threshold)))
        self._last_resize = 0.0

    def maybe_resize(self, now: Optional[float] = None) -> Optional[int]:
        """Evaluate pressure once; returns the requested width when a
        resize was issued, else None."""
        now = time.monotonic() if now is None else now
        if now - self._last_resize < self.cooldown_s:
            return None
        st = self.status_fn() or {}
        current = int(st.get("np", self.min_np))
        want = desired_np(
            current, self.min_np, self.max_np,
            queue_depth=int(st.get("queue_depth", 0)),
            target_queue=self.target_queue,
            ttft_p95=float(st.get("ttft_p95", 0.0)),
            slo_ttft_s=self.slo_ttft_s,
            occupancy=float(st.get("occupancy", 0.0)),
            burn_rate=float(st.get("burn_rate", 0.0)),
            burn_threshold=self.burn_threshold)
        if want == current:
            return None
        reason = (f"serving autoscale: queue_depth="
                  f"{st.get('queue_depth', 0)}, ttft_p95="
                  f"{st.get('ttft_p95', 0.0):.3f}s, {current}->{want}")
        if not self.driver.request_resize(want, reason):
            return None
        self._last_resize = now
        from ..metrics.registry import registry
        registry().counter(
            "hvd_serving_autoscale_total",
            "Replica resizes issued by the serving autoscaler",
            direction="up" if want > current else "down").inc()
        from ..debug import flight
        flight.record("serving.autoscale", None, np=want,
                      was=current, queue=int(st.get("queue_depth", 0)))
        return want
