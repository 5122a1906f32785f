"""Drift detection over step time + component shares (EWMA/CUSUM; port of
horovod_tpu/metrics/baseline.py).

The attribution layer says where a step's time *went*; this module
notices when that quietly *changes* — the steps/sec regression nobody
is watching for after an autotune decision, an elastic round, a fleet
preemption, or a net-fabric recovery rung.  Per ``step_end``:

* an EWMA mean/variance of step time is the **baseline** (slow alpha,
  so a regression cannot teach the baseline its own slowdown before
  being caught);
* a one-sided CUSUM of standardized excursions accumulates evidence of
  *sustained* slowdown: ``c = max(0, c + z - k)`` with slack ``k`` —
  single noisy steps decay, a level shift climbs linearly;
* fast-EWMA component shares (attribution's wall components) name
  which component grew when the detector fires.

Firing requires BOTH the CUSUM trip (``HVD_TPU_PERF_DRIFT_THRESHOLD``
sigmas of accumulated evidence) and a minimum relative slowdown
(``HVD_TPU_PERF_DRIFT_MIN_PCT`` of the baseline) — variance collapse on
near-deterministic steps can inflate z-scores, the ratio guard keeps
microsecond jitter from ever firing.  On fire: a ``perf.drift`` flight
event, ``hvd_perf_drift_total{component}``, and a rank-attributed
regression report (``debug/regression.py``) correlating the drift
onset against the flight-recorded causal event stream — autotune
decisions, elastic rounds, fleet preemptions, net recovery, checkpoint
activity — so the report *names the suspect subsystem*.  The detector
then re-baselines at the new level (a persistent regression is
reported once, not every step) and mutes for the cooldown.  A confirmed
drift is then handed to the tuner (``autotune.notify_drift``), which
decides on a bounded re-tune episode and records its decision in the
report's ``tuning`` section.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional

from ..core import config as _config
from ..debug import flight as _flight
from .registry import registry as _registry

from .attribution import WALL_COMPONENTS as _DRIFT_COMPONENTS
# Components eligible to be named as the drift's dominant contributor
# (comm_hidden is informational, not wall time) — single-homed in
# attribution.py so a new wall component is considered here too.

# CUSUM slack: excursions under k sigmas decay instead of accumulating.
_CUSUM_SLACK = 0.5
# Relative std floor: near-deterministic baselines (simulated steps,
# scan-folded loops) would otherwise make z explode on the first noisy
# step.
_REL_STD_FLOOR = 0.02
# Fast share alpha (the "what does the step look like NOW" view).
_FAST_ALPHA = 0.2


class DriftEvent:
    """One confirmed drift: when, how bad, and which component grew."""

    __slots__ = ("step", "onset_step", "onset_wall", "onset_mono",
                 "ratio", "component", "baseline_s", "current_s",
                 "share_delta", "report_path")

    def __init__(self, step, onset_step, onset_wall, onset_mono, ratio,
                 component, baseline_s, current_s, share_delta):
        self.step = step
        self.onset_step = onset_step
        self.onset_wall = onset_wall
        self.onset_mono = onset_mono
        self.ratio = ratio
        self.component = component
        self.baseline_s = baseline_s
        self.current_s = current_s
        self.share_delta = share_delta
        self.report_path: Optional[str] = None

    def as_dict(self) -> dict:
        return {"step": self.step, "onset_step": self.onset_step,
                "onset_wall": self.onset_wall, "ratio": self.ratio,
                "component": self.component,
                "baseline_s": self.baseline_s,
                "current_s": self.current_s,
                "share_delta": self.share_delta,
                "report_path": self.report_path}


class DriftDetector:
    """EWMA baseline + one-sided CUSUM over per-step attribution
    records.  Thresholds freeze at construction (like the straggler
    detector); the process-global instance is :func:`drift_detector`."""

    def __init__(self, alpha: float = 0.02,
                 warmup: Optional[int] = None,
                 threshold: Optional[float] = None,
                 min_pct: Optional[float] = None,
                 cooldown: Optional[int] = None,
                 emit_report: bool = True):
        cfgc = _config.TELEMETRY
        self.alpha = float(alpha)
        self.warmup = warmup if warmup is not None else _config.get_int_or(
            _config.PERF_DRIFT_WARMUP, cfgc.perf_drift_warmup)
        self.threshold = threshold if threshold is not None else \
            _config.get_float(_config.PERF_DRIFT_THRESHOLD,
                              cfgc.perf_drift_threshold)
        self.min_pct = min_pct if min_pct is not None else \
            _config.get_float(_config.PERF_DRIFT_MIN_PCT,
                              cfgc.perf_drift_min_pct)
        self.cooldown = cooldown if cooldown is not None else \
            _config.get_int_or(_config.PERF_DRIFT_COOLDOWN,
                               cfgc.perf_drift_cooldown)
        self.emit_report = emit_report
        self._lock = threading.Lock()
        self._m_active = None
        self._reset_state()

    def _reset_state(self) -> None:
        self._steps = 0
        self._mean = 0.0
        self._var = 0.0
        self._fast_mean = 0.0
        self._cusum = 0.0
        self._cooldown_left = 0
        self._base_shares: Dict[str, float] = {}
        self._fast_shares: Dict[str, float] = {}
        # Where the current CUSUM climb began (candidate drift onset).
        self._onset_step: Optional[int] = None
        self._onset_wall = 0.0
        self._onset_mono = 0.0
        self._events: List[DriftEvent] = []

    # -- the per-step update ----------------------------------------------

    def update(self, step: int, dur_s: float,
               shares: Optional[Dict[str, float]] = None
               ) -> Optional[DriftEvent]:
        if dur_s is None or dur_s <= 0:
            return None
        shares = shares or {}
        with self._lock:
            self._steps += 1
            a = self.alpha
            if self._steps == 1:
                self._mean = dur_s
                self._fast_mean = dur_s
                self._fast_shares = {k: shares.get(k, 0.0)
                                     for k in _DRIFT_COMPONENTS}
                self._base_shares = dict(self._fast_shares)
                return None
            self._fast_mean += _FAST_ALPHA * (dur_s - self._fast_mean)
            for k in _DRIFT_COMPONENTS:
                s = shares.get(k, 0.0)
                self._fast_shares[k] = self._fast_shares.get(k, 0.0) + \
                    _FAST_ALPHA * (s - self._fast_shares.get(k, 0.0))
            if self._steps <= self.warmup:
                # Learning the baseline: mean/var and the slow shares.
                delta = dur_s - self._mean
                self._mean += a * delta
                self._var = (1 - a) * (self._var + a * delta * delta)
                for k in _DRIFT_COMPONENTS:
                    s = shares.get(k, 0.0)
                    self._base_shares[k] = self._base_shares.get(k, 0.0) \
                        + a * (s - self._base_shares.get(k, 0.0))
                return None
            if self._cooldown_left > 0:
                self._cooldown_left -= 1
                if self._cooldown_left == 0 and self._m_active is not None:
                    self._m_active.set(0.0)
                # Track at the FAST alpha through the cooldown: the fire
                # re-baselined at a fast view that had not yet converged
                # to the regressed level, and the slow alpha alone would
                # leave the gap wide enough to re-fire on the same
                # regression the moment the cooldown ends.
                delta = dur_s - self._mean
                self._mean += _FAST_ALPHA * delta
                self._var = (1 - _FAST_ALPHA) * (
                    self._var + _FAST_ALPHA * delta * delta)
                return None

            std = math.sqrt(max(self._var, 0.0))
            std = max(std, _REL_STD_FLOOR * max(self._mean, 1e-9), 1e-9)
            z = (dur_s - self._mean) / std
            prev = self._cusum
            self._cusum = max(0.0, self._cusum + z - _CUSUM_SLACK)
            if self._cusum > 0.0 and prev == 0.0:
                self._onset_step = int(step)
                self._onset_wall = time.time()
                self._onset_mono = time.monotonic()
            elif self._cusum == 0.0:
                self._onset_step = None

            ratio = self._fast_mean / max(self._mean, 1e-12)
            fired = (self._cusum >= self.threshold
                     and ratio >= 1.0 + self.min_pct / 100.0)
            if not fired:
                # Healthy step: the baseline keeps (slowly) learning.
                if self._cusum == 0.0:
                    delta = dur_s - self._mean
                    self._mean += a * delta
                    self._var = (1 - a) * (self._var + a * delta * delta)
                return None

            component, share_delta = self._dominant_component()
            event = DriftEvent(
                step=int(step),
                onset_step=self._onset_step if self._onset_step is not None
                else int(step),
                onset_wall=self._onset_wall or time.time(),
                onset_mono=self._onset_mono or time.monotonic(),
                ratio=ratio, component=component,
                baseline_s=self._mean, current_s=self._fast_mean,
                share_delta=share_delta)
            # Re-baseline at the new level: a persistent regression is
            # one report, not one per step.
            self._mean = self._fast_mean
            self._var = 0.0
            self._cusum = 0.0
            self._onset_step = None
            self._base_shares = dict(self._fast_shares)
            self._cooldown_left = self.cooldown
            self._events.append(event)
        self._emit(event)
        return event

    def _dominant_component(self) -> tuple:
        """The wall component whose share grew the most between the
        slow baseline and the fast view (lock held)."""
        best, best_delta = "compute", float("-inf")
        for k in _DRIFT_COMPONENTS:
            d = self._fast_shares.get(k, 0.0) - self._base_shares.get(k, 0.0)
            if d > best_delta:
                best, best_delta = k, d
        if best_delta <= 0.0:
            # Uniform slowdown: every share held steady while the step
            # grew — attribute to compute (the residual carrier).
            return "compute", 0.0
        return best, best_delta

    def _emit(self, event: DriftEvent) -> None:
        reg = _registry()
        if self._m_active is None:
            self._m_active = reg.gauge(
                "hvd_perf_drift_active",
                "1 while the last confirmed drift's cooldown runs")
        # cooldown=0: there is no cooldown window, and the only path
        # that clears the gauge (the cooldown countdown) never runs —
        # setting it would leave the drift "active" forever.
        self._m_active.set(1.0 if self.cooldown > 0 else 0.0)
        reg.counter("hvd_perf_drift_total",
                    "Confirmed step-time drifts by dominant component",
                    component=event.component).inc()
        _flight.record("perf.drift", event.component, step=event.step,
                       onset_step=event.onset_step,
                       ratio=round(event.ratio, 4),
                       baseline_s=round(event.baseline_s, 6),
                       current_s=round(event.current_s, 6))
        from ..utils import logging as log
        log.warning(
            "perf drift: step time %.1f ms = %.2fx the baseline %.1f ms "
            "since ~step %d (dominant component: %s, share +%.0f%%)",
            event.current_s * 1e3, event.ratio, event.baseline_s * 1e3,
            event.onset_step, event.component, event.share_delta * 100)
        report = None
        if self.emit_report:
            try:
                from ..debug import regression
                report = regression.build_regression_report(event)
                event.report_path = report.get("path")
            except Exception:  # noqa: BLE001 — diagnosis never kills
                pass
        # Close the loop: a drift whose suspect is a tunable subsystem
        # (or whose dominant component is exposed comm) triggers a
        # bounded re-tune episode with regression-gated rollback instead
        # of an operator page — autotune.notify_drift decides, records
        # its decision in the report's ``tuning`` section, and no-ops on
        # ranks that own no tuner.
        try:
            from .. import autotune as _autotune
            _autotune.notify_drift(event, report)
        except Exception:  # noqa: BLE001 — the loop never kills the step
            pass

    # -- read side ---------------------------------------------------------

    def events(self) -> List[DriftEvent]:
        with self._lock:
            return list(self._events)

    def last_event(self) -> Optional[DriftEvent]:
        with self._lock:
            return self._events[-1] if self._events else None

    def state(self) -> dict:
        with self._lock:
            return {"steps": self._steps, "baseline_s": self._mean,
                    "fast_s": self._fast_mean, "cusum": self._cusum,
                    "cooldown_left": self._cooldown_left,
                    "warmup": self.warmup, "threshold": self.threshold,
                    "events": len(self._events)}

    def reset(self) -> None:
        with self._lock:
            self._reset_state()
            # _reset_state zeroed the cooldown countdown — the only
            # other path that clears the active gauge — so clear it
            # here or a reset mid-cooldown pins "drift active" forever.
            if self._m_active is not None:
                self._m_active.set(0.0)


_enabled: Optional[bool] = None


def drift_enabled() -> bool:
    """Cached like ``attribution.enabled`` — read per step_end, so an
    env read per step is measurable at the <1% budget."""
    global _enabled
    if _enabled is None:
        _enabled = _config.get_bool(_config.PERF_DRIFT,
                                    _config.TELEMETRY.perf_drift)
    return _enabled


def set_drift_enabled(flag: Optional[bool]) -> None:
    """Toggle drift detection (None = re-read the env knob)."""
    global _enabled
    _enabled = None if flag is None else bool(flag)


_detector: Optional[DriftDetector] = None
_detector_lock = threading.Lock()


def drift_detector() -> DriftDetector:
    """Process-global drift detector (thresholds frozen at first use)."""
    global _detector
    with _detector_lock:
        if _detector is None:
            _detector = DriftDetector()
        return _detector


def reset_drift_detector() -> None:
    """Tests: drop the singleton so the next use re-reads the knobs."""
    global _detector
    with _detector_lock:
        if _detector is not None:
            # The replacement instance has no handle on the registry
            # gauge the old one may have left at 1 — clear through the
            # old instance before dropping it.
            _detector.reset()
        _detector = None


def last_drift_event() -> Optional[DriftEvent]:
    return drift_detector().last_event()
