"""Per-tenant rolling SLO error budgets for the serving plane (port of
horovod_tpu/serving/slo.py).

Each tenant has an attainment target (``HVD_TPU_SLO_TARGET``, default
99% of requests meet their TTFT/deadline objective); over a sliding
window (``HVD_TPU_SLO_WINDOW_S``) the observed miss fraction divided by
the allowed miss fraction is the **burn rate** — 1.0 means the tenant is
spending budget exactly as fast as it accrues; at or above
``HVD_TPU_SLO_BURN_THRESHOLD`` the tenant is *burning* and
``policy.plan`` gives it priority.

The math lives in pure free functions (``burn_rate``,
``budget_remaining``); ``SloTracker`` adds the sliding window.  The
reference exports ``hvd_slo_burn_rate`` / ``hvd_slo_budget_remaining``
gauges per tenant; the port has no metrics registry yet and keeps their
last values on the tracker (``SloTracker.gauges``).
"""

from __future__ import annotations

import collections
from typing import Deque, Dict, Optional, Tuple

from ..core import config as _config


def burn_rate(good: int, bad: int, target: float) -> float:
    """Observed miss fraction over the allowed miss fraction.  Pure:
    ``(bad / (good + bad)) / (1 - target)``; 0.0 with no events (no
    evidence is not a violation)."""
    total = good + bad
    if total <= 0:
        return 0.0
    allowed = 1.0 - target
    if allowed <= 0.0:
        return float("inf") if bad else 0.0
    return (bad / float(total)) / allowed


def budget_remaining(good: int, bad: int, target: float) -> float:
    """1.0 = untouched budget, 0.0 = spent (clamped).  Defined as
    ``1 - burn_rate`` so the two gauges are always consistent."""
    return max(0.0, 1.0 - burn_rate(good, bad, target))


class SloTracker:
    """Sliding-window per-tenant error budgets.

    Single-threaded by contract (the serving loop owns it, like the
    engine).  Each ``record`` appends an (arrival, ok) event to the
    tenant's window, prunes events older than ``window_s``, and
    refreshes the two per-tenant gauges.  ``now_s`` is always passed
    explicitly so tests drive a synthetic clock.
    """

    def __init__(self, target: Optional[float] = None,
                 window_s: Optional[float] = None,
                 burn_threshold: Optional[float] = None):
        if target is None:
            target = _config.slo_target()
        if window_s is None:
            window_s = _config.slo_window_s()
        if burn_threshold is None:
            burn_threshold = _config.slo_burn_threshold()
        self.target = float(target)
        self.window_s = float(window_s)
        self.burn_threshold = float(burn_threshold)
        self._events: Dict[str, Deque[Tuple[float, bool]]] = {}
        # Last trace id that MISSED per tenant: the exemplar that
        # turns a burning gauge into a debuggable request.
        self._last_miss_trace: Dict[str, Optional[str]] = {}
        # The two per-tenant gauges' last values: {tenant: {"burn_rate",
        # "budget_remaining"}}.
        self.gauges: Dict[str, Dict[str, float]] = {}

    # -- recording ---------------------------------------------------

    def record(self, tenant: str, ok: bool, now_s: float,
               trace_id: Optional[str] = None) -> None:
        tenant = tenant or "default"
        dq = self._events.get(tenant)
        if dq is None:
            dq = self._events[tenant] = collections.deque()
        dq.append((now_s, bool(ok)))
        if not ok and trace_id:
            self._last_miss_trace[tenant] = trace_id
        self._prune(dq, now_s)
        self._export(tenant, now_s)

    def _prune(self, dq: Deque[Tuple[float, bool]], now_s: float) -> None:
        horizon = now_s - self.window_s
        while dq and dq[0][0] < horizon:
            dq.popleft()

    def _counts(self, tenant: str, now_s: float) -> Tuple[int, int]:
        dq = self._events.get(tenant)
        if not dq:
            return 0, 0
        self._prune(dq, now_s)
        good = sum(1 for _, ok in dq if ok)
        return good, len(dq) - good

    def _export(self, tenant: str, now_s: float) -> None:
        good, bad = self._counts(tenant, now_s)
        self.gauges[tenant] = {
            "burn_rate": burn_rate(good, bad, self.target),
            "budget_remaining": budget_remaining(good, bad, self.target)}

    # -- queries -----------------------------------------------------

    def burn(self, tenant: str, now_s: float) -> float:
        good, bad = self._counts(tenant or "default", now_s)
        return burn_rate(good, bad, self.target)

    def burn_rates(self, now_s: float) -> Dict[str, float]:
        """All tenants' burn rates — the dict policy.plan takes."""
        return {t: self.burn(t, now_s) for t in list(self._events)}

    def burning(self, now_s: float) -> Dict[str, float]:
        """Only tenants at/over the burn threshold."""
        return {t: b for t, b in self.burn_rates(now_s).items()
                if b >= self.burn_threshold}

    def max_burn(self, now_s: float) -> float:
        rates = self.burn_rates(now_s)
        return max(rates.values()) if rates else 0.0

    def stats(self, now_s: float) -> Dict[str, object]:
        """The ``/serve/stats`` "slo" section."""
        tenants = {}
        for t in sorted(self._events):
            good, bad = self._counts(t, now_s)
            tenants[t] = {
                "good": good, "bad": bad,
                "burn_rate": burn_rate(good, bad, self.target),
                "budget_remaining": budget_remaining(good, bad,
                                                     self.target),
                "last_miss_trace": self._last_miss_trace.get(t),
            }
        return {"target": self.target, "window_s": self.window_s,
                "burn_threshold": self.burn_threshold,
                "tenants": tenants}
