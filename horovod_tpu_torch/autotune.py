"""Autotuning of runtime parameters — the ParameterManager (port of
horovod_tpu/autotune.py).

Capability parity with the reference's autotune subsystem
(parameter_manager.h:42-246 + optim/bayesian_optimization.cc +
optim/gaussian_process.cc): joint Bayesian optimization of {fusion
threshold bytes, cycle time ms} AND the categorical toggles
{hierarchical_allreduce, hierarchical_allgather, cache_enabled}
(parameter_manager.h:91-93), scored by data-plane throughput
(bytes/sec) over sample windows, with an optional CSV log
(HOROVOD_AUTOTUNE_LOG).  Rebuilt in numpy: RBF-kernel Gaussian-process
regression with expected-improvement acquisition maximized over a random
candidate set (the reference uses Eigen + LBFGS for the same acquisition);
the categorical toggles ride the same GP as relaxed [0,1] dimensions
rounded at application, instead of the reference's nested grids.

The tuner runs on rank 0 (the coordinator owns fusion decisions); tuned
parameters are applied through the native runtime's SetParams hook.

Everything here is numpy on the host, line for line the reference's: the
same seed and score stream give the same proposals, journal and log.  One
hook is the port's: ``window_sync``, called once as a sample window
closes, before its clock is read.  On the card the negotiated plane's
collectives return when NCCL has them queued, and the runtime counts a
response's bytes when the executor returns; the native controller passes
a wait on the executor's last completion event, so a window's seconds
cover the device work its bytes count (one wait a window, never one an
operation).  Without it the scoring is the reference's.
"""

from __future__ import annotations

import math
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np


class GaussianProcess:
    """GP regression with an RBF kernel and observation noise."""

    def __init__(self, length_scale: float = 1.0, noise: float = 1e-4,
                 signal_var: float = 1.0):
        self.length_scale = length_scale
        self.noise = noise
        self.signal_var = signal_var
        self._x: Optional[np.ndarray] = None
        self._y: Optional[np.ndarray] = None
        self._k_inv: Optional[np.ndarray] = None
        self._y_mean = 0.0
        self._y_std = 1.0

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return self.signal_var * np.exp(-0.5 * d2 / self.length_scale ** 2)

    def fit(self, x: np.ndarray, y: np.ndarray):
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        y = np.asarray(y, dtype=np.float64)
        self._y_mean = float(y.mean())
        self._y_std = float(y.std()) or 1.0
        yn = (y - self._y_mean) / self._y_std
        k = self._kernel(x, x) + self.noise * np.eye(len(x))
        self._k_inv = np.linalg.inv(k)
        self._x, self._y = x, yn

    def predict(self, x_star: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        x_star = np.atleast_2d(np.asarray(x_star, dtype=np.float64))
        if self._x is None:
            mu = np.zeros(len(x_star))
            sigma = np.full(len(x_star), math.sqrt(self.signal_var))
            return mu * self._y_std + self._y_mean, sigma * self._y_std
        ks = self._kernel(x_star, self._x)
        mu = ks @ self._k_inv @ self._y
        kss = self.signal_var * np.ones(len(x_star))
        var = kss - np.einsum("ij,jk,ik->i", ks, self._k_inv, ks)
        sigma = np.sqrt(np.maximum(var, 1e-12))
        return mu * self._y_std + self._y_mean, sigma * self._y_std


def expected_improvement(mu: np.ndarray, sigma: np.ndarray,
                         best: float, xi: float = 0.01) -> np.ndarray:
    """EI acquisition (reference bayesian_optimization.cc)."""
    from math import erf, sqrt
    z = (mu - best - xi) / sigma
    cdf = 0.5 * (1.0 + np.vectorize(erf)(z / sqrt(2.0)))
    pdf = np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)
    return (mu - best - xi) * cdf + sigma * pdf


class BayesianOptimizer:
    """Maximize an unknown function over a box via GP + EI."""

    def __init__(self, bounds: Sequence[Tuple[float, float]],
                 seed: int = 0, n_candidates: int = 512,
                 noise: float = 0.8,
                 pinned: Optional[dict] = None):
        self.bounds = np.asarray(bounds, dtype=np.float64)
        self.rng = np.random.RandomState(seed)
        self.n_candidates = n_candidates
        # dim index -> NORMALIZED value, clamped into every candidate:
        # letting candidates vary a dimension whose observations are
        # pinned keeps posterior sigma maximal there, so EI chases
        # unrealizable points and the free dims ride along as noise.
        self.pinned = dict(pinned or {})
        # The GP standardizes scores to zero-mean/unit-std internally, so
        # this noise level acts on unit-scale observations — directly
        # comparable to the reference's alpha knob
        # (--autotune-gaussian-process-noise, default 0.8).
        self.gp = GaussianProcess(length_scale=0.3, noise=noise)
        self.xs: List[np.ndarray] = []
        self.ys: List[float] = []

    def _normalize(self, x):
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        return (np.asarray(x) - lo) / (hi - lo)

    def _denormalize(self, u):
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        return lo + np.asarray(u) * (hi - lo)

    def observe(self, x, y: float):
        self.xs.append(self._normalize(x))
        self.ys.append(float(y))
        self.gp.fit(np.stack(self.xs), np.asarray(self.ys))

    def _pin(self, u: np.ndarray) -> np.ndarray:
        for i, v in self.pinned.items():
            u[..., i] = v
        return u

    def suggest(self, focus: Optional[Sequence[int]] = None) -> np.ndarray:
        """Propose the next point by EI over a random candidate set.

        ``focus`` (dim indices) prioritizes a subset of the space: half
        the candidates hold every NON-focus dim at the incumbent best
        observation while the focus dims sweep their full range — the
        acquisition then spends its budget where the caller's evidence
        (e.g. a comm-dominated attribution window) says the payoff is,
        without forbidding the free-roaming half from correcting a wrong
        hunch.  Pinned dims stay pinned either way."""
        if len(self.xs) < 3:  # bootstrap with random exploration
            return self._denormalize(self._pin(
                self.rng.rand(len(self.bounds))))
        cand = self._pin(self.rng.rand(self.n_candidates,
                                       len(self.bounds)))
        if focus:
            incumbent = self.xs[int(np.argmax(self.ys))]
            hold = [i for i in range(len(self.bounds))
                    if i not in set(focus)]
            if hold:
                cand[: self.n_candidates // 2, hold] = incumbent[hold]
            cand = self._pin(cand)
        mu, sigma = self.gp.predict(cand)
        ei = expected_improvement(mu, sigma, max(self.ys))
        return self._denormalize(cand[int(np.argmax(ei))])

    def best(self) -> Tuple[np.ndarray, float]:
        i = int(np.argmax(self.ys))
        return self._denormalize(self.xs[i]), self.ys[i]


class ParameterManager:
    """Tunes {log2(fusion bytes), cycle ms} JOINTLY with the categorical
    toggles {hierarchical_allreduce, hierarchical_allgather, cache_enabled}
    against observed throughput.

    Reference semantics (parameter_manager.h:91-93, 225-236): the three
    booleans are CategoricalParameter<bool>s chained with the joint
    Bayesian numeric parameters; scores are throughput bytes/sec over
    sample windows; after ``max_samples`` windows the best parameters are
    frozen.  Difference from upstream Horovod: instead of its nested
    categorical grids, the toggles are relaxed to [0,1] dimensions of the
    SAME GP and rounded at application — one joint surrogate over the
    mixed space — with a deterministic bootstrap plan that tries both
    values of every toggle before EI takes over (so e.g. hierarchical
    allreduce is demonstrably tried OFF on a single host, where it
    loses).
    """

    # log2(bytes): 1 MB .. 256 MB; cycle: 0.5 .. 25 ms; three relaxed
    # booleans {hierarchical_allreduce, hierarchical_allgather, cache};
    # one relaxed trinary (wire compression, rounded into thirds); one
    # relaxed quaternary (overlap bucket bytes, rounded into quarters).
    BOUNDS = [(20.0, 28.0), (0.5, 25.0),
              (0.0, 1.0), (0.0, 1.0), (0.0, 1.0), (0.0, 1.0), (0.0, 1.0)]

    # Wire-format categorical (quantized collective engine): tuned like
    # the boolean toggles, as a relaxed [0,1] dimension of the same GP
    # rounded into thirds at application.  int4 is deliberately absent —
    # without error feedback (an optimizer-state concern the runtime
    # cannot provide) it trades too much gradient fidelity to auto-pick.
    COMPRESSION_CHOICES = ("none", "bf16", "int8")

    # Overlap bucket-size categorical (backward-overlap scheduler,
    # ops/overlap.py): 0 = bucketing off (the per-leaf barrier
    # schedule), else the bucket size in bytes — log2-spaced because
    # the overlap/launch-overhead trade is multiplicative.  Tuned
    # jointly with fusion/cycle/compression: the schedule is
    # value-invariant (bit parity); an explicit
    # HVD_TPU_OVERLAP_BUCKET_BYTES pins the dimension.  Callers may
    # restrict the grid via ``overlap_choices`` — the native controller
    # excludes 0 on multi-rank jobs, because a live on<->off flip is
    # rank-0-local and changes the eager collective NAME sequence
    # (barrier auto-names vs the queue's leaf names), which would
    # desync negotiation; bucket-SIZE flips are name-invariant.
    OVERLAP_CHOICES = (0, 2 << 20, 8 << 20, 32 << 20)

    # Crossover-shift grid for dispatch mode (see ``dispatch_shifts``):
    # the probe-seeded table is the warm start (shift 0); ±1 moves every
    # crossover boundary of that op kind by one payload bucket.
    SHIFT_CHOICES = (-1, 0, 1)

    # GP dims the attribution plane can act on: the comm knobs —
    # dispatch shifts / hierarchical toggles (2, 3), wire compression
    # (5) and the overlap bucket size (6).  Fusion/cycle stay
    # free-roaming: they trade comm batching against host latency and a
    # comm-dominant window does not disambiguate the direction.
    _COMM_DIMS = (2, 3, 5, 6)
    # A window counts as comm-bound when exposed comm is at least this
    # share of the wall AND the largest non-compute component — compute
    # is excluded from the comparison because no tuned knob shrinks the
    # model's arithmetic, so comm stays the biggest *actionable* lever
    # even under a compute-heavy step.
    _COMM_FOCUS_MIN = 0.15

    def __init__(self, apply_fn, max_samples: int = 20,
                 window_seconds: float = 2.0,
                 log_file: Optional[str] = None, seed: int = 0,
                 warmup_samples: int = 3, steps_per_sample: int = 0,
                 gp_noise: float = 0.8,
                 initial_toggles: Tuple[bool, bool, bool] =
                 (False, False, True),
                 tune_toggles: bool = True,
                 initial_compression: str = "none",
                 tune_compression: bool = False,
                 initial_overlap: int = 0,
                 tune_overlap: bool = False,
                 overlap_choices=None,
                 dispatch_shifts: bool = False,
                 attribution_source=None,
                 window_sync=None):
        """apply_fn(fusion_bytes: int, cycle_ms: float, hierarchical_
        allreduce: bool, hierarchical_allgather: bool, cache_enabled:
        bool, compression: str, overlap_bucket_bytes: int) applies
        parameters to the runtime (native SetParams + SetTunedToggles +
        SetWireCompression + the overlap engine's session bucket size).

        ``warmup_samples`` windows are discarded (not fed to the GP) to
        skip compile/cache-cold noise; ``steps_per_sample > 0`` closes a
        window every N traffic reports instead of by wall-clock — the
        reference's step-counted sampling (--autotune-steps-per-sample).
        ``initial_toggles`` seeds the bootstrap plan with the configured
        algorithm choice.  ``tune_toggles`` is a per-toggle bool triple
        (a plain bool applies to all three): a pinned toggle stays at
        its initial value and is never explored — flipping a toggle
        that cannot take effect (hierarchical with one node, cache with
        capacity 0) would burn sample budget re-measuring an identical
        configuration.  ``initial_compression``/``tune_compression`` do
        the same for the wire-format categorical (COMPRESSION_CHOICES);
        an explicitly-configured format stays pinned.
        ``initial_overlap``/``tune_overlap`` handle the overlap
        bucket-size categorical (``overlap_choices``, default
        OVERLAP_CHOICES, 0 = off): the bootstrap demonstrably tries
        each choice (overlap OFF against each bucket size, when 0 is in
        the grid) before EI takes over, and an explicitly-configured
        size (HVD_TPU_OVERLAP_BUCKET_BYTES, or any off-grid value) pins
        the dimension.

        ``dispatch_shifts``: once a topology-probed dispatch table is
        installed (ops/dispatch.py), the two hierarchical dims stop
        being blind whole-range booleans and become bounded crossover
        SHIFTS in {-1, 0, +1} over that table — the probe result is the
        warm start, the GP only refines where the flat/hier boundary
        sits.  ``initial_toggles[0:2]`` are then initial shifts (ints)
        and apply_fn receives shift ints in those positions.

        ``attribution_source``: zero-arg callable returning the current
        attribution window's wall-component shares (or None) — default
        the process-global observatory
        (``metrics.attribution.window_shares``).  When the window is
        comm-bound the bootstrap plan tries the comm arms (dispatch
        shifts, compression, bucket size) before the host-side ones and
        the EI acquisition focuses the comm dims; every decision record
        (CSV line, ``autotune.decision`` flight event, journal entry)
        carries the attribution vector that motivated it.

        ``window_sync``: zero-arg callable run once as a window closes,
        before the window's clock is read (the native controller's wait
        on the device plane's last completion event)."""
        self._apply = apply_fn
        self._window_sync = window_sync
        self._dispatch_shifts = bool(dispatch_shifts)
        if self._dispatch_shifts:
            init_toggles = (
                min(max(int(initial_toggles[0]), -1), 1),
                min(max(int(initial_toggles[1]), -1), 1),
                bool(initial_toggles[2]))
        else:
            init_toggles = tuple(bool(t) for t in initial_toggles)
        if isinstance(tune_toggles, (tuple, list)):
            tunable = tuple(bool(t) for t in tune_toggles)
        else:
            tunable = (bool(tune_toggles),) * 3
        if initial_compression not in self.COMPRESSION_CHOICES:
            # int4/fp16 (or a typo) cannot be represented in the tuned
            # space: respect it by pinning, never by silently replacing.
            tune_compression = False
        self._initial_compression = initial_compression
        self._tune_compression = bool(tune_compression)
        self._overlap_choices = (tuple(int(c) for c in overlap_choices)
                                 if overlap_choices else
                                 self.OVERLAP_CHOICES)
        initial_overlap = int(initial_overlap)
        if initial_overlap not in self._overlap_choices:
            # An explicit off-grid bucket size: respect by pinning.
            tune_overlap = False
        self._initial_overlap = initial_overlap
        self._tune_overlap = bool(tune_overlap)
        # Pin the GP's candidate dims for non-tunable toggles (toggle
        # bounds are [0,1], so normalized == raw value; shift dims pin
        # at the center of their third).
        pinned = {2 + i: self._toggle_coord(i, init_toggles[i])
                  for i in range(3) if not tunable[i]}
        if not self._tune_compression:
            pinned[5] = self._compression_x(initial_compression)
        if not self._tune_overlap:
            pinned[6] = self._overlap_x(initial_overlap)
        self._opt = BayesianOptimizer(
            self.BOUNDS, seed=seed, noise=gp_noise, pinned=pinned)
        self._max_samples = max_samples
        self._window = window_seconds
        self._warmup_left = max(0, warmup_samples)
        self._steps_per_sample = max(0, steps_per_sample)
        self._steps_in_window = 0
        self._log_file = log_file
        self._samples = 0
        self._frozen = False
        self._current = None
        self._initial_toggles = init_toggles
        self._tunable = tunable
        # Deterministic categorical bootstrap (the reference's grids try
        # every categorical value; here: the configured combo, then each
        # TUNABLE toggle flipped once, then each non-initial wire format
        # once, then each non-initial overlap bucket size once — so
        # "overlap off vs each bucket size" is a controlled comparison).
        # Numeric dims stay GP-proposed.  Entries are tagged with the
        # knob category they vary ("comm" = dispatch/hierarchical,
        # compression, overlap bucket; "host" = cache) so a comm-bound
        # attribution window can pull the comm arms forward without
        # losing any arm.
        self._toggle_plan = self._build_plan()
        # The plan holds the numeric dims FIXED across the toggle flips:
        # a controlled comparison, so fusion/cycle variation (which can
        # swing throughput far more than ~20%) cannot confound the
        # categorical signal.  The reference's nested grids get the same
        # property structurally.
        self._plan_numeric = None
        self._window_start = time.perf_counter()
        self._bytes = 0
        # The observatory signal: shares of the last closed attribution
        # window (captured per _observe), default source the
        # process-global engine.  Guarded — the tuner must run with the
        # observatory disabled or absent.
        if attribution_source is None:
            attribution_source = _default_attribution_source
        self._attr_source = attribution_source
        self._last_attr: Optional[dict] = None
        # Decision trail: every applied config with the score it earned
        # and the attribution vector that motivated it (bounded).
        self._journal: List[dict] = []
        # Closed-loop state: the frozen config's measured score (the
        # pre-drift baseline a re-tune episode is gated against), the
        # bounded-episode countdown, the last-known-good rollback
        # target, and the loop's lifetime counters.
        self._frozen_score: Optional[float] = None
        self._retune_left = 0
        self._retune_scores: List[Tuple[float, tuple]] = []
        self._retune_baseline: Optional[float] = None
        self._retune_focus: Optional[str] = None
        self._known_good: Optional[tuple] = None
        self._retunes = 0
        self._rollbacks = 0
        self._warm_started = False
        self._last_outcome: Optional[dict] = None
        # Tuning memory (fleet/tuning.py): attached by announce_model /
        # attach_memory; the frozen best writes back through it.
        self._memory = None
        self._memory_key: Optional[str] = None
        # One-shot reason override for the next proposal (warm_start
        # applies through _propose but must record as warm_start).
        self._pending_reason: Optional[str] = None
        # Autotune decisions feed the metrics registry: which parameters
        # are live right now, how many sample windows were scored, and
        # whether the tuner froze — queryable next to the throughput
        # they produced instead of buried in the CSV log.
        from .metrics.registry import registry as _metrics_registry
        _mreg = _metrics_registry()
        self._m_samples = _mreg.counter(
            "hvd_autotune_samples_total",
            "Scored autotune sample windows")
        self._m_decisions = _mreg.counter(
            "hvd_autotune_decisions_total",
            "Parameter applications by the autotuner")
        self._m_fusion = _mreg.gauge(
            "hvd_autotune_fusion_bytes",
            "Fusion threshold currently applied by the autotuner")
        self._m_cycle = _mreg.gauge(
            "hvd_autotune_cycle_ms",
            "Cycle time currently applied by the autotuner")
        self._m_frozen = _mreg.gauge(
            "hvd_autotune_frozen",
            "1 once the autotuner froze its best parameters")
        # The closed loop's own observability: how often the
        # drift plane re-opened the tuner, how often the episode rolled
        # back, whether this job started from the tuning memory, and the
        # last episode's score vs its pre-drift baseline.
        self._m_retunes = _mreg.counter(
            "hvd_autotune_retunes_total",
            "Drift-triggered bounded re-tune episodes")
        self._m_rollbacks = _mreg.counter(
            "hvd_autotune_rollbacks_total",
            "Re-tune episodes rolled back to the last-known-good config")
        self._m_warm = _mreg.counter(
            "hvd_autotune_warm_starts_total",
            "Tuners seeded from the persistent tuning memory")
        self._m_score_ratio = _mreg.gauge(
            "hvd_autotune_score_ratio",
            "Last re-tune episode's best score / pre-drift baseline")
        self._reason = "bootstrap"
        self._propose()

    def _build_plan(self) -> List[Tuple[str, tuple]]:
        """The deterministic categorical bootstrap as (category, tail)
        entries — tail is the 5-wide categorical suffix appended to the
        plan's fixed numerics."""
        if not (any(self._tunable) or self._tune_compression or
                self._tune_overlap):
            return []
        t0 = self._initial_toggles + (self._initial_compression,
                                      self._initial_overlap)
        plan: List[Tuple[str, tuple]] = [("base", t0)]
        for i in range(3):
            if not self._tunable[i]:
                continue
            # Alternatives per dim: a boolean flips once; a
            # dispatch-mode shift dim tries each other crossover
            # shift (so ±1 are both demonstrably measured against
            # the probe's warm start before EI takes over).
            if self._dispatch_shifts and i < 2:
                alts = [s for s in self.SHIFT_CHOICES if s != t0[i]]
            else:
                alts = [not t0[i]]
            cat = "comm" if i < 2 else "host"
            plan += [(cat, tuple(a if j == i else t0[j] for j in range(3))
                      + (self._initial_compression, self._initial_overlap))
                     for a in alts]
        if self._tune_compression:
            plan += [("comm", self._initial_toggles
                      + (c, self._initial_overlap))
                     for c in self.COMPRESSION_CHOICES
                     if c != self._initial_compression]
        if self._tune_overlap:
            plan += [("comm", self._initial_toggles
                      + (self._initial_compression, o))
                     for o in self._overlap_choices
                     if o != self._initial_overlap]
        return plan

    def _refresh_attr(self) -> Optional[dict]:
        """Snapshot the attribution window's shares (guarded — the
        observatory may be off, absent, or mid-reset)."""
        try:
            shares = self._attr_source() if self._attr_source else None
        except Exception:  # noqa: BLE001 — telemetry never kills tuning
            shares = None
        if shares:
            self._last_attr = {k: round(float(v), 4)
                               for k, v in shares.items()}
        return self._last_attr

    def _comm_focus(self) -> bool:
        """True when the last attribution window says the step is
        comm-bound — exposed comm at least _COMM_FOCUS_MIN of the wall
        and the largest non-compute component."""
        attr = self._last_attr
        if not attr:
            return False
        comm = attr.get("comm_exposed", 0.0)
        others = [attr.get(k, 0.0) for k in ("input", "checkpoint", "host")]
        return comm >= self._COMM_FOCUS_MIN and comm >= max(others, default=0)

    @property
    def frozen(self) -> bool:
        return self._frozen

    @property
    def current(self):
        """(fusion_bytes, cycle_ms, hier_allreduce, hier_allgather,
        cache_enabled, compression, overlap_bucket_bytes)"""
        return self._current

    def _toggle_coord(self, i: int, v) -> float:
        """Normalized GP coordinate of one toggle value: booleans sit at
        the interval ends; dispatch-mode shift dims at the center of
        their third (stable rounding, like compression)."""
        if self._dispatch_shifts and i < 2:
            return (min(max(int(v), -1), 1) + 1 + 0.5) / 3.0
        return 1.0 if v else 0.0

    def _round_toggles(self, x) -> Tuple:
        out = []
        for i in range(3):
            if not self._tunable[i]:
                out.append(self._initial_toggles[i])
            elif self._dispatch_shifts and i < 2:
                out.append(min(int(float(x[2 + i]) * 3), 2) - 1)
            else:
                out.append(bool(x[2 + i] >= 0.5))
        return tuple(out)

    @classmethod
    def _compression_x(cls, comp: str) -> float:
        """Normalized GP coordinate of a wire format: the center of its
        third (so rounding is stable against GP jitter)."""
        choices = cls.COMPRESSION_CHOICES
        idx = choices.index(comp) if comp in choices else 0
        return (idx + 0.5) / len(choices)

    def _round_compression(self, x) -> str:
        if not self._tune_compression:
            return self._initial_compression
        n = len(self.COMPRESSION_CHOICES)
        idx = min(int(float(x[5]) * n), n - 1)
        return self.COMPRESSION_CHOICES[idx]

    def _overlap_x(self, overlap: int) -> float:
        """Normalized GP coordinate of an overlap bucket size: the
        center of its grid cell (stable rounding, like compression)."""
        choices = self._overlap_choices
        idx = choices.index(overlap) if overlap in choices else 0
        return (idx + 0.5) / len(choices)

    def _round_overlap(self, x) -> int:
        if not self._tune_overlap:
            return self._initial_overlap
        n = len(self._overlap_choices)
        idx = min(int(float(x[6]) * n), n - 1)
        return self._overlap_choices[idx]

    def _propose(self):
        # A re-tune episode is GP territory: the tuner may have frozen
        # before exhausting the bootstrap plan (max_samples below the
        # plan length), and replaying stale pre-drift arms here would
        # bypass the episode's comm focus and mislabel the decision
        # trail as "bootstrap".
        if self._toggle_plan and self._retune_left == 0:
            if self._plan_numeric is None:
                x = self._opt.suggest()
                self._plan_numeric = (int(2 ** x[0]), float(x[1]))
            # Attribution-guided ordering: a comm-bound window pulls the
            # first comm arm (dispatch shift / wire format / bucket
            # size) forward — every arm is still measured exactly once,
            # only the order adapts to where the step's time went.
            idx = 0
            if self._comm_focus():
                idx = next((j for j, (cat, _) in
                            enumerate(self._toggle_plan)
                            if cat == "comm"), 0)
            self._reason = "bootstrap"
            self._current = self._plan_numeric + \
                self._toggle_plan.pop(idx)[1]
        else:
            # Comm focus comes from either live attribution or the drift
            # event that opened a re-tune episode (its dominant
            # component is the evidence even when the window shares are
            # not wired up).
            comm = self._comm_focus() or (
                self._retune_left > 0
                and self._retune_focus == "comm_exposed")
            focus = self._COMM_DIMS if comm else None
            x = self._opt.suggest(focus=focus)
            self._reason = ("retune" if self._retune_left > 0 else
                            ("ei_comm_focus" if focus else "ei"))
            self._current = ((int(2 ** x[0]), float(x[1]))
                             + self._round_toggles(x)
                             + (self._round_compression(x),)
                             + (self._round_overlap(x),))
        if self._pending_reason:
            self._reason = self._pending_reason
            self._pending_reason = None
        self._apply(*self._current)
        self._record_applied()

    def _record_applied(self):
        self._m_decisions.inc()
        self._m_fusion.set(self._current[0])
        self._m_cycle.set(self._current[1])
        # Flight event: autotune decisions were metrics-only, invisible
        # to the drift diagnoser — a regression that starts right after
        # a parameter application should name the tuner as the suspect
        # (debug/regression.py correlates perf.drift onsets against
        # these).
        from .debug import flight as _flight
        # In dispatch mode slots 2/3 are crossover SHIFTS (ints) over
        # the probe-seeded table, not whole-range booleans — record the
        # raw value either way so the drift diagnoser quotes what was
        # actually applied.
        _flight.record(
            "autotune.decision", None,
            fusion_bytes=int(self._current[0]),
            cycle_ms=round(float(self._current[1]), 3),
            hierarchical_allreduce=(int(self._current[2])
                                    if self._dispatch_shifts
                                    else bool(self._current[2])),
            hierarchical_allgather=(int(self._current[3])
                                    if self._dispatch_shifts
                                    else bool(self._current[3])),
            cache_enabled=bool(self._current[4]),
            compression=self._current[5],
            overlap_bucket_bytes=int(self._current[6]),
            frozen=self._frozen,
            # The explainability payload: why THIS proposal — which
            # phase chose it and the attribution vector that motivated
            # the ordering/focus, so a tuning trajectory reads from the
            # flight stream alone.
            reason=self._reason,
            attr=self._last_attr)

    def record_bytes(self, nbytes: int):
        """Feed data-plane traffic; closes a window when enough time passed
        (or, in step-counted mode, after steps_per_sample reports)."""
        if self._frozen:
            return
        self._bytes += int(nbytes)
        now = time.perf_counter()
        elapsed = now - self._window_start
        if self._steps_per_sample > 0:
            self._steps_in_window += 1
            if self._steps_in_window < self._steps_per_sample:
                return
        elif elapsed < self._window:
            return
        if self._window_sync is not None:
            # The window closes on completed device work, not on the
            # host's enqueue clock.
            self._window_sync()
            now = time.perf_counter()
            elapsed = now - self._window_start
        score = self._bytes / max(elapsed, 1e-9)
        self._observe(score)
        self._bytes = 0
        self._steps_in_window = 0
        self._window_start = now

    def _x_of_current(self) -> np.ndarray:
        return np.array(
            [math.log2(self._current[0]), self._current[1]]
            + [self._toggle_coord(i, self._current[2 + i])
               for i in range(3)]
            # De-normalize the categorical coordinates back into their
            # raw [0,1] bounds (observe() re-normalizes; toggle bounds
            # are [0,1] so this is the identity for them too).
            + [self._compression_x(self._current[5]),
               self._overlap_x(self._current[6])])

    def _observe(self, score: float):
        self._refresh_attr()
        if self._warmup_left > 0:
            # Warmup windows (compile/cache-cold noise) are logged but
            # not fed to the GP and do not count toward max_samples.
            # The current proposal stays applied and NO plan entry is
            # consumed — the bootstrap's categorical arms all replay
            # after warmup ends, so discarded windows can never cost
            # bootstrap coverage.
            self._warmup_left -= 1
            self._log(score, tag="warmup")
            return
        if self._retune_left > 0:
            # Bounded drift-triggered episode: score the candidate,
            # remember it, and either propose the next or resolve the
            # episode (accept vs regression-gated rollback).
            self._opt.observe(self._x_of_current(), score)
            self._retune_scores.append((float(score), self._current))
            self._log(score, tag="retune")
            self._retune_left -= 1
            if self._retune_left > 0:
                self._propose()
            else:
                self._finish_retune()
            return
        self._opt.observe(self._x_of_current(), score)
        self._log(score)
        self._samples += 1
        self._m_samples.inc()
        if self._samples >= self._max_samples:
            best_x, best_y = self._opt.best()
            self._current = ((int(2 ** best_x[0]), float(best_x[1]))
                             + tuple(self._round_toggles(best_x))
                             + (self._round_compression(best_x),)
                             + (self._round_overlap(best_x),))
            self._reason = "final"
            self._apply(*self._current)
            self._record_applied()
            self._frozen = True
            self._frozen_score = float(best_y)
            self._m_frozen.set(1)
            self._log(best_y, tag="final")
            self._memory_put()
        else:
            self._propose()

    def _log(self, score: float, tag: str = "sample"):
        # Journal first (always on): the in-memory decision trail the
        # loop status / regression report's tuning section quote.
        self._journal.append({
            "tag": tag, "score": float(score),
            "config": self.config_dict(), "attr": self._last_attr,
            "reason": self._reason})
        if len(self._journal) > 256:
            del self._journal[:64]
        if not self._log_file:
            return
        # Attribution column: ";"-joined k=v (never a comma — the CSV
        # stays 10 naively-splittable columns), "-" when the
        # observatory had nothing for this window.
        attr = "-" if not self._last_attr else ";".join(
            f"{k}={v:.3f}" for k, v in sorted(self._last_attr.items()))
        try:
            with open(self._log_file, "a") as f:
                f.write(f"{tag},{self._current[0]},{self._current[1]:.3f},"
                        f"{int(self._current[2])},{int(self._current[3])},"
                        f"{int(self._current[4])},{self._current[5]},"
                        f"{int(self._current[6])},{score:.1f},{attr}\n")
        except OSError:
            pass

    # -- the closed loop: configs as records, re-tune, rollback, memory ----

    def config_dict(self, config: Optional[tuple] = None) -> dict:
        """One applied config as the named record every surface shares —
        the journal, the tuning-memory store, the flight events and the
        regression report's tuning section all speak this shape."""
        c = config if config is not None else self._current
        shifts = self._dispatch_shifts
        return {
            "fusion_bytes": int(c[0]),
            "cycle_ms": round(float(c[1]), 4),
            "hierarchical_allreduce": int(c[2]) if shifts else bool(c[2]),
            "hierarchical_allgather": int(c[3]) if shifts else bool(c[3]),
            "cache_enabled": bool(c[4]),
            "compression": str(c[5]),
            "overlap_bucket_bytes": int(c[6]),
        }

    def _config_from_dict(self, d: dict) -> tuple:
        """The inverse of :meth:`config_dict`, clamped into this tuner's
        space: pinned dims keep their pinned values (an operator's
        explicit knob outranks a stored record), off-grid categorical
        values fall back to the initials, numerics clamp into BOUNDS."""
        toggles = []
        for i, key in enumerate(("hierarchical_allreduce",
                                 "hierarchical_allgather",
                                 "cache_enabled")):
            if not self._tunable[i]:
                toggles.append(self._initial_toggles[i])
                continue
            v = d.get(key, self._initial_toggles[i])
            if self._dispatch_shifts and i < 2:
                toggles.append(min(max(int(v), -1), 1))
            else:
                toggles.append(bool(v))
        comp = d.get("compression", self._initial_compression)
        if not self._tune_compression or comp not in \
                self.COMPRESSION_CHOICES:
            comp = self._initial_compression
        try:
            ov = int(d.get("overlap_bucket_bytes", self._initial_overlap))
        except (TypeError, ValueError):
            ov = self._initial_overlap
        if not self._tune_overlap or ov not in self._overlap_choices:
            ov = self._initial_overlap
        lo_f, hi_f = 2 ** int(self.BOUNDS[0][0]), 2 ** int(self.BOUNDS[0][1])
        fusion = min(max(int(d.get("fusion_bytes", lo_f)), lo_f), hi_f)
        lo_c, hi_c = self.BOUNDS[1]
        cycle = min(max(float(d.get("cycle_ms", lo_c)), lo_c), hi_c)
        return (fusion, cycle) + tuple(toggles) + (comp, ov)

    def gp_dims(self) -> tuple:
        """Descriptor tuple of the knob space this tuner optimizes over.

        Stored with every tuning-memory record: the GP dimensionality
        has grown twice already (the compression dim, the dispatch
        shift rebase) and a record tuned over a different space must be
        refused, not silently mis-seeded — fleet/tuning.py compares
        these tuples verbatim."""
        hier = "shift3" if self._dispatch_shifts else "bool"
        return ("log2_fusion:20-28", "cycle_ms:0.5-25",
                f"hier_allreduce:{hier}", f"hier_allgather:{hier}",
                "cache:bool",
                "compression:" + "|".join(self.COMPRESSION_CHOICES),
                "overlap:" + "|".join(str(c)
                                      for c in self._overlap_choices))

    def journal(self) -> List[dict]:
        """The decision trail: every scored window's config, score and
        motivating attribution vector (bounded to the recent ~256)."""
        return list(self._journal)

    def loop_status(self) -> dict:
        """What the feedback loop is doing right now — quoted by the
        regression report's ``tuning`` section and ``hvd.debug``."""
        return {
            "frozen": self._frozen,
            "samples": self._samples,
            "retuning": self._retune_left > 0,
            "retune_windows_left": self._retune_left,
            "retunes": self._retunes,
            "rollbacks": self._rollbacks,
            "warm_started": self._warm_started,
            "frozen_score": self._frozen_score,
            "current": self.config_dict(),
            "last_outcome": self._last_outcome,
        }

    def attach_memory(self, store, key: str) -> None:
        """Bind a tuning-memory store: the frozen best (and every
        accepted re-tune) writes back under ``key``."""
        self._memory = store
        self._memory_key = key

    def _memory_put(self) -> None:
        if self._memory is None or not self._memory_key:
            return
        try:
            from .fleet import tuning as _tuning
            self._memory.put(self._memory_key, _tuning.make_record(
                self.config_dict(), score=self._frozen_score,
                dims=self.gp_dims()))
        except Exception as e:  # noqa: BLE001 — memory is best-effort
            from .utils import logging as log
            log.warning("autotune memory: write-back failed: %r", e)

    def warm_start(self, record: dict, source: str = "memory") -> bool:
        """Seed this tuner from a stored tuned config: the bootstrap
        collapses to the seeded combo (the categorical sweep already ran
        on the job that stored it) and the stored score anchors the GP,
        so EI only *refines*.  Only meaningful before any scored sample;
        returns False once tuning started.  Raises ``ValueError`` on a
        knob-space mismatch — callers that reached this point should
        have dim-checked at the store (fleet/tuning.py does)."""
        if self._frozen or self._samples > 0 or self._retune_left > 0:
            return False
        dims = list(record.get("dims") or [])
        if dims != list(self.gp_dims()):
            raise ValueError(
                f"tuned-config record was stored over knob space {dims}, "
                f"but this tuner optimizes {list(self.gp_dims())} — "
                "refusing to mis-seed; delete the stale record or let "
                "the job tune cold")
        t = self._config_from_dict(record.get("config") or {})
        self._initial_toggles = t[2:5]
        self._initial_compression = t[5]
        self._initial_overlap = t[6]
        self._plan_numeric = (t[0], float(t[1]))
        self._toggle_plan = [("base", t[2:7])]
        score = record.get("score")
        if score is not None:
            # The stored score anchors the incumbent for EI (the key
            # fixes model/world/topology, so the bytes/sec scale is the
            # same run-to-run).
            try:
                self._opt.observe(
                    np.array([math.log2(t[0]), t[1]]
                             + [self._toggle_coord(i, t[2 + i])
                                for i in range(3)]
                             + [self._compression_x(t[5]),
                                self._overlap_x(t[6])]), float(score))
            except Exception:  # noqa: BLE001
                pass
        self._warm_started = True
        self._m_warm.inc()
        from .debug import flight as _flight
        _flight.record("autotune.warm_start", self._memory_key,
                       source=source, stored_score=score,
                       config=self.config_dict(t))
        self._pending_reason = "warm_start"
        self._propose()
        return True

    def request_retune(self, reason: str = "drift",
                       windows: Optional[int] = None,
                       focus_component: Optional[str] = None) -> bool:
        """Open a bounded re-tune episode on a frozen tuner (the drift
        plane's entry point, autotune.notify_drift).  ``windows`` sample
        windows are scored (the incumbent first, under the post-drift
        conditions, then GP proposals — comm-focused when
        ``focus_component`` is comm_exposed), after which the episode
        resolves: the best candidate is adopted unless it regresses past
        the pre-drift baseline by HVD_TPU_AUTOTUNE_ROLLBACK_PCT, in
        which case the tuner rolls back to the last-known-good config.
        Returns False when the tuner is still exploring or already in an
        episode."""
        if not self._frozen or self._retune_left > 0:
            return False
        from .core import config as _config
        if windows is None:
            windows = _config.autotune_retune_windows()
        windows = max(1, int(windows))
        self._known_good = self._current
        self._retune_baseline = self._frozen_score
        self._retune_scores = []
        self._retune_left = windows
        self._retune_focus = focus_component
        self._frozen = False
        self._m_frozen.set(0)
        self._retunes += 1
        self._m_retunes.inc()
        # Fresh window accounting: record_bytes early-returned for the
        # whole frozen stretch, so the marks are stale.
        self._bytes = 0
        self._steps_in_window = 0
        self._window_start = time.perf_counter()
        self._reason = "retune_incumbent"
        from .debug import flight as _flight
        _flight.record("autotune.retune", None, reason=reason,
                       windows=windows, focus=focus_component,
                       baseline_score=self._retune_baseline,
                       incumbent=self.config_dict())
        # The incumbent stays applied for the first episode window — a
        # post-drift measurement of the last-known-good config, so the
        # journal shows what the regression actually costs and the GP
        # learns the new level before proposing alternatives.
        return True

    def _finish_retune(self) -> None:
        best_score, best_cfg = max(self._retune_scores,
                                   key=lambda e: e[0])
        from .core import config as _config
        from .debug import flight as _flight
        pct = _config.autotune_rollback_pct()
        baseline = self._retune_baseline
        ratio = (best_score / baseline) if baseline else None
        if ratio is not None:
            self._m_score_ratio.set(ratio)
        rolled = (baseline is not None and self._known_good is not None
                  and best_score < baseline * (1.0 - pct / 100.0))
        if rolled:
            # Regression gate: nothing the episode tried recovers the
            # pre-drift baseline (an external cause, or a genuinely bad
            # direction) — roll back to the journaled last-known-good
            # entry and keep its score as the standing baseline.
            self._current = self._known_good
            self._reason = "rollback"
            self._apply(*self._current)
            self._record_applied()
            self._rollbacks += 1
            self._m_rollbacks.inc()
            _flight.record(
                "autotune.rollback", None,
                best_score=round(best_score, 1),
                baseline_score=round(baseline, 1),
                score_ratio=round(ratio, 4) if ratio else None,
                restored=self.config_dict())
            outcome = "rolled_back"
        else:
            confirmed = best_cfg == self._known_good
            self._current = best_cfg
            self._reason = "retuned"
            self._apply(*self._current)
            self._record_applied()
            self._frozen_score = best_score
            outcome = "confirmed" if confirmed else "accepted"
            self._memory_put()
        self._frozen = True
        self._m_frozen.set(1)
        self._retune_left = 0
        self._last_outcome = {
            "action": "retune", "outcome": outcome,
            "best_score": best_score, "baseline_score": baseline,
            "score_ratio": ratio, "windows": len(self._retune_scores),
            "config": self.config_dict(),
        }
        # The regression diagnoser recognizes the resolution: the last
        # report's ``tuning`` section now records what the loop did
        # about the drift (and the rewritten JSON on disk says so too).
        try:
            from .debug import regression as _regression
            _regression.record_tuning(dict(self._last_outcome))
        except Exception:  # noqa: BLE001 — diagnosis never kills tuning
            pass


# ---------------------------------------------------------------------------
# the process-global loop surface (rank 0 owns the tuner; everywhere
# else these are cheap no-ops)
# ---------------------------------------------------------------------------

def _default_attribution_source():
    """The process-global observatory's window shares (None when the
    observatory is off or has no closed window yet)."""
    from .metrics import attribution as _attr
    if not _attr.enabled():
        return None
    return _attr.attribution().window_shares()


_active_manager: Optional[ParameterManager] = None


def set_active_manager(pm: Optional[ParameterManager]) -> None:
    """Register the live tuner (the native controller's, on rank 0) so
    the drift plane and the tuning memory can reach it.  Pass None to
    clear (tests, shutdown)."""
    global _active_manager
    _active_manager = pm


def active_manager() -> Optional[ParameterManager]:
    return _active_manager


def loop_status() -> Optional[dict]:
    """The active tuner's closed-loop status (None when this process
    owns no tuner) — what the regression report's tuning section and
    hang reports quote."""
    pm = _active_manager
    return pm.loop_status() if pm is not None else None


# Drift suspects the tuner can plausibly act on: its own past decision,
# the dispatch plane it shifts, the overlap scheduler it sizes.  A drift
# whose dominant component is exposed comm is tunable even under a
# non-tunable suspect (net slowdown, no suspect at all): the comm knobs
# exist precisely to trade wire time, and the episode's regression gate
# rolls back when they turn out not to help.
TUNABLE_SUSPECTS = frozenset({"autotune", "dispatch", "overlap"})
TUNABLE_COMPONENTS = frozenset({"comm_exposed"})


def notify_drift(event, report: Optional[dict] = None) -> bool:
    """Close the loop on one confirmed drift: decide whether a bounded
    re-tune episode is warranted, start it, and record the decision in
    the regression report's ``tuning`` section either way.  Called by
    the drift detector (metrics/baseline.py) after the report is built;
    returns True when an episode started."""
    from .core import config as _config
    pm = _active_manager
    suspect = None
    if report:
        s = report.get("suspect") or None
        if s:
            suspect = s.get("subsystem")
    component = getattr(event, "component", None)
    tunable = suspect in TUNABLE_SUSPECTS or component in TUNABLE_COMPONENTS
    action = {"considered": True, "suspect": suspect,
              "component": component}
    started = False
    if pm is None:
        action.update(action="none", why="no active tuner in this process")
    elif not _config.autotune_retune():
        action.update(action="none", why="HVD_TPU_AUTOTUNE_RETUNE=0")
    elif not tunable:
        action.update(
            action="none",
            why=f"suspect {suspect!r} / component {component!r} is not a "
                "tunable subsystem")
    elif not pm.frozen:
        action.update(action="none",
                      why="tuner still exploring (not frozen)")
    else:
        started = pm.request_retune(reason=f"drift:{component}",
                                    focus_component=component)
        action.update(action="retune" if started else "none",
                      outcome="started" if started else "refused")
    try:
        from .debug import regression as _regression
        _regression.record_tuning(action)
    except Exception:  # noqa: BLE001
        pass
    return started


def announce_model(tree=None, fingerprint: Optional[str] = None,
                   world: Optional[int] = None,
                   store=None) -> Optional[str]:
    """Tell the tuning memory what this job trains: computes the
    leaf-spec fingerprint of ``tree`` (the checkpoint fingerprint —
    world-size-invariant), builds the (fingerprint, world, topology)
    memory key, warm-starts the active tuner from a stored record when
    the knob space still matches, and binds the store for freeze-time
    write-back.  Returns the key (None when this process owns no tuner,
    the memory knob is off, or no fingerprint is derivable).  Wired
    automatically into ``TpuState``; call directly from custom loops."""
    pm = _active_manager
    if pm is None:
        return None
    from .core import config as _config
    if not _config.autotune_memory():
        return None
    from .utils import logging as log
    try:
        from .fleet import tuning as _tuning
        if fingerprint is None:
            if tree is None:
                return None
            fingerprint = _tuning.model_fingerprint(tree)
        if world is None:
            from .core.state import global_state
            world = max(int(getattr(global_state, "size", 1) or 1), 1)
        key = _tuning.config_key(fingerprint, world,
                                 _tuning.topology_signature())
        if store is None:
            store = _tuning.resolve_store()
        pm.attach_memory(store, key)
        try:
            rec = store.get(key, dims=pm.gp_dims())
        except _tuning.TuningSchemaMismatch as e:
            # Loud and pointed, never fatal: a stale record must not
            # mis-seed the job, and the job must still train.
            log.error("autotune memory: %s", e)
            from .debug import flight as _flight
            _flight.record("autotune.memory_reject", key, error=str(e))
            return key
        if rec is not None:
            pm.warm_start(rec)
        return key
    except Exception as e:  # noqa: BLE001 — memory is best-effort
        log.warning("autotune memory: announce failed: %r", e)
        return None
