"""Deterministic fault injection for the recovery drills (port of
horovod_tpu/recovery/chaos.py).

Every injection is a pure function of the knobs, with no wall clock and
no ``random`` state, so every incarnation of every rank derives the same
schedule and a failing drill replays from its seed.

Knobs (``HVD_TPU_CHAOS_*``; inert unless one is set):

* ``CHAOS_SEED`` — the schedule seed; :meth:`Chaos.kill_epoch` draws a
  deterministic kill step from it.
* ``CHAOS_KILL_STEPS`` — ``"rank@step[,rank@step...]"``, consumed by
  :meth:`Chaos.maybe_kill` once a step: the marked rank exits mid-step.
* ``CHAOS_COMMIT_CRASH`` — ``"<point>[@step]"``: a crash inside the
  commit window at a named point (``after_replicate``: replica sent,
  disk not committed; ``pre_manifest``: shards written, manifest not).
  It fires once per process and disarms.
* ``CHAOS_SLOW_PEER_MS`` — latency in the replica transport's handlers.
* ``CHAOS_TORN_RANKS`` — ranks whose buddy copies are corrupted after
  checksumming (a torn transfer; restore must refuse the copy).
"""

from __future__ import annotations

import hashlib
import time
from typing import Dict, Optional, Set, Tuple


class ChaosKill(SystemExit):
    """A scheduled rank kill: a ``SystemExit``, so an uninjected training
    loop dies while a test can catch it."""


class ChaosCrash(RuntimeError):
    """A scheduled commit-window crash."""


def _parse_kills(spec: str) -> Dict[int, Set[int]]:
    """``"rank@step,..."`` → {rank: {steps}}; malformed entries are
    ignored (a typo'd drill knob must not take down a real job)."""
    out: Dict[int, Set[int]] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or "@" not in part:
            continue
        r, _, s = part.partition("@")
        try:
            out.setdefault(int(r), set()).add(int(s))
        except ValueError:
            continue
    return out


def _parse_crash(spec: str) -> Tuple[str, Optional[int]]:
    spec = (spec or "").strip()
    if not spec:
        return "", None
    point, _, step = spec.partition("@")
    try:
        return point, int(step) if step else None
    except ValueError:
        return point, None


class Chaos:
    """One parsed injection schedule.  Tests construct it; the recovery
    tier goes through the env-backed :func:`chaos`."""

    def __init__(self, seed: int = 0, kill_steps: str = "",
                 commit_crash: str = "", slow_peer_ms: float = 0.0,
                 torn_ranks: str = ""):
        self.seed = int(seed)
        self.kills = _parse_kills(kill_steps)
        self.crash_point, self.crash_step = _parse_crash(commit_crash)
        self.slow_peer_ms = float(slow_peer_ms)
        self.torn_ranks = {int(x) for x in torn_ranks.split(",")
                           if x.strip().lstrip("-").isdigit()}
        self._crash_armed = True

    @classmethod
    def from_env(cls) -> "Chaos":
        from ..core import config as C
        return cls(seed=C.get_int_or(C.CHAOS_SEED, 0),
                   kill_steps=C.get_env(C.CHAOS_KILL_STEPS, "") or "",
                   commit_crash=C.get_env(C.CHAOS_COMMIT_CRASH, "") or "",
                   slow_peer_ms=C.get_float(C.CHAOS_SLOW_PEER_MS, 0.0),
                   torn_ranks=C.get_env(C.CHAOS_TORN_RANKS, "") or "")

    @property
    def enabled(self) -> bool:
        return bool(self.kills or self.crash_point or self.torn_ranks
                    or self.slow_peer_ms > 0 or self.seed)

    # -- seeded draws ------------------------------------------------------

    def draw(self, key: str, lo: int, hi: int) -> int:
        """Deterministic integer in ``[lo, hi)`` from ``(seed, key)``."""
        if hi <= lo:
            return int(lo)
        h = hashlib.sha256(f"{self.seed}:{key}".encode()).digest()
        return lo + int.from_bytes(h[:8], "big") % (hi - lo)

    def kill_epoch(self, key: str, lo: int, hi: int) -> int:
        """A seeded kill step for the entity ``key`` (a slot, a rank)
        within a window."""
        return self.draw(f"kill:{key}", lo, hi)

    # -- kill schedule -----------------------------------------------------

    def should_kill(self, rank: int, step: int) -> bool:
        return int(step) in self.kills.get(int(rank), ())

    def maybe_kill(self, rank: int, step: int, hard: bool = False):
        """Raise :class:`ChaosKill` (or ``os._exit(1)`` when ``hard``,
        which no handler absorbs, as a preemption) when the schedule
        marks this (rank, step)."""
        if not self.should_kill(rank, step):
            return
        if hard:
            import os
            os._exit(1)
        raise ChaosKill(f"chaos: scheduled kill of rank {rank} at "
                        f"step {step}")

    # -- commit-window crashes ---------------------------------------------

    def should_crash(self, point: str, step: Optional[int] = None) -> bool:
        if not self._crash_armed or self.crash_point != point:
            return False
        return self.crash_step is None or step is None \
            or int(step) == self.crash_step

    def maybe_crash(self, point: str, step: Optional[int] = None):
        if self.should_crash(point, step):
            self._crash_armed = False
            raise ChaosCrash(f"chaos: scheduled crash at commit point "
                             f"{point!r} (step {step})")

    # -- replication-path injections ---------------------------------------

    def torn(self, rank: int) -> bool:
        """True when ``rank``'s buddy copy is to be corrupted in
        transit."""
        return int(rank) in self.torn_ranks

    def slow_peer(self) -> None:
        if self.slow_peer_ms > 0:
            time.sleep(self.slow_peer_ms / 1e3)


_chaos: Optional[Chaos] = None


def chaos() -> Chaos:
    """The process-wide schedule, parsed from the environment at first
    use."""
    global _chaos
    if _chaos is None:
        _chaos = Chaos.from_env()
    return _chaos


def reset_chaos() -> None:
    """Drop the cached schedule (after a change of the CHAOS_* knobs)."""
    global _chaos
    _chaos = None
