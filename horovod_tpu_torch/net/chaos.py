"""Seeded wire chaos for the Python HTTP planes (port of
horovod_tpu/net/chaos.py).

The native socket layer injects its faults in C (``native/src/net.cc``
``NetChaos``, the same ``HVD_TPU_CHAOS_NET_*`` knobs); this is the HTTP
half, so one drill covers every cross-host channel: the rendezvous KV and
the replica transport.  Every injection is a pure function of (seed,
site key, per-site draw index) through sha256, with no ``random`` state,
so a failing drill replays bit for bit.

Knobs (inert unless set):

* ``HVD_TPU_CHAOS_NET_SEED`` — schedule seed.
* ``HVD_TPU_CHAOS_NET_DROP_PCT`` — the request never reaches the server
  (:class:`ChaosNetFault`, an ``OSError`` the retry ladder treats as any
  transient transport failure).
* ``HVD_TPU_CHAOS_NET_RESET_PCT`` — a simulated connection reset
  (a ``ConnectionResetError``).
* ``HVD_TPU_CHAOS_NET_DELAY_MS`` — latency injected before the request.
* ``HVD_TPU_CHAOS_NET_TRUNCATE`` — the response body is cut in half
  (callers see an invalid payload and retry).
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Dict, Optional, Tuple


class ChaosNetFault(OSError):
    """An injected transport fault (dropped request)."""


class ChaosNetReset(ConnectionResetError):
    """An injected connection reset."""


def _draw(seed: int, key: str, index: int) -> float:
    """Deterministic uniform in [0, 1) from (seed, key, index)."""
    h = hashlib.sha256(f"{seed}:{key}:{index}".encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


@dataclasses.dataclass
class NetChaos:
    """One parsed HTTP-plane injection schedule.  Tests construct it;
    the planes go through the env-backed :func:`net_chaos`."""

    seed: int = 0
    drop_pct: float = 0.0
    reset_pct: float = 0.0
    delay_ms: float = 0.0
    truncate_pct: float = 0.0

    def __post_init__(self):
        self._counters: Dict[str, int] = {}
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls) -> "NetChaos":
        from ..core import config as _config
        return cls(
            seed=_config.get_int_or(_config.CHAOS_NET_SEED, 0),
            drop_pct=_config.get_float(_config.CHAOS_NET_DROP_PCT, 0.0),
            reset_pct=_config.get_float(_config.CHAOS_NET_RESET_PCT, 0.0),
            delay_ms=_config.get_float(_config.CHAOS_NET_DELAY_MS, 0.0),
            truncate_pct=_config.get_float(_config.CHAOS_NET_TRUNCATE,
                                           0.0))

    @property
    def enabled(self) -> bool:
        return (self.drop_pct > 0 or self.reset_pct > 0
                or self.delay_ms > 0 or self.truncate_pct > 0)

    def _next_index(self, key: str) -> int:
        with self._lock:
            n = self._counters.get(key, 0)
            self._counters[key] = n + 1
            return n

    def draw(self, key: str, index: int) -> float:
        """The schedule primitive."""
        return _draw(self.seed, key, index)

    def before_request(self, key: str) -> None:
        """Injection point ahead of one HTTP attempt: raises on a
        scheduled drop or reset, sleeps on a scheduled delay."""
        if not self.enabled:
            return
        n = self._next_index(key)
        if self.delay_ms > 0:
            time.sleep(self.delay_ms / 1e3)
        if self.reset_pct > 0 and \
                _draw(self.seed, key, n * 3 + 1) * 100.0 < self.reset_pct:
            raise ChaosNetReset(
                f"chaos: injected connection reset at {key}#{n}")
        if self.drop_pct > 0 and \
                _draw(self.seed, key, n * 3 + 2) * 100.0 < self.drop_pct:
            raise ChaosNetFault(
                f"chaos: injected request drop at {key}#{n}")

    def mangle_response(self, key: str, body: bytes
                        ) -> Tuple[bytes, bool]:
        """Truncation injection on a response body: (body, truncated)."""
        if self.truncate_pct <= 0 or not body:
            return body, False
        n = self._next_index(key + "#resp")
        if _draw(self.seed, key, n * 3 + 3) * 100.0 < self.truncate_pct:
            return body[: len(body) // 2], True
        return body, False


_chaos: Optional[NetChaos] = None
_chaos_lock = threading.Lock()


def net_chaos() -> NetChaos:
    """The process-wide HTTP-plane schedule, parsed from the environment
    at first use."""
    global _chaos
    with _chaos_lock:
        if _chaos is None:
            _chaos = NetChaos.from_env()
        return _chaos


def reset_net_chaos() -> None:
    """Drop the cached schedule (after a change of the CHAOS_NET_*
    knobs)."""
    global _chaos
    with _chaos_lock:
        _chaos = None
