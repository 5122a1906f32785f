"""Per-attempt deadlines with bounded jittered-backoff retries (port of
horovod_tpu/net/retry.py): rung 1 of the wire fabric's escalation
ladder, shared by every Python HTTP plane (rendezvous KV, replica
transport).

The jitter is seeded (sha256 of ``(seed, name, attempt)``, the chaos
layers' determinism contract), so a retry schedule replays bit for bit
in drills, while the call sites' distinct names still decorrelate a
fleet of workers polling one rendezvous server.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable, Optional, Tuple, Type


class DeadlineExceeded(TimeoutError):
    """The retry ladder ran out of budget (attempts or deadline)."""


def _jitter(seed: int, name: str, attempt: int) -> float:
    h = hashlib.sha256(f"{seed}:{name}:{attempt}".encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


@dataclasses.dataclass(frozen=True)
class Policy:
    """One retry budget: ``attempts`` tries, each backed off by a
    jittered exponential delay, optionally capped by an overall
    ``deadline_s``."""

    attempts: int = 3
    base_ms: float = 50.0
    max_ms: float = 2000.0
    deadline_s: Optional[float] = None
    seed: int = 0

    @classmethod
    def from_env(cls, deadline_s: Optional[float] = None) -> "Policy":
        from ..core import config as _config
        return cls(attempts=_config.net_http_retries(),
                   base_ms=_config.net_http_backoff_ms(),
                   seed=_config.get_int_or(_config.CHAOS_NET_SEED, 0),
                   deadline_s=deadline_s)

    def backoff_ms(self, attempt: int, name: str = "") -> float:
        """Delay before retry ``attempt`` (1-based): jittered exponential
        in ``[0.5, 1.0] * min(base * 2^(attempt-1), max)``, a pure
        function of (seed, name, attempt)."""
        raw = min(self.base_ms * (2.0 ** max(attempt - 1, 0)), self.max_ms)
        return raw * (0.5 + 0.5 * _jitter(self.seed, name, attempt))


def retry_call(fn: Callable[[], object], *,
               policy: Optional[Policy] = None,
               name: str = "net",
               retry_on: Tuple[Type[BaseException], ...] = (OSError,),
               raise_on: Tuple[Type[BaseException], ...] = (),
               sleep: Callable[[float], None] = time.sleep):
    """Run ``fn`` under the retry ladder.  Exceptions in ``retry_on``
    consume an attempt (with backoff); anything else propagates at once.
    ``raise_on`` names subclasses of ``retry_on`` that still propagate
    un-retried (``urllib.error.HTTPError`` is an ``OSError``, but a 404
    is an answer, not a transport fault).  Raises the last transient
    failure once the budget is spent.  Each retry counts in
    ``hvd_net_retries_total{plane="http"}`` and records a ``net.retry``
    flight event."""
    from ..debug import flight as _flight
    from ..metrics.registry import registry as _registry
    policy = policy or Policy.from_env()
    start = time.monotonic()
    last: Optional[BaseException] = None
    for attempt in range(1, policy.attempts + 1):
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203 — the ladder is the point
            if raise_on and isinstance(e, raise_on):
                raise
            last = e
            if attempt >= policy.attempts:
                break
            delay_s = policy.backoff_ms(attempt, name) / 1e3
            if policy.deadline_s is not None and \
                    time.monotonic() - start + delay_s >= policy.deadline_s:
                break
            _registry().counter(
                "hvd_net_retries_total",
                "Wire-fabric recovery attempts by plane",
                plane="http").inc()
            _flight.record("net.retry", name, attempt=attempt,
                           error=repr(e)[:120],
                           backoff_ms=round(delay_s * 1e3, 1))
            sleep(delay_s)
    assert last is not None
    raise last


def poll_kv(addr: str, scope: str, key: str, *,
            deadline_s: float,
            interval_s: float = 0.1,
            timeout_s: float = 5.0,
            accept: Optional[Callable[[bytes], object]] = None,
            secret: Optional[str] = None):
    """GET ``scope/key`` from the rendezvous KV until ``accept`` (default:
    any body) returns a truthy value, sleeping ``interval_s`` between
    polls, bounded by ``deadline_s``.  Returns the accepted value; raises
    :class:`DeadlineExceeded` at the deadline, ``PermissionError`` when
    the server refuses the signature."""
    from ..runner.rendezvous import http_get
    accept = accept or (lambda b: b)
    deadline = time.monotonic() + deadline_s
    # This loop is the retry ladder: the inner GET runs one attempt, or
    # nested ladders would multiply the caller's deadline.
    single = Policy(attempts=1, seed=Policy.from_env().seed)
    while True:
        blob = http_get(addr, scope, key, timeout=timeout_s,
                        secret=secret, policy=single)
        if blob is not None:
            value = accept(blob)
            if value:
                return value
        if time.monotonic() >= deadline:
            raise DeadlineExceeded(
                f"rendezvous key {scope}/{key} not acceptable within "
                f"{deadline_s:.0f}s")
        time.sleep(interval_s)
