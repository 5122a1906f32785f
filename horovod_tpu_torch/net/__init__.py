"""``hvd.net`` — the self-healing wire fabric's shared resilience layer
(port of horovod_tpu/net/).

Every cross-host channel climbs one failure-escalation ladder before a
fault may cost an elastic reset:

1. **Per-attempt deadlines and bounded jittered-backoff retries** —
   :func:`retry_call` / :func:`request_bytes` for the Python HTTP planes
   (the rendezvous KV, the replica transport).
2. **Reconnect and resume** — the native TCP mesh (``native/src/net.cc``)
   frames every transfer with sequence numbers and acknowledgements; a
   broken connection re-establishes through the pair's listeners and
   retransmits from the last delivered frame.
3. **Ring re-negotiation** — when reconnecting is exhausted, the
   coordinator agrees the dead link and re-forms the ring without it.
4. **Elastic reset** — only then does the error surface.

The seeded wire-chaos plane (``HVD_TPU_CHAOS_NET_*``) drills every rung,
in the native socket layer and in these HTTP transports, and the
``hvd_net_{retries,reconnects,renegotiations,resets_avoided}_total``
families and ``net.*`` flight events observe them; :func:`status` tells
"retrying, deadline not yet reached" from no recent recovery.
"""

from __future__ import annotations

from typing import Optional

from .chaos import (ChaosNetFault, ChaosNetReset, NetChaos, net_chaos,
                    reset_net_chaos)
from .native import (native_counters, reset_sync_state, status,
                     sync_native_metrics)
from .retry import DeadlineExceeded, Policy, poll_kv, retry_call

__all__ = [
    "ChaosNetFault", "ChaosNetReset", "DeadlineExceeded", "NetChaos",
    "Policy", "native_counters", "net_chaos", "poll_kv", "request_bytes",
    "reset_net_chaos", "reset_sync_state", "retry_call", "status",
    "sync_native_metrics",
]


def request_bytes(req, *, timeout: float = 5.0,
                  policy: Optional[Policy] = None,
                  name: str = "http") -> bytes:
    """Perform one ``urllib.request.Request`` under rung 1: chaos
    injection, a per-attempt timeout and bounded jittered retries;
    returns the response body.  ``HTTPError`` propagates un-retried (a
    403 or 404 is an answer, not a transient fault); transport-level
    ``OSError``/``URLError`` and a truncated response consume
    attempts."""
    import urllib.error
    import urllib.request

    chaos = net_chaos()

    def attempt() -> bytes:
        chaos.before_request(name)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                body = resp.read()
                length = resp.headers.get("Content-Length")
        except urllib.error.HTTPError:
            raise  # an answer: the URLError clause below must not eat it
        except urllib.error.URLError as e:
            # urllib wraps socket errors; unify on OSError for retry_on.
            raise OSError(f"transport failure: {e.reason}") from e
        body, truncated = chaos.mangle_response(name, body)
        if truncated or (length is not None
                         and len(body) != int(length)):
            raise OSError(
                f"truncated response ({len(body)} bytes of {length})")
        return body

    return retry_call(attempt, policy=policy, name=name,
                      retry_on=(OSError,),
                      raise_on=(urllib.error.HTTPError,))
