"""Request-scoped tracing for the serving plane (port of
horovod_tpu/serving/tracing.py).

One **trace context** — a 128-bit trace id plus a 64-bit root span id —
is minted at ``POST /serve/generate`` ingress (or accepted from an
``x-hvd-trace`` client header) and rides the request through every stage
it crosses: ingress, plan, admit, prefix, prefill, decode, speculate,
swap_stall, migrate_export, migrate_adopt, finish, shed.  Each stage of
a sampled request records one span.

Sampling is seeded and deterministic: the decision is a pure function of
the trace id and ``HVD_TPU_TRACE_SAMPLE``, so two replicas (or two runs
under the same seed) sample the same requests, and an unsampled request
pays one attribute check per potential span.  A client header's sampled
flag wins over the local rate.  Tracing never touches the model math,
the sampling rngs or the admission order.

The reference records spans as ``trace.<stage>`` events of its flight
recorder; the port has no flight recorder yet, so :func:`span` appends
``(stage, trace_id, span_id, parent, fields)`` to a bounded in-process
list (:func:`spans`, the newest ``SPAN_CAPACITY``), which the engine's
``stats()`` counts.

Knobs: ``HVD_TPU_TRACE_SAMPLE`` (sampled fraction, default 0.01),
``HVD_TPU_TRACE_SEED`` (trace-id derivation seed, default 0).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
from typing import Any, Deque, Dict, List, Optional, Tuple

from ..core import config as _config

#: The propagation header, request AND response side.  Value format:
#: ``<32-hex trace id>-<16-hex span id>-<01|00>`` (sampled flag last).
HEADER = "x-hvd-trace"

_TRACE_HEX = 32      # 128-bit trace id
_SPAN_HEX = 16       # 64-bit span id

#: Spans kept in process (the oldest drop first).
SPAN_CAPACITY = 4096
_spans: Deque[Tuple[str, str, str, str, Dict[str, Any]]] = \
    collections.deque(maxlen=SPAN_CAPACITY)
_spans_lock = threading.Lock()


@dataclasses.dataclass
class TraceContext:
    """One request's trace identity.  ``sampled`` gates every span —
    an unsampled context propagates (ids stay stable across replicas)
    but records nothing."""

    trace_id: str
    span_id: str
    sampled: bool = False

    def header(self) -> str:
        return (f"{self.trace_id}-{self.span_id}-"
                f"{'01' if self.sampled else '00'}")


def sample_rate() -> float:
    """The live ``HVD_TPU_TRACE_SAMPLE`` value, clamped to [0, 1]."""
    return _config.trace_sample()


def trace_seed() -> int:
    return _config.trace_seed()


def derive_trace_id(request_id: str, seed: Optional[int] = None) -> str:
    """Deterministic 128-bit trace id: a hash of (seed, request id).
    Same seed + same id → same trace id on every replica — the
    property the cross-replica stitch and the seeded-sampling
    determinism tests rely on."""
    if seed is None:
        seed = trace_seed()
    h = hashlib.sha256(f"{seed}:{request_id}".encode()).hexdigest()
    return h[:_TRACE_HEX]


def derive_span_id(trace_id: str, stage: str, seq: int = 0) -> str:
    h = hashlib.sha256(f"{trace_id}:{stage}:{seq}".encode()).hexdigest()
    return h[:_SPAN_HEX]


def sampled(trace_id: str, rate: Optional[float] = None) -> bool:
    """Pure sampling decision: the trace id's top 64 bits against the
    rate threshold.  rate=0 samples nothing, rate=1 everything."""
    if rate is None:
        rate = sample_rate()
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    return int(trace_id[:16], 16) < int(rate * float(1 << 64))


def parse_header(value: Optional[str]) -> Optional[TraceContext]:
    """``x-hvd-trace`` value → context; None on anything malformed (a
    bad client header must never 500 the ingress — the request just
    gets a locally-minted context instead)."""
    if not value:
        return None
    parts = value.strip().lower().split("-")
    if len(parts) != 3:
        return None
    tid, sid, flag = parts
    if len(tid) != _TRACE_HEX or len(sid) != _SPAN_HEX \
            or flag not in ("00", "01"):
        return None
    try:
        int(tid, 16), int(sid, 16)
    except ValueError:
        return None
    return TraceContext(trace_id=tid, span_id=sid,
                        sampled=(flag == "01"))


def mint(request_id: str, header: Optional[str] = None,
         rate: Optional[float] = None,
         seed: Optional[int] = None) -> TraceContext:
    """The ingress entry point: honor a client ``x-hvd-trace`` header
    (its sampled flag wins — forced traces need no knob change), else
    derive a deterministic context and apply the seeded sampling
    decision."""
    ctx = parse_header(header)
    if ctx is not None:
        return ctx
    tid = derive_trace_id(request_id, seed=seed)
    return TraceContext(trace_id=tid,
                        span_id=derive_span_id(tid, "root"),
                        sampled=sampled(tid, rate=rate))


def span(ctx: Optional[TraceContext], stage: str, **fields) -> None:
    """Record one span of ``stage`` under the context's trace id.  No-op
    (one None/flag check) when the context is absent or unsampled."""
    if ctx is None or not ctx.sampled:
        return
    with _spans_lock:
        _spans.append((stage, ctx.trace_id,
                       derive_span_id(ctx.trace_id, stage), ctx.span_id,
                       fields))


def spans(trace_id: Optional[str] = None
          ) -> List[Tuple[str, str, str, str, Dict[str, Any]]]:
    """The recorded spans, oldest first: ``(stage, trace_id, span_id,
    parent, fields)``, all of them or one trace's."""
    with _spans_lock:
        out = list(_spans)
    return out if trace_id is None else [s for s in out
                                         if s[1] == trace_id]


def to_state(ctx: Optional[TraceContext]) -> Optional[Dict[str, Any]]:
    """Context → the JSON-safe dict that rides an exported request's
    state (``DecodeEngine.export_request``)."""
    if ctx is None:
        return None
    return {"trace_id": ctx.trace_id, "span_id": ctx.span_id,
            "sampled": bool(ctx.sampled)}


def from_state(d: Optional[Dict[str, Any]]) -> Optional[TraceContext]:
    if not isinstance(d, dict) or not d.get("trace_id"):
        return None
    tid = str(d["trace_id"]).lower()
    try:
        if len(tid) != _TRACE_HEX:
            return None
        int(tid, 16)
    except ValueError:
        # A corrupted wire header must never mint a bogus trace.
        return None
    return TraceContext(trace_id=tid,
                        span_id=str(d.get("span_id") or
                                    derive_span_id(tid, "root")),
                        sampled=bool(d.get("sampled")))
