"""Disaggregated prefill/decode — KV-page migration between replicas
(port of horovod_tpu/serving/disagg.py).

Prefill is compute-bound (one big chunked forward per prompt); decode
is latency-bound (one small forward per token, forever).  Colocating
them makes every long prompt a decode stall.  This module splits the
two across replica pools: a PREFILL replica admits the prompt, runs
the prefill to completion, then exports the request — every written KV
page plus the exact host decode state (generated tokens, lengths, the
sampling rng's bit-generator state) — and hands it to a DECODE replica,
which adopts it and resumes token-for-token as if it had prefilled
locally.

The wire is the recovery transport's one-shot mailbox
(``recovery/transport.py`` ``/recovery/kv/<key>``: signed requests, the
hvd.net retry ladder, bounded server-side storage), and pages ride it
block-scaled int8-quantized by default via ``ops/quantization.py``
(~3.9x smaller than fp32; ``SERVING_MIGRATE_BITS=0`` selects the raw
fp32 wire, on which the migrated decode resumes exactly).  A sha256 over
the payloads rides the header: a torn or corrupted bundle fails loudly
at decode, never adopts silently.

The bundle is byte for byte the reference's (the same header fields in
the same order, the same four sections), so a bundle written by either
package decodes in the other.  In-process (:func:`migrate`) and
over-the-wire (:func:`send` / :func:`receive`) paths share
:func:`encode_bundle`/:func:`decode_bundle`.
"""

from __future__ import annotations

import hashlib
import json
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..core import config as _config
from ..ops import quantization as Q

_MAGIC = b"HVKV"


def _spec_for(bits: int, block: int = 256) -> Optional[Q.QuantSpec]:
    if bits == 0:
        return None
    return Q.QuantSpec(bits=bits, block=block)


def _metrics():
    from ..metrics.registry import registry
    reg = registry()
    return {
        "bytes": reg.counter(
            "hvd_serving_migrate_bytes_total",
            "KV-migration payload bytes put on the wire"),
        "migrations": reg.counter(
            "hvd_serving_migrations_total",
            "Requests migrated prefill-pool -> decode-pool"),
    }


def encode_bundle(state: Dict[str, Any], k_pages, v_pages,
                  bits: Optional[int] = None) -> bytes:
    """Serialize one exported request: 4-byte magic, u32 header length,
    JSON header (request state, page-tensor shape, quant spec, section
    lengths, sha256 of the payload sections), then the four payload
    sections (K payload, K scales, V payload, V scales).  The pages are
    numpy arrays or tensors, quantized from fp32."""
    if bits is None:
        bits = _config.serving_migrate_bits()
    if bits not in (0, 4, 8):
        raise ValueError(f"migrate bits must be 0, 4 or 8, got {bits}")
    spec = _spec_for(bits)
    kp, ks = Q.encode_pages(np.asarray(k_pages, np.float32), spec)
    vp, vs = Q.encode_pages(np.asarray(v_pages, np.float32), spec)
    digest = hashlib.sha256(kp + ks + vp + vs).hexdigest()
    header = {
        "v": 1,
        "state": state,
        "shape": list(k_pages.shape),
        "bits": bits,
        "block": spec.block if spec else 0,
        "lens": [len(kp), len(ks), len(vp), len(vs)],
        "sha256": digest,
    }
    hb = json.dumps(header).encode()
    return b"".join([_MAGIC, struct.pack(">I", len(hb)), hb,
                     kp, ks, vp, vs])


def decode_bundle(blob: bytes
                  ) -> Tuple[Dict[str, Any], np.ndarray, np.ndarray]:
    """Parse and VERIFY one bundle; raises ValueError on any torn or
    corrupted section.  Returns (state, k_pages fp32, v_pages fp32), the
    pages as numpy arrays."""
    if blob[:4] != _MAGIC:
        raise ValueError("not a KV-migration bundle (bad magic)")
    (hlen,) = struct.unpack(">I", blob[4:8])
    header = json.loads(blob[8:8 + hlen].decode())
    lens = header["lens"]
    off = 8 + hlen
    if len(blob) != off + sum(lens):
        raise ValueError(
            f"torn bundle: {len(blob)} bytes, header promises "
            f"{off + sum(lens)}")
    sections = []
    for n in lens:
        sections.append(blob[off:off + n])
        off += n
    kp, ks, vp, vs = sections
    digest = hashlib.sha256(kp + ks + vp + vs).hexdigest()
    if digest != header["sha256"]:
        raise ValueError("corrupted bundle: payload sha256 mismatch")
    shape = tuple(header["shape"])
    n = int(np.prod(shape)) if shape else 0
    spec = _spec_for(header["bits"], header.get("block") or 256)
    k_pages = Q.decode_pages(kp, ks, spec, n, shape).numpy()
    v_pages = Q.decode_pages(vp, vs, spec, n, shape).numpy()
    return header["state"], k_pages, v_pages


def wire_ratio(bits: int, n: int, block: int = 256) -> float:
    """fp32 bytes / quantized wire bytes for an n-element page tensor
    (the bench discloses this next to the measured tokens/sec)."""
    return (4.0 * n) / Q.page_wire_bytes(n, _spec_for(bits, block))


def migrate(src, request_id: str, dst, bits: Optional[int] = None
            ) -> int:
    """In-process migration: export from ``src``, round-trip the wire
    encoding (the SAME bytes the HTTP path ships — the drill must
    exercise the codec, not a shortcut), adopt into ``dst``, release
    the source slot.  Returns the wire size in bytes."""
    state, k_pages, v_pages = src.export_request(request_id)
    blob = encode_bundle(state, k_pages, v_pages, bits)
    state2, k2, v2 = decode_bundle(blob)
    dst.adopt_request(state2, k2, v2)
    src.release_request(request_id)
    m = _metrics()
    m["bytes"].inc(len(blob))
    m["migrations"].inc()
    _flight(request_id, len(blob), state["length"], state.get("trace"))
    return len(blob)


def send(src, request_id: str, addr: str,
         bits: Optional[int] = None, timeout: float = 10.0) -> int:
    """Export ``request_id`` from ``src`` and PUT its bundle into the
    decode replica's one-shot mailbox at ``addr`` (keyed by request
    id).  Releases the source slot only after the push lands; raises
    on a failed push so the source keeps serving the request."""
    from ..recovery import transport
    state, k_pages, v_pages = src.export_request(request_id)
    blob = encode_bundle(state, k_pages, v_pages, bits)
    if not transport.push_kv(addr, request_id, blob, timeout=timeout):
        raise RuntimeError(
            f"migrate {request_id}: push to {addr} failed — source "
            "slot retained")
    src.release_request(request_id)
    m = _metrics()
    m["bytes"].inc(len(blob))
    m["migrations"].inc()
    _flight(request_id, len(blob), state["length"], state.get("trace"))
    return len(blob)


def receive(dst, request_id: str, addr: str,
            timeout: float = 10.0) -> bool:
    """Fetch ``request_id``'s bundle from the mailbox at ``addr`` and
    adopt it into ``dst``.  False when the bundle is not (yet) there;
    raises ValueError on a corrupted bundle."""
    from ..recovery import transport
    blob = transport.fetch_kv(addr, request_id, timeout=timeout)
    if blob is None:
        return False
    state, k_pages, v_pages = decode_bundle(blob)
    dst.adopt_request(state, k_pages, v_pages)
    return True


def _flight(request_id: str, nbytes: int, length: int,
            trace_state: Optional[Dict[str, Any]] = None) -> None:
    from ..debug import flight
    from . import tracing as _tracing
    flight.record("serving.migrate", request_id, bytes=nbytes,
                  length=length)
    _tracing.span(_tracing.from_state(trace_state), "migrate",
                  request=request_id, bytes=nbytes, length=length)
