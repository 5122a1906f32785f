"""Serving plane — continuous-batching inference of the flagship
transformer (port of horovod_tpu/serving/).

One replica is

* a **decode engine** (``engine.py``): prefill/decode split over the
  flagship transformer (``models/transformer.py``) with a paged per-slot
  KV cache and a token-level continuous-batching step loop — finished
  sequences retire mid-batch, new requests admit into the freed slots
  next iteration, and admission never changes a shape;
* a **request plane** (``server.py`` + ``policy.py``): HMAC-gated
  ``POST /serve/generate`` with streaming token responses, a bounded
  admission queue, and a pure deterministic admission policy (priority,
  per-tenant fair share, deadline-aware ordering, page-reservation aging,
  loud shed-on-overload);
* the **train→serve loop** (``service.py``): weights cold-load from a
  committed training checkpoint over the checkpoint engine's streaming
  read path, and a watcher hot-swaps newer committed steps between
  decode iterations, equal to a cold load;
* a **radix prefix cache** (``prefix.py``), **chunked prefill** and
  **speculative decoding** (``speculative.py``) on the same geometry,
  each exact under greedy decoding;
* request **tracing** (``tracing.py``) and per-tenant **SLO error
  budgets** (``slo.py``), which feed the policy.

Load client: ``python -m horovod_tpu_torch.serving.submit``.

Not ported yet: the KV-page transport between replicas (the reference's
``disagg``: ``send``/``receive``/``migrate`` and the bundle codec) waits
for the recovery transport; the autoscaler (``Autoscaler``,
``desired_np``) for the elastic driver's resize; the fleet's service job
kind for the fleet; the ``hvd_serving_*``/``hvd_slo_*`` metric families
and ``trace.*`` flight events for the port's telemetry (plain counters
stand in); expert-parallel placement of MoE serving weights.
"""

from .engine import DecodeEngine, Event, Request
from .loadgen import drive, synthetic_workload
from .policy import RequestView, plan
from .prefix import RadixPrefixCache
from .server import ServingServer
from .service import (CheckpointWatcher, ServingService, load_params,
                      save_params)
from .slo import SloTracker, budget_remaining, burn_rate
from .speculative import DraftSpec
from .tracing import TraceContext, mint, parse_header, span

__all__ = [
    "DecodeEngine", "Event", "Request",
    "drive", "synthetic_workload",
    "RequestView", "plan",
    "RadixPrefixCache",
    "ServingServer",
    "CheckpointWatcher", "ServingService", "load_params", "save_params",
    "SloTracker", "budget_remaining", "burn_rate",
    "DraftSpec",
    "TraceContext", "mint", "parse_header", "span",
]
