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
* request **tracing** (``tracing.py``: ``trace.*`` flight events) and
  per-tenant **SLO error budgets** (``slo.py``), which feed the policy;
  the engine and the request plane count into the ``hvd_serving_*`` and
  ``hvd_slo_*`` metric families.

* **disaggregated prefill/decode** (``disagg.py``): a prefilled
  request's KV pages and host state migrate to another replica in a
  sha256-checked bundle on an fp32, int8 or int4 wire, in process
  (``migrate``) or over the recovery transport's one-shot mailbox
  (``send`` / ``receive``);
* the **autoscaler** (``autoscale.py``): ``desired_np`` from queue
  depth, TTFT and SLO burn, and ``Autoscaler`` driving the elastic
  driver's ``request_resize``.

Load client: ``python -m horovod_tpu_torch.serving.submit``.  On a fleet
gateway a replica is submitted as a ``kind: service`` job (``fleet/``).
"""

from .autoscale import Autoscaler, desired_np
from .disagg import decode_bundle, encode_bundle, migrate, receive, send
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
    "Autoscaler", "desired_np",
    "decode_bundle", "encode_bundle", "migrate", "receive", "send",
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
