"""Continuous-batching decode engine over a paged KV cache (port of
horovod_tpu/serving/engine.py).

One engine owns one replica's decode slots.  Its step loop is token-level
batch recomposition: every iteration advances queued prefill work within
the chunk budget, advances every decoding slot (one batched
``decode_step``, or one speculative round when a draft model is
attached), and retires finished sequences mid-batch — there is no
static-batch barrier, so a long generation never holds hostage the slots
of its finished neighbors.

Geometry is fixed at construction: ``slots`` decode slots, a page pool of
``page_tokens``-token KV pages, ``max_len`` context per slot.  Admission
changes only tensor contents (page tables, lengths, input tokens), never
shapes.  The reference counts jit traces to prove it (one decode trace
per geometry, one prefill trace per power-of-two page-row bucket); the
port has no trace, so ``decode_traces``, ``prefill_traces`` and
``verify_traces`` count the first call of each shape key the reference's
jit cache keys on: one for decode, ``("target", 1, kq)`` for prompt
chunks, ``("verify", slots, k + 1)`` for verify rounds.  Prompt prefill
runs through ``tfm.decode_verify``; a chunk is padded to its bucket and
the position mask keeps the padding out of every valid context.

Three optional planes share the geometry:

* **radix prefix cache** (``prefix.py``): prompts sharing a prefix attach
  to refcounted cached pages (copy-on-write at the divergence point) and
  prefill only their suffix; retired prompt pages stay cached at
  refcount 0 and are reclaimed LRU-first when the free list runs short —
  ``free_pages()`` counts them as available;
* **chunked prefill**: ``prefill_chunk`` > 0 bounds the prompt tokens
  processed per iteration, so a long prompt interleaves into decode
  iterations instead of stalling every co-batched request's TTFT;
* **speculative decoding** (``speculative.py``): an attached draft
  proposes k tokens per round and one batched ``decode_verify`` scores
  them — greedy acceptance is exact, seeded sampling preserves the
  target distribution.

Slot bookkeeping (page tables, lengths, free lists, the prefix trie)
lives on the host; only the page pools live on the device, updated in
place.  Physical page 0 is the scratch page: unallocated page-table
entries and inactive slots point at it, so their (masked, ignored)
writes land somewhere harmless.  Logits come to the host one needed row
at a time (the prompt's last position; the decoding slots' rows), and
sampling is numpy float64 on the host, as the reference's.

Weight hot-swap: :meth:`swap_params` parks the new tree; it is applied at
the top of the next iteration — between decode steps, never inside one —
and equals constructing a fresh engine from the same tree, because the
engine never transforms params beyond passing them to the model
functions.  A swap flushes the prefix cache (cached K/V is a function of
the params that computed it); the draft does not swap — a stale draft
only lowers the acceptance rate, never correctness.

The reference's ``hvd_serving_*`` metric families and its flight-recorder
events wait for the port's telemetry; until then the engine keeps plain
counters (``stats()``, ``ttft_samples``, ``token_latency_samples``) and
the request plane's ingress counters live in this module
(:func:`record_request`, :func:`record_shed`, :func:`set_queue_depth`,
:func:`plane_counters`).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import config as _config
from ..models import transformer as tfm
from .prefix import RadixPrefixCache
from . import speculative as spec
from . import tracing as _tracing

log = logging.getLogger("horovod_tpu_torch.serving")

#: Samples kept of each latency series (TTFT, per-token).
SAMPLE_CAPACITY = 100_000

_plane_lock = threading.Lock()
_plane = {"requests": {}, "shed": {}, "queue_depth": 0}
#: The newest sheds, (request id, tenant, reason): a shed is loud.
recent_sheds: Deque[Tuple[str, str, str]] = collections.deque(maxlen=256)


def record_request(tenant: str) -> None:
    """Count one request at ingress (HTTP handler or load driver)."""
    with _plane_lock:
        _plane["requests"][tenant] = _plane["requests"].get(tenant, 0) + 1


def record_shed(request_id: str, tenant: str, reason: str) -> None:
    """Count, log and keep one shed request."""
    with _plane_lock:
        _plane["shed"][reason] = _plane["shed"].get(reason, 0) + 1
        recent_sheds.append((request_id, tenant, reason))
    log.warning("serving: shed request %s (tenant %s): %s",
                request_id, tenant, reason)


def set_queue_depth(depth: int) -> None:
    with _plane_lock:
        _plane["queue_depth"] = int(depth)


def plane_counters() -> Dict[str, Any]:
    """Requests by tenant, sheds by reason, the queue depth."""
    with _plane_lock:
        return {"requests": dict(_plane["requests"]),
                "shed": dict(_plane["shed"]),
                "queue_depth": _plane["queue_depth"]}


@dataclasses.dataclass
class Request:
    """One generation request as the engine sees it."""

    id: str
    prompt: List[int]
    max_new_tokens: int = 0        # 0 → HVD_TPU_SERVING_MAX_NEW_TOKENS
    eos_id: Optional[int] = None
    tenant: str = "default"
    priority: int = 0
    deadline_s: float = 0.0        # TTFT SLO; 0 = none
    temperature: float = 0.0       # 0 = greedy
    seed: int = 0
    arrival_mono: float = 0.0      # time.monotonic() at ingress
    submit_seq: int = 0
    # Trace context (tracing.TraceContext) minted at ingress; None =
    # untraced.  Never consulted by the model math.
    trace: Optional[Any] = None

    def pages_needed(self, page_tokens: int) -> int:
        """KV pages reserved at admission: prompt + the full output
        budget — conservative (a short generation frees early at
        retire), but admission can then never deadlock on a page the
        pool cannot produce."""
        return -(-(len(self.prompt) + max(1, self.max_new_tokens))
                 // page_tokens)


@dataclasses.dataclass
class Event:
    """One engine output: a token landing on a request, or its end."""

    request: Request
    kind: str                      # "token" | "finish"
    token: Optional[int] = None
    first: bool = False
    reason: str = ""               # finish: "eos" | "length"
    tokens: Optional[List[int]] = None   # finish: the full output


class _Slot:
    __slots__ = ("request", "generated", "pages", "rng", "prefill_pos",
                 "n_shared", "trie_nodes", "admit_seq", "spec_rng")

    def __init__(self, request: Request, pages: List[int],
                 admit_seq: int = 0):
        self.request = request
        self.generated: List[int] = []
        self.pages = pages
        self.rng = (np.random.default_rng(request.seed)
                    if request.temperature > 0 else None)
        # Independent stream for draft proposal draws: proposals must
        # not perturb the request's own sampling stream.
        self.spec_rng = (np.random.default_rng(request.seed
                                               ^ 0x9E3779B9)
                         if request.temperature > 0 else None)
        self.prefill_pos = 0           # prompt tokens already in KV
        self.n_shared = 0              # leading pages from the trie
        self.trie_nodes: List[Any] = []
        self.admit_seq = admit_seq

    def prefilling(self) -> bool:
        return self.prefill_pos < len(self.request.prompt)


def _bucket_len(tokens: int, page_tokens: int, pages_per_slot: int) -> int:
    """A chunk's padded length: its page rows rounded up to a power of
    two, at most a slot's pages."""
    rows = -(-tokens // page_tokens)
    bucket = 1
    while bucket < rows:
        bucket *= 2
    return min(bucket, pages_per_slot) * page_tokens


class DecodeEngine:
    """Single-threaded by contract: exactly one driver thread calls
    :meth:`admit`/:meth:`step`; :meth:`swap_params` may be called from
    any thread (it only parks the tree under a lock).

    ``params`` is a ``Transformer`` or its tensor tree (``init_params``'
    layout, as ``service.load_params`` returns it); the engine computes
    on the device its ``embed`` lives on."""

    def __init__(self, cfg: tfm.TransformerConfig, params,
                 slots: Optional[int] = None,
                 page_tokens: Optional[int] = None,
                 max_len: Optional[int] = None,
                 total_pages: Optional[int] = None,
                 params_tag: Any = "cold",
                 prefix_cache: Optional[bool] = None,
                 prefill_chunk: Optional[int] = None,
                 draft: Optional[spec.DraftSpec] = None):
        self.cfg = cfg
        # An explicit constructor argument wins over the knob; both are
        # clamped so a garbage value cannot zero-divide the engine.
        self.slots = max(1, int(slots if slots is not None
                                else _config.serving_slots()))
        self.page_tokens = max(1, int(
            page_tokens if page_tokens is not None
            else _config.serving_page_tokens()))
        ml = max_len if max_len is not None else _config.serving_max_len()
        self.max_len = int(ml) if ml else cfg.seq_len
        if self.max_len > cfg.seq_len:
            raise ValueError(
                f"max_len {self.max_len} exceeds the model's positional "
                f"table ({cfg.seq_len})")
        # Rounded DOWN to a page multiple: a partial tail page would
        # make a full prompt's padded prefill extent overrun the
        # positional table.
        self.max_len -= self.max_len % self.page_tokens
        if self.max_len < self.page_tokens:
            raise ValueError(
                f"max_len must be at least one page "
                f"({self.page_tokens} tokens)")
        self.pages_per_slot = self.max_len // self.page_tokens
        n_pages = int(total_pages if total_pages is not None
                      else self.slots * self.pages_per_slot)
        self.total_pages = n_pages
        self.prefill_chunk = max(0, int(
            prefill_chunk if prefill_chunk is not None
            else _config.serving_prefill_chunk()))
        use_cache = (prefix_cache if prefix_cache is not None
                     else _config.serving_prefix_cache())
        self.prefix_cache = (RadixPrefixCache(self.page_tokens)
                             if use_cache else None)
        self.device = tfm._tree(params)["embed"].device
        # Physical page 0 is scratch; real pages are 1..n_pages.
        self._kv = tfm.init_kv_pages(cfg, n_pages + 1, self.page_tokens,
                                     device=self.device)
        self._free_pages: List[int] = list(range(1, n_pages + 1))
        self._page_table = np.zeros((self.slots, self.pages_per_slot),
                                    np.int64)
        self._lengths = np.zeros((self.slots,), np.int64)
        self._slots: List[Optional[_Slot]] = [None] * self.slots
        self._params = params
        self.params_tag = params_tag
        self._pending: Optional[tuple] = None
        self._swap_lock = threading.Lock()
        self._shape_keys: set = set()
        self.decode_traces = 0
        self.prefill_traces = 0
        self.verify_traces = 0
        self.steps = 0
        self.tokens_out = 0
        self.swaps = 0
        self._admit_seq = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._last_evicted = 0       # pages evicted by the last alloc
        # (seconds, trace id or None) of each first token since arrival,
        # and the wall seconds of each decode iteration a token waited.
        self.ttft_samples: Deque[Tuple[float, Optional[str]]] = \
            collections.deque(maxlen=SAMPLE_CAPACITY)
        self.token_latency_samples: Deque[float] = collections.deque(
            maxlen=SAMPLE_CAPACITY)

        # Speculative plane: the draft runs over a parallel page pool
        # with IDENTICAL page indices — the engine's page table and the
        # prefix trie describe both pools at once, so cache hits and
        # COW copies cover the draft's K/V for free.
        self._draft: Optional[spec.DraftSpec] = None
        self._draft_kv = None
        if draft is not None:
            draft = dataclasses.replace(
                draft, k=min(32, max(1, int(draft.k))))
            draft.validate(cfg, self.max_len)
            self._draft = draft
            self._draft_kv = tfm.init_kv_pages(
                draft.cfg, n_pages + 1, self.page_tokens,
                device=self.device)

    # -- capacity ----------------------------------------------------------

    def free_slots(self) -> int:
        return sum(1 for s in self._slots if s is None)

    def free_pages(self) -> int:
        """Pages an admission can claim: the free list PLUS cached
        prefix pages at refcount 0 (evicted LRU-first on demand)."""
        n = len(self._free_pages)
        if self.prefix_cache is not None:
            n += self.prefix_cache.evictable()
        return n

    def active(self) -> int:
        return self.slots - self.free_slots()

    def occupancy(self) -> float:
        return self.active() / self.slots

    def prefill_backlog(self) -> int:
        """Prompt tokens admitted but not yet prefilled — the
        chunked-prefill queue depth."""
        return sum(len(s.request.prompt) - s.prefill_pos
                   for s in self._slots
                   if s is not None and s.prefilling())

    def running_by_tenant(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for s in self._slots:
            if s is not None:
                t = s.request.tenant
                out[t] = out.get(t, 0) + 1
        return out

    # -- weight hot-swap ---------------------------------------------------

    def swap_params(self, params, tag: Any) -> None:
        """Park a new weight tree; applied between decode iterations.
        Its tensors must be ready on the engine's device (the watcher
        finishes its host-to-device copies before it parks)."""
        with self._swap_lock:
            self._pending = (params, tag)

    def maybe_swap(self) -> None:
        """Apply a parked swap now (the serving loop also calls this
        while idle, so a drained replica still advances its weights)."""
        self._maybe_swap()

    def _maybe_swap(self) -> None:
        with self._swap_lock:
            pending, self._pending = self._pending, None
        if pending is None:
            return
        self._params, self.params_tag = pending
        if self.prefix_cache is not None:
            # Cached K/V is a function of the OLD params — flush; pages
            # still pinned by active slots free through release().
            self._free_pages.extend(self.prefix_cache.flush())
        self.swaps += 1
        for s in self._slots:
            if s is not None:
                _tracing.span(s.request.trace, "swap_stall",
                              tag=str(self.params_tag))

    # -- the model calls ---------------------------------------------------

    def _first_call(self, key, counter: Optional[str]) -> None:
        """Count the first call of a shape key (the reference counts the
        jit trace that key costs)."""
        if key not in self._shape_keys:
            self._shape_keys.add(key)
            if counter is not None:
                setattr(self, counter, getattr(self, counter) + 1)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _model(self, which: str):
        """(cfg, params, pool) of the draft or the target."""
        if which == "draft":
            return self._draft.cfg, self._draft.params, self._draft_kv
        return self.cfg, self._params, self._kv

    def _decode(self, which: str, tokens: np.ndarray, lengths: np.ndarray,
                table: np.ndarray) -> torch.Tensor:
        """decode_step on the target (counted in decode_traces) or the
        draft."""
        self._first_call((which, "decode"),
                         "decode_traces" if which == "target" else None)
        cfg, params, kv = self._model(which)
        logits, _ = tfm.decode_step(cfg, params, self._tensor(tokens),
                                    self._tensor(lengths), kv,
                                    self._tensor(table))
        return logits

    def _chunk(self, which: str, tokens: np.ndarray, lengths: np.ndarray,
               table: np.ndarray) -> torch.Tensor:
        """decode_verify on ``which`` model ("target": a prompt chunk,
        counted in prefill_traces; "verify": a batched verify round,
        verify_traces; "draft": the draft's prompt chunk, uncounted)."""
        b, kq = tokens.shape
        counter = {"target": "prefill_traces",
                   "verify": "verify_traces"}.get(which)
        self._first_call((which, b, kq), counter)
        cfg, params, kv = self._model("draft" if which == "draft"
                                      else "target")
        logits, _ = tfm.decode_verify(cfg, params, self._tensor(tokens),
                                      self._tensor(lengths), kv,
                                      self._tensor(table))
        return logits

    @staticmethod
    def _host_rows(logits: torch.Tensor, rows: List[int]) -> np.ndarray:
        """``logits[rows]`` as a host fp32 array: only the rows the
        caller samples from cross to the host."""
        if rows != list(range(logits.shape[0])):
            logits = logits[torch.tensor(rows, device=logits.device)]
        return logits.float().cpu().numpy()

    @staticmethod
    def _copy_rows(kv, src: int, dst: int, r: int) -> None:
        """Copy-on-write: rows [0, r) of page ``src`` into page ``dst``,
        every layer, K and V."""
        for name in ("k", "v"):
            kv[name][:, dst, :r] = kv[name][:, src, :r]

    # -- page allocation ---------------------------------------------------

    def _alloc_pages(self, n: int) -> List[int]:
        """Pop ``n`` pages off the free list, evicting refcount-0
        cached prefix pages (LRU, leaves-first) to cover a shortfall —
        exactly the shortfall, so a hot cache survives admission
        pressure as long as the pool allows."""
        self._last_evicted = 0
        if n <= 0:
            return []
        short = n - len(self._free_pages)
        if short > 0 and self.prefix_cache is not None:
            evicted = self.prefix_cache.evict(short)
            self._last_evicted = len(evicted)
            self._free_pages.extend(evicted)
        if len(self._free_pages) < n:
            raise RuntimeError(
                f"page pool exhausted: need {n}, have "
                f"{len(self._free_pages)}")
        return [self._free_pages.pop(0) for _ in range(n)]

    # -- admission ---------------------------------------------------------

    def admit(self, request: Request) -> List[Event]:
        """Seat a request in a free slot: match its prompt against the
        prefix cache, allocate the non-shared page reservation
        (copy-on-write at a partial-page divergence), and prefill the
        suffix — fully, or up to the chunk budget with the remainder
        interleaving into subsequent :meth:`step` iterations.  The
        first token (the TTFT moment) samples when prefill completes.
        The caller (the serving loop, driven by ``policy.plan``)
        guarantees a slot and pages are free."""
        self._maybe_swap()
        if not request.prompt:
            raise ValueError("empty prompt")
        if not request.max_new_tokens:
            request.max_new_tokens = _config.serving_max_new_tokens()
        need = request.pages_needed(self.page_tokens)
        if need > self.pages_per_slot:
            raise ValueError(
                f"request {request.id}: prompt + output budget "
                f"({len(request.prompt)} + {request.max_new_tokens} "
                f"tokens) exceeds the slot context ({self.max_len})")
        if self.free_slots() == 0 or need > self.free_pages():
            # The policy guarantees capacity before admitting; a caller
            # bypassing it must fail loudly, not corrupt the free list.
            raise RuntimeError(
                f"request {request.id}: no capacity (free slots "
                f"{self.free_slots()}, free pages "
                f"{self.free_pages()} < {need})")
        slot = next(i for i, s in enumerate(self._slots) if s is None)
        plen = len(request.prompt)

        # Prefix match over prompt[:-1]: the LAST prompt position must
        # always recompute — its logits sample the first token.
        matched: List[Any] = []
        partial = None
        if self.prefix_cache is not None:
            matched, partial = self.prefix_cache.match(
                request.prompt[:plen - 1])
            self.prefix_cache.acquire(matched)   # pin before eviction
        m_pages = len(matched)
        try:
            fresh = self._alloc_pages(need - m_pages)
        except RuntimeError:
            if self.prefix_cache is not None and matched:
                self._free_pages.extend(
                    self.prefix_cache.release(matched))
            raise
        pages = [n.page for n in matched] + fresh
        self._page_table[slot, :] = 0
        self._page_table[slot, :need] = pages
        self._lengths[slot] = 0

        self._admit_seq += 1
        st = _Slot(request, pages, admit_seq=self._admit_seq)
        st.n_shared = m_pages
        st.trie_nodes = list(matched)
        start = m_pages * self.page_tokens
        if partial is not None:
            # Copy-on-write at the divergence point: the first r rows
            # of the cached page are valid under this prompt too —
            # copy them into the slot's first fresh page and prefill
            # only from the divergent position.
            node, r = partial
            self._copy_rows(self._kv, node.page, pages[m_pages], r)
            if self._draft is not None:
                self._copy_rows(self._draft_kv, node.page, pages[m_pages],
                                r)
            start += r
        st.prefill_pos = start
        if self.prefix_cache is not None:
            if start > 0:
                self.prefix_cache.hits += 1
                self.prefix_cache.tokens_reused += start
            else:
                self.prefix_cache.misses += 1
        self._slots[slot] = st
        tr = request.trace
        if tr is not None and tr.sampled:
            wait = (time.monotonic() - request.arrival_mono
                    if request.arrival_mono else 0.0)
            _tracing.span(tr, "admit", request=request.id, slot=slot,
                          prompt=plen, pages=need,
                          tenant=request.tenant,
                          queue_wait_s=round(max(0.0, wait), 6))
            _tracing.span(tr, "prefix", hit=start > 0, tokens=start,
                          pages=m_pages, cow=bool(partial),
                          evicted=self._last_evicted)
        events, _ = self._advance_prefill(slot, st, self.prefill_chunk)
        return events

    # -- chunked prefill ---------------------------------------------------

    def _advance_prefill(self, slot: int, st: _Slot, budget: int):
        """Prefill one chunk of ``st``'s remaining prompt (all of it
        when ``budget`` <= 0).  Returns (events, tokens_processed);
        events carry the first sampled token when the prompt
        completes."""
        req = st.request
        plen = len(req.prompt)
        remaining = plen - st.prefill_pos
        take = remaining if budget <= 0 else min(budget, remaining)
        if take <= 0:
            return [], 0
        kq = _bucket_len(take, self.page_tokens, self.pages_per_slot)
        tokens = np.zeros((1, kq), np.int64)
        tokens[0, :take] = req.prompt[st.prefill_pos:st.prefill_pos + take]
        start = np.asarray([st.prefill_pos], np.int64)
        table = self._page_table[slot][None]
        logits = self._chunk("target", tokens, start, table)
        if self._draft is not None:
            self._chunk("draft", tokens, start, table)
        st.prefill_pos += take
        tr = req.trace
        if tr is not None and tr.sampled:
            _tracing.span(tr, "prefill", pos=st.prefill_pos,
                          tokens=take, done=st.prefill_pos >= plen)
        if st.prefill_pos < plen:
            return [], take
        row = logits[0, take - 1].float().cpu().numpy()
        return self._finish_prefill(slot, st, row), take

    def _finish_prefill(self, slot: int, st: _Slot,
                        row: np.ndarray) -> List[Event]:
        req = st.request
        plen = len(req.prompt)
        self._lengths[slot] = plen
        if self.prefix_cache is not None:
            # Hand the full-prompt pages to the trie ONLY now — a
            # half-prefilled page must never be matchable.
            pt = self.page_tokens
            full = plen // pt
            if full > st.n_shared:
                parent = st.trie_nodes[-1] if st.trie_nodes else None
                chunks = [tuple(req.prompt[p * pt:(p + 1) * pt])
                          for p in range(st.n_shared, full)]
                nodes, _dups = self.prefix_cache.insert(
                    parent, chunks, st.pages[st.n_shared:full])
                st.trie_nodes.extend(nodes)
        token = self._sample(st, row)
        if req.arrival_mono:
            tr = req.trace
            self.ttft_samples.append((
                max(0.0, time.monotonic() - req.arrival_mono),
                tr.trace_id if tr is not None and tr.sampled else None))
        return self._deliver(slot, st, token, first=True)

    # -- the continuous-batching iteration ---------------------------------

    def step(self) -> List[Event]:
        """One iteration: advance pending prefill chunks within the
        budget, then every decoding slot by one token (or one
        speculative round).  Returns the token/finish events it
        produced (empty when idle)."""
        self._maybe_swap()
        events: List[Event] = []
        prefilling = sorted(
            ((i, s) for i, s in enumerate(self._slots)
             if s is not None and s.prefilling()),
            key=lambda t: t[1].admit_seq)
        if prefilling:
            budget = self.prefill_chunk
            left = budget if budget > 0 else None
            for i, st in prefilling:
                if left is not None and left <= 0:
                    break
                evs, used = self._advance_prefill(
                    i, st, left if left is not None else 0)
                events.extend(evs)
                if left is not None:
                    left -= used
        active = [(i, s) for i, s in enumerate(self._slots)
                  if s is not None]
        decoding = [(i, s) for i, s in active if not s.prefilling()]
        if not decoding:
            return events
        if self._draft is not None:
            return events + self._spec_round(decoding, len(active))
        t0 = time.perf_counter()
        tokens = np.zeros((self.slots,), np.int64)
        for i, st in decoding:
            tokens[i] = st.generated[-1]
        lengths, table = self._decode_rows(decoding)
        logits = self._decode("target", tokens, lengths, table)
        rows = [i for i, _ in decoding]
        host = self._host_rows(logits, rows)
        wall = time.perf_counter() - t0
        self.steps += 1
        occ = len(active) / self.slots
        for (i, st), row in zip(decoding, host):
            self._lengths[i] += 1
            token = self._sample(st, row)
            self.token_latency_samples.append(wall)
            tr = st.request.trace
            if tr is not None and tr.sampled:
                _tracing.span(tr, "decode",
                              token_index=len(st.generated),
                              occupancy=round(occ, 4),
                              step=self.steps)
            events.extend(self._deliver(i, st, token, first=False))
        return events

    def _decode_rows(self, decoding) -> Tuple[np.ndarray, np.ndarray]:
        """Lengths and page table of a decode call: slots not decoding
        (free, or still prefilling) sit out on scratch rows with length
        0 — the batched math runs, the writes land on page 0, the logits
        are ignored."""
        dec = {i for i, _ in decoding}
        lengths = self._lengths.copy()
        table = self._page_table.copy()
        for i in range(self.slots):
            if i not in dec:
                lengths[i] = 0
                table[i, :] = 0
        return lengths, table

    # -- speculative decoding ----------------------------------------------

    def _spec_round(self, decoding, n_active: int) -> List[Event]:
        """One draft-propose / target-verify round over every decoding
        slot: k+1 draft decode steps (the +1 keeps the draft's own KV
        gapless when every proposal lands) and ONE batched target
        verify.  Each slot emits 1..k+1 tokens."""
        ds = self._draft
        k = ds.k
        n = self.slots
        t0 = time.perf_counter()
        lengths0, table = self._decode_rows(decoding)
        rows = [i for i, _ in decoding]
        tokens = np.zeros((n,), np.int64)
        for i, st in decoding:
            tokens[i] = st.generated[-1]
        d_len = lengths0.copy()
        proposals = np.zeros((n, k), np.int64)
        draft_logits = np.zeros((n, k, self.cfg.vocab_size), np.float32)
        for t in range(k + 1):
            lg = self._decode("draft", tokens, d_len, table)
            if t < k:
                host = self._host_rows(lg, rows)
                for (i, st), row in zip(decoding, host):
                    if st.request.temperature > 0:
                        p = spec.probs(row, st.request.temperature)
                        tok = int(st.spec_rng.choice(len(p), p=p))
                        draft_logits[i, t] = row
                    else:
                        tok = int(np.argmax(row))
                    proposals[i, t] = tok
                    tokens[i] = tok
            d_len = d_len + 1
        vt = np.zeros((n, k + 1), np.int64)
        for i, st in decoding:
            vt[i, 0] = st.generated[-1]
            vt[i, 1:] = proposals[i]
        vl = self._host_rows(self._chunk("verify", vt, lengths0, table),
                             rows)
        wall = time.perf_counter() - t0
        self.steps += 1
        events: List[Event] = []
        for (i, st), target in zip(decoding, vl):
            req = st.request
            props = [int(x) for x in proposals[i]]
            if req.temperature > 0:
                j, nxt = spec.accept_sampled(
                    target, draft_logits[i], props, req.temperature,
                    st.rng)
            else:
                j, nxt = spec.accept_greedy(target, props)
            self._spec_proposed += k
            self._spec_accepted += j
            self.token_latency_samples.append(wall)
            tr = req.trace
            if tr is not None and tr.sampled:
                _tracing.span(tr, "speculate", proposed=k, accepted=j,
                              occupancy=round(n_active / self.slots,
                                              4))
            events.extend(self._deliver_tokens(i, st,
                                               props[:j] + [nxt]))
        return events

    # -- sampling / delivery / retire --------------------------------------

    def _sample(self, st: _Slot, logits: np.ndarray) -> int:
        req = st.request
        if req.temperature > 0:
            z = logits.astype(np.float64) / req.temperature
            z -= z.max()
            p = np.exp(z)
            p /= p.sum()
            token = int(st.rng.choice(len(p), p=p))
        else:
            token = int(np.argmax(logits))
        st.generated.append(token)
        self.tokens_out += 1
        return token

    def _finish(self, slot: int, st: _Slot, token: int
                ) -> Optional[Event]:
        """The finish event if ``token`` ends the request (and retire
        it), else None."""
        req = st.request
        done_eos = req.eos_id is not None and token == req.eos_id
        if not (done_eos or len(st.generated) >= req.max_new_tokens):
            return None
        reason = "eos" if done_eos else "length"
        _tracing.span(req.trace, "finish", reason=reason,
                      tokens=len(st.generated))
        self._retire(slot)
        return Event(req, "finish", reason=reason,
                     tokens=list(st.generated))

    def _deliver(self, slot: int, st: _Slot, token: int,
                 first: bool) -> List[Event]:
        events = [Event(st.request, "token", token=token, first=first)]
        fin = self._finish(slot, st, token)
        return events if fin is None else events + [fin]

    def _deliver_tokens(self, slot: int, st: _Slot,
                        toks: List[int]) -> List[Event]:
        """Deliver a speculative round's accepted run.  The slot's
        length advances one position per delivered token (the last
        token stays unwritten — it is the next round's input, same as
        the single-token path)."""
        events: List[Event] = []
        for t in toks:
            t = int(t)
            st.generated.append(t)
            self.tokens_out += 1
            self._lengths[slot] += 1
            events.append(Event(st.request, "token", token=t, first=False))
            fin = self._finish(slot, st, t)
            if fin is not None:
                events.append(fin)
                break
        return events

    def _retire(self, slot: int) -> None:
        st = self._slots[slot]
        self._slots[slot] = None
        if self.prefix_cache is not None and st.trie_nodes:
            # Shared + inserted prompt pages release THROUGH the trie:
            # refcount 0 keeps them cached for the next prefix hit;
            # only detached (flushed) pages free immediately.
            self._free_pages.extend(
                self.prefix_cache.release(st.trie_nodes))
            owned = {n.page for n in st.trie_nodes}
            self._free_pages.extend(
                p for p in st.pages if p not in owned)
        else:
            self._free_pages.extend(st.pages)
        self._page_table[slot, :] = 0
        self._lengths[slot] = 0

    # -- KV-page export / adopt (the migration's two ends) ------------------

    def export_request(self, request_id: str):
        """Snapshot one fully-prefilled request for another replica:
        (state dict, k_pages, v_pages) — host fp32 copies of every
        written KV page (exact for a bf16 pool too), (n_layers, n_used,
        page_tokens, n_heads, head_dim), plus everything needed to
        resume the decode bit for bit (including the sampling rng
        state).  The slot stays live; call :meth:`release_request` after
        the handoff lands."""
        slot, st = self._find(request_id)
        if st.prefilling():
            raise ValueError(
                f"request {request_id} is still prefilling — migrate "
                "after the prefill completes")
        length = int(self._lengths[slot])
        n_used = -(-length // self.page_tokens)
        phys = torch.tensor(st.pages[:n_used], device=self.device)
        k_pages = self._kv["k"][:, phys].float().cpu().numpy()
        v_pages = self._kv["v"][:, phys].float().cpu().numpy()
        req = st.request
        state = {
            "id": req.id, "prompt": list(req.prompt),
            "max_new_tokens": req.max_new_tokens,
            "eos_id": req.eos_id, "tenant": req.tenant,
            "priority": req.priority, "deadline_s": req.deadline_s,
            "temperature": req.temperature, "seed": req.seed,
            "submit_seq": req.submit_seq,
            "generated": list(st.generated),
            "length": length,
            "rng_state": (st.rng.bit_generator.state
                          if st.rng is not None else None),
            "spec_rng_state": (st.spec_rng.bit_generator.state
                               if st.spec_rng is not None else None),
            "trace": _tracing.to_state(req.trace),
        }
        _tracing.span(req.trace, "migrate_export", length=length,
                      pages=n_used, generated=len(st.generated))
        return state, k_pages, v_pages

    def release_request(self, request_id: str) -> None:
        """Retire a migrated-away request without emitting events (its
        stream continues on the destination replica)."""
        slot, _ = self._find(request_id)
        self._retire(slot)

    def adopt_request(self, state: Dict[str, Any], k_pages, v_pages
                      ) -> None:
        """Seat a migrated request: allocate private pages, write the
        transferred KV into them (numpy or tensors, cast to the pool's
        dtype), and resume decoding from the exact host state the source
        exported.  Adopted pages bypass the prefix trie (only
        locally-prefilled pages are matchable)."""
        req = Request(
            id=state["id"], prompt=list(state["prompt"]),
            max_new_tokens=int(state["max_new_tokens"]),
            eos_id=state.get("eos_id"),
            tenant=state.get("tenant", "default"),
            priority=int(state.get("priority", 0)),
            deadline_s=float(state.get("deadline_s", 0.0)),
            temperature=float(state.get("temperature", 0.0)),
            seed=int(state.get("seed", 0)),
            submit_seq=int(state.get("submit_seq", 0)),
            trace=_tracing.from_state(state.get("trace")))
        need = req.pages_needed(self.page_tokens)
        length = int(state["length"])
        n_used = -(-length // self.page_tokens)
        if k_pages.shape[1] != n_used:
            raise ValueError(
                f"migrated bundle carries {k_pages.shape[1]} pages; "
                f"length {length} needs {n_used}")
        if self.free_slots() == 0 or need > self.free_pages():
            raise RuntimeError(
                f"adopt {req.id}: no capacity (free slots "
                f"{self.free_slots()}, free pages {self.free_pages()} "
                f"< {need})")
        slot = next(i for i, s in enumerate(self._slots) if s is None)
        pages = self._alloc_pages(need)
        self._page_table[slot, :] = 0
        self._page_table[slot, :need] = pages
        self._lengths[slot] = length
        idx = torch.tensor(pages[:n_used], device=self.device)
        for name, value in (("k", k_pages), ("v", v_pages)):
            self._kv[name][:, idx] = torch.as_tensor(value).to(
                self.device, self.cfg.dtype)
        self._admit_seq += 1
        st = _Slot(req, pages, admit_seq=self._admit_seq)
        st.prefill_pos = len(req.prompt)
        st.generated = [int(t) for t in state["generated"]]
        if st.rng is not None and state.get("rng_state") is not None:
            st.rng.bit_generator.state = state["rng_state"]
        if (st.spec_rng is not None
                and state.get("spec_rng_state") is not None):
            st.spec_rng.bit_generator.state = state["spec_rng_state"]
        self._slots[slot] = st
        if self._draft is not None:
            # The bundle carries only the TARGET's pages; rebuild the
            # draft's K/V locally with one chunk forward over every
            # written position (cheap — the draft is small).
            seq = list(req.prompt) + st.generated[:-1]
            kq = _bucket_len(length, self.page_tokens, self.pages_per_slot)
            toks = np.zeros((1, kq), np.int64)
            toks[0, :length] = seq[:length]
            self._chunk("draft", toks, np.zeros((1,), np.int64),
                        self._page_table[slot][None])
        _tracing.span(req.trace, "migrate_adopt", slot=slot,
                      length=length, generated=len(st.generated))

    def _find(self, request_id: str):
        for i, s in enumerate(self._slots):
            if s is not None and s.request.id == request_id:
                return i, s
        raise KeyError(f"request {request_id} holds no slot")

    # -- introspection -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        out = {
            "slots": self.slots,
            "active": self.active(),
            "free_pages": self.free_pages(),
            "page_tokens": self.page_tokens,
            "max_len": self.max_len,
            "occupancy": round(self.occupancy(), 4),
            "decode_traces": self.decode_traces,
            "prefill_traces": self.prefill_traces,
            "verify_traces": self.verify_traces,
            "steps": self.steps,
            "tokens_out": self.tokens_out,
            "params_tag": self.params_tag,
            "prefill_chunk": self.prefill_chunk,
            "prefill_backlog": self.prefill_backlog(),
            "swaps": self.swaps,
            "trace_spans": len(_tracing.spans()),
        }
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
        if self._draft is not None:
            prop = self._spec_proposed
            out["speculative"] = {
                "k": self._draft.k,
                "proposed": prop,
                "accepted": self._spec_accepted,
                "acceptance_rate": (round(self._spec_accepted / prop, 4)
                                    if prop else 0.0),
            }
        return out
