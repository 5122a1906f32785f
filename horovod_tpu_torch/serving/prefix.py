"""Radix prefix cache — prompt-prefix reuse over the paged KV pool (a
copy of horovod_tpu/serving/prefix.py: pure host bookkeeping).

A trie keyed on token-id page-chunks: each node owns ONE physical KV
page whose content is the K/V of one full ``page_tokens``-token chunk
of some previously-prefilled prompt, and the path from the root spells
the exact token prefix that content was computed under (K/V at a
position is a function of every token at or before it, so the page is
reusable only under a bit-identical token prefix — the trie encodes
precisely that).

The cache is pure host bookkeeping over page INDICES; it never touches
the device pool.  The engine (``engine.py``) is the only caller and the
contract is refcount-based:

* :meth:`match` walks the longest full-chunk prefix of a prompt and
  reports a partial-chunk child for copy-on-write at the divergence
  point (the first ``r`` positions of a cached page are valid for any
  prompt sharing the first ``path + r`` tokens — the engine copies
  them into a fresh page and prefills only the divergent suffix);
* :meth:`acquire` pins the matched path (one ref per active slot per
  node) — a pinned page can never be evicted;
* :meth:`insert` hands ownership of freshly-prefilled full-prompt
  pages to the trie (called only AFTER the prefill that fills them
  completes — a half-written page must never be matchable);
* :meth:`release` drops a retiring slot's refs; pages stay cached
  (refcount 0 = evictable, not freed) unless the node was detached by
  a :meth:`flush` — then hitting zero frees the page immediately;
* :meth:`evict` reclaims refcount-0 pages LRU-first, leaves before
  parents (an interior node must outlive its children or the path
  spelling breaks), when the engine's free list runs short.

Refcount invariant: every active slot holds a ref on EVERY node of its
matched path, so ``refs == 0`` on a node implies ``refs == 0`` on its
whole subtree — which is why :meth:`evictable` is a simple count and
why eviction can always peel leaves.

A weight hot-swap calls :meth:`flush`: cached K/V is a function of the
params that computed it, so the index drops atomically; still-pinned
pages free through :meth:`release` as their slots retire.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

_ids = itertools.count(1)


class PrefixNode:
    """One cached full-chunk page.  Identity is the root path."""

    __slots__ = ("chunk", "page", "parent", "children", "refs", "stamp",
                 "detached", "nid")

    def __init__(self, chunk: Optional[Tuple[int, ...]], page: int,
                 parent: Optional["PrefixNode"]):
        self.chunk = chunk
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "PrefixNode"] = {}
        self.refs = 0
        self.stamp = 0
        self.detached = False
        self.nid = next(_ids)


class RadixPrefixCache:
    def __init__(self, page_tokens: int):
        if page_tokens < 1:
            raise ValueError("page_tokens must be >= 1")
        self.page_tokens = int(page_tokens)
        self._root = PrefixNode(None, -1, None)
        self._clock = 0
        self._nodes = 0            # attached, non-root
        # Counters surfaced through engine.stats().
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0
        self.evictions = 0
        self.flushes = 0

    # -- internals ---------------------------------------------------------

    def _touch(self, node: PrefixNode) -> None:
        self._clock += 1
        node.stamp = self._clock

    # -- lookup ------------------------------------------------------------

    def match(self, tokens: Sequence[int]
              ) -> Tuple[List[PrefixNode], Optional[Tuple[PrefixNode, int]]]:
        """Longest cached prefix of ``tokens`` at page granularity.

        Returns ``(path, partial)``: ``path`` is the matched full-chunk
        node chain from the root (its pages hold valid K/V for
        ``tokens[:len(path) * page_tokens]``), and ``partial`` is
        ``(node, r)`` for the child sharing the longest ``r >= 1``
        leading tokens of the NEXT (possibly short) chunk — the
        copy-on-write divergence point — or None.  Pure lookup: no refs
        move (call :meth:`acquire` on the path to pin it)."""
        pt = self.page_tokens
        path: List[PrefixNode] = []
        node = self._root
        i = 0
        while i + pt <= len(tokens):
            child = node.children.get(tuple(tokens[i:i + pt]))
            if child is None:
                break
            path.append(child)
            node = child
            i += pt
        partial: Optional[Tuple[PrefixNode, int]] = None
        tail = tuple(tokens[i:i + pt])
        if tail:
            best_r = 0
            for chunk, child in node.children.items():
                r = 0
                for a, b in zip(tail, chunk):
                    if a != b:
                        break
                    r += 1
                if r > best_r:
                    best_r, partial = r, (child, r)
        return path, partial

    # -- refcount lifecycle ------------------------------------------------

    def acquire(self, nodes: Sequence[PrefixNode]) -> None:
        for n in nodes:
            n.refs += 1
            self._touch(n)

    def insert(self, parent: Optional[PrefixNode],
               chunks: Sequence[Tuple[int, ...]],
               pages: Sequence[int]) -> Tuple[List[PrefixNode], List[int]]:
        """Graft a freshly-prefilled chunk chain under ``parent`` (None
        = root), transferring page ownership to the trie with one ref
        held for the inserting slot.  Returns ``(nodes, duplicates)``:
        ``nodes`` is the slot's full inserted/acquired chain and
        ``duplicates`` the caller-owned pages NOT adopted because an
        identical chunk was already cached (the caller keeps serving
        from its own copy and frees it at retire)."""
        assert len(chunks) == len(pages)
        node = parent if parent is not None else self._root
        out: List[PrefixNode] = []
        dups: List[int] = []
        for chunk, page in zip(chunks, pages):
            chunk = tuple(chunk)
            existing = node.children.get(chunk)
            if existing is not None:
                # Two identical prompts prefilled concurrently: the
                # second finished after the first inserted.  Keep the
                # established node; the caller's page stays private.
                existing.refs += 1
                self._touch(existing)
                dups.append(page)
                node = existing
            else:
                child = PrefixNode(chunk, int(page), node)
                child.refs = 1
                self._touch(child)
                node.children[chunk] = child
                self._nodes += 1
                node = child
            out.append(node)
        return out, dups

    def release(self, nodes: Sequence[PrefixNode]) -> List[int]:
        """Drop one ref per node (a slot retiring).  Returns the pages
        to hand back to the free list NOW: only detached (flushed)
        nodes free on their last ref — attached nodes stay cached at
        refcount 0, reclaimable via :meth:`evict`."""
        freed: List[int] = []
        for n in reversed(list(nodes)):
            if n.refs <= 0:
                raise RuntimeError(
                    f"prefix-cache refcount underflow on page {n.page}")
            n.refs -= 1
            if n.refs == 0 and n.detached:
                freed.append(n.page)
        return freed

    # -- reclaim -----------------------------------------------------------

    def evictable(self) -> int:
        """Pages reclaimable right now = attached nodes at refcount 0
        (the refs-on-every-path-node invariant makes every refs-0
        subtree whole, so this count is exact)."""
        return self._nodes - self._count_pinned(self._root)

    def _count_pinned(self, node: PrefixNode) -> int:
        total = 0
        for c in node.children.values():
            if c.refs > 0:
                total += 1 + self._count_pinned(c)
        return total

    def evict(self, n: int) -> List[int]:
        """Reclaim up to ``n`` refcount-0 pages, oldest-touched leaves
        first (evicting a leaf may expose its parent as the next
        candidate).  Returns the freed page indices."""
        freed: List[int] = []
        while len(freed) < n:
            victim: Optional[PrefixNode] = None
            stack = [self._root]
            while stack:
                node = stack.pop()
                for c in node.children.values():
                    if c.refs > 0:
                        stack.append(c)
                    elif not c.children:
                        if victim is None or c.stamp < victim.stamp:
                            victim = c
                    else:
                        stack.append(c)
            if victim is None:
                break
            del victim.parent.children[victim.chunk]
            self._nodes -= 1
            self.evictions += 1
            freed.append(victim.page)
        return freed

    def flush(self) -> List[int]:
        """Invalidate the whole index (weight hot-swap: cached K/V is
        stale under new params).  Returns immediately-freeable pages;
        pinned pages detach and free through :meth:`release` as their
        slots retire."""
        freed: List[int] = []
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node.refs == 0:
                freed.append(node.page)
            else:
                node.detached = True
        self._root = PrefixNode(None, -1, None)
        self._nodes = 0
        self.flushes += 1
        return freed

    # -- introspection -----------------------------------------------------

    def cached_pages(self) -> int:
        return self._nodes

    def stats(self) -> Dict[str, int]:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hits / total, 4) if total else 0.0,
            "tokens_reused": self.tokens_reused,
            "cached_pages": self._nodes,
            "evictable_pages": self.evictable(),
            "evictions": self.evictions,
            "flushes": self.flushes,
        }
