"""Radix prefix index: page-aligned prompt prefixes -> committed pages.

At serving scale most prompts share prefixes (system prompts, few-shot
templates, multi-turn history).  The page table already admits sharing
— the ragged paged-attention kernel gathers pages per-sequence through
the table, so two sequences pointing at one physical page costs
nothing — and `PagePool` refcounts make the lifetime safe.  What is
missing is the LOOKUP: given a new prompt, which already-committed
pages hold its longest page-aligned prefix?

This index is a radix tree with ONE node per page: a node's key is the
page's exact `page_size`-token content, its value the physical page id
(the index holds its own pool reference on it, taken with
`PagePool.share`).  Matching is by real token values — a poisoned or
stale routing fingerprint can therefore never produce a wrong-token
stream, only a miss.  Committed pages are immutable by construction
(the engine only ever commits FULL prompt pages; the partial tail page
stays private to its sequence), so a cached page's content is a pure
function of the token path that reaches it.

Eviction is LRU over idle leaves: a leaf whose page refcount is 1
(the index is the only holder) frees immediately; leaves referenced by
live sequences are skipped for pool-pressure reclaims.  Removing a
leaf may expose its parent as the next candidate, so deep cold chains
unwind back-to-front.  `max_tokens` bounds the cache (insert reclaims
LRU idle leaves past it); the scheduler calls `evict_idle` as the
reclaim tier BETWEEN FIFO admission and youngest-first recompute
eviction, so idle cache always dies before a live sequence does.

Quantized-KV sidecar: under ``kv_precision='int8'`` the pools hold
int8 + scales, but a warm tail-prefill must attend the prefix at the
SAME precision a cold prefill would (full), or warm and cold streams
diverge beyond reduction-order noise.  Nodes therefore carry an
optional per-layer exact (k, v) page copy captured at commit time
(from the cold prefill's dense buffers, before quantized pack); the
exact tier needs none — the pools themselves are exact.
"""
from __future__ import annotations

import threading
import time

from .paging import PagePool

__all__ = ["PrefixIndex"]


class _Node:
    __slots__ = ("key", "page", "children", "parent", "last_used",
                 "exact")

    def __init__(self, key, page, parent, now, exact=None):
        self.key = key             # tuple of page_size token ids
        self.page = int(page)      # physical page id (index holds a ref)
        self.children = {}         # key tuple -> _Node
        self.parent = parent       # _Node or None (root child)
        self.last_used = now
        self.exact = exact         # optional per-layer (k, v) page copy


class PrefixIndex:
    """Thread-safe; lock order is scheduler -> index -> pool (the index
    never calls back into the scheduler)."""

    def __init__(self, pool: PagePool, max_tokens: int = 0,
                 clock=time.monotonic, on_evict=None):
        self.pool = pool
        self.page_size = int(pool.page_size)
        # 0 = unbounded by tokens (pool pressure still reclaims)
        self.max_tokens = max(0, int(max_tokens))
        self.clock = clock
        self.on_evict = on_evict   # callable(n_pages) -> None
        self._lock = threading.RLock()
        self._children = {}        # root level: key tuple -> _Node
        self._nodes = 0
        self._evicted_pages = 0

    # --- helpers ------------------------------------------------------------
    def _chunks(self, tokens, max_pages):
        ps = self.page_size
        n = min(len(tokens) // ps, max_pages)
        return [tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
                for i in range(n)]

    # --- lookup -------------------------------------------------------------
    def lookup(self, tokens, max_pages: int):
        """Longest cached page-aligned prefix of `tokens`, capped at
        `max_pages` pages (the caller caps so at least one prompt token
        is always left for the tail prefill).  Returns
        ``(shared_tokens, pages, nodes)`` — pages are NOT yet shared
        into the pool; the caller takes its references via
        `PagePool.share` only when it actually admits the sequence.
        Touches `last_used` along the matched path (LRU)."""
        now = self.clock()
        pages, nodes = [], []
        with self._lock:
            level = self._children
            for key in self._chunks(tokens, max_pages):
                node = level.get(key)
                if node is None:
                    break
                node.last_used = now
                pages.append(node.page)
                nodes.append(node)
                level = node.children
        return len(pages) * self.page_size, pages, nodes

    # --- insert -------------------------------------------------------------
    def insert(self, tokens, pages, exact=None) -> int:
        """Commit the full-page prefix of `tokens` backed by `pages`
        (the owning sequence's first ``len(tokens)//page_size`` pages).
        Chunks already present keep the CACHE's canonical page (the
        sequence keeps its private copy — identical content); new
        chunks take a pool reference on the sequence's page.  `exact`
        (optional, int8-KV tier): per-page per-layer exact (k, v)
        copies aligned with `pages`.  Returns the number of NEW pages
        the cache now holds."""
        now = self.clock()
        added = 0
        with self._lock:
            level = self._children
            parent = None
            chunks = self._chunks(tokens, len(pages))
            for i, key in enumerate(chunks):
                node = level.get(key)
                if node is None:
                    page = self.pool.share([pages[i]])[0]
                    node = _Node(key, page, parent, now,
                                 exact=None if exact is None
                                 else exact[i])
                    level[key] = node
                    self._nodes += 1
                    added += 1
                else:
                    node.last_used = now
                parent = node
                level = node.children
            if self.max_tokens:
                over = self._nodes * self.page_size - self.max_tokens
                if over > 0:
                    # the bound reclaims ANY idle leaf, including ones
                    # just inserted (newest-first paths survive via LRU
                    # stamps from this very call)
                    self._evict_idle_locked(
                        -(-over // self.page_size))
        return added

    # --- eviction -----------------------------------------------------------
    def _iter_leaves_locked(self):
        stack = list(self._children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            else:
                yield node

    def _remove_leaf_locked(self, node):  # pt-lint: ok[PT101,PT102] (callers hold _lock)
        level = (self._children if node.parent is None
                 else node.parent.children)
        level.pop(node.key, None)
        self._nodes -= 1
        self.pool.free([node.page])
        self._evicted_pages += 1

    def _evict_idle_locked(self, want_pages: int) -> int:
        # one tree walk builds the idle-leaf heap; evicting a leaf may
        # expose its parent, which joins the heap if idle — O(leaves)
        # + O(log n) per eviction, not a full rescan per page (a large
        # cache reclaim runs under the scheduler's lock)
        import heapq

        heap = [(n.last_used, id(n), n)
                for n in self._iter_leaves_locked()
                if self.pool.refcount(n.page) == 1]
        heapq.heapify(heap)
        freed = 0
        while freed < want_pages and heap:
            _, _, node = heapq.heappop(heap)
            parent = node.parent
            self._remove_leaf_locked(node)
            freed += 1
            if parent is not None and not parent.children \
                    and self.pool.refcount(parent.page) == 1:
                heapq.heappush(
                    heap, (parent.last_used, id(parent), parent))
        if freed and self.on_evict is not None:
            try:
                self.on_evict(freed)
            except Exception:  # pt-lint: ok[PT005]
                pass           # (telemetry fan-out guard: eviction must
                # reclaim pages even when the metrics hook is broken)
        return freed

    def evict_idle(self, want_pages: int = 1) -> int:
        """Reclaim up to `want_pages` refcount-idle cached pages, LRU
        leaves first.  Returns how many pages actually went back to the
        free list — 0 when every cached page is also held by a live
        sequence (nothing reclaimable without hurting live work)."""
        with self._lock:
            return self._evict_idle_locked(max(1, int(want_pages)))

    def clear(self) -> int:
        """Drop EVERY cache reference (regardless of sharing) — used by
        `engine.clear_prefix_cache()` and the chaos drain assertion.
        Pages shared with live sequences stay live under the sequences'
        own references."""
        with self._lock:
            n = 0
            for node in list(self._iter_leaves_locked()):
                # unwind leaf-first so parents become leaves in turn
                while node is not None and not node.children:
                    parent = node.parent
                    self._remove_leaf_locked(node)
                    n += 1
                    node = parent
            return n

    def apply_moves(self, moves: dict) -> None:
        """Rewrite node page ids after a `PagePool.defrag()` — the
        pool remaps its refcounts, the engine remaps live page tables,
        and the index remaps here: one physical copy per page, every
        holder repointed (a shared page moves exactly once)."""
        if not moves:
            return
        with self._lock:
            stack = list(self._children.values())
            while stack:
                node = stack.pop()
                node.page = moves.get(node.page, node.page)
                stack.extend(node.children.values())

    # --- introspection ------------------------------------------------------
    @property
    def nodes(self) -> int:
        with self._lock:
            return self._nodes

    @property
    def cached_tokens(self) -> int:
        with self._lock:
            return self._nodes * self.page_size

    def stats(self) -> dict:
        with self._lock:
            return {
                "nodes": self._nodes,
                "cached_tokens": self._nodes * self.page_size,
                "max_tokens": self.max_tokens,
                "evicted_pages": self._evicted_pages,
            }
