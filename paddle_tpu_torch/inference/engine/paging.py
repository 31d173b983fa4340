"""Block-pool paged KV allocation (host side).

The engine's KV state lives in fixed-size pages drawn from one shared
pool per layer (`[num_pages, kv_heads, page_size, head_dim]` device
arrays owned by the engine).  This module is the HOST allocator over
those pools: which page ids are free, which are live, and how
fragmented the pool is.  It never touches device memory — the engine
applies `defrag()` moves to the device arrays and the per-sequence
page tables.

Page 0 is RESERVED as the scratch page: free batch slots point their
whole page-table row at it, masked/dead writes land in it, and it is
never allocated to a sequence — so a stale table entry can corrupt at
worst the page nobody reads.

Prefix caching: pages carry REFCOUNTS.  `alloc()` grants a
page at refcount 1; `share()` lets a second holder (another sequence,
or the scheduler's radix prefix index) take a reference to the same
physical page, and `free()` only returns a page to the free list when
its last reference drops.  Full committed-prefix pages are immutable
by contract — the engine never writes a page whose content is shared
(copy-on-write happens at the boundary: the partial tail page is
always a private fresh allocation) — so two page tables pointing at
one physical page is safe for the kernel by construction.  The int8
KV tier's scale tables ride next to the pools indexed by the same page
ids, so sharing a page shares its scale rows under the same refcount.
`stats()` reports the physical/logical split (`shared_pages`,
`logical_pages`) so `engine.page_utilization` counts a shared page
ONCE — capacity scales with unique tokens, and the telemetry says so.
"""
from __future__ import annotations

import threading

__all__ = ["PagePool", "OutOfPages", "SCRATCH_PAGE"]

SCRATCH_PAGE = 0


class OutOfPages(RuntimeError):
    """The pool cannot satisfy an allocation — the scheduler's cue to
    evict (or stop admitting) rather than a request failure."""


class PagePool:
    """Free-list allocator over ``num_pages`` fixed-size pages.

    Thread-safe (the engine loop allocates while handler threads
    submit).  Telemetry: `stats()` feeds the `engine.page_utilization`
    gauge; every alloc/free keeps an exact live count so a leak shows
    up as a non-zero `used_pages` after drain — the chaos scenario's
    first assertion.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("PagePool needs >= 2 pages (page 0 is the "
                             "reserved scratch page)")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._lock = threading.Lock()
        # pop() yields ascending ids (1, 2, ...): fresh pools fill from
        # the bottom, which keeps the untouched tail contiguous
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._live = set()
        self._refs = {}            # page -> refcount (live pages only)
        self._peak = 0

    # --- allocation ---------------------------------------------------------
    @property
    def capacity(self) -> int:
        """Allocatable pages (scratch page excluded)."""
        return self.num_pages - 1

    @property
    def used_pages(self) -> int:
        with self._lock:
            return len(self._live)

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    def can_alloc(self, n: int) -> bool:
        with self._lock:
            return len(self._free) >= n

    def alloc(self, n: int) -> list:
        """n page ids, or raise `OutOfPages` (allocation is all-or-
        nothing: a partial grant would leak on the error path)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        with self._lock:
            if len(self._free) < n:
                raise OutOfPages(
                    f"need {n} page(s), {len(self._free)} free of "
                    f"{self.capacity}")
            pages = [self._free.pop() for _ in range(n)]
            self._live.update(pages)
            for p in pages:
                self._refs[p] = 1
            self._peak = max(self._peak, len(self._live))
        return pages

    def share(self, pages) -> list:
        """Take one MORE reference on each live page (prefix-cache page
        sharing): the page now has two holders, and `free()` from either
        leaves it live for the other.  Sharing a dead or scratch page is
        loud — handing out a reference to a page the free list could
        re-grant would alias two sequences onto one page.  Returns the
        pages (int-normalized) for chaining into a page-table list."""
        out = []
        with self._lock:
            for p in pages:
                p = int(p)
                if p == SCRATCH_PAGE:
                    raise ValueError("cannot share the scratch page")
                if p not in self._live:
                    raise ValueError(f"share of dead page {p}")
                self._refs[p] += 1
                out.append(p)
        return out

    def free(self, pages) -> None:
        """Drop one reference per page; a page returns to the pool when
        its LAST reference drops.  Over-frees (a page freed more times
        than it was alloc'd+shared) and scratch-page frees are errors —
        both mean the caller's bookkeeping is corrupt, and silently
        absorbing them would hand one page to two sequences later."""
        with self._lock:
            for p in pages:
                p = int(p)
                if p == SCRATCH_PAGE:
                    raise ValueError("cannot free the scratch page")
                if p not in self._live:
                    raise ValueError(f"double free of page {p}")
                self._refs[p] -= 1
                if self._refs[p] == 0:
                    del self._refs[p]
                    self._live.discard(p)
                    self._free.append(p)

    def refcount(self, page) -> int:
        """Live reference count for one page (0 when free/dead)."""
        with self._lock:
            return self._refs.get(int(page), 0)

    def ref_counts(self) -> dict:
        """Snapshot of every live page's refcount — the chaos leak
        assertion ("zero refcount leak") diffs this against empty."""
        with self._lock:
            return dict(self._refs)

    # --- defrag -------------------------------------------------------------
    def defrag(self) -> dict:
        """Compact live pages into the densest prefix {1..used}.

        Returns ``{src: dst}`` moves (empty when already compact).  The
        caller must apply each move to the device pools (copy page src
        -> dst) and rewrite every page table BEFORE the next decode
        step.  Compaction keeps the pool's touched high-water mark (and
        therefore the working set a future pool resize / snapshot must
        carry) at the live minimum."""
        with self._lock:
            live = sorted(self._live)
            moves = {}
            dst = 1
            for src in live:
                if src != dst:
                    moves[src] = dst
                dst += 1
            if moves:
                n = len(live)
                self._live = set(range(1, n + 1))
                self._free = list(range(self.num_pages - 1, n, -1))
                # refcounts travel with the page: a SHARED page moves
                # exactly once (one physical copy), and every holder's
                # table is rewritten to the same destination
                self._refs = {moves.get(p, p): r
                              for p, r in self._refs.items()}
        return moves

    # --- telemetry ----------------------------------------------------------
    def utilization(self) -> float:
        with self._lock:
            return len(self._live) / max(1, self.capacity)

    def stats(self) -> dict:
        with self._lock:
            shared = sum(1 for r in self._refs.values() if r > 1)
            logical = sum(self._refs.values())
            return {
                "page_size": self.page_size,
                "num_pages": self.num_pages,
                "capacity": self.capacity,
                # `used` counts each physical page ONCE regardless of
                # how many holders reference it (sharing must not
                # inflate utilization/peak); the shared/logical split makes the dedup visible — saved
                # pages = logical_pages - used
                "used": len(self._live),
                "free": len(self._free),
                "shared_pages": shared,
                "logical_pages": logical,
                "peak_used": self._peak,
                "utilization": len(self._live) / max(1, self.capacity),
            }
