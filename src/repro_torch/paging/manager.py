"""Host-side page-pool bookkeeping for the paged KV cache.

Port of ``repro/paging/manager.py`` (plain numpy / Python; the reference's
package imports jax, so the port keeps its own copy).  The device only sees
the ``(n_lanes, max_pages_per_lane)`` int32 block table and the pools
(``cache.PagedCache``).

Physical page 0 is **reserved as the trash page**: idle lanes still ride
the fixed-shape decode step, and their garbage K/V write is redirected
there (``models/attention._write_page``) -- paged lanes write through a
table into pages that may already belong to someone else, so the redirect
is a correctness requirement.

Admission uses *reservations*: a lane reserves its worst-case page count
(prompt + generation budget) up front, but pages materialize only as the
sequence grows, so mid-decode pool exhaustion is impossible while short
requests still reserve few pages.

Pages are **refcounted** so the shared-prefix cache (``repro_torch/prefix/``)
can alias one physical page into many lanes' block tables: a lane's own
allocation holds one reference, each adopting lane adds one, and the
prefix tree (when it publishes the page) adds one more.  A page returns
to the free list only when its count reaches zero -- so freeing a lane
whose prompt pages live in the tree releases just its private tail.  A
lane must never *write* a page it shares: ``ensure_writable`` (and the
planned forks the engine takes at admission) copy-on-write forks the page
into a private copy first, leaving every other holder aliasing the
original bytes.
"""

from __future__ import annotations

import heapq
from typing import Callable, Sequence

import numpy as np

from repro_torch.configs.base import pages_for

TRASH_PAGE = 0


class PageManager:
    def __init__(self, n_pages: int, page_size: int, n_lanes: int,
                 max_pages_per_lane: int):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the trash page)")
        if page_size < 1 or max_pages_per_lane < 1:
            raise ValueError("page_size and max_pages_per_lane must be >= 1")
        self.n_pages = n_pages
        self.page_size = page_size
        self.n_lanes = n_lanes
        self.max_pages_per_lane = max_pages_per_lane
        # lowest-index-first like the slot scheduler: deterministic layouts
        self._free: list[int] = list(range(1, n_pages))
        heapq.heapify(self._free)
        self.block_tables = np.zeros((n_lanes, max_pages_per_lane), np.int32)
        self.lane_pages: list[list[int]] = [[] for _ in range(n_lanes)]
        self.lengths = np.zeros((n_lanes,), np.int64)   # valid rows per lane
        self.reserved = np.zeros((n_lanes,), np.int64)  # promised page counts
        # holders per physical page: lane references + the prefix tree's
        # (page 0, the trash page, is never allocated and never counted)
        self.refcount = np.zeros((n_pages,), np.int64)
        # tree-held references (subset of refcount), for invariant checks
        self.tree_held = np.zeros((n_pages,), bool)
        # device table out of date? (set by free/growth/adopt/fork/defrag;
        # admission writes its row together with its pages instead)
        self.dirty = False
        # prefix-tree page remap hooks, called with {src: dst} after defrag
        self.remap_listeners: list[Callable[[dict[int, int]], None]] = []

    # -- capacity ----------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        """Physical pages somebody references (lanes and/or the tree)."""
        return (self.n_pages - 1) - len(self._free)

    @property
    def span(self) -> int:
        """Highest referenced physical page index (0 when pool is empty)."""
        used = np.nonzero(self.refcount)[0]
        return int(used.max()) if used.size else 0

    @property
    def outstanding(self) -> int:
        """Pages promised to admitted lanes but not yet materialized."""
        return int(sum(max(int(self.reserved[l]) - len(self.lane_pages[l]), 0)
                       for l in range(self.n_lanes)))

    @property
    def available(self) -> int:
        """Pages an admission may still reserve without risking mid-decode
        exhaustion of already-admitted lanes."""
        return len(self._free) - self.outstanding

    def pages_for(self, tokens: int) -> int:
        return pages_for(tokens, self.page_size)

    def can_admit(self, reserve_tokens: int) -> bool:
        return self.pages_for(reserve_tokens) <= self.available

    # -- lane lifecycle ----------------------------------------------------
    def admit(self, lane: int, reserve_tokens: int,
              adopt_pages: Sequence[int] = (), forks: int = 0) -> None:
        """Reserve worst-case capacity for a lane about to prefill.

        ``adopt_pages`` are shared-prefix pages the lane aliases instead of
        drawing from the pool; ``forks`` is how many of those the admission
        will copy-on-write fork (each fork draws one fresh page).  The
        capacity gate therefore checks the *pool draw*:
        ``pages_for(reserve) - len(adopt_pages) + forks``.
        """
        if self.lane_pages[lane]:
            raise RuntimeError(f"lane {lane} already holds pages")
        need = self.pages_for(reserve_tokens)
        if need > self.max_pages_per_lane:
            raise ValueError(
                f"request needs {need} pages but lanes hold at most "
                f"{self.max_pages_per_lane} (cache_len / page_size)")
        draw = need - len(adopt_pages) + forks
        if draw > self.available:
            raise RuntimeError(
                f"admitting {draw} pages would overcommit the pool "
                f"({self.available} available of {self.n_pages - 1})")
        self.reserved[lane] = need
        self.lengths[lane] = 0
        if adopt_pages:
            self.adopt(lane, adopt_pages)

    def alloc(self, lane: int, n: int = 1) -> list[int]:
        """Materialize ``n`` pages for a lane (within its reservation)."""
        held = self.lane_pages[lane]
        if len(held) + n > self.max_pages_per_lane:
            raise RuntimeError(f"lane {lane} exceeds its block table width")
        if n > len(self._free):
            raise RuntimeError("page pool exhausted (reservation bug?)")
        got = [heapq.heappop(self._free) for _ in range(n)]
        for p in got:
            self.refcount[p] = 1
            self.block_tables[lane, len(held)] = p
            held.append(p)
        return got

    def adopt(self, lane: int, pages: Sequence[int]) -> None:
        """Alias already-referenced ``pages`` into the lane's block table
        (shared-prefix seeding): ref +1 each, no pool draw."""
        held = self.lane_pages[lane]
        if len(held) + len(pages) > self.max_pages_per_lane:
            raise RuntimeError(f"lane {lane} exceeds its block table width")
        for p in pages:
            if self.refcount[p] < 1:
                raise RuntimeError(f"adopting unreferenced page {p}")
            self.refcount[p] += 1
            self.block_tables[lane, len(held)] = p
            held.append(p)
        self.dirty = True

    def ensure(self, lane: int, tokens: int) -> list[int]:
        """Allocate pages until the lane covers ``tokens`` rows."""
        need = self.pages_for(tokens) - len(self.lane_pages[lane])
        if need <= 0:
            return []
        self.dirty = True
        return self.alloc(lane, need)

    def cow_fork(self, lane: int, page_idx: int) -> tuple[int, int]:
        """Copy-on-write fork: replace the lane's shared page at
        ``page_idx`` with a fresh private page.  Returns ``(src, dst)`` —
        the caller copies the device rows (``PagedCache.copy_pages``).
        The source keeps its other holders' references untouched."""
        src = self.lane_pages[lane][page_idx]
        if self.refcount[src] <= 1:
            raise RuntimeError(f"page {src} is not shared; nothing to fork")
        if not self._free:
            raise RuntimeError("page pool exhausted (fork unaccounted?)")
        dst = heapq.heappop(self._free)
        self.refcount[dst] = 1
        self.refcount[src] -= 1
        self.lane_pages[lane][page_idx] = dst
        self.block_tables[lane, page_idx] = dst
        self.dirty = True
        return src, dst

    def ensure_writable(self, lane: int, row: int) -> "tuple[int, int] | None":
        """CoW guard before a lane writes ``row``: if the covering page is
        shared, fork it.  Returns the ``(src, dst)`` copy the caller must
        apply on device, or None (the common case: page private or not yet
        materialized)."""
        idx = row // self.page_size
        held = self.lane_pages[lane]
        if idx >= len(held) or self.refcount[held[idx]] <= 1:
            return None
        return self.cow_fork(lane, idx)

    def ensure_writable_range(self, lane: int, start: int, n: int
                              ) -> "list[tuple[int, int]]":
        """CoW guard before a lane writes rows ``start .. start + n - 1``
        (the speculative verify window): fork every shared page the range
        covers.  Returns the ``(src, dst)`` copies the caller must apply
        on device (empty in the common all-private case)."""
        if n <= 0:
            return []
        held = self.lane_pages[lane]
        moves = []
        first = start // self.page_size
        last = (start + n - 1) // self.page_size
        for idx in range(first, min(last + 1, len(held))):
            if self.refcount[held[idx]] > 1:
                moves.append(self.cow_fork(lane, idx))
        return moves

    def set_length(self, lane: int, tokens: int) -> None:
        self.lengths[lane] = tokens

    def advance(self, lanes) -> None:
        """One decode step: each active lane grew by one row."""
        for lane in lanes:
            self.lengths[lane] += 1

    def free_lane(self, lane: int) -> int:
        """Release a lane: ref -1 on every held page; pages nobody else
        holds (no other lane, not the prefix tree) return to the pool the
        same step.  Returns the number of pages actually freed."""
        pages = self.lane_pages[lane]
        n = 0
        for p in pages:
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                heapq.heappush(self._free, p)
                n += 1
        pages.clear()
        self.block_tables[lane, :] = TRASH_PAGE
        self.lengths[lane] = 0
        self.reserved[lane] = 0
        self.dirty = True
        return n

    # -- prefix-tree references -------------------------------------------
    def tree_ref(self, pages: Sequence[int]) -> None:
        """The prefix tree now references ``pages`` (publish)."""
        for p in pages:
            if self.refcount[p] < 1:
                raise RuntimeError(f"tree publishing unreferenced page {p}")
            if self.tree_held[p]:
                raise RuntimeError(f"tree already holds page {p}")
            self.refcount[p] += 1
            self.tree_held[p] = True

    def tree_unref(self, pages: Sequence[int]) -> int:
        """Tree eviction: drop the tree's reference; pages with no other
        holder return to the pool.  Returns pages actually freed."""
        n = 0
        for p in pages:
            if not self.tree_held[p]:
                raise RuntimeError(f"tree does not hold page {p}")
            self.tree_held[p] = False
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                heapq.heappush(self._free, p)
                n += 1
        return n

    # -- defrag ------------------------------------------------------------
    def defrag(self) -> list[tuple[int, int]]:
        """Compact referenced pages onto the lowest physical indices.

        Returns ``(src, dst)`` moves for the device-side pool copy
        (``PagedCache.defrag`` applies them); block tables are remapped
        here.  Shared pages move ONCE — every lane aliasing a page (and
        the prefix tree, via ``remap_listeners``) is remapped to the same
        destination, so aliasing survives compaction.  After compaction
        the used set is exactly ``[1, pages_in_use]``, so a long-running
        pool's free list stays contiguous no matter the alloc/free
        history.
        """
        used = sorted(int(p) for p in np.nonzero(self.refcount)[0])
        targets = set(range(1, len(used) + 1))
        vacant = sorted(targets - set(used))
        moves: list[tuple[int, int]] = []
        remap = {}
        for p in sorted(used, reverse=True):
            if p in targets:
                continue
            dst = vacant.pop(0)
            remap[p] = dst
            moves.append((p, dst))
        if not moves:
            return []
        for lane, pages in enumerate(self.lane_pages):
            for j, p in enumerate(pages):
                if p in remap:
                    pages[j] = remap[p]
                    self.block_tables[lane, j] = remap[p]
        for src, dst in moves:
            self.refcount[dst] = self.refcount[src]
            self.refcount[src] = 0
            self.tree_held[dst] = self.tree_held[src]
            self.tree_held[src] = False
        for listener in self.remap_listeners:
            listener(remap)
        self._free = list(range(len(used) + 1, self.n_pages))
        heapq.heapify(self._free)
        self.dirty = True
        return moves

    # -- invariants (property tests + the engine's debug mode poke this) ---
    def invariant_violations(self) -> list[str]:
        """Every bookkeeping inconsistency as a human-readable string:
        refcounts must match actual holders, nothing may be simultaneously
        free and referenced, and block tables must mirror the lane page
        lists.  Empty list = pool consistent.  Non-raising so the engine's
        ``debug_invariants`` mode can log the full set as one structured
        event before failing."""
        out: list[str] = []
        if (self.refcount < 0).any():
            out.append("negative refcount")
        holders = np.zeros_like(self.refcount)
        for pages in self.lane_pages:
            for p in pages:
                holders[p] += 1
        holders[self.tree_held] += 1
        if not (holders == self.refcount).all():
            bad = np.nonzero(holders != self.refcount)[0]
            out.append(f"refcount mismatch on pages {bad.tolist()}")
        free = set(self._free)
        if len(free) != len(self._free):
            out.append("duplicate pages on the free list")
        if TRASH_PAGE in free:
            out.append("trash page on the free list")
        referenced = set(int(p) for p in np.nonzero(self.refcount)[0])
        both = free & referenced
        if both:
            out.append(f"pages both free and referenced: {sorted(both)}")
        elif len(free) + len(referenced) != self.n_pages - 1:
            out.append("pages leaked (neither free nor referenced)")
        for lane, pages in enumerate(self.lane_pages):
            if self.block_tables[lane, :len(pages)].tolist() != pages:
                out.append(f"lane {lane} table/page-list mismatch")
        return out

    def check_invariants(self) -> None:
        """Raise on the first inconsistency ``invariant_violations`` finds
        (the property-test surface; unchanged behaviour)."""
        bad = self.invariant_violations()
        if bad:
            raise AssertionError(bad[0])
