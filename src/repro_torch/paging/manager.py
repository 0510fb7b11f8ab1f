"""Host-side page-pool bookkeeping for the paged KV cache.

Port of ``repro/paging/manager.py`` (plain numpy / Python; the reference's
package imports jax, so the port keeps its own copy).  The device only sees
the ``(n_lanes, max_pages_per_lane)`` int32 block table and the pools
(``cache.PagedCache``).

Physical page 0 is **reserved as the trash page**: idle lanes still ride
the fixed-shape decode step, and their garbage K/V write is redirected
there (``models/attention._write_page``) — paged lanes write through a
table into pages that may already belong to someone else, so the redirect
is a correctness requirement.

Admission uses *reservations*: a lane reserves its worst-case page count
(prompt + generation budget) up front, but pages materialize only as the
sequence grows, so mid-decode pool exhaustion is impossible while short
requests still reserve few pages.

Pages are refcounted (a lane's allocation holds one reference; a page
returns to the free list when its count reaches zero), the hook the shared
prefix cache of a later slice aliases pages through.  ``defrag`` compacts
the referenced pages onto the lowest physical indices and remaps the
block tables.  Prefix adoption and copy-on-write forks are ROADMAP queue
1, item 6.
"""

from __future__ import annotations

import heapq

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
        # lowest-index-first: deterministic layouts
        self._free: list[int] = list(range(1, n_pages))
        heapq.heapify(self._free)
        self.block_tables = np.zeros((n_lanes, max_pages_per_lane), np.int32)
        self.lane_pages: list[list[int]] = [[] for _ in range(n_lanes)]
        self.lengths = np.zeros((n_lanes,), np.int64)   # valid rows per lane
        self.reserved = np.zeros((n_lanes,), np.int64)  # promised page counts
        # holders per physical page (page 0 is never allocated or counted)
        self.refcount = np.zeros((n_pages,), np.int64)
        # device table out of date? (set by free/growth; admission writes
        # its row together with its pages instead)
        self.dirty = False

    # -- capacity ----------------------------------------------------------
    @property
    def pages_in_use(self) -> int:
        """Physical pages somebody references."""
        return (self.n_pages - 1) - len(self._free)

    @property
    def span(self) -> int:
        """Highest referenced physical page index (0 when the pool is empty)."""
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
    def admit(self, lane: int, reserve_tokens: int) -> None:
        """Reserve worst-case capacity for a lane about to prefill."""
        if self.lane_pages[lane]:
            raise RuntimeError(f"lane {lane} already holds pages")
        need = self.pages_for(reserve_tokens)
        if need > self.max_pages_per_lane:
            raise ValueError(
                f"request needs {need} pages but lanes hold at most "
                f"{self.max_pages_per_lane} (cache_len / page_size)")
        if need > self.available:
            raise RuntimeError(
                f"admitting {need} pages would overcommit the pool "
                f"({self.available} available of {self.n_pages - 1})")
        self.reserved[lane] = need
        self.lengths[lane] = 0

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

    def ensure(self, lane: int, tokens: int) -> list[int]:
        """Allocate pages until the lane covers ``tokens`` rows."""
        need = self.pages_for(tokens) - len(self.lane_pages[lane])
        if need <= 0:
            return []
        self.dirty = True
        return self.alloc(lane, need)

    def set_length(self, lane: int, tokens: int) -> None:
        self.lengths[lane] = tokens

    def advance(self, lanes) -> None:
        """One decode step: each active lane grew by one row."""
        for lane in lanes:
            self.lengths[lane] += 1

    def free_lane(self, lane: int) -> int:
        """Release a lane: ref -1 on every held page; pages nobody else
        holds return to the pool the same step.  Returns pages freed."""
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

    # -- defrag ------------------------------------------------------------
    def defrag(self) -> list[tuple[int, int]]:
        """Compact referenced pages onto the lowest physical indices.

        Returns the ``(src, dst)`` moves the device copy applies
        (``PagedCache.defrag``); the block tables and page lists are
        remapped here.  Afterwards the used set is exactly ``[1,
        pages_in_use]`` and the free list is contiguous above it."""
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
        self._free = list(range(len(used) + 1, self.n_pages))
        heapq.heapify(self._free)
        self.dirty = True
        return moves

    # -- invariants ----------------------------------------------------------
    def invariant_violations(self) -> list[str]:
        """Every bookkeeping inconsistency as a string (empty = consistent):
        refcounts match holders, nothing is both free and referenced, and
        block tables mirror the lane page lists."""
        out: list[str] = []
        if (self.refcount < 0).any():
            out.append("negative refcount")
        holders = np.zeros_like(self.refcount)
        for pages in self.lane_pages:
            for p in pages:
                holders[p] += 1
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
        """Raise on the first inconsistency ``invariant_violations`` finds."""
        bad = self.invariant_violations()
        if bad:
            raise AssertionError(bad[0])
