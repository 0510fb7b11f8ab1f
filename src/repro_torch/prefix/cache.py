"""Shared-prefix KV cache: the glue between the radix tree and the page
pool.

Port of ``repro/prefix/cache.py`` (stdlib only, copied so that the port imports
nothing of the JAX package).

``PrefixCache`` owns a ``tree.PrefixTree`` and pairs every structural tree
change with the matching refcount operation on the ``paging.PageManager``:

* ``plan``    — longest page-aligned cached prefix for a prompt, shaped
  into the engine's admission decision (which pages to alias, where the
  suffix (re)computation resumes, whether the last shared page must be
  copy-on-write forked first);
* ``publish`` — after a prefill completes, the prompt's *full* pages enter
  the tree (tree ref +1) so later prompts can alias them.  Only
  prefill-written rows are ever published: decode-written rows come from a
  different dispatch graph, so reusing them could break the bitwise
  cold-vs-warm guarantee;
* ``evict_for`` — LRU leaf eviction under pool pressure.  Only nodes whose
  pages no running lane aliases (refcount exactly the tree's own 1) are
  eligible; evicting a shared trunk would free nothing anyway.

Exactness contract (what keeps warm == cold bitwise): shared pages hold
rows written by (chunked) prefill, which this repo already pins down as
bitwise-equal to one-shot prefill; adopting them and resuming the suffix
through the same chunk step therefore reproduces the cold computation
exactly.  int8 pools need one extra structural condition: the chunk step
*attends dequantized pages* while one-shot prefill attends raw bf16 K/V,
so cold and warm admissions must take the SAME path for their graphs to
match.  The engine guarantees this by forcing every admission on an
int8 + prefix pool through the chunk step (any prompt length; see
``ServingEngine._should_chunk_len``), which lifts the old one-page cap:
full-prompt hits CoW-fork the boundary page and resume at the final
prompt token (``allow_fork=True``).  The re-prefilled boundary row
quantizes to the same bytes a cold chunked prefill wrote (row-independent
projections + deterministic quantize), so warm stays bitwise cold.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.prefix.tree import PrefixNode, PrefixTree


@dataclasses.dataclass
class PrefixPlan:
    """One admission's prefix decision (host-side, recomputed cheaply)."""

    pages: list[int]              # physical pages the lane will alias
    match_tokens: int             # len(pages) * page_size
    resume: int                   # first prompt position to (re)compute
    fork_index: Optional[int]     # lane page index to CoW-fork, or None
    nodes: tuple[PrefixNode, ...]  # matched path (LRU touch / evict pin)


class PrefixCache:
    def __init__(self, manager, page_size: int, allow_fork: bool = True):
        self.manager = manager
        self.page_size = page_size
        self.allow_fork = allow_fork
        self.tree = PrefixTree(page_size)
        # bumped on every structural change (publish / evict / remap) so
        # callers can memoize plans: a plan stays valid while the epoch
        # does (node SPLITS don't invalidate — they preserve page chains)
        self.epoch = 0
        # defrag moves physical pages; the tree must follow the remap so
        # shared-page aliasing survives compaction
        manager.remap_listeners.append(self.remap)

    # -- admission side ----------------------------------------------------
    def plan(self, prompt: Sequence[int]) -> Optional[PrefixPlan]:
        """Longest page-aligned cached prefix of ``prompt`` (None = miss).

        A full-prompt hit still needs one forward position (the last
        prompt token's logits seed sampling): with ``allow_fork`` the plan
        keeps every shared page, CoW-forks the one covering the final
        token and resumes at ``prompt_len - 1``; otherwise the last page is
        dropped from the match and a whole page's tokens recompute.
        """
        ps = self.page_size
        pages, path = self.tree.match(prompt)
        if not pages:
            return None
        match = len(pages) * ps
        if match < len(prompt):
            return PrefixPlan(pages=list(pages), match_tokens=match,
                              resume=match, fork_index=None, nodes=path)
        # full-prompt hit (prompt_len is a whole number of pages)
        if self.allow_fork:
            return PrefixPlan(pages=list(pages), match_tokens=match,
                              resume=len(prompt) - 1,
                              fork_index=len(pages) - 1, nodes=path)
        pages = list(pages[:-1])
        if not pages:
            return None
        return PrefixPlan(pages=pages, match_tokens=match - ps,
                          resume=match - ps, fork_index=None, nodes=path)

    def adopt(self, plan: PrefixPlan, lane: int) -> None:
        """Alias the plan's pages into ``lane``'s block table (ref +1 each)
        and refresh the matched path's recency."""
        self.manager.adopt(lane, plan.pages)
        self.tree.touch(plan.nodes)

    # -- publish / evict ---------------------------------------------------
    def publish(self, prompt: Sequence[int], lane_pages: Sequence[int]) -> int:
        """Enter the prompt's full pages into the tree; returns how many
        pages the tree newly references.  Regions the tree already covers
        keep the tree's pages (the lane's duplicates stay lane-owned)."""
        n_full = len(prompt) // self.page_size
        if n_full == 0:
            return 0
        new = self.tree.insert(list(prompt[: n_full * self.page_size]),
                               list(lane_pages[:n_full]))
        if new:
            self.manager.tree_ref(new)
            self.epoch += 1
        return len(new)

    def evict_for(self, n_pages: int,
                  protect: Sequence[PrefixNode] = ()) -> int:
        """LRU-evict tree-only nodes until ``n_pages`` physical pages are
        freed (best effort).  Returns pages actually returned to the pool."""
        ref = self.manager.refcount

        def only_tree(node: PrefixNode) -> bool:
            return all(ref[p] == 1 for p in node.pages)

        released = self.tree.evict(n_pages, only_tree, protect=protect)
        if not released:
            return 0
        self.epoch += 1
        return self.manager.tree_unref(released)

    def remap(self, mapping: dict[int, int]) -> None:
        self.tree.remap(mapping)
        self.epoch += 1

    @property
    def cached_pages(self) -> int:
        return self.tree.total_pages

    @property
    def evictable_pages(self) -> int:
        """Pages eviction could free right now: tree-held with no lane
        aliasing them (refcount exactly the tree's 1).  Upper bound — a
        protected path can pin some of them during one admission gate."""
        mgr = self.manager
        return int((mgr.tree_held & (mgr.refcount == 1)).sum())

    def stats(self) -> dict:
        """Structured snapshot of the tree for the observability layer:
        what's cached, what's reclaimable, and the epoch (plan-memo
        generation) — one dict, JSON-serializable."""
        return {
            "cached_pages": self.cached_pages,
            "evictable_pages": self.evictable_pages,
            "cached_tokens": self.cached_pages * self.page_size,
            "epoch": self.epoch,
        }
