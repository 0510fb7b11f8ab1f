"""Device-side paged KV cache: page pools + page scatter.

Port of ``repro/paging/cache.py``.  ``PagedCache`` allocates the pool tree
once (``models/model.paged_cache_shapes``): attention KV in global
``(n_pages, page_size, ...)`` pools stacked over periods, plus the
per-lane ``pos`` and the block table.  Host bookkeeping lives in
``manager.PageManager``.

Unlike the reference, whose functional ``.at[].set`` returns new pools,
every write here is **in place**: :func:`paged_insert_many` scatters a
prefill's rows (one lane or a stacked admission's k) into the pools
with ``index_put_``, the chunk and decode steps write their rows the same
way, and ``PagedCache.defrag`` copies moved pages within the pools, so the
pools are allocated once and never copied whole.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, default_page_count, pages_for
from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.models.kvcache import zeros_like_shapes
from repro_torch.paging.manager import PageManager

# paged-pool leaf -> the key holding the same rows in a contiguous prefill cache
_POOL_KEY_MAP = {"kp": "k", "vp": "v", "kp_scale": "k_scale", "vp_scale": "v_scale"}


def _scatter_block(pool_blk, multi_blk, page_ids, stacked: bool, src_row: int):
    """Write batch row ``src_row`` of a contiguous cache into whole pages,
    in place."""
    for pk, leaf in pool_blk.items():
        src = multi_blk[_POOL_KEY_MAP[pk]]
        if stacked:
            rows = src[:, src_row]                            # (periods, S, ...)
            ps = leaf.shape[2]
            rows = rows.reshape((rows.shape[0], rows.shape[1] // ps, ps)
                                + tuple(rows.shape[2:]))
            leaf[:, page_ids] = rows.to(leaf.dtype)
        else:
            rows = src[src_row]                               # (S, ...)
            ps = leaf.shape[1]
            rows = rows.reshape((rows.shape[0] // ps, ps) + tuple(rows.shape[1:]))
            leaf[page_ids] = rows.to(leaf.dtype)


def paged_insert_many(cache, multi, lanes, page_ids, table_rows, new_lens):
    """Scatter a batch=k contiguous prefill cache into k lanes' pages, in
    place: batch row ``i`` lands in lane ``lanes[i]``'s pages
    ``page_ids[i]``, with its ``pos`` ``new_lens[i]`` and block-table row
    ``table_rows[i]``.

    Each row must hold exactly ``len(page_ids[i]) * page_size`` cache rows
    (the engine sizes the admission prefill that way)."""
    dev = cache["pos"].device
    for i, lane in enumerate(lanes):
        ids = torch.as_tensor(page_ids[i], dtype=torch.long, device=dev)
        cache["pos"][lane] = int(new_lens[i])
        cache["block_tables"][lane] = torch.as_tensor(table_rows[i], dtype=torch.int32,
                                                      device=dev)
        for pb, mb in zip(cache["blocks"], multi["blocks"]):
            _scatter_block(pb, mb, ids, stacked=True, src_row=i)
        for pb, mb in zip(cache["tail_blocks"], multi["tail_blocks"]):
            _scatter_block(pb, mb, ids, stacked=False, src_row=i)
    return cache


def paged_insert(cache, single, lane: int, page_ids, table_row, new_len: int):
    """The batch=1 form of :func:`paged_insert_many`."""
    return paged_insert_many(cache, single, [lane], [page_ids], [table_row], [new_len])


def _move_pages(cache, src, dst) -> None:
    """Copy pool pages ``src -> dst`` in every layer, in place (all sources
    are read before any destination is written)."""
    for blk in cache["blocks"]:
        for leaf in blk.values():
            leaf[:, dst] = leaf[:, src]
    for blk in cache["tail_blocks"]:
        for leaf in blk.values():
            leaf[dst] = leaf[src]


class PagedCache:
    """Engine-owned paged pool: ``n_lanes`` block-table rows over
    ``n_pages`` physical pages of ``page_size`` rows each, on ``device``
    (default CUDA)."""

    def __init__(self, cfg: ModelConfig, n_lanes: int, cache_len: int,
                 page_size: int, n_pages: int | None = None, device=None):
        self.device = resolve_device(device)
        self.n_lanes = n_lanes
        self.cache_len = cache_len
        self.page_size = page_size
        self.max_pages = pages_for(cache_len, page_size)
        self.n_pages = (default_page_count(n_lanes, cache_len, page_size)
                        if n_pages is None else n_pages)
        shapes = model_lib.paged_cache_shapes(cfg, n_lanes, cache_len, page_size,
                                              self.n_pages)
        self.cache = zeros_like_shapes(shapes, self.device)
        self.manager = PageManager(self.n_pages, page_size, n_lanes, self.max_pages)

    def insert(self, single_cache, lane: int, page_ids, new_len: int) -> None:
        paged_insert(self.cache, single_cache, lane, page_ids,
                     self.manager.block_tables[lane], new_len)

    def sync_tables(self) -> None:
        """Upload the host block table if growth/free changed it."""
        if self.manager.dirty:
            self.cache["block_tables"].copy_(
                torch.from_numpy(self.manager.block_tables))
            self.manager.dirty = False

    def free(self, lane: int) -> int:
        """Release a lane's pages back to the pool (same step)."""
        return self.manager.free_lane(lane)

    def copy_pages(self, src, dst) -> None:
        """Duplicate pool pages ``src -> dst`` in every layer (the source
        keeps its bytes)."""
        _move_pages(self.cache, torch.as_tensor(src, dtype=torch.long, device=self.device),
                    torch.as_tensor(dst, dtype=torch.long, device=self.device))
        self.sync_tables()

    def defrag(self) -> list:
        """Compact the pool: the manager remaps the tables, the moved pages
        are copied on the device.  Returns the ``(src, dst)`` moves."""
        moves = self.manager.defrag()
        if moves:
            self.copy_pages([s for s, _ in moves], [d for _, d in moves])
        return moves
