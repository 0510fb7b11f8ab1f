"""Device-side paged KV cache: page pools + page scatter.

Port of ``repro/paging/cache.py``.  ``PagedCache`` allocates the pool tree
once (``models/model.paged_cache_shapes``): attention KV in global
``(n_pages, page_size, ...)`` pools stacked over periods, plus the
per-lane ``pos`` and the block table.  Host bookkeeping lives in
``manager.PageManager``.

Unlike the reference, whose functional ``.at[].set`` returns new pools,
every write here is **in place**: :func:`paged_insert` scatters a prefill's
rows into the pools with ``index_put_``, and the decode step writes its
token's row the same way, so the pools are allocated once and never copied.
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


def _scatter_block(pool_blk, single_blk, page_ids, stacked: bool):
    """Write a batch=1 contiguous cache's rows into whole pages, in place."""
    for pk, leaf in pool_blk.items():
        src = single_blk[_POOL_KEY_MAP[pk]]
        if stacked:
            rows = src[:, 0]                                  # (periods, S, ...)
            ps = leaf.shape[2]
            rows = rows.reshape((rows.shape[0], rows.shape[1] // ps, ps)
                                + tuple(rows.shape[2:]))
            leaf[:, page_ids] = rows.to(leaf.dtype)
        else:
            rows = src[0]                                     # (S, ...)
            ps = leaf.shape[1]
            rows = rows.reshape((rows.shape[0] // ps, ps) + tuple(rows.shape[1:]))
            leaf[page_ids] = rows.to(leaf.dtype)


def paged_insert(cache, single, lane: int, page_ids, table_row, new_len: int):
    """Scatter a batch=1 contiguous prefill cache into the page pools, in
    place, and write the lane's ``pos`` and block-table row.

    ``single`` must hold exactly ``len(page_ids) * page_size`` cache rows
    (the engine sizes the admission prefill that way)."""
    dev = cache["pos"].device
    page_ids = torch.as_tensor(page_ids, dtype=torch.long, device=dev)
    cache["pos"][lane] = int(new_len)
    cache["block_tables"][lane] = torch.as_tensor(table_row, dtype=torch.int32,
                                                  device=dev)
    for pb, sb in zip(cache["blocks"], single["blocks"]):
        _scatter_block(pb, sb, page_ids, stacked=True)
    for pb, sb in zip(cache["tail_blocks"], single["tail_blocks"]):
        _scatter_block(pb, sb, page_ids, stacked=False)
    return cache


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
