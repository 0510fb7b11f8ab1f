"""Paged KV cache of the port: host page bookkeeping, device page pools
and the chunked-prefill step."""

from repro_torch.paging.cache import PagedCache, paged_insert, paged_insert_many
from repro_torch.paging.manager import TRASH_PAGE, PageManager
from repro_torch.paging.prefill import (
    CHUNKABLE_KINDS,
    STATEFUL_CHUNK_KINDS,
    chunkable,
    chunkable_with_state,
    make_chunk_step,
    stack_kinds,
)

__all__ = ["CHUNKABLE_KINDS", "STATEFUL_CHUNK_KINDS", "PageManager", "PagedCache", "TRASH_PAGE", "chunkable", "chunkable_with_state",
           "make_chunk_step", "paged_insert", "paged_insert_many", "stack_kinds"]
