"""Paged KV cache of the port: host page bookkeeping + device page pools."""

from repro_torch.paging.cache import PagedCache, paged_insert
from repro_torch.paging.manager import TRASH_PAGE, PageManager

__all__ = ["PageManager", "PagedCache", "TRASH_PAGE", "paged_insert"]
