"""Shared-prefix KV cache of the port (``repro/prefix/``): a token-ID radix
tree over page-aligned prompt prefixes plus the refcount/copy-on-write glue
that lets many serving lanes alias the same physical KV pages.

* ``tree.PrefixTree``   -- host-side radix tree (path-compressed, page-
  granular splits, deterministic LRU clock) mapping token runs to
  physical page chains.
* ``cache.PrefixCache`` -- ties the tree to ``paging.PageManager``:
  admission planning (longest cached prefix, CoW fork decision), prefill
  publishing, and LRU eviction under pool pressure.

The engine integration lives in ``serving/engine.py`` behind the
``policies.PrefixPolicy`` seam; page refcounts and forking live in
``paging/manager.py``.
"""

from repro_torch.prefix.cache import PrefixCache, PrefixPlan
from repro_torch.prefix.tree import PrefixNode, PrefixTree

__all__ = ["PrefixCache", "PrefixNode", "PrefixPlan", "PrefixTree"]
