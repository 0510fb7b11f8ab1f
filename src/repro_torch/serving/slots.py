"""Fixed-shape slot KV cache for continuous batching (port of
``repro/serving/slots.py``).

One cache tree is allocated once for ``n_slots`` lanes at a fixed
``cache_len`` (``models/model.init_cache``, the layout ``prefill``
returns, bf16 or int8 with scales).  Requests come and go by writing into
a lane of that tree, so the decode step always sees the same shapes:

* ``insert(single_cache, slot)`` copies a batch=1 prefill cache into lane
  ``slot``, in place (:func:`scatter_lane`; a stacked admission's batch=k
  cache goes to k lanes through :func:`scatter_lanes`);
* ``free(slot)`` releases the lane and resets its ``pos`` to 0.

The lane axis depends on the leaf: ``blocks`` leaves are stacked
``(n_periods, B, ...)`` (axis 1), every other leaf is ``(B, ...)`` (axis
0).  Free lanes still ride through ``decode_step``; the engine passes a
live-lane mask, which pins their ``pos`` to 0, so their writes stay in
their own lane at row 0, which the next insert rewrites.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib

# top-level cache keys whose leaves are stacked over periods (lane axis 1)
_PERIOD_STACKED = ("blocks",)


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (dicts, lists, tuples) and the
    matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def batch_axes(cache) -> dict:
    """A tree of the ``cache``'s structure: each leaf's lane axis."""
    return {key: _tree_map(lambda _leaf, ax=(1 if key in _PERIOD_STACKED else 0): ax, sub)
            for key, sub in cache.items()}


def _write_lane(full, part, slot: int, ax: int, row: int) -> None:
    """Write batch row ``row`` of ``part`` into lane ``slot`` of ``full``."""
    src = part.narrow(ax, row, 1)
    idx = tuple(slice(slot, slot + 1) if i == ax else slice(0, n)
                for i, n in enumerate(src.shape))
    full[idx] = src.to(full.dtype)


def scatter_lanes(cache, multi, slots, axes):
    """Write batch row ``i`` of the batch=k ``multi`` tree into lane
    ``slots[i]`` of ``cache``, in place (a leaf shorter than the lane fills
    its leading rows, as the reference's ``dynamic_update_slice`` does).
    Returns ``cache``."""
    for i, slot in enumerate(slots):
        _tree_map(lambda full, part, ax: _write_lane(full, part, slot, ax, i),
                  cache, multi, axes)
    return cache


def scatter_lane(cache, single, slot: int, axes):
    """The batch=1 form of :func:`scatter_lanes`."""
    return scatter_lanes(cache, single, [slot], axes)


class SlotCache:
    """Engine-owned cache pool: ``n_slots`` lanes of ``cache_len`` rows on
    ``device`` (default CUDA)."""

    def __init__(self, cfg: ModelConfig, n_slots: int, cache_len: int, device=None):
        self.device = resolve_device(device)
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.cache = model_lib.init_cache(cfg, n_slots, cache_len, self.device)
        self._axes = batch_axes(self.cache)

    def insert(self, single_cache, slot: int) -> None:
        """Copy a batch=1 prefill cache into lane ``slot``."""
        scatter_lane(self.cache, single_cache, slot, self._axes)

    def free(self, slot: int) -> None:
        """Release a lane (resets its write position)."""
        self.cache["pos"][slot] = 0

    @property
    def pos(self):
        return self.cache["pos"]
