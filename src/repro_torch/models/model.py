"""Model entry points: init / caches / prefill / decode for dense GQA stacks.

Port of ``repro/models/model.py`` for the ``"attn"`` kind.  Parameter
layout mirrors the reference's (plain dicts of tensors):

    {"embed": (V, d) bf16,
     "head_blocks": [], "tail_blocks": [per-layer trees],
     "blocks": (slot_0_tree, ...),   # leaves stacked over n_periods
     "final_norm": (d,) f32,
     "head": (V, d) bf16 (absent if tied)}

The reference's ``lax.scan`` over periods is a Python loop here.  Decode
runs over a contiguous (slot) cache or a paged one; its writes land in the
cache in place.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, pages_for
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.kvcache import (
    block_cache_shape,
    paged_block_cache_shape,
    zeros_like_shapes,
)
from repro_torch.models.layers import embed, rmsnorm, truncated_normal, unembed


def layer_layout(cfg: ModelConfig):
    """(n_periods, tail_kinds) for the stack's depth."""
    period = cfg.pattern_period
    n_periods = cfg.n_layers // period
    tail = tuple(cfg.block_pattern[i % period]
                 for i in range(n_periods * period, cfg.n_layers))
    return n_periods, tail


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Random weights from a ``torch.Generator`` seeded with ``seed``, made
    on ``device`` (default CUDA).  Same distributions as the reference's
    ``init_params``; not the same numbers (use ``weights.params_from_jax``
    to carry the reference's weights across).  ``device="meta"`` gives the
    layout (names, shapes, dtypes) without memory."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    n_periods, tail = layer_layout(cfg)
    emb_scale = 1.0 / (cfg.d_model ** 0.5)
    params = {
        "embed": truncated_normal(gen, dev, (cfg.vocab_size, cfg.d_model), emb_scale),
        "head_blocks": [],
        "blocks": tuple(tfm.init_block(cfg, gen, dev, kind, stack=(n_periods,))
                        for kind in cfg.block_pattern) if n_periods else (),
        "tail_blocks": [tfm.init_block(cfg, gen, dev, kind) for kind in tail],
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32, device=dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = truncated_normal(gen, dev, (cfg.vocab_size, cfg.d_model),
                                          emb_scale)
    return params


def _head_table(params, cfg: ModelConfig):
    return params["embed"] if cfg.tie_embeddings else params["head"]


def _stack(trees):
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device):
    """Zero contiguous cache (the layout :func:`prefill` returns)."""
    n_periods, tail = layer_layout(cfg)

    def stacked(kind):
        return {k: ((n_periods,) + shp, dt)
                for k, (shp, dt) in block_cache_shape(kind, cfg, batch, cache_len).items()}

    shapes = {
        "pos": ((batch,), torch.int32),
        "head_blocks": [],
        "blocks": tuple(stacked(kind) for kind in cfg.block_pattern) if n_periods else (),
        "tail_blocks": [block_cache_shape(kind, cfg, batch, cache_len) for kind in tail],
    }
    return zeros_like_shapes(shapes, device)


def paged_cache_shapes(cfg: ModelConfig, n_lanes: int, cache_len: int,
                       page_size: int, n_pages: int):
    """(shape, dtype) tree of the paged decode cache: KV in global page
    pools (stacked over periods) indexed through ``block_tables``
    ``(n_lanes, pages_for(cache_len))`` int32."""
    n_periods, tail = layer_layout(cfg)

    def stacked(kind):
        return {k: ((n_periods,) + shp, dt)
                for k, (shp, dt) in paged_block_cache_shape(kind, cfg, n_pages, page_size).items()}

    return {
        "pos": ((n_lanes,), torch.int32),
        "block_tables": ((n_lanes, pages_for(cache_len, page_size)), torch.int32),
        "head_blocks": [],
        "blocks": tuple(stacked(kind) for kind in cfg.block_pattern) if n_periods else (),
        "tail_blocks": [paged_block_cache_shape(kind, cfg, n_pages, page_size)
                        for kind in tail],
    }


def prefill(params, cfg: ModelConfig, tokens, cache_len: int, lengths=None):
    """Process prompts ``tokens`` (B, S); return (last-position logits
    (B, V) f32, contiguous cache with rows [0, S) filled).

    ``lengths`` (B,) are the true lengths of right-padded prompts: logits
    come from position ``lengths - 1`` and the cache ``pos`` starts at
    ``lengths``, so padded rows are overwritten before any query can
    attend them."""
    b, s = tokens.shape
    x = embed(tokens, params["embed"])
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    n_periods, tail = layer_layout(cfg)
    per_slot = [[] for _ in cfg.block_pattern]
    for i in range(n_periods):
        for slot, kind in enumerate(cfg.block_pattern):
            x, c = tfm.apply_block_prefill(
                x, tfm.period_params(params["blocks"][slot], i), kind, cfg,
                positions, cache_len)
            per_slot[slot].append(c)
    tail_caches = []
    for p, kind in zip(params["tail_blocks"], tail):
        x, c = tfm.apply_block_prefill(x, p, kind, cfg, positions, cache_len)
        tail_caches.append(c)
    cache = {
        "head_blocks": [],
        "blocks": tuple(_stack(per) for per in per_slot) if n_periods else (),
        "tail_blocks": tail_caches,
    }
    if lengths is None:
        cache["pos"] = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
        x_last = x[:, -1:, :]
    else:
        lengths = lengths.to(torch.int32)
        cache["pos"] = lengths
        idx = torch.clamp(lengths.long() - 1, 0, s - 1)
        x_last = x[torch.arange(b, device=x.device), idx][:, None, :]
    h = rmsnorm(x_last, params["final_norm"], cfg.norm_eps)
    return unembed(h, _head_table(params, cfg))[:, 0, :], cache


def decode_step(params, cfg: ModelConfig, tokens, cache, active=None):
    """One token for every lane.  tokens: (B,) int.

    A ``block_tables`` key in ``cache`` marks a paged cache (see
    :func:`paged_cache_shapes`); without one, ``cache`` is the contiguous
    layout of :func:`init_cache` / :func:`prefill`.  ``active`` (B,) bool
    marks lanes serving a request: idle lanes still ride the fixed-shape
    step, but their ``pos`` is pinned to 0; their paged writes go to the
    trash page, their slot writes stay in their own lane at row 0.
    ``active=None`` advances every lane.  The cache is updated in place and
    returned with ``pos`` advanced.  Returns (logits (B, V), cache)."""
    pos = cache["pos"]
    tables = cache.get("block_tables")
    x = embed(tokens[:, None], params["embed"])
    n_periods, tail = layer_layout(cfg)
    for i in range(n_periods):
        for slot, kind in enumerate(cfg.block_pattern):
            x, _ = tfm.apply_block_decode(
                x, tfm.period_params(params["blocks"][slot], i), kind, cfg,
                tfm.period_params(cache["blocks"][slot], i), pos,
                tables=tables, active=active)
    for p, kind, c in zip(params["tail_blocks"], tail, cache["tail_blocks"]):
        x, _ = tfm.apply_block_decode(x, p, kind, cfg, c, pos, tables=tables,
                                      active=active)
    cache["pos"] = (pos + 1 if active is None
                    else torch.where(active, pos + 1, torch.zeros_like(pos)))
    h = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(h, _head_table(params, cfg))[:, 0, :], cache
