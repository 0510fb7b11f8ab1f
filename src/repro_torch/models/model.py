"""Model entry points: init / caches / prefill / decode / verify for the
attention family (GQA, MLA, MoE with leading dense layers).

Port of ``repro/models/model.py``.  Parameter layout mirrors the
reference's (plain dicts of tensors):

    {"embed": (V, d) bf16,
     "head_blocks": [per-layer trees of the first_k_dense layers],
     "blocks": (slot_0_tree, ...),   # leaves stacked over n_periods
     "tail_blocks": [per-layer trees],
     "final_norm": (d,) f32,
     "head": (V, d) bf16 (absent if tied)}

The reference's ``lax.scan`` over periods is a Python loop here.  Decode
runs over a contiguous (slot) cache or a paged one; its writes land in the
cache in place.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, check_ported, pages_for
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.transformer import layer_layout
from repro_torch.models.kvcache import (
    block_cache_shape,
    paged_block_cache_shape,
    zeros_like_shapes,
)
from repro_torch.models.layers import (
    COMPUTE_DTYPE,
    embed,
    rmsnorm,
    rmsnorm_columns,
    truncated_normal,
    unembed,
)


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Random weights from a ``torch.Generator`` seeded with ``seed``, made
    on ``device`` (default CUDA).  Same distributions as the reference's
    ``init_params``; not the same numbers (use ``weights.params_from_jax``
    to carry the reference's weights across).  ``device="meta"`` gives the
    layout (names, shapes, dtypes) without memory.  A stack the port does
    not serve yet raises ``NotImplementedError`` (``check_ported``)."""
    check_ported(cfg)
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    lead, n_periods, tail = layer_layout(cfg)
    emb_scale = 1.0 / (cfg.d_model ** 0.5)
    params = {
        "embed": truncated_normal(gen, dev, (cfg.vocab_size, cfg.d_model), emb_scale),
        "head_blocks": [tfm.init_block(cfg, gen, dev, "dense_ffn_layer")
                        for _ in range(lead)],
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
    """Zero contiguous cache (the layout :func:`prefill` returns).  The lead
    layers' caches are keyed ``one("attn")`` as in the reference."""
    check_ported(cfg)
    lead, n_periods, tail = layer_layout(cfg)

    def one(kind):
        return block_cache_shape(tfm.effective_kind(kind, cfg), cfg, batch, cache_len)

    def stacked(kind):
        return {k: ((n_periods,) + shp, dt) for k, (shp, dt) in one(kind).items()}

    shapes = {
        "pos": ((batch,), torch.int32),
        "head_blocks": [one("attn") for _ in range(lead)],
        "blocks": tuple(stacked(kind) for kind in cfg.block_pattern) if n_periods else (),
        "tail_blocks": [one(kind) for kind in tail],
    }
    return zeros_like_shapes(shapes, device)


def paged_cache_shapes(cfg: ModelConfig, n_lanes: int, cache_len: int,
                       page_size: int, n_pages: int):
    """(shape, dtype) tree of the paged decode cache: KV in global page
    pools (stacked over periods) indexed through ``block_tables``
    ``(n_lanes, pages_for(cache_len))`` int32.  The lead layers' pools are
    keyed ``one("dense_ffn_layer")`` as in the reference."""
    check_ported(cfg)
    lead, n_periods, tail = layer_layout(cfg)

    def one(kind):
        return paged_block_cache_shape(tfm.effective_kind(kind, cfg), cfg, n_lanes, cache_len,
                                       n_pages, page_size)

    def stacked(kind):
        return {k: ((n_periods,) + shp, dt) for k, (shp, dt) in one(kind).items()}

    return {
        "pos": ((n_lanes,), torch.int32),
        "block_tables": ((n_lanes, pages_for(cache_len, page_size)), torch.int32),
        "head_blocks": [one("dense_ffn_layer") for _ in range(lead)],
        "blocks": tuple(stacked(kind) for kind in cfg.block_pattern) if n_periods else (),
        "tail_blocks": [one(kind) for kind in tail],
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
    _, n_periods, _ = layer_layout(cfg)
    head_caches, tail_caches = [], []
    per_slot = [[] for _ in cfg.block_pattern]
    for group, idx, period, kind, carry in tfm.layer_plan(cfg):
        x, c = tfm.apply_block_prefill(x, tfm.plan_entry(params, group, idx, period), kind,
                                       cfg, positions, cache_len, carry=carry)
        (per_slot[idx] if group == "blocks" else
         head_caches if group == "head_blocks" else tail_caches).append(c)
    cache = {
        "head_blocks": head_caches,
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
    for group, idx, period, kind, carry in tfm.layer_plan(cfg, carry_out=True):
        x, _ = tfm.apply_block_decode(x, tfm.plan_entry(params, group, idx, period), kind, cfg,
                                      tfm.plan_entry(cache, group, idx, period), pos,
                                      tables=tables, active=active, carry=carry)
    cache["pos"] = (pos + 1 if active is None
                    else torch.where(active, pos + 1, torch.zeros_like(pos)))
    h = rmsnorm(x, params["final_norm"], cfg.norm_eps, dtype=COMPUTE_DTYPE)
    return unembed(h, _head_table(params, cfg))[:, 0, :], cache


def verify_step(params, cfg: ModelConfig, tokens, cache, active=None):
    """W tokens for every lane in one dispatch (speculative verify).

    tokens: (B, W) int -- the last accepted token followed by W-1 drafted
    tokens; row c runs at absolute position ``pos + c`` (causal within the
    window, attending the lane's full slot/paged history before it).  All
    W K/V rows are written in place; rows past the accepted prefix are
    garbage that the next verify/decode step overwrites before any query
    attends them.  Every row computes what the decode step computes at its
    position (norms reduce the window column by column; the paged attention
    kernel splits each row as the decode step does).  Unlike
    :func:`decode_step`, ``cache["pos"]`` is left UNCHANGED: the accept
    length is only known after the logits, so ``spec.verify`` advances it.
    Returns (logits (B, W, V), cache)."""
    pos = cache["pos"]
    tables = cache.get("block_tables")
    x = embed(tokens, params["embed"])
    for group, idx, period, kind, carry in tfm.layer_plan(cfg):
        x, _ = tfm.apply_block_verify(x, tfm.plan_entry(params, group, idx, period), kind, cfg,
                                      tfm.plan_entry(cache, group, idx, period), pos,
                                      tables=tables, active=active, carry=carry)
    h = rmsnorm_columns(x, params["final_norm"], cfg.norm_eps)
    return unembed(h, _head_table(params, cfg)), cache
