"""Decode-time cache layouts for every block kind of a decoder-only stack
(port of ``repro/models/kvcache.py``).

Shapes are ``(shape, dtype)`` pairs in dicts that mirror the reference's
ShapeDtypeStruct trees:

* ``attn``, ``moe``, ``dense_ffn_layer``: contiguous ``{"k","v"}``
  (B, S_cache, H_kv, D) bf16, or int8 payloads plus
  ``{"k_scale","v_scale"}`` (B, S_cache, H_kv) f32; paged ``{"kp","vp"}``
  (n_pages, page_size, H_kv, D) plus ``{"kp_scale","vp_scale"}`` for int8
  pools;
* ``mla``: the compressed latents, contiguous ``{"ckv","kr"}`` (B,
  S_cache, kv_lora_rank / qk_rope_head_dim), paged ``{"ckvp","krp"}``
  (n_pages, page_size, ...), bf16 whatever ``kv_cache_dtype`` says;
* ``local_attn``: a ring of ``min(cache_len, sliding_window)`` rows in the
  ``attn`` layout (bf16, or int8 with scales), slot ``pos % rows``;
* ``rglru``: ``{"h": (B, lru), "conv": (B, W-1, lru)}`` f32;
* ``mlstm``: ``{"C": (B, H, dh, dh), "n": (B, H, dh)}`` f32;
* ``slstm``: ``{"c","n","h"}`` (B, H, dh) f32.

The paged layout pages only the kinds whose cache grows with the
sequence; the recurrent states and the window-sized rings stay per lane
(``(n_lanes, ...)`` leaves) in the paged cache too.

**A rank's part** (a ``configs.base.RankConfig``, tp > 1): the leaves
hold the rank's blocks of the reference's specs (``runtime.sharding.
pool_specs``), with the bytes those give one rank:

* attention KV: the rank's KV heads (pools: the spec's head axis; a slot
  cache or ring holds its KV heads too, where the spec splits the
  trailing ``head_dim``: the same bytes);
* an MQA stack's one KV head (``kv_split``): pools hold the whole head
  (the spec replicates a head axis of 1), slot caches and rings the
  rank's ``head_dim / tp`` columns (the spec's trailing split);
* MLA: ``ckv`` / ``ckvp`` the rank's ``kv_lora_rank / tp`` latent
  columns, the slot ``kr`` its ``rope / tp`` columns, the pool ``krp``
  whole (replicated);
* ``rglru``: the rank's ``lru / tp`` channels of ``h`` and ``conv`` (the
  spec's trailing split);
* ``mlstm`` / ``slstm``: the rank's ``H / tp`` heads, each ``dh`` whole,
  where the spec splits the trailing ``dh`` of every head: the same
  bytes, laid out so that a rank's cells run on its own heads (ROADMAP
  queue 3).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, kv_split, model_ways
from repro_torch.models.layers import COMPUTE_DTYPE


def _kv_cols(cfg: ModelConfig, lane: bool) -> int:
    """The ``head_dim`` columns a KV leaf holds: a rank's block of an MQA
    head's in a per-lane leaf (slot cache, ring), else the whole head."""
    hd = cfg.resolved_head_dim
    return hd // model_ways(cfg) if lane and kv_split(cfg) else hd


def _kv(shp, cfg: ModelConfig, names):
    if cfg.kv_cache_dtype == "int8":
        return {names[0]: (shp, torch.int8), names[1]: (shp, torch.int8),
                names[2]: (shp[:3], torch.float32), names[3]: (shp[:3], torch.float32)}
    return {names[0]: (shp, COMPUTE_DTYPE), names[1]: (shp, COMPUTE_DTYPE)}


_KV_KINDS = ("attn", "moe", "dense_ffn_layer")
# kinds whose cache lives in the page pools (a windowless local_attn too)
PAGED_KINDS = frozenset(_KV_KINDS + ("mla",))
_F32 = torch.float32


def _latents(rows, cfg: ModelConfig, names, pool: bool):
    m, tp = cfg.mla, model_ways(cfg)
    return {names[0]: ((*rows, m.kv_lora_rank // tp), COMPUTE_DTYPE),
            names[1]: ((*rows, m.qk_rope_head_dim // (1 if pool else tp)), COMPUTE_DTYPE)}


def block_cache_shape(kind: str, cfg: ModelConfig, batch: int, cache_len: int):
    """(shape, dtype) leaves for one layer's contiguous cache of the given
    (effective) kind."""
    if kind in _KV_KINDS:
        shp = (batch, cache_len, cfg.n_kv_heads, _kv_cols(cfg, True))
        return _kv(shp, cfg, ("k", "v", "k_scale", "v_scale"))
    if kind == "local_attn":
        rows = cache_len if cfg.sliding_window is None else min(cache_len, cfg.sliding_window)
        shp = (batch, rows, cfg.n_kv_heads, _kv_cols(cfg, True))
        return _kv(shp, cfg, ("k", "v", "k_scale", "v_scale"))
    if kind == "mla":
        return _latents((batch, cache_len), cfg, ("ckv", "kr"), pool=False)
    if kind == "rglru":
        lru = (cfg.lru_width or cfg.d_model) // model_ways(cfg)
        return {"h": ((batch, lru), _F32), "conv": ((batch, cfg.conv_width - 1, lru), _F32)}
    dh = cfg.resolved_head_dim
    if kind == "mlstm":
        return {"C": ((batch, cfg.n_heads, dh, dh), _F32), "n": ((batch, cfg.n_heads, dh), _F32)}
    if kind == "slstm":
        return {name: ((batch, cfg.n_heads, dh), _F32) for name in ("c", "n", "h")}
    raise ValueError(f"no cache for block kind {kind!r}")


def is_paged_kind(kind: str, cfg: ModelConfig) -> bool:
    """Does this (effective) kind's cache live in the page pools?  The
    attention family does; so does a windowless ``local_attn`` (it caches
    like full attention).  Recurrent state and window rings stay per lane."""
    return kind in PAGED_KINDS or (kind == "local_attn" and cfg.sliding_window is None)


def paged_block_cache_shape(kind: str, cfg: ModelConfig, batch: int, cache_len: int,
                            n_pages: int, page_size: int):
    """(shape, dtype) leaves for one layer's paged cache: page pools for
    the paged kinds, the per-lane layout of :func:`block_cache_shape` for
    the others."""
    if kind == "mla":
        return _latents((n_pages, page_size), cfg, ("ckvp", "krp"), pool=True)
    if is_paged_kind(kind, cfg):
        shp = (n_pages, page_size, cfg.n_kv_heads, _kv_cols(cfg, False))
        return _kv(shp, cfg, ("kp", "vp", "kp_scale", "vp_scale"))
    return block_cache_shape(kind, cfg, batch, cache_len)


def zeros_like_shapes(tree, device):
    """Allocate a zero tensor for every (shape, dtype) leaf."""
    if isinstance(tree, dict):
        return {k: zeros_like_shapes(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [zeros_like_shapes(v, device) for v in tree]
    if isinstance(tree, tuple) and not (len(tree) == 2 and isinstance(tree[1], torch.dtype)):
        return tuple(zeros_like_shapes(v, device) for v in tree)
    shape, dtype = tree
    return torch.zeros(shape, dtype=dtype, device=device)
