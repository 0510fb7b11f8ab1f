"""Decode-time cache layouts for the attention-family kinds (port of
``repro/models/kvcache.py``).

Shapes are ``(shape, dtype)`` pairs in dicts that mirror the reference's
ShapeDtypeStruct trees:

* ``attn``, ``moe``, ``dense_ffn_layer``: contiguous ``{"k","v"}``
  (B, S_cache, H_kv, D) bf16, or int8 payloads plus
  ``{"k_scale","v_scale"}`` (B, S_cache, H_kv) f32; paged ``{"kp","vp"}``
  (n_pages, page_size, H_kv, D) plus ``{"kp_scale","vp_scale"}`` for int8
  pools;
* ``mla``: the compressed latents, contiguous ``{"ckv","kr"}`` (B,
  S_cache, kv_lora_rank / qk_rope_head_dim), paged ``{"ckvp","krp"}``
  (n_pages, page_size, ...), bf16 whatever ``kv_cache_dtype`` says.

The recurrent states and the local-attention ring come with ROADMAP
queue 1, item 7.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import COMPUTE_DTYPE


def _kv(shp, cfg: ModelConfig, names):
    if cfg.kv_cache_dtype == "int8":
        return {names[0]: (shp, torch.int8), names[1]: (shp, torch.int8),
                names[2]: (shp[:3], torch.float32), names[3]: (shp[:3], torch.float32)}
    return {names[0]: (shp, COMPUTE_DTYPE), names[1]: (shp, COMPUTE_DTYPE)}


_KV_KINDS = ("attn", "moe", "dense_ffn_layer")


def _latents(rows, cfg: ModelConfig, names):
    m = cfg.mla
    return {names[0]: ((*rows, m.kv_lora_rank), COMPUTE_DTYPE),
            names[1]: ((*rows, m.qk_rope_head_dim), COMPUTE_DTYPE)}


def block_cache_shape(kind: str, cfg: ModelConfig, batch: int, cache_len: int):
    """(shape, dtype) leaves for one layer's contiguous cache of the given
    (effective) kind."""
    if kind in _KV_KINDS:
        shp = (batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        return _kv(shp, cfg, ("k", "v", "k_scale", "v_scale"))
    if kind == "mla":
        return _latents((batch, cache_len), cfg, ("ckv", "kr"))
    raise NotImplementedError(f"no cache for block kind {kind!r} in the port yet "
                              "(ROADMAP queue 1, item 7)")


def paged_block_cache_shape(kind: str, cfg: ModelConfig, n_pages: int, page_size: int):
    """(shape, dtype) leaves for one layer's paged pool."""
    if kind in _KV_KINDS:
        shp = (n_pages, page_size, cfg.n_kv_heads, cfg.resolved_head_dim)
        return _kv(shp, cfg, ("kp", "vp", "kp_scale", "vp_scale"))
    if kind == "mla":
        return _latents((n_pages, page_size), cfg, ("ckvp", "krp"))
    raise NotImplementedError(f"no paged cache for block kind {kind!r} in the port yet "
                              "(ROADMAP queue 1, item 7)")


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
