"""Blocks and the layer loop for the ``"attn"`` kind.

Port of the ``"attn"`` parts of ``repro/models/transformer.py``.  The
reference scans over periods of ``cfg.block_pattern`` with parameters
stacked along a leading period axis; here the same stacked layout is
walked by a Python loop (:func:`period_params` picks period ``i``).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import glu_mlp, init_linear, rmsnorm, rmsnorm_columns


def init_block(cfg: ModelConfig, gen: torch.Generator, device, kind: str = "attn",
               stack=()):
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    d = cfg.d_model
    return {
        "norm1": torch.ones((*stack, d), dtype=torch.float32, device=device),
        "attn": attn.init_attention(cfg, gen, device, stack),
        "norm2": torch.ones((*stack, d), dtype=torch.float32, device=device),
        "mlp": {
            "w_gate": init_linear(gen, device, (*stack, d, cfg.d_ff)),
            "w_up": init_linear(gen, device, (*stack, d, cfg.d_ff)),
            "w_down": init_linear(gen, device, (*stack, cfg.d_ff, d)),
        },
    }


def period_params(tree, i: int):
    """Period ``i`` of a tree stacked along a leading period axis (views)."""
    if isinstance(tree, dict):
        return {k: period_params(v, i) for k, v in tree.items()}
    return tree[i]


def _residual_mlp(x, a, p, cfg: ModelConfig, norm=rmsnorm):
    """``x + a`` then ``+ mlp(norm2(x + a))``.  The mid-block residual stays
    f32 into the norm and is rounded to ``x``'s dtype only for the second
    add, where the reference's compiled graph rounds it."""
    mid = x.float() + a.float()
    h = norm(mid, p["norm2"], cfg.norm_eps, dtype=x.dtype)
    m = glu_mlp(h, p["mlp"], cfg.act, cfg.quant_mode, cfg.gemm_backend)
    return mid.to(x.dtype) + m


def apply_block(x, p, kind: str, cfg: ModelConfig, positions):
    """Full-sequence causal application. Returns (x, fresh (k, v))."""
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    a, kv = attn.attention_block(h, p["attn"], cfg, positions)
    return _residual_mlp(x, a, p, cfg), kv


def apply_block_prefill(x, p, kind: str, cfg: ModelConfig, positions, cache_len: int):
    """Like :func:`apply_block`, plus the layer's contiguous decode cache
    (B, cache_len, ...) with the fresh K/V in rows [0, S) — quantized into
    the byte-size layout for int8 caches."""
    x, (k, v) = apply_block(x, p, kind, cfg, positions)
    if cfg.kv_cache_dtype == "int8":
        kq, ks = attn.quantize_kv(k)
        vq, vs = attn.quantize_kv(v)
        fresh = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        fresh = {"k": k, "v": v}
    s = x.shape[1]
    if cache_len < s:
        raise ValueError(f"cache_len {cache_len} is shorter than the prompt ({s})")
    cache = {}
    for name, val in fresh.items():
        buf = torch.zeros((val.shape[0], cache_len) + tuple(val.shape[2:]),
                          dtype=val.dtype, device=val.device)
        buf[:, :s] = val
        cache[name] = buf
    return x, cache


def apply_block_decode(x_t, p, kind: str, cfg: ModelConfig, cache, pos,
                       tables=None, active=None):
    """One-token decode through one block.  A paged cache is recognized by
    its pool keys (``kp``); ``tables`` are the block tables threaded down
    from the cache root, ``active`` the live-lane mask (see
    ``model.decode_step``).  Either cache is written in place.  Returns
    (x_t, cache)."""
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    h = rmsnorm(x_t, p["norm1"], cfg.norm_eps)
    if "kp" in cache:
        a, cache = attn.paged_attention_decode(h, p["attn"], cfg, cache, pos, tables,
                                               active=active)
    else:
        a, cache = attn.attention_decode(h, p["attn"], cfg, cache, pos)
    return _residual_mlp(x_t, a, p, cfg), cache


def apply_block_verify(x, p, kind: str, cfg: ModelConfig, cache, pos, tables=None,
                       active=None):
    """W-token speculative verify through one block (the verify twin of
    :func:`apply_block_decode`).  Only the row-independent ``"attn"`` kind
    is ported; other kinds raise the reference's ``ValueError``.  The norms
    reduce the window column by column (``layers.rmsnorm_columns``), as the
    decode step reduces its rows.  Returns (x, cache)."""
    if kind != "attn":
        raise ValueError(f"speculative verify unsupported for block kind {kind!r}")
    h = rmsnorm_columns(x, p["norm1"], cfg.norm_eps)
    if "kp" in cache:
        a, cache = attn.paged_attention_verify(h, p["attn"], cfg, cache, pos, tables,
                                               active=active)
    else:
        a, cache = attn.attention_verify(h, p["attn"], cfg, cache, pos)
    return _residual_mlp(x, a, p, cfg, norm=rmsnorm_columns), cache
