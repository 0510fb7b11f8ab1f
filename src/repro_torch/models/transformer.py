"""Blocks and the layer layout for the attention family.

Port of the ``"attn"``, ``"mla"``, ``"moe"`` and ``"dense_ffn_layer"``
parts of ``repro/models/transformer.py``.  The reference scans over
periods of ``cfg.block_pattern`` with parameters stacked along a leading
period axis; here the same stacked layout is walked by a Python loop
(:func:`period_params` picks period ``i``).  A MoE stack's leading dense
layers (``moe.first_k_dense``) run first, as ``head_blocks``; remainder
layers run last, as ``tail_blocks`` (:func:`layer_layout`).

Every kind is attention (GQA, or MLA when ``cfg.use_mla``) then an FFN:
the GLU MLP, or for ``"moe"`` the routed experts (``models/moe.py``).
The recurrent cells and the local-attention ring come with ROADMAP queue
1, item 7.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import glu_mlp, init_glu_mlp, rmsnorm, rmsnorm_columns
from repro_torch.models.moe import init_moe, moe_ffn


def effective_kind(kind: str, cfg: ModelConfig) -> str:
    if kind == "attn" and cfg.use_mla:
        return "mla"
    return kind


def layer_layout(cfg: ModelConfig, n_layers=None):
    """(first_k_dense, n_periods, tail_kinds) for the stack's depth."""
    n = n_layers if n_layers is not None else cfg.n_layers
    lead = cfg.moe.first_k_dense if cfg.moe is not None else 0
    rest = n - lead
    period = cfg.pattern_period
    n_periods = rest // period
    tail = tuple(cfg.block_pattern[i % period] for i in range(n_periods * period, rest))
    return lead, n_periods, tail


def init_block(cfg: ModelConfig, gen: torch.Generator, device, kind: str = "attn",
               stack=()):
    kind = effective_kind(kind, cfg)
    d = cfg.d_model
    if kind in ("attn", "moe", "dense_ffn_layer"):
        a = attn.init_attention(cfg, gen, device, stack)
    elif kind == "mla":
        a = attn.init_mla(cfg, gen, device, stack)
    else:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet "
                                  "(ROADMAP queue 1, item 7)")
    p = {
        "norm1": torch.ones((*stack, d), dtype=torch.float32, device=device),
        "attn": a,
        "norm2": torch.ones((*stack, d), dtype=torch.float32, device=device),
    }
    if kind == "moe":
        p["moe"] = init_moe(cfg, gen, device, stack)
    else:
        d_ff = (cfg.moe.d_ff_dense or cfg.d_ff) if kind == "dense_ffn_layer" else cfg.d_ff
        p["mlp"] = init_glu_mlp(gen, device, d, d_ff, stack)
    return p


def period_params(tree, i: int):
    """Period ``i`` of a tree stacked along a leading period axis (views)."""
    if isinstance(tree, dict):
        return {k: period_params(v, i) for k, v in tree.items()}
    return tree[i]


def _residual_mlp(x, a, p, cfg: ModelConfig, norm=rmsnorm):
    """``x + a`` then ``+ ffn(norm2(x + a))``, the FFN being the routed
    experts of a ``"moe"`` block or the GLU MLP.  The mid-block residual
    stays f32 into the norm and is rounded to ``x``'s dtype only for the
    second add, where the reference's compiled graph rounds it."""
    mid = x.float() + a.float()
    h = norm(mid, p["norm2"], cfg.norm_eps, dtype=x.dtype)
    if "moe" in p:
        f, _ = moe_ffn(h, p["moe"], cfg)
    else:
        f = glu_mlp(h, p["mlp"], cfg.act, cfg.quant_mode, cfg.gemm_backend)
    return mid.to(x.dtype) + f


def apply_block(x, p, kind: str, cfg: ModelConfig, positions):
    """Full-sequence causal application.  Returns (x, fresh cache rows):
    (k, v) for the GQA kinds, (c_kv, k_rope) for MLA."""
    kind = effective_kind(kind, cfg)
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if kind == "mla":
        a, fresh = attn.mla_block(h, p["attn"], cfg, positions)
    elif kind in ("attn", "moe", "dense_ffn_layer"):
        a, fresh = attn.attention_block(h, p["attn"], cfg, positions)
    else:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet "
                                  "(ROADMAP queue 1, item 7)")
    return _residual_mlp(x, a, p, cfg), fresh


def apply_block_prefill(x, p, kind: str, cfg: ModelConfig, positions, cache_len: int):
    """Like :func:`apply_block`, plus the layer's contiguous decode cache
    (B, cache_len, ...) with the fresh rows in [0, S): K/V (quantized into
    the byte-size layout for int8 caches) or the MLA latents (bf16)."""
    x, fresh = apply_block(x, p, kind, cfg, positions)
    if effective_kind(kind, cfg) == "mla":
        fresh = {"ckv": fresh[0], "kr": fresh[1]}
    elif cfg.kv_cache_dtype == "int8":
        kq, ks = attn.quantize_kv(fresh[0])
        vq, vs = attn.quantize_kv(fresh[1])
        fresh = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        fresh = {"k": fresh[0], "v": fresh[1]}
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
    its pool keys (``kp``, or ``ckvp`` for MLA); ``tables`` are the block
    tables threaded down from the cache root, ``active`` the live-lane mask
    (see ``model.decode_step``).  Either cache is written in place.
    Returns (x_t, cache)."""
    kind = effective_kind(kind, cfg)
    h = rmsnorm(x_t, p["norm1"], cfg.norm_eps)
    if kind == "mla":
        if "ckvp" in cache:
            a, cache = attn.mla_paged_decode(h, p["attn"], cfg, cache, pos, tables,
                                             active=active)
        else:
            a, _ = attn.mla_decode(h, p["attn"], cfg, cache["ckv"], cache["kr"], pos)
    elif kind in ("attn", "moe", "dense_ffn_layer"):
        if "kp" in cache:
            a, cache = attn.paged_attention_decode(h, p["attn"], cfg, cache, pos, tables,
                                                   active=active)
        else:
            a, cache = attn.attention_decode(h, p["attn"], cfg, cache, pos)
    else:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet "
                                  "(ROADMAP queue 1, item 7)")
    return _residual_mlp(x_t, a, p, cfg), cache


def apply_block_verify(x, p, kind: str, cfg: ModelConfig, cache, pos, tables=None,
                       active=None):
    """W-token speculative verify through one block (the verify twin of
    :func:`apply_block_decode`), for the row-independent kinds only:
    ``attn``, ``mla`` and ``dense_ffn_layer``, as in the reference (a
    routed FFN's capacity depends on the dispatch width).  The norms reduce
    the window column by column (``layers.rmsnorm_columns``), as the decode
    step reduces its rows.  Returns (x, cache)."""
    kind = effective_kind(kind, cfg)
    h = rmsnorm_columns(x, p["norm1"], cfg.norm_eps)
    if kind == "mla":
        if "ckvp" in cache:
            a, cache = attn.mla_paged_verify(h, p["attn"], cfg, cache, pos, tables,
                                             active=active)
        else:
            a, _ = attn.mla_verify(h, p["attn"], cfg, cache["ckv"], cache["kr"], pos)
    elif kind in ("attn", "dense_ffn_layer"):
        if "kp" in cache:
            a, cache = attn.paged_attention_verify(h, p["attn"], cfg, cache, pos, tables,
                                                   active=active)
        else:
            a, cache = attn.attention_verify(h, p["attn"], cfg, cache, pos)
    else:
        raise ValueError(f"speculative verify unsupported for block kind {kind!r}")
    return _residual_mlp(x, a, p, cfg, norm=rmsnorm_columns), cache
