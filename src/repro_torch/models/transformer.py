"""Blocks and the layer layout of a decoder-only stack.

Port of the decoder-only parts of ``repro/models/transformer.py``.  The
reference scans over periods of ``cfg.block_pattern`` with parameters
stacked along a leading period axis; here the same stacked layout is
walked by a Python loop (:func:`layer_plan`, :func:`period_params` picks
period ``i``).  A MoE stack's leading dense
layers (``moe.first_k_dense``) run first, as ``head_blocks``; remainder
layers run last, as ``tail_blocks`` (:func:`layer_layout`).

The attention kinds are attention (GQA, or MLA when ``cfg.use_mla``;
``"local_attn"`` attends a sliding window and decodes over a ring of
``min(cache_len, sliding_window)`` rows) then an FFN: the GLU MLP, or for
``"moe"`` the routed experts (``models/moe.py``).  The recurrent kinds run
a cell of ``models/recurrent.py``: ``"rglru"`` with its own norm and GLU
MLP after it, ``"mlstm"`` and ``"slstm"`` alone (the cell carries its own
projections).  Their decode state is written into the cache in place.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import recurrent as rec
from repro_torch.models.kvcache import block_cache_shape, zeros_like_shapes
from repro_torch.models.layers import (
    COMPUTE_DTYPE,
    glu_mlp,
    init_glu_mlp,
    rank_block,
    rmsnorm,
    rmsnorm_columns,
)
from repro_torch.models.moe import init_moe, moe_ffn


RECURRENT_KINDS = frozenset({"rglru", "mlstm", "slstm"})
_ATTN_KINDS = ("attn", "local_attn", "moe", "dense_ffn_layer")


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


def layer_plan(cfg: ModelConfig, carry_out: bool = False):
    """The stack's layers in order, as ``(group, index, period, kind,
    carry)``: ``group`` is ``"head_blocks"`` / ``"tail_blocks"`` (``index``
    into the list, ``period`` None) or ``"blocks"`` (``index`` the pattern
    slot, ``period`` the period).

    ``carry`` marks a layer whose output stream goes on in f32, unrounded.
    The reference's compiled graph rounds a bf16 residual add for the next
    residual add, but an input norm (an explicit cast to f32) reads the f32
    sum, wherever the two sit in one stretch of straight-line code: the
    slots of one period (one ``lax.scan`` body) and consecutive tail
    layers.  A period ends with the scan's bf16 carry, so its last layer
    rounds.  ``carry_out`` extends this to the last layer when it is a tail
    layer: the decode step's final norm reads it unrounded (the prefill
    gathers the last row from the rounded stream first)."""
    lead, n_periods, tail = layer_layout(cfg)
    plan = [("head_blocks", i, None, "dense_ffn_layer", False) for i in range(lead)]
    period = len(cfg.block_pattern)
    for i in range(n_periods):
        for slot, kind in enumerate(cfg.block_pattern):
            plan.append(("blocks", slot, i, kind, slot < period - 1))
    for j, kind in enumerate(tail):
        plan.append(("tail_blocks", j, None, kind, carry_out or j < len(tail) - 1))
    return plan


def plan_entry(tree, group: str, index: int, period):
    """The layer's subtree of a params or cache tree (period views for the
    stacked ``"blocks"``)."""
    sub = tree[group][index]
    return sub if period is None else period_params(sub, period)


def init_block(cfg: ModelConfig, gen: torch.Generator, device, kind: str = "attn",
               stack=()):
    kind = effective_kind(kind, cfg)
    d = cfg.d_model
    if kind in RECURRENT_KINDS:
        init_cell = {"rglru": rec.init_rglru, "mlstm": rec.init_mlstm,
                     "slstm": rec.init_slstm}[kind]
        p = {"norm1": torch.ones((*stack, d), dtype=torch.float32, device=device),
             "cell": init_cell(cfg, gen, device, stack)}
        if kind == "rglru":
            p["norm2"] = torch.ones((*stack, d), dtype=torch.float32, device=device)
            p["mlp"] = init_glu_mlp(gen, device, d, cfg.d_ff, stack)
        return p
    if kind in _ATTN_KINDS:
        a = attn.init_attention(cfg, gen, device, stack)
    elif kind == "mla":
        a = attn.init_mla(cfg, gen, device, stack)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
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


def _add(x, a, carry: bool):
    """The residual add ``x + a`` of the bf16 stream; with ``carry`` its
    f32 value before the rounding (see :func:`layer_plan`)."""
    y = x.to(COMPUTE_DTYPE).float() + a.float()
    return y if carry else y.to(COMPUTE_DTYPE)


def _norm1(x, p, cfg: ModelConfig, norm=rmsnorm):
    """The block's input norm, of the stream as it arrives (f32 when the
    previous block carried it unrounded)."""
    return norm(x, p["norm1"], cfg.norm_eps, dtype=COMPUTE_DTYPE)


def _residual_mlp(x, a, p, cfg: ModelConfig, norm=rmsnorm, carry: bool = False,
                  aux_out=None):
    """``x + a`` then ``+ ffn(norm2(x + a))``, the FFN being the routed
    experts of a ``"moe"`` block or the GLU MLP.  The mid-block residual
    stays f32 into the norm and is rounded to bf16 only for the second
    add, where the reference's compiled graph rounds it.  A ``"moe"``
    block appends its load-balance loss to the list ``aux_out`` when one
    is given."""
    mid = x.to(COMPUTE_DTYPE).float() + a.float()
    h = norm(mid, p["norm2"], cfg.norm_eps, dtype=COMPUTE_DTYPE)
    if "moe" in p:
        f, aux = moe_ffn(h, p["moe"], cfg)
        if aux_out is not None:
            aux_out.append(aux)
    else:
        f = glu_mlp(h, p["mlp"], cfg.act, cfg.quant_mode, cfg.gemm_backend)
    return _add(mid, f, carry)


def _apply_cell(x, p, kind: str, cfg: ModelConfig, state, carry: bool):
    """A recurrent block: the cell over norm1(x), the residual, and for
    ``"rglru"`` its norm2 + GLU MLP.  Returns (x, the cell's state)."""
    a, state = rec.CELLS[kind][0](_norm1(x, p, cfg), p["cell"], cfg, state)
    if kind == "rglru":
        return _residual_mlp(x, a, p, cfg, carry=carry), state
    return _add(x, a, carry), state


def apply_block(x, p, kind: str, cfg: ModelConfig, positions, carry: bool = False,
                causal: bool = True, aux_out=None):
    """Full-sequence application.  Returns (x, fresh cache rows): (k, v)
    for the GQA kinds, (c_kv, k_rope) for MLA, None for the recurrent
    kinds.  ``carry``: return the output stream in f32, unrounded
    (:func:`layer_plan`).  ``causal=False`` unmasks the GQA kinds'
    self-attention, as in the reference (MLA and the cells stay causal).
    ``aux_out``: see :func:`_residual_mlp`."""
    kind = effective_kind(kind, cfg)
    if kind in RECURRENT_KINDS:
        return _apply_cell(x, p, kind, cfg, None, carry)[0], None
    h = _norm1(x, p, cfg)
    if kind == "mla":
        a, fresh = attn.mla_block(h, p["attn"], cfg, positions)
    elif kind in _ATTN_KINDS:
        window = cfg.sliding_window if kind == "local_attn" else None
        a, fresh = attn.attention_block(h, p["attn"], cfg, positions, window=window,
                                        causal=causal)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    return _residual_mlp(x, a, p, cfg, carry=carry, aux_out=aux_out), fresh


def apply_block_prefill(x, p, kind: str, cfg: ModelConfig, positions, cache_len: int,
                        carry: bool = False):
    """Like :func:`apply_block`, plus the layer's contiguous decode cache:
    (B, cache_len, ...) with the fresh rows in [0, S) -- K/V (quantized into
    the byte-size layout for int8 caches) or the MLA latents (bf16); for
    ``"local_attn"`` a ring of ``min(cache_len, sliding_window)`` rows
    holding the last positions, rolled so that position ``t`` sits in slot
    ``t % rows``; for the recurrent kinds the cell's state after the last
    token, in the cache layout's dtypes."""
    kind_e = effective_kind(kind, cfg)
    if kind_e in RECURRENT_KINDS:
        tmpl = zeros_like_shapes(block_cache_shape(kind_e, cfg, x.shape[0], cache_len),
                                 x.device)
        x, state = _apply_cell(x, p, kind_e, cfg, tmpl, carry)
        return x, {k: state[k].to(v.dtype) for k, v in tmpl.items()}
    x, fresh = apply_block(x, p, kind, cfg, positions, carry)
    if kind_e == "mla":
        fresh = {"ckv": fresh[0], "kr": fresh[1]}
    elif cfg.kv_cache_dtype == "int8":
        kq, ks = attn.quantize_kv(fresh[0])
        vq, vs = attn.quantize_kv(fresh[1])
        fresh = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        fresh = {"k": fresh[0], "v": fresh[1]}
    # the rank keeps its block of a width its cache splits (MLA latents, an
    # MQA head's columns: models/kvcache.py)
    widths = block_cache_shape(kind_e, cfg, x.shape[0], cache_len)
    fresh = {name: rank_block(val, widths[name][0][-1]) for name, val in fresh.items()}
    s = x.shape[1]
    if kind_e == "local_attn" and cfg.sliding_window is not None:
        rows = min(cache_len, cfg.sliding_window)
        if rows < s:   # the ring keeps the last `rows` positions, slot t % rows
            return x, {name: torch.roll(val[:, s - rows:], s % rows, dims=1)
                       for name, val in fresh.items()}
        cache_len = rows
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
                       tables=None, active=None, carry: bool = False):
    """One-token decode through one block.  A paged cache is recognized by
    its pool keys (``kp``, or ``ckvp`` for MLA); ``tables`` are the block
    tables threaded down from the cache root, ``active`` the live-lane mask
    (see ``model.decode_step``).  Either cache is written in place; the
    recurrent kinds and the local-attention ring keep their per-lane layout
    in both cache modes.  A recurrent state advances on the active lanes
    only (the reference advances every lane, which corrupts the state a
    chunked admission carries between its chunks: ROADMAP queue 3).
    Returns (x_t, cache)."""
    kind = effective_kind(kind, cfg)
    if kind in RECURRENT_KINDS:
        a, state = rec.CELLS[kind][2](_norm1(x_t, p, cfg), p["cell"], cfg, cache)
        for name, val in state.items():
            if active is not None:
                # an idle lane keeps its state: a chunked admission in flight
                # carries it between chunks while the other lanes decode
                keep = active.reshape((-1,) + (1,) * (val.ndim - 1))
                val = torch.where(keep, val, cache[name])
            cache[name].copy_(val)
        if kind == "rglru":
            return _residual_mlp(x_t, a, p, cfg, carry=carry), cache
        return _add(x_t, a, carry), cache
    h = _norm1(x_t, p, cfg)
    if kind == "mla":
        if "ckvp" in cache:
            a, cache = attn.mla_paged_decode(h, p["attn"], cfg, cache, pos, tables,
                                             active=active)
        else:
            a, _ = attn.mla_decode(h, p["attn"], cfg, cache["ckv"], cache["kr"], pos)
    elif kind in _ATTN_KINDS:
        if "kp" in cache:
            a, cache = attn.paged_attention_decode(h, p["attn"], cfg, cache, pos, tables,
                                                   active=active)
        else:
            window = cfg.sliding_window if kind == "local_attn" else None
            a, cache = attn.attention_decode(h, p["attn"], cfg, cache, pos, window=window)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    return _residual_mlp(x_t, a, p, cfg, carry=carry), cache


def apply_block_verify(x, p, kind: str, cfg: ModelConfig, cache, pos, tables=None,
                       active=None, carry: bool = False):
    """W-token speculative verify through one block (the verify twin of
    :func:`apply_block_decode`), for the row-independent kinds only:
    ``attn``, ``mla`` and ``dense_ffn_layer``, as in the reference (a
    routed FFN's capacity depends on the dispatch width).  The norms reduce
    the window column by column (``layers.rmsnorm_columns``), as the decode
    step reduces its rows.  Returns (x, cache)."""
    kind = effective_kind(kind, cfg)
    h = _norm1(x, p, cfg, norm=rmsnorm_columns)
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
    return _residual_mlp(x, a, p, cfg, norm=rmsnorm_columns, carry=carry), cache
