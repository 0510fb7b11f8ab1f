"""GQA attention: chunked prefill, slot-cache decode and paged decode.

Port of the ``"attn"`` parts of ``repro/models/attention.py``.  Query heads
group as ``q.reshape(b, s, g, hkv, d)`` exactly as in the reference, so
query head ``h`` reads KV head ``h % hkv``.

Plain PyTorch, as the reference computes these outside Pallas:

* prefill attention (:func:`multihead_attention`), query-chunked at the
  reference's sizes so that its memory grows as chunk x prompt;
* slot-cache decode (:func:`attention_decode`): the token's K/V goes into
  row ``pos`` of its lane's contiguous cache, in place, then
  :func:`_decode_attend` attends rows ``0..pos``.

Paged decode (:func:`paged_attention_decode`) writes the new token's K/V
into its page in place, then attends through the CUDA kernel
(``kernels/paged_attention``) on CUDA tensors, or through the gather twin
(``_gather_pages`` + ``_decode_attend``) on CPU tensors.  Both decode paths
use the reference's ``"jnp"`` numerics: bf16 operands and probabilities
cast to bf16 before PV.

A chunked-prefill step (:func:`attention_chunk`) writes a prompt chunk's
K/V into its lane's pages in place, then attends the gathered table row
under the causal mask in plain torch, as the reference computes it in jnp
(int8 pools attend their dequantized pages).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models.layers import apply_rope, init_linear, linear

NEG_INF = -1e30


def init_attention(cfg: ModelConfig, gen: torch.Generator, device, stack=()):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": init_linear(gen, device, (*stack, d, cfg.n_heads * hd)),
        "wk": init_linear(gen, device, (*stack, d, cfg.n_kv_heads * hd)),
        "wv": init_linear(gen, device, (*stack, d, cfg.n_kv_heads * hd)),
        "wo": init_linear(gen, device, (*stack, cfg.n_heads * hd, d)),
    }


def _neg_inf_like(t):
    return torch.tensor(NEG_INF, dtype=t.dtype, device=t.device)


def _pick_chunk(s: int) -> int:
    """Query rows per chunk: the reference's sizes and rule (one pass when
    none divides ``s`` with more than one chunk)."""
    for c in (512, 256, 128, 64):
        if s % c == 0 and s > c:
            return c
    return s


def _attend_chunk(q, k, v, q_offset: int, prob_dtype):
    """Causal attention of query rows ``q_offset ..`` over every key.

    q: (B, C, G, Hkv, D) bf16; k/v: (B, S, Hkv, D) f32 copies of the bf16
    keys and values.  Exact f32 softmax: f32 accumulation, probabilities
    rounded to ``prob_dtype`` (v's own dtype) before PV."""
    d = q.shape[-1]
    scores = torch.einsum("bcghd,bshd->bcghs", q.float(), k) * (d ** -0.5)
    qpos = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = kpos <= qpos
    scores = torch.where(mask[None, :, None, None, :], scores, _neg_inf_like(scores))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bcghs,bshd->bcghd", probs.to(prob_dtype).float(), v)
    return out.to(q.dtype)


def multihead_attention(q, k, v):
    """Causal GQA. q: (B, Sq, Hq, D), k/v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D).

    Query-chunked as the reference chunks it (:func:`_pick_chunk`: 512,
    256, 128 or 64 rows), so the f32 scores of one chunk, (B, C, G, Hkv,
    Skv), are the largest tensor and memory grows as C x Skv, not Sq x Skv.
    That bound is what lets a long prompt prefill: at 16,384 tokens and 32
    heads, unchunked scores would take 34 GB a copy.  Every query row is
    computed the same way in either form; a prompt length that the
    reference leaves in one pass stays in one pass here."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hq // hkv, hkv, d)
    kf, vf = k.float(), v.float()
    chunk = _pick_chunk(sq)
    out = torch.cat([_attend_chunk(qg[:, i:i + chunk], kf, vf, i, v.dtype)
                     for i in range(0, sq, chunk)], dim=1)
    return out.reshape(b, sq, hq, v.shape[-1])


def attention_block(x, p, cfg: ModelConfig, positions):
    """Full causal self-attention over x: projections + RoPE + attend + output.
    Returns (out, (k, v)) with the fresh K/V for the cache."""
    b, s, _ = x.shape
    hd, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    qm, be = cfg.quant_mode, cfg.gemm_backend
    q = linear(x, p["wq"], qm, be).reshape(b, s, hq, hd)
    k = linear(x, p["wk"], qm, be).reshape(b, s, hkv, hd)
    v = linear(x, p["wv"], qm, be).reshape(b, s, hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = multihead_attention(q, k, v)
    return linear(out.reshape(b, s, hq * hd), p["wo"], qm, be), (k, v)


def quantize_kv(t):
    """(..., D) -> int8 payload + per-row f32 scale over D (byte-size KV).
    The constant division is a reciprocal multiply, as in quant/qtensor.py."""
    tf = t.float()
    absmax = tf.abs().amax(dim=-1)
    scale = torch.clamp_min(absmax, 1e-8) * (1.0 / 127.0)
    q = torch.round(tf / scale[..., None]).clamp_(-127, 127).to(torch.int8)
    return q, scale


def _decode_qkv(x_t, p, cfg: ModelConfig, pos):
    """Decode-side projections + RoPE. Returns q, k, v (B, 1, H, D)."""
    b = x_t.shape[0]
    hd, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    qm, be = cfg.quant_mode, cfg.gemm_backend
    q = linear(x_t, p["wq"], qm, be).reshape(b, 1, hq, hd)
    k = linear(x_t, p["wk"], qm, be).reshape(b, 1, hkv, hd)
    v = linear(x_t, p["wv"], qm, be).reshape(b, 1, hkv, hd)
    posb = pos[:, None]
    return apply_rope(q, posb, cfg.rope_theta), apply_rope(k, posb, cfg.rope_theta), v


def _decode_attend(qg, k_cache, v_cache, k_scale, v_scale, valid):
    """Single-token attention over a logically contiguous KV view.

    qg: (B, C, G, Hkv, D) bf16; k_cache/v_cache: (B, S, Hkv, D) payloads
    (int8 when scales are given); valid: (B, S) bool.  Returns f32
    (B, C, G, Hkv, D)."""
    hd = qg.shape[-1]
    int8_cache = k_scale is not None
    k_op = k_cache.to(qg.dtype) if int8_cache else k_cache
    scores = torch.einsum("bcghd,bshd->bcghs", qg.float(), k_op.float()) * (hd ** -0.5)
    if int8_cache:
        scores = scores * k_scale.permute(0, 2, 1)[:, None, None, :, :]
    scores = torch.where(valid[:, None, None, None, :], scores, _neg_inf_like(scores))
    probs = torch.softmax(scores, dim=-1)
    if int8_cache:
        probs = probs * v_scale.permute(0, 2, 1)[:, None, None, :, :]
        v_op = v_cache.to(qg.dtype)
    else:
        v_op = v_cache
    return torch.einsum("bcghs,bshd->bcghd", probs.to(v_op.dtype).float(), v_op.float())


def attention_decode(x_t, p, cfg: ModelConfig, cache, pos, *, window=None):
    """One-token decode over a slot cache.

    cache: {"k","v"[,"k_scale","v_scale"]} (B, Smax, Hkv, D) lanes; pos
    (B,) int32.  The token's K/V (quantized for int8 caches) is written
    into row ``pos`` of each lane IN PLACE, clamped to the last row as the
    reference's ``dynamic_update_slice`` clamps, then rows ``0..pos`` are
    attended.  Returns (out (B, 1, d_model), cache)."""
    if window is not None:
        raise NotImplementedError("windowed (ring) decode caches belong to local_attn, "
                                  "not ported yet (ROADMAP queue 1, item 7)")
    b = x_t.shape[0]
    hd, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    int8_cache = cfg.kv_cache_dtype == "int8"
    q, k, v = _decode_qkv(x_t, p, cfg, pos)

    k_cache, v_cache = cache["k"], cache["v"]
    smax = k_cache.shape[1]
    lanes = torch.arange(b, device=pos.device)
    row = torch.clamp(pos.long(), 0, smax - 1)
    k_scale = v_scale = None
    if int8_cache:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        k_cache[lanes, row] = kq[:, 0]
        v_cache[lanes, row] = vq[:, 0]
        k_scale, v_scale = cache["k_scale"], cache["v_scale"]
        k_scale[lanes, row] = ks[:, 0]
        v_scale[lanes, row] = vs[:, 0]
    else:
        k_cache[lanes, row] = k[:, 0].to(k_cache.dtype)
        v_cache[lanes, row] = v[:, 0].to(v_cache.dtype)

    qg = q.reshape(b, 1, hq // hkv, hkv, hd)
    valid = torch.arange(smax, device=pos.device)[None, :] <= pos[:, None]
    out = _decode_attend(qg, k_cache, v_cache, k_scale, v_scale, valid)
    out = out.to(x_t.dtype).reshape(b, 1, hq * hd)
    return linear(out, p["wo"], cfg.quant_mode, cfg.gemm_backend), cache


def _resolve_paged_impl(cfg: ModelConfig, device: torch.device) -> str:
    """The device decides: CUDA tensors run the kernel, CPU tensors the
    gather twin.  The twin never serves CUDA tensors."""
    if device.type != "cuda":
        return "gather"
    if cfg.paged_attn_impl == "gather":
        raise ValueError("paged_attn_impl='gather' is the CPU twin; CUDA tensors "
                         "run the paged_attention kernel")
    return "kernel"


def _write_page(tables, pos, page_size, active):
    """(physical page, in-page offset) each lane's next token writes to.

    Inactive lanes are redirected to the reserved trash page 0: a lane's
    pages return to the shared pool on eviction, so a write through a
    stale table entry would corrupt whichever request owns that page now.
    """
    idx = torch.clamp(pos.long() // page_size, 0, tables.shape[1] - 1)
    pg = torch.gather(tables, 1, idx[:, None])[:, 0].long()
    off = pos.long() % page_size
    if active is not None:
        pg = torch.where(active, pg, 0)
        off = torch.where(active, off, 0)
    return pg, off


def _gather_pages(pool, tables):
    """(n_pages, page_size, ...) pool + (B, P) tables -> (B, P*page_size, ...)
    logically contiguous per-lane view."""
    b, n_tbl = tables.shape
    g = pool[tables.long()]
    return g.reshape((b, n_tbl * pool.shape[1]) + tuple(pool.shape[2:]))


def paged_attention_decode(x_t, p, cfg: ModelConfig, cache, pos, tables, *,
                           active=None):
    """One-token decode over this layer's page pools.

    cache: {"kp","vp"[,"kp_scale","vp_scale"]} (n_pages, page_size, Hkv, D)
    views of the layer's pools; tables (B, P) int32; pos (B,) int32.  The
    new token's K/V is written into page ``tables[b, pos // page_size]`` IN
    PLACE (``index_put_`` on the pool), then attention runs over
    ``pos + 1`` rows.  Returns (out (B, 1, d_model), cache)."""
    b = x_t.shape[0]
    hd, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    int8_cache = "kp_scale" in cache
    q, k, v = _decode_qkv(x_t, p, cfg, pos)

    kp, vp = cache["kp"], cache["vp"]
    page_size = kp.shape[1]
    pg, off = _write_page(tables, pos, page_size, active)
    if int8_cache:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        kp[pg, off] = kq[:, 0]
        vp[pg, off] = vq[:, 0]
        cache["kp_scale"][pg, off] = ks[:, 0]
        cache["vp_scale"][pg, off] = vs[:, 0]
    else:
        kp[pg, off] = k[:, 0].to(kp.dtype)
        vp[pg, off] = v[:, 0].to(vp.dtype)

    g = hq // hkv
    if _resolve_paged_impl(cfg, x_t.device) == "gather":
        qg = q.reshape(b, 1, g, hkv, hd)
        smax = tables.shape[1] * page_size
        k_all, v_all = _gather_pages(kp, tables), _gather_pages(vp, tables)
        ks_all = _gather_pages(cache["kp_scale"], tables) if int8_cache else None
        vs_all = _gather_pages(cache["vp_scale"], tables) if int8_cache else None
        valid = torch.arange(smax, device=pos.device)[None, :] <= pos[:, None]
        out = _decode_attend(qg, k_all, v_all, ks_all, vs_all, valid)
    else:
        qk = q[:, 0].reshape(b, g, hkv, hd).permute(0, 2, 1, 3).contiguous()
        out = paged_attention(
            qk, kp, vp, tables, (pos + 1).to(torch.int32),
            k_scale=cache.get("kp_scale"), v_scale=cache.get("vp_scale"))
        out = out.permute(0, 2, 1, 3)[:, None]          # (B, 1, G, Hkv, D)
    out = out.to(x_t.dtype).reshape(b, 1, hq * hd)
    return linear(out, p["wo"], cfg.quant_mode, cfg.gemm_backend), cache


def _chunk_pages(tables_row, start: int, chunk: int, page_size: int):
    """(page, in-page offset) of chunk positions ``start + [0, chunk)`` of
    one lane; tables_row: (1, P).  Positions past the table clamp to its
    last entry, as the reference's ``take_along_axis(mode="clip")``."""
    idx = start + torch.arange(chunk, device=tables_row.device)
    pg = tables_row[0, torch.clamp(idx // page_size, 0, tables_row.shape[1] - 1)]
    return pg.long(), idx % page_size


def attention_chunk(x, p, cfg: ModelConfig, cache, tables_row, start: int, *, positions):
    """Chunked-prefill extend of one lane's paged KV (B == 1).

    x: (1, C, d) chunk hidden states; cache: this layer's page pools;
    tables_row: (1, P) block-table row; start: absolute position of the
    chunk's first token; positions: (1, C) for RoPE.  Writes the chunk's
    K/V (quantized for int8 pools) into the lane's pages IN PLACE, then
    attends the gathered row (earlier chunks + this one) under the causal
    mask; int8 pools attend their dequantized pages.  Earlier chunks' rows
    read back exactly what a one-shot prefill computes on bf16 pools, and
    a padded tail is overwritten before any query can attend it.  Returns
    (out (1, C, d_model), cache)."""
    b, cs, _ = x.shape
    hd, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    qm, be = cfg.quant_mode, cfg.gemm_backend
    int8_cache = "kp_scale" in cache
    q = linear(x, p["wq"], qm, be).reshape(b, cs, hq, hd)
    k = linear(x, p["wk"], qm, be).reshape(b, cs, hkv, hd)
    v = linear(x, p["wv"], qm, be).reshape(b, cs, hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    kp, vp = cache["kp"], cache["vp"]
    pg, off = _chunk_pages(tables_row, start, cs, kp.shape[1])
    if int8_cache:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        kp[pg, off] = kq[0]
        vp[pg, off] = vq[0]
        cache["kp_scale"][pg, off] = ks[0]
        cache["vp_scale"][pg, off] = vs[0]
    else:
        kp[pg, off] = k[0].to(kp.dtype)
        vp[pg, off] = v[0].to(vp.dtype)

    k_all, v_all = _gather_pages(kp, tables_row), _gather_pages(vp, tables_row)
    if int8_cache:
        ks_all = _gather_pages(cache["kp_scale"], tables_row)
        vs_all = _gather_pages(cache["vp_scale"], tables_row)
        k_all = (k_all.float() * ks_all[..., None]).to(x.dtype)
        v_all = (v_all.float() * vs_all[..., None]).to(x.dtype)
    qg = q.reshape(b, cs, hq // hkv, hkv, hd)
    out = _attend_chunk(qg, k_all.float(), v_all.float(), start, v_all.dtype)
    out = out.reshape(b, cs, hq * hd)
    return linear(out, p["wo"], qm, be), cache
