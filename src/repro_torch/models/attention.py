"""GQA attention: chunked prefill, slot-cache decode and paged decode.

Port of the ``"attn"`` parts of ``repro/models/attention.py``.  Query heads
group as ``q.reshape(b, s, g, hkv, d)`` exactly as in the reference, so
query head ``h`` reads KV head ``h % hkv``.

Plain PyTorch, as the reference computes these outside Pallas:

* prefill attention (:func:`multihead_attention`), query-chunked at the
  reference's sizes so that its memory grows as chunk x prompt; causal,
  or unmasked for cross-attention (:func:`cross_attention_block` over the
  encoder's K/V from :func:`encode_cross_kv`);
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

A speculative verify window of W rows a lane writes its K/V in place and
attends under a per-row causal mask: over a slot cache in plain torch
(:func:`attention_verify`); over pages (:func:`paged_attention_verify`)
through the gather twin on CPU tensors, and on CUDA tensors through the
``paged_attention`` kernel, the W rows as single-query lanes split as the
decode step splits them.

Multi-head Latent Attention (the MLA section, ``mla_*``) caches the
compressed latents ``c_kv`` and the shared RoPE key instead of K/V.
Prefill and chunk steps reconstruct K/V through the up-projections (the
non-absorbed form); decode and verify attend in latent space (the
absorbed form, :func:`_mla_attend`), over a slot cache or over the
gathered latent pages on either device: the reference's paged MLA path is
its gather form only, so no kernel serves it.

On a tensor-parallel mesh (a ``configs.base.RankConfig``) every block
runs on the rank's query heads: q / k / v (and MLA's ``w_uq`` /
``w_uk`` / ``w_uv``) are column-parallel, ``wo`` row-parallel.  Where the
reference's specs split a width that the rank needs whole, the rank
gathers it over the model axis (exact): an MQA head's columns after the
K / V projections (:func:`_kv_proj`), so RoPE and the attention see the
whole head; a slot cache's or ring's columns of that head before it
attends; MLA's latent columns (``ckv`` / ``ckvp``, and the slot ``kr``)
before the latent products.  The fresh rows it writes are its own block
(``layers.rank_block``).  MLA's absorbed attention runs the rank's
heads in place among zero heads (:func:`_mla_attend_rows`), so its
products have the unsharded step's shapes and bits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, kv_split, model_ways
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models.layers import (
    apply_rope,
    init_linear,
    linear,
    rank_block,
    rmsnorm,
    rmsnorm_columns,
    whole,
)
from repro_torch.runtime.collectives import model_axis, model_input

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


def _attend_chunk(q, k, v, q_offset: int, prob_dtype, kv_offset: int = 0, window=None,
                  causal: bool = True):
    """Attention of query rows ``q_offset ..`` over keys ``kv_offset ..``:
    causal unless ``causal=False``, within ``window`` positions when one is
    given.

    q: (B, C, G, Hkv, D) bf16; k/v: (B, S, Hkv, D) f32 copies of the bf16
    keys and values.  Exact f32 softmax: f32 accumulation, probabilities
    rounded to ``prob_dtype`` (v's own dtype) before PV."""
    d = q.shape[-1]
    scores = torch.einsum("bcghd,bshd->bcghs", q.float(), k) * (d ** -0.5)
    qpos = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
    kpos = kv_offset + torch.arange(k.shape[1], device=q.device)[None, :]
    mask = (kpos <= qpos) | (not causal)
    if window is not None:
        mask &= kpos > qpos - window
    scores = torch.where(mask[None, :, None, None, :], scores, _neg_inf_like(scores))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bcghs,bshd->bcghd", probs.to(prob_dtype).float(), v)
    return out.to(q.dtype)


def multihead_attention(q, k, v, *, causal: bool = True, window=None):
    """GQA, causal unless ``causal=False`` (cross-attention, where ``Sq``
    and ``Skv`` may differ). q: (B, Sq, Hq, D), k/v: (B, Skv, Hkv, D) ->
    (B, Sq, Hq, D).

    Query-chunked as the reference chunks it (:func:`_pick_chunk`: 512,
    256, 128 or 64 rows), so the f32 scores of one chunk, (B, C, G, Hkv,
    Skv), are the largest tensor and memory grows as C x Skv, not Sq x Skv.
    That bound is what lets a long prompt prefill: at 16,384 tokens and 32
    heads, unchunked scores would take 34 GB a copy.  Every query row is
    computed the same way in either form; a prompt length that the
    reference leaves in one pass stays in one pass here.

    ``window`` (sliding-window attention) masks keys more than ``window -
    1`` positions back.  Chunked self-attention (``Sq == Skv``) then reads
    only the key band a chunk needs, ``window + chunk`` rows starting at
    ``max(start - window, 0)`` (clamped into the keys), as the reference
    slices it."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hq // hkv, hkv, d)
    kf, vf = k.float(), v.float()
    chunk = _pick_chunk(sq)
    band = None if window is None or sq != skv or chunk == sq else window + chunk
    outs = []
    for i in range(0, sq, chunk):
        start, rows, kw = 0, skv, {}
        if window is not None:
            if band is not None:
                start = max(i - window, 0)
                start = min(start, skv - band) if skv >= band else 0
                rows = min(band, skv)
            kw = dict(kv_offset=start, window=window)
        outs.append(_attend_chunk(qg[:, i:i + chunk], kf[:, start:start + rows],
                                  vf[:, start:start + rows], i, v.dtype, causal=causal,
                                  **kw))
    return torch.cat(outs, dim=1).reshape(b, sq, hq, v.shape[-1])


def attention_block(x, p, cfg: ModelConfig, positions, window=None, causal: bool = True):
    """Full self-attention over x, causal unless ``causal=False`` (within
    ``window`` positions when one is given): projections + RoPE + attend +
    output.  Returns (out, (k, v)) with the fresh K/V for the cache."""
    b, s, _ = x.shape
    hd, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    qm, be = cfg.quant_mode, cfg.gemm_backend
    x = model_input(x)
    q = linear(x, p["wq"], qm, be, col=True).reshape(b, s, hq, hd)
    k, v = _kv_proj(x, p, cfg)
    k, v = k.reshape(b, s, hkv, hd), v.reshape(b, s, hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = multihead_attention(q, k, v, causal=causal, window=window)
    return linear(out.reshape(b, s, hq * hd), p["wo"], qm, be, row=True), (k, v)


# ---------------------------------------------------------------------------
# Cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------

def init_cross_attention(cfg: ModelConfig, gen: torch.Generator, device, stack=()):
    return init_attention(cfg, gen, device, stack)


def cross_attention_block(x, enc_kv, p, cfg: ModelConfig):
    """x: (B, St, d) decoder states; enc_kv: the encoder's (k, v), each
    (B, Ssrc, Hkv, D), from :func:`encode_cross_kv`.  Every decoder row
    attends every encoder row (no mask, no RoPE)."""
    b, s, _ = x.shape
    hd, hq = cfg.resolved_head_dim, cfg.n_heads
    qm, be = cfg.quant_mode, cfg.gemm_backend
    q = linear(model_input(x), p["wq"], qm, be, col=True).reshape(b, s, hq, hd)
    k, v = enc_kv
    out = multihead_attention(q, k, v, causal=False)
    return linear(out.reshape(b, s, hq * hd), p["wo"], qm, be, row=True)


def encode_cross_kv(enc_out, p, cfg: ModelConfig):
    """The encoder output's cross K/V for one decoder layer, (B, Ssrc, Hkv,
    D) each, bf16 in every quant mode (``linear``'s output).  The
    replicated ``enc_out`` enters each decoder layer's split K/V
    projections through its own *f*."""
    b, s, _ = enc_out.shape
    hd, hkv = cfg.resolved_head_dim, cfg.n_kv_heads
    k, v = _kv_proj(model_input(enc_out), p, cfg)
    return k.reshape(b, s, hkv, hd), v.reshape(b, s, hkv, hd)


def _kv_proj(x, p, cfg: ModelConfig):
    """The K and V projections of ``x``, (..., Hkv * D) each, column-parallel
    on a tensor-parallel mesh.  An MQA head split by its columns
    (``cfg.kv_split``: the spec splits ``wk`` / ``wv``'s ``head_dim``) is
    gathered whole, so every rank attends (and applies RoPE, which mixes
    the two halves of a head) with the whole head.  The rank's query heads
    read that gathered head, so *f* follows the gather: its backward sums
    the ranks' gradients of the head before the rank keeps its columns."""
    qm, be = cfg.quant_mode, cfg.gemm_backend
    width = cfg.n_kv_heads * cfg.resolved_head_dim

    def head(w):
        t = linear(x, w, qm, be, col=True)
        full = whole(t, width)
        return full if full is t else model_input(full)

    return head(p["wk"]), head(p["wv"])


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
    q = linear(x_t, p["wq"], qm, be, col=True).reshape(b, 1, hq, hd)
    k, v = _kv_proj(x_t, p, cfg)
    k, v = k.reshape(b, 1, hkv, hd), v.reshape(b, 1, hkv, hd)
    posb = pos[:, None]
    return apply_rope(q, posb, cfg.rope_theta), apply_rope(k, posb, cfg.rope_theta), v


def _verify_qkv(x, p, cfg: ModelConfig, pos):
    """W-row verify-window projections + RoPE. x: (B, W, d); pos: (B,) is
    the window's first absolute position. Returns q, k, v (B, W, H, D)."""
    b, w, _ = x.shape
    hd, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    qm, be = cfg.quant_mode, cfg.gemm_backend
    q = linear(x, p["wq"], qm, be, col=True).reshape(b, w, hq, hd)
    k, v = _kv_proj(x, p, cfg)
    k, v = k.reshape(b, w, hkv, hd), v.reshape(b, w, hkv, hd)
    positions = pos[:, None] + torch.arange(w, dtype=pos.dtype, device=pos.device)[None, :]
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _verify_valid(pos, w: int, smax: int):
    """(B, W, S) causal mask for the verify window: query row c of lane b
    sits at absolute position pos[b] + c and may attend kpos <= pos[b] + c
    -- causal within the window, full paged/slot history before it."""
    row_pos = pos[:, None] + torch.arange(w, device=pos.device)[None, :]
    return torch.arange(smax, device=pos.device)[None, None, :] <= row_pos[:, :, None]


def _decode_attend(qg, k_cache, v_cache, k_scale, v_scale, valid):
    """Single-token attention over a logically contiguous KV view.

    qg: (B, C, G, Hkv, D) bf16; k_cache/v_cache: (B, S, Hkv, D) payloads
    (int8 when scales are given); valid: (B, S) bool, or (B, C, S) for a
    per-query-row mask (the speculative verify window, where row c may
    attend one position more than row c-1).  Returns f32 (B, C, G, Hkv,
    D)."""
    hd = qg.shape[-1]
    int8_cache = k_scale is not None
    k_op = k_cache.to(qg.dtype) if int8_cache else k_cache
    scores = torch.einsum("bcghd,bshd->bcghs", qg.float(), k_op.float()) * (hd ** -0.5)
    if int8_cache:
        scores = scores * k_scale.permute(0, 2, 1)[:, None, None, :, :]
    mask = valid[:, None, None, None, :] if valid.ndim == 2 else valid[:, :, None, None, :]
    scores = torch.where(mask, scores, _neg_inf_like(scores))
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
    attended.

    With ``window`` the cache is a ring (local attention, ``Smax <=
    window``): the token goes to slot ``pos % Smax``; before the ring wraps
    slots ``0..pos`` are attended, after it every slot (all lie within the
    window).  Returns (out (B, 1, d_model), cache)."""
    b = x_t.shape[0]
    hd, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    int8_cache = cfg.kv_cache_dtype == "int8"
    q, k, v = _decode_qkv(x_t, p, cfg, pos)

    k_cache, v_cache = cache["k"], cache["v"]
    smax = k_cache.shape[1]
    if window is not None and smax > window:
        raise ValueError("local decode cache must be allocated with Smax == window")
    lanes = torch.arange(b, device=pos.device)
    row = pos.long() % smax if window is not None else torch.clamp(pos.long(), 0, smax - 1)
    k_scale = v_scale = None
    cols = k_cache.shape[-1]
    if int8_cache:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        k_cache[lanes, row] = rank_block(kq[:, 0], cols)
        v_cache[lanes, row] = rank_block(vq[:, 0], cols)
        k_scale, v_scale = cache["k_scale"], cache["v_scale"]
        k_scale[lanes, row] = ks[:, 0]
        v_scale[lanes, row] = vs[:, 0]
    else:
        k_cache[lanes, row] = rank_block(k[:, 0], cols).to(k_cache.dtype)
        v_cache[lanes, row] = rank_block(v[:, 0], cols).to(v_cache.dtype)

    qg = q.reshape(b, 1, hq // hkv, hkv, hd)
    valid = torch.arange(smax, device=pos.device)[None, :] <= pos[:, None]
    if window is not None:
        valid = valid | (pos[:, None] >= smax)
    out = _decode_attend(qg, whole(k_cache, hd), whole(v_cache, hd), k_scale, v_scale, valid)
    out = out.to(x_t.dtype).reshape(b, 1, hq * hd)
    return linear(out, p["wo"], cfg.quant_mode, cfg.gemm_backend, row=True), cache


def attention_verify(x, p, cfg: ModelConfig, cache, pos):
    """W-token speculative verify over a slot cache.

    x: (B, W, d) -- the last accepted token plus the drafted window; pos:
    (B,) absolute position of the window's first row.  Writes all W K/V
    rows at pos..pos+W-1 of each lane IN PLACE (clamped to the lane's last
    row, as the reference's ``dynamic_update_slice`` clamps the window's
    start), then attends the lane under the per-row causal mask.  Rows past
    the eventually-accepted prefix hold garbage, overwritten by the next
    verify/decode step before any query attends them.  Plain torch on both
    devices, as slot decode is.  Returns (out (B, W, d_model), cache)."""
    b, w, _ = x.shape
    hd, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    int8_cache = cfg.kv_cache_dtype == "int8"
    q, k, v = _verify_qkv(x, p, cfg, pos)

    k_cache, v_cache = cache["k"], cache["v"]
    smax = k_cache.shape[1]
    lanes = torch.arange(b, device=pos.device)[:, None]
    start = torch.clamp(pos.long(), 0, smax - w)
    rows = start[:, None] + torch.arange(w, device=pos.device)[None, :]
    k_scale = v_scale = None
    cols = k_cache.shape[-1]
    if int8_cache:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        k_cache[lanes, rows] = rank_block(kq, cols)
        v_cache[lanes, rows] = rank_block(vq, cols)
        k_scale, v_scale = cache["k_scale"], cache["v_scale"]
        k_scale[lanes, rows] = ks
        v_scale[lanes, rows] = vs
    else:
        k_cache[lanes, rows] = rank_block(k, cols).to(k_cache.dtype)
        v_cache[lanes, rows] = rank_block(v, cols).to(v_cache.dtype)

    qg = q.reshape(b, w, hq // hkv, hkv, hd)
    out = _decode_attend(qg, whole(k_cache, hd), whole(v_cache, hd), k_scale, v_scale,
                         _verify_valid(pos, w, smax))
    out = out.to(x.dtype).reshape(b, w, hq * hd)
    return linear(out, p["wo"], cfg.quant_mode, cfg.gemm_backend, row=True), cache


def _resolve_paged_impl(cfg: ModelConfig, device: torch.device) -> str:
    """The device decides: CUDA tensors run the kernel, CPU tensors the
    gather twin.  The twin never serves CUDA tensors."""
    if device.type != "cuda":
        return "gather"
    if cfg.paged_attn_impl == "gather":
        raise ValueError("paged_attn_impl='gather' is the CPU twin; CUDA tensors "
                         "run the paged_attention kernel")
    return "kernel"


def _split_lanes(b: int, cfg: ModelConfig) -> int:
    """The lane count the ``paged_attention`` kernel picks its split from:
    ``b``, times the model axis's size on a tensor-parallel mesh -- a rank
    launches 1/tp of the KV heads, and the kernel sizes its split by lanes
    x KV heads, so each lane and head splits as in the unsharded run and
    its result is the same bits.  An MQA rank's pools hold the whole head
    (``cfg.kv_split``), so it launches the unsharded run's heads."""
    ax = model_axis()
    return b * (ax.size if ax is not None and not kv_split(cfg) else 1)


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
            k_scale=cache.get("kp_scale"), v_scale=cache.get("vp_scale"),
            split_lanes=_split_lanes(b, cfg))
        out = out.permute(0, 2, 1, 3)[:, None]          # (B, 1, G, Hkv, D)
    out = out.to(x_t.dtype).reshape(b, 1, hq * hd)
    return linear(out, p["wo"], cfg.quant_mode, cfg.gemm_backend, row=True), cache


def _write_pages(tables, pos, w: int, page_size: int, active):
    """Multi-row variant of :func:`_write_page`: (B, W) page/offset pairs
    for the verify-window rows ``pos + [0, w)``.  Inactive lanes redirect
    to the reserved trash page 0 for the same pool-safety reason."""
    idx = pos.long()[:, None] + torch.arange(w, device=pos.device)[None, :]   # (B, W)
    pg = torch.gather(tables, 1, torch.clamp(idx // page_size, 0, tables.shape[1] - 1)).long()
    off = idx % page_size
    if active is not None:
        pg = torch.where(active[:, None], pg, 0)
        off = torch.where(active[:, None], off, 0)
    return pg, off


def paged_attention_verify(x, p, cfg: ModelConfig, cache, pos, tables, *, active=None):
    """W-token speculative verify over this layer's page pools.

    The paged twin of :func:`attention_verify`: scatters the window's W
    K/V rows through the block table IN PLACE (the engine reserves the
    overshoot pages up front), then attends.  CPU tensors attend the
    gathered view under the per-row causal mask (the reference's gather
    twin, bitwise).  CUDA tensors launch the ``paged_attention`` kernel,
    which computes exactly this function: the window's W rows go to the
    kernel as B*W single-query lanes, lane b's table row repeated W times
    and row c given length ``pos + c + 1``.  The kernel chooses its split
    count from ``split_lanes`` = B, the decode step's lane count (the
    engine runs every lane in both), so each verify row is split, and its
    partials combined, exactly as the decode step at that position does
    it.  Returns (out (B, W, d_model), cache)."""
    b, w, _ = x.shape
    hd, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    int8_cache = "kp_scale" in cache
    q, k, v = _verify_qkv(x, p, cfg, pos)

    kp, vp = cache["kp"], cache["vp"]
    page_size = kp.shape[1]
    pg, off = _write_pages(tables, pos, w, page_size, active)
    if int8_cache:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        kp[pg, off] = kq
        vp[pg, off] = vq
        cache["kp_scale"][pg, off] = ks
        cache["vp_scale"][pg, off] = vs
    else:
        kp[pg, off] = k.to(kp.dtype)
        vp[pg, off] = v.to(vp.dtype)

    g = hq // hkv
    if _resolve_paged_impl(cfg, x.device) == "gather":
        qg = q.reshape(b, w, g, hkv, hd)
        smax = tables.shape[1] * page_size
        k_all, v_all = _gather_pages(kp, tables), _gather_pages(vp, tables)
        ks_all = _gather_pages(cache["kp_scale"], tables) if int8_cache else None
        vs_all = _gather_pages(cache["vp_scale"], tables) if int8_cache else None
        out = _decode_attend(qg, k_all, v_all, ks_all, vs_all, _verify_valid(pos, w, smax))
    else:
        qk = q.reshape(b * w, g, hkv, hd).permute(0, 2, 1, 3).contiguous()
        lengths = (pos[:, None] + 1
                   + torch.arange(w, dtype=pos.dtype, device=pos.device)[None, :])
        out = paged_attention(
            qk, kp, vp, tables.repeat_interleave(w, dim=0).contiguous(),
            lengths.reshape(b * w).to(torch.int32),
            k_scale=cache.get("kp_scale"), v_scale=cache.get("vp_scale"),
            split_lanes=_split_lanes(b, cfg))
        out = out.permute(0, 2, 1, 3).reshape(b, w, g, hkv, hd)
    out = out.to(x.dtype).reshape(b, w, hq * hd)
    return linear(out, p["wo"], cfg.quant_mode, cfg.gemm_backend, row=True), cache


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
    q = linear(x, p["wq"], qm, be, col=True).reshape(b, cs, hq, hd)
    k, v = _kv_proj(x, p, cfg)
    k, v = k.reshape(b, cs, hkv, hd), v.reshape(b, cs, hkv, hd)
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
    return linear(out, p["wo"], qm, be, row=True), cache


# ---------------------------------------------------------------------------
# MLA -- Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------------

def init_mla(cfg: ModelConfig, gen: torch.Generator, device, stack=()):
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_dq": init_linear(gen, device, (*stack, d, m.q_lora_rank)),
        "q_norm": torch.ones((*stack, m.q_lora_rank), dtype=torch.float32, device=device),
        "w_uq": init_linear(gen, device, (*stack, m.q_lora_rank, h * qk_dim)),
        "w_dkv": init_linear(gen, device, (*stack, d, m.kv_lora_rank)),
        "kv_norm": torch.ones((*stack, m.kv_lora_rank), dtype=torch.float32, device=device),
        "w_uk": init_linear(gen, device, (*stack, m.kv_lora_rank, h * m.qk_nope_head_dim)),
        "w_uv": init_linear(gen, device, (*stack, m.kv_lora_rank, h * m.v_head_dim)),
        "w_kr": init_linear(gen, device, (*stack, d, m.qk_rope_head_dim)),
        "wo": init_linear(gen, device, (*stack, h * m.v_head_dim, d)),
    }


def _mla_qkv(x, p, cfg: ModelConfig, positions, norm=rmsnorm):
    """Query halves and the latents of x (B, S, d): q_nope (B, S, H,
    nope), q_rope (B, S, H, rope) after RoPE, c_kv (B, S, rank) after its
    norm, k_rope (B, S, 1, rope) after RoPE.  ``norm`` is
    ``layers.rmsnorm_columns`` for a verify window (see
    ``transformer.apply_block_verify``).  ``x`` feeds the replicated
    ``w_dq`` / ``w_dkv`` / ``w_kr`` whole, so it needs no *f*; the
    replicated ``cq`` enters the column-parallel ``w_uq`` through *f* here,
    ``c_kv`` and ``k_rope`` their split products in :func:`_mla_kv`."""
    m, h = cfg.mla, cfg.n_heads
    b, s, _ = x.shape
    qm, be = cfg.quant_mode, cfg.gemm_backend
    cq = norm(linear(x, p["w_dq"], qm, be), p["q_norm"], cfg.norm_eps)
    q = linear(model_input(cq), p["w_uq"], qm, be, col=True).reshape(b, s, h, -1)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = norm(linear(x, p["w_dkv"], qm, be), p["kv_norm"], cfg.norm_eps)
    k_rope = linear(x, p["w_kr"], qm, be).reshape(b, s, 1, m.qk_rope_head_dim)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def _mla_kv(c_kv, k_rope, p, cfg: ModelConfig):
    """Reconstruct K (B, S, H, nope + rope) and V (B, S, H, v) from the
    latents (the non-absorbed form of prefill and chunk steps).  The
    replicated latents feed the rank's heads, each through one *f*."""
    m, h = cfg.mla, cfg.n_heads
    b, s, _ = c_kv.shape
    qm, be = cfg.quant_mode, cfg.gemm_backend
    c_kv, k_rope = model_input(c_kv), model_input(k_rope)
    k_nope = linear(c_kv, p["w_uk"], qm, be, col=True).reshape(b, s, h, m.qk_nope_head_dim)
    v = linear(c_kv, p["w_uv"], qm, be, col=True).reshape(b, s, h, m.v_head_dim)
    k = torch.cat([k_nope, k_rope.reshape(b, s, 1, -1).expand(b, s, h, m.qk_rope_head_dim)],
                  dim=-1)
    return k, v


def mla_block(x, p, cfg: ModelConfig, positions):
    """Prefill MLA (non-absorbed: K and V reconstructed per token).
    Returns (out, (c_kv (B, S, rank), k_rope (B, S, rope))) for the cache."""
    m, h = cfg.mla, cfg.n_heads
    b, s, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(x, p, cfg, positions)
    k, v = _mla_kv(c_kv, k_rope, p, cfg)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = multihead_attention(q, k, v)
    out = linear(out.reshape(b, s, h * m.v_head_dim), p["wo"], cfg.quant_mode,
                 cfg.gemm_backend, row=True)
    return out, (c_kv, k_rope.reshape(b, s, m.qk_rope_head_dim))


def _mla_attend_rows(q_nope, q_rope, ckv_view, kr_view, valid, p, cfg: ModelConfig):
    """Absorbed attention of one query row a lane; valid: (B, S).

    On a tensor-parallel mesh the rank's heads sit at their place among
    the model's heads, the other heads' queries and ``w_uk`` / ``w_uv``
    columns zero, so every product has the unsharded step's shapes: on
    the card cuBLAS picks its kernel (so its summation order) by the heads
    a product batches or folds into its rows, and a rank's heads then get
    the unsharded step's bits with nothing gathered.  A decode row's heads
    fit one tile of rows, so the zero heads ride in tiles the rank's own
    heads launch anyway; the rank keeps its heads' outputs."""
    m, h = cfg.mla, cfg.n_heads
    w_uk = p["w_uk"].reshape(m.kv_lora_rank, h, m.qk_nope_head_dim)
    w_uv = p["w_uv"].reshape(m.kv_lora_rank, h, m.v_head_dim)
    first, tp = 0, model_ways(cfg)
    if tp > 1:
        first = model_axis().rank * h
        pad = (0, 0, first, (tp - 1) * h - first)
        q_nope, q_rope = F.pad(q_nope, pad), F.pad(q_rope, pad)
        w_uk, w_uv = F.pad(w_uk, pad), F.pad(w_uv, pad)
    # the reference's bf16 einsums accumulate in f32; bf16 values are
    # exact in f32, so f32 operands give its products
    q_lat = torch.einsum("bchd,lhd->bchl", q_nope.float(), w_uk.float())
    scores = torch.einsum("bchl,bsl->bchs", q_lat.to(ckv_view.dtype).float(),
                          ckv_view.float())
    scores = scores + torch.einsum("bchr,bsr->bchs", q_rope.to(kr_view.dtype).float(),
                                   kr_view.float())
    scores = scores * (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    scores = torch.where(valid[:, None, None, :], scores, _neg_inf_like(scores))
    probs = torch.softmax(scores, dim=-1)
    out_lat = torch.einsum("bchs,bsl->bchl", probs.to(ckv_view.dtype).float(),
                           ckv_view.float())
    out = torch.einsum("bchl,lhv->bchv", out_lat, w_uv.float())
    return out[:, :, first:first + h]


def _mla_attend(q_nope, q_rope, ckv_view, kr_view, pos, p, cfg: ModelConfig):
    """Absorbed-matmul MLA attention over a logically contiguous latent view.

    ckv_view: (B, S, rank); kr_view: (B, S, rope).  Shared by the slot
    path and the paged gather form.  q_nope/q_rope may carry C > 1 query
    rows (the speculative verify window): row c attends positions
    ``<= pos + c`` and is computed alone, with the decode step's shapes, so
    each verify row sums in the decode step's order on any device (one
    batched pass over the window sums otherwise on an H100: row 0 differs
    from the decode step, ``test_mla_verify_rows_are_the_decode_steps_on_card``).
    Returns f32 (B, C, H * v_head_dim)."""
    m, h = cfg.mla, cfg.n_heads
    b, c = q_nope.shape[:2]
    kpos = torch.arange(ckv_view.shape[1], device=pos.device)[None, :]
    out = torch.cat([
        _mla_attend_rows(q_nope[:, r:r + 1], q_rope[:, r:r + 1], ckv_view, kr_view,
                         kpos <= (pos[:, None] + r), p, cfg)
        for r in range(c)], dim=1)
    return out.reshape(b, c, h * m.v_head_dim)


def mla_decode(x_t, p, cfg: ModelConfig, ckv_cache, krope_cache, pos):
    """Absorbed-matmul MLA decode over slot caches of latents: the token's
    (c_kv, k_rope) go into row ``pos`` of each lane in place (clamped to the
    last row, as ``dynamic_update_slice`` clamps), then rows ``0..pos`` are
    attended in latent space.  Returns (out, (ckv_cache, krope_cache))."""
    return mla_verify(x_t, p, cfg, ckv_cache, krope_cache, pos, norm=rmsnorm)


def mla_verify(x, p, cfg: ModelConfig, ckv_cache, krope_cache, pos, norm=None):
    """W-token speculative verify over the slot latent caches (the MLA twin
    of :func:`attention_verify`; W = 1 is :func:`mla_decode`).  Writes the
    window's latents at rows ``pos .. pos + W - 1`` in place (the start
    clamped so the window fits), then attends under the per-row causal
    mask.  The window's norms reduce column by column
    (``layers.rmsnorm_columns``), as the decode step reduces its rows."""
    m = cfg.mla
    b, w, _ = x.shape
    positions = pos[:, None] + torch.arange(w, dtype=pos.dtype, device=pos.device)[None, :]
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(x, p, cfg, positions,
                                            norm=norm or rmsnorm_columns)
    smax = ckv_cache.shape[1]
    lanes = torch.arange(b, device=pos.device)[:, None]
    start = torch.clamp(pos.long(), 0, smax - w)
    rows = start[:, None] + torch.arange(w, device=pos.device)[None, :]
    ckv_cache[lanes, rows] = rank_block(c_kv, ckv_cache.shape[-1]).to(ckv_cache.dtype)
    krope_cache[lanes, rows] = rank_block(k_rope.reshape(b, w, m.qk_rope_head_dim),
                                          krope_cache.shape[-1]).to(krope_cache.dtype)
    out = _mla_attend(q_nope, q_rope, whole(ckv_cache, m.kv_lora_rank),
                      whole(krope_cache, m.qk_rope_head_dim), pos, p, cfg).to(x.dtype)
    return linear(out, p["wo"], cfg.quant_mode, cfg.gemm_backend, row=True), (ckv_cache, krope_cache)


def mla_paged_decode(x_t, p, cfg: ModelConfig, cache, pos, tables, *, active=None):
    """Absorbed MLA decode over latent page pools.

    cache: {"ckvp","krp"} (n_pages, page_size, rank / rope) views of the
    layer's pools.  The token's latents go into page ``tables[b, pos //
    page_size]`` in place (inactive lanes into the trash page), then the
    lane's gathered latent view is attended, on CPU and CUDA tensors
    alike: the reference serves paged MLA through its gather form only.
    Returns (out (B, 1, d_model), cache)."""
    return _mla_paged(x_t, p, cfg, cache, pos, tables, active, rmsnorm)


def mla_paged_verify(x, p, cfg: ModelConfig, cache, pos, tables, *, active=None):
    """W-token speculative verify over the latent page pools (the paged
    twin of :func:`mla_verify`, gather form like :func:`mla_paged_decode`)."""
    return _mla_paged(x, p, cfg, cache, pos, tables, active, rmsnorm_columns)


def _mla_paged(x, p, cfg: ModelConfig, cache, pos, tables, active, norm):
    m = cfg.mla
    b, w, _ = x.shape
    positions = pos[:, None] + torch.arange(w, dtype=pos.dtype, device=pos.device)[None, :]
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(x, p, cfg, positions, norm=norm)
    ckvp, krp = cache["ckvp"], cache["krp"]
    pg, off = _write_pages(tables, pos, w, ckvp.shape[1], active)
    ckvp[pg, off] = rank_block(c_kv, ckvp.shape[-1]).to(ckvp.dtype)
    krp[pg, off] = k_rope.reshape(b, w, m.qk_rope_head_dim).to(krp.dtype)
    out = _mla_attend(q_nope, q_rope, whole(_gather_pages(ckvp, tables), m.kv_lora_rank),
                      _gather_pages(krp, tables), pos, p, cfg).to(x.dtype)
    return linear(out, p["wo"], cfg.quant_mode, cfg.gemm_backend, row=True), cache


def mla_chunk(x, p, cfg: ModelConfig, cache, tables_row, start: int, *, positions):
    """Chunked-prefill extend of one lane's paged MLA latents (B == 1).

    The chunk's latents are written to its pages in place, then K/V are
    recomputed from the gathered latents through the up-projections (the
    non-absorbed form of :func:`mla_block`): the latent pages hold bf16
    exactly and every projection is row-independent, so earlier chunks'
    rows give what a one-shot prefill computes.  Returns (out (1, C,
    d_model), cache)."""
    m, h = cfg.mla, cfg.n_heads
    b, cs, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(x, p, cfg, positions)
    ckvp, krp = cache["ckvp"], cache["krp"]
    pg, off = _chunk_pages(tables_row, start, cs, ckvp.shape[1])
    ckvp[pg, off] = rank_block(c_kv[0], ckvp.shape[-1]).to(ckvp.dtype)
    krp[pg, off] = k_rope.reshape(b, cs, m.qk_rope_head_dim)[0].to(krp.dtype)
    k_all, v_all = _mla_kv(whole(_gather_pages(ckvp, tables_row), m.kv_lora_rank),
                           _gather_pages(krp, tables_row), p, cfg)
    q = torch.cat([q_nope, q_rope], dim=-1)
    qg = q.reshape(b, cs, 1, h, q.shape[-1])
    out = _attend_chunk(qg, k_all.float(), v_all.float(), start, v_all.dtype)
    out = out.to(x.dtype).reshape(b, cs, h * m.v_head_dim)
    return linear(out, p["wo"], cfg.quant_mode, cfg.gemm_backend, row=True), cache
