"""Recurrent blocks: RG-LRU (RecurrentGemma / Griffin) and xLSTM (mLSTM,
sLSTM).

Port of ``repro/models/recurrent.py``, forward only.  The projections go
through :func:`layers.linear` (the SPOGA quant modes, ``spoga_gemm_dequant``
on the card at ``int8_spoga``); the recurrences are plain f32 torch ops, as
the reference computes them in jnp outside Pallas.

* RG-LRU prefills with the reference's associative scan, mirrored step for
  step (:func:`associative_scan`: JAX's ``_scan`` recursion of pair
  reductions, a recursive scan of the pairs, the even-position combine and
  the interleave), and decodes with the O(1) update.  XLA:CPU contracts the
  combine's ``ar * bl + br`` (and the carried state's fold into the first
  step) into one fused multiply-add; :func:`fma` rounds it once the same
  way, so the scan over given coefficients is bitwise the jitted
  reference's.
* mLSTM runs the chunkwise-parallel form: attention-like math inside
  chunks of 256 rows, a sequential loop over chunk boundaries carrying the
  (C, n) matrix memory.  Its cumulative sum of the log forget gates is
  :func:`xla_cumsum`, the order XLA's compiled ``cumsum`` adds in.
* sLSTM is sequential (recurrent block-diagonal ``r_zifo``): a loop over
  the tokens.

The elementwise transcendental functions (``exp``, ``tanh``, the logistic,
``log1p``) are PyTorch's; XLA's CPU versions differ from them in the last
ulp for some inputs, so the cells hold the reference within the
tolerances their tests state (ROADMAP queue 3).

The ``*_chunk`` cells run one chunk of a chunked prefill with only its
first ``n_valid`` rows real, carrying the cell state across chunks; pad
rows are neutralized in each cell's own algebra (identity recurrence,
zero gate injection, carry freeze).

On a tensor-parallel mesh (a ``configs.base.RankConfig``) the reference's
specs make the input projections column-parallel and ``w_out``
row-parallel, and each cell runs on the rank's part:

* RG-LRU on its ``lru / tp`` channels (its ``conv_w`` and ``lam``
  blocks); the two gates take the whole conv'd branch, gathered;
* mLSTM on its ``H / tp`` heads (``wq`` / ``wk`` / ``wv`` / ``w_ogate``
  split by head, the replicated ``w_igate`` / ``w_fgate`` read for its
  heads); its ``C`` and ``n`` hold those heads whole, where the spec
  splits every head's trailing ``dh``: the same bytes (ROADMAP queue 3);
* sLSTM on its heads too: ``w_zifo``'s column block is not a head block
  (at tp=2 one rank holds gates z and i of every head), so the gates are
  gathered whole and the rank keeps its heads; the rank holds whole heads
  of ``r_zifo``, where the spec splits its last dim: the same bytes
  (``shard.core._by_head``, ROADMAP queue 3); ``c`` / ``n`` / ``h`` hold
  its heads.

Every cell's state advances on the rank's part alone: no collective runs
inside a recurrence.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    causal_conv1d,
    conv1d_decode,
    init_conv1d,
    init_linear,
    linear,
    rank_block,
    truncated_normal_init,
    whole,
)
from repro_torch.runtime.collectives import model_input


def fma(a, b, c):
    """``a * b + c`` rounded once to f32 (a fused multiply-add): the f32
    product is exact in f64, so only the sum rounds before the cast."""
    return (a.double() * b.double() + c.double()).float()


# ---------------------------------------------------------------------------
# The associative scan and the compiled cumsum, in the reference's order
# ---------------------------------------------------------------------------

def _interleave(even, odd, axis: int):
    n = even.shape[axis] + odd.shape[axis]
    shape = list(even.shape)
    shape[axis] = n
    out = even.new_empty(shape)
    idx = [slice(None)] * even.ndim
    idx[axis] = slice(0, n, 2)
    out[tuple(idx)] = even
    idx[axis] = slice(1, n, 2)
    out[tuple(idx)] = odd
    return out


def associative_scan(combine, elems, axis: int = 1):
    """Inclusive scan of the tuple ``elems`` along ``axis`` by
    ``jax.lax.associative_scan``'s recursion: combine adjacent pairs, scan
    the pairs, combine each odd result with the next even element, and
    interleave.  ``combine(l, r)`` takes and returns tuples."""
    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.ndim
        idx[axis] = slice(start, stop, step)
        return t[tuple(idx)]

    def scan(el):
        n = el[0].shape[axis]
        if n < 2:
            return el
        reduced = combine(tuple(sl(e, 0, n - 1, 2) for e in el),
                          tuple(sl(e, 1, None, 2) for e in el))
        odd = scan(reduced)
        left = odd if n % 2 else tuple(sl(e, 0, -1) for e in odd)
        even = combine(left, tuple(sl(e, 2, None, 2) for e in el))
        even = tuple(torch.cat([sl(e, 0, 1), r], dim=axis) for e, r in zip(el, even))
        return tuple(_interleave(e, o, axis) for e, o in zip(even, odd))

    return scan(tuple(elems))


def _sequential_cumsum(x):
    out = torch.empty_like(x)
    acc = x[..., 0]
    out[..., 0] = acc
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
        out[..., i] = acc
    return out


_CUMSUM_BASE = 16


def xla_cumsum(x):
    """Inclusive cumsum over the last axis in the order XLA's compiled
    ``jnp.cumsum`` adds: up to 16 elements a sequential fold; longer axes
    are cut into tiles of 16 (zero-padded at the end), each tile folded
    sequentially, and each tile's result offset by the sequential sum of
    the earlier tiles' totals (XLA rewrites the cumulative reduce-window
    that way).  Axes up to 256 long, the mLSTM chunk's."""
    n = x.shape[-1]
    if n <= _CUMSUM_BASE:
        return _sequential_cumsum(x)
    tiles = -(-n // _CUMSUM_BASE)
    if tiles > _CUMSUM_BASE:
        raise ValueError(f"xla_cumsum covers {_CUMSUM_BASE ** 2} elements, got {n}")
    pad = x.new_zeros(tuple(x.shape[:-1]) + (tiles * _CUMSUM_BASE - n,))
    xt = torch.cat([x, pad], dim=-1).reshape(tuple(x.shape[:-1]) + (tiles, _CUMSUM_BASE))
    inner = _sequential_cumsum(xt)
    totals = inner[..., -1]
    before = torch.zeros_like(totals)
    acc = torch.zeros_like(totals[..., 0])
    for t in range(1, tiles):
        acc = acc + totals[..., t - 1]
        before[..., t] = acc
    out = inner + before[..., None]
    return out.reshape(tuple(x.shape[:-1]) + (tiles * _CUMSUM_BASE,))[..., :n]


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0


def init_rglru(cfg: ModelConfig, gen, device, stack=()):
    d = cfg.d_model
    lru = cfg.lru_width or d
    return {
        "w_gate_branch": init_linear(gen, device, (*stack, d, lru)),
        "w_x_branch": init_linear(gen, device, (*stack, d, lru)),
        "conv_w": init_conv1d(gen, device, lru, cfg.conv_width, stack),
        "w_rec_gate": init_linear(gen, device, (*stack, lru, lru)),
        "w_in_gate": init_linear(gen, device, (*stack, lru, lru)),
        # a = exp(-c softplus(lam)) lands in [0.9, 0.999]; f32
        "lam": truncated_normal_init(gen, device, (*stack, lru), scale=0.1,
                                     dtype=torch.float32) - 4.0,
        "w_out": init_linear(gen, device, (*stack, lru, d)),
    }


def _gelu(x):
    """``jax.nn.gelu``: its default tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _rglru_coeffs(xb, p, quant_mode, backend=None):
    """The recurrence's (a, b), f32 (B, S, lru), of the conv'd branch xb.
    On a tensor-parallel mesh ``xb`` holds the rank's channels: the gates
    take the whole branch (gathered) and give the rank's columns, so *f*
    follows the gather."""
    xw = model_input(whole(xb, p["w_rec_gate"].shape[-2]))
    r = torch.sigmoid(linear(xw, p["w_rec_gate"], quant_mode, backend, col=True).float())
    i = torch.sigmoid(linear(xw, p["w_in_gate"], quant_mode, backend, col=True).float())
    log_a = -_RGLRU_C * F.softplus(p["lam"]) * r                # <= 0
    a = torch.exp(log_a)
    gated_x = i * xb.float()
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-9)) * gated_x
    return a, b


def _rglru_combine(left, right):
    al, bl = left
    ar, br = right
    return al * ar, fma(ar, bl, br)


def rglru_scan_coeffs(a, b, h0):
    """The associative scan over precomputed (a, b) (B, S, lru) with the
    carried ``h0`` (B, lru) folded into the first step.  Returns (h, h_last)."""
    b = b.clone()
    b[:, 0, :] = fma(a[:, 0, :], h0, b[:, 0, :])
    _, h = associative_scan(_rglru_combine, (a, b), axis=1)
    return h, h[:, -1, :]


def rglru_scan(xb, p, quant_mode, h0=None, backend=None):
    """xb: (B, S, lru) conv'd branch -> (y (B, S, lru) f32, h_last (B, lru))."""
    a, b = _rglru_coeffs(xb, p, quant_mode, backend)
    if h0 is not None:
        return rglru_scan_coeffs(a, b, h0)
    _, h = associative_scan(_rglru_combine, (a, b), axis=1)
    return h, h[:, -1, :]


def rglru_block(x, p, cfg: ModelConfig, state=None):
    """Griffin recurrent block over (B, S, d).  ``state`` (any non-None
    value) asks for the decode state ``{"h": (B, lru), "conv": (B, W-1,
    lru)}`` after the last token: the conv state holds the last W-1 raw
    (pre-conv) branch rows in f32."""
    qm, be = cfg.quant_mode, cfg.gemm_backend
    x = model_input(x)
    gate = _gelu(linear(x, p["w_gate_branch"], qm, be, col=True).float())
    xb_raw = linear(x, p["w_x_branch"], qm, be, col=True)
    xb = causal_conv1d(xb_raw, p["conv_w"])
    h, h_last = rglru_scan(xb, p, qm, None, backend=be)
    out = linear((gate * h).to(x.dtype), p["w_out"], qm, be, row=True)
    if state is None:
        return out, None
    w = cfg.conv_width
    raw = torch.nn.functional.pad(xb_raw.float(), (0, 0, w - 1, 0))
    return out, {"h": h_last, "conv": raw[:, raw.shape[1] - (w - 1):, :]}


def rglru_chunk(x, p, cfg: ModelConfig, state, n_valid: int):
    """Chunked-prefill step over a (1, C, d) chunk whose first ``n_valid``
    rows are real, carrying ``state`` (``h``, and ``conv``: the previous
    chunk's last W-1 raw branch rows, zeros for the first chunk).  Pad
    rows get the identity recurrence (a=1, b=0), so ``h_last`` and the
    conv carry are exact whatever the padding."""
    qm, be = cfg.quant_mode, cfg.gemm_backend
    w = cfg.conv_width
    c = x.shape[1]
    gate = _gelu(linear(x, p["w_gate_branch"], qm, be, col=True).float())
    xb_raw = linear(x, p["w_x_branch"], qm, be, col=True)
    full_raw = torch.cat([state["conv"].float(), xb_raw.float()], dim=1)  # (B, W-1+C, lru)
    xb = torch.zeros_like(full_raw[:, w - 1:, :])
    for i in range(w):
        xb = xb + full_raw[:, i:i + c, :] * p["conv_w"][i]
    xb = xb.to(xb_raw.dtype)
    a, bcoef = _rglru_coeffs(xb, p, qm, be)
    valid = (torch.arange(c, device=x.device) < n_valid)[None, :, None]
    a = torch.where(valid, a, torch.ones_like(a))
    bcoef = torch.where(valid, bcoef, torch.zeros_like(bcoef))
    h, h_last = rglru_scan_coeffs(a, bcoef, state["h"])
    out = linear((gate * h).to(x.dtype), p["w_out"], qm, be, row=True)
    return out, {"h": h_last, "conv": full_raw[:, n_valid:n_valid + w - 1]}


def rglru_decode(x_t, p, cfg: ModelConfig, state):
    """One step. x_t: (B, 1, d); state {"h": (B, lru), "conv": (B, W-1, lru)}."""
    qm, be = cfg.quant_mode, cfg.gemm_backend
    gate = _gelu(linear(x_t, p["w_gate_branch"], qm, be, col=True).float())
    xb = linear(x_t, p["w_x_branch"], qm, be, col=True)[:, 0, :]
    xb_c, conv_state = conv1d_decode(xb, state["conv"], p["conv_w"])
    a, b = _rglru_coeffs(xb_c[:, None, :], p, qm, be)
    h = fma(a[:, 0, :], state["h"], b[:, 0, :])
    y = (gate[:, 0, :] * h).to(x_t.dtype)
    out = linear(y[:, None, :], p["w_out"], qm, be, row=True)
    return out, {"h": h, "conv": conv_state}


# ---------------------------------------------------------------------------
# mLSTM (matrix memory), chunkwise parallel
# ---------------------------------------------------------------------------

_MLSTM_CHUNK = 256


def init_mlstm(cfg: ModelConfig, gen, device, stack=()):
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    return {
        "wq": init_linear(gen, device, (*stack, d, h * dh)),
        "wk": init_linear(gen, device, (*stack, d, h * dh)),
        "wv": init_linear(gen, device, (*stack, d, h * dh)),
        "w_igate": init_linear(gen, device, (*stack, d, h)),
        "w_fgate": init_linear(gen, device, (*stack, d, h)),
        "w_ogate": init_linear(gen, device, (*stack, d, d)),
        "w_out": init_linear(gen, device, (*stack, d, d)),
    }


def _mlstm_chunk_math(q, k, v, logf, logi, C0, n0):
    """One chunk. q, k, v: (B, H, L, dh) f32; logf, logi: (B, H, L);
    C0: (B, H, dh, dh); n0: (B, H, dh).  Returns (h, C1, n1)."""
    L = q.shape[2]
    cum_f = xla_cumsum(logf)                                   # log F_t, inclusive
    # intra-chunk decay D[t, s] = exp(cum_f[t] - cum_f[s]) * exp(logi[s]), s <= t
    dmat = cum_f[..., :, None] - cum_f[..., None, :] + logi[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    dmat = torch.where(mask, dmat, torch.full_like(dmat, float("-inf")))
    D = torch.exp(dmat)
    scores = torch.einsum("bhld,bhsd->bhls", q, k) * D
    intra = torch.einsum("bhls,bhsd->bhld", scores, v)
    Ft = torch.exp(cum_f)[..., None]                           # (B, H, L, 1)
    inter = Ft * torch.einsum("bhld,bhde->bhle", q, C0)
    num = intra + inter
    # normalizer n_t = F_t n0 + sum_s (F_t / F_s) i_s k_s; den = |q . n_t|
    inter_n = Ft * torch.einsum("bhld,bhd->bhl", q, n0)[..., None]
    n_intra = torch.einsum("bhls,bhsd->bhld", D, k)
    qn = torch.einsum("bhld,bhld->bhl", q, n_intra)[..., None] + inter_n
    den = torch.clamp_min(qn.abs(), 1.0)
    h = num / den
    # carry to the next chunk
    FL = torch.exp(cum_f[..., -1])[..., None, None]            # (B, H, 1, 1)
    decay_to_end = torch.exp(cum_f[..., -1:] - cum_f + logi)   # (B, H, L)
    C1 = FL * C0 + torch.einsum("bhl,bhld,bhle->bhde", decay_to_end, k, v)
    n1 = FL[..., 0] * n0 + torch.einsum("bhl,bhld->bhd", decay_to_end, k)
    return h, C1, n1


def _gates(x, p, name: str, cfg: ModelConfig):
    """The (B, S, H) pre-activation of a per-head gate (``w_igate`` /
    ``w_fgate``, replicated over a tensor-parallel mesh), the rank's heads
    (``layers.rank_block``: under autograd its backward gathers every
    rank's heads, so the replicated gate gets its whole gradient).  ``x``
    is the replicated input itself, not its *f*."""
    g = linear(x, p[name], cfg.quant_mode, cfg.gemm_backend).float()
    return rank_block(g, cfg.n_heads)


def _mlstm_inputs(x, p, cfg: ModelConfig):
    """q, k, v (B, H, S, dh) f32 and the log gates (B, H, S): the rank's H
    heads on a tensor-parallel mesh (``wq`` / ``wk`` / ``wv`` column-parallel
    by head, fed through *f*; the replicated gates read ``x`` itself)."""
    qm, be = cfg.quant_mode, cfg.gemm_backend
    b, s, _ = x.shape
    hh, dh = cfg.n_heads, cfg.resolved_head_dim
    xf = model_input(x)

    def heads(t):
        return t.reshape(b, s, hh, dh).transpose(1, 2).float()

    q = heads(linear(xf, p["wq"], qm, be, col=True)) * (dh ** -0.5)
    k = heads(linear(xf, p["wk"], qm, be, col=True)) * (dh ** -0.5)
    v = heads(linear(xf, p["wv"], qm, be, col=True))
    logi = F.logsigmoid(_gates(x, p, "w_igate", cfg)).transpose(1, 2)
    logf = F.logsigmoid(_gates(x, p, "w_fgate", cfg)).transpose(1, 2)
    return q, k, v, logf, logi


def _mlstm_scan(x, p, cfg: ModelConfig, q, k, v, logf, logi, C, n):
    """The chunk loop and the output gate.  Returns (out, C, n)."""
    qm, be = cfg.quant_mode, cfg.gemm_backend
    b, s, _ = x.shape
    L = min(_MLSTM_CHUNK, s)
    assert s % L == 0, f"seq {s} not divisible by mLSTM chunk {L}"
    hs = []
    for c0 in range(0, s, L):
        h, C, n = _mlstm_chunk_math(q[:, :, c0:c0 + L], k[:, :, c0:c0 + L],
                                    v[:, :, c0:c0 + L], logf[..., c0:c0 + L],
                                    logi[..., c0:c0 + L], C, n)
        hs.append(h)
    h = torch.cat(hs, dim=2).transpose(1, 2).reshape(b, s, -1)
    o = torch.sigmoid(linear(model_input(x), p["w_ogate"], qm, be, col=True).float())
    return linear((o * h).to(x.dtype), p["w_out"], qm, be, row=True), C, n


def mlstm_block(x, p, cfg: ModelConfig, state=None):
    """x: (B, S, d) -> (out, new state or None).  ``state`` (``C``, ``n``)
    is the carried matrix memory; None starts from zeros and returns no
    state."""
    b = x.shape[0]
    hh, dh = cfg.n_heads, cfg.resolved_head_dim
    q, k, v, logf, logi = _mlstm_inputs(x, p, cfg)
    if state is None:
        C0 = torch.zeros((b, hh, dh, dh), dtype=torch.float32, device=x.device)
        n0 = torch.zeros((b, hh, dh), dtype=torch.float32, device=x.device)
    else:
        C0, n0 = state["C"], state["n"]
    out, C, n = _mlstm_scan(x, p, cfg, q, k, v, logf, logi, C0, n0)
    return out, (None if state is None else {"C": C, "n": n})


def mlstm_chunk(x, p, cfg: ModelConfig, state, n_valid: int):
    """Chunked-prefill step over a (1, C, d) chunk whose first ``n_valid``
    rows are real.  Pad rows get ``log f = 0`` (decay 1) and ``log i =
    -inf`` (no injection), so the carried (C, n) are the exact-length
    run's."""
    q, k, v, logf, logi = _mlstm_inputs(x, p, cfg)
    valid = (torch.arange(x.shape[1], device=x.device) < n_valid)[None, None, :]
    logf = torch.where(valid, logf, torch.zeros_like(logf))
    logi = torch.where(valid, logi, torch.full_like(logi, float("-inf")))
    out, C, n = _mlstm_scan(x, p, cfg, q, k, v, logf, logi, state["C"], state["n"])
    return out, {"C": C, "n": n}


def mlstm_decode(x_t, p, cfg: ModelConfig, state):
    """One recurrent step. state: {"C": (B, H, dh, dh), "n": (B, H, dh)}."""
    qm, be = cfg.quant_mode, cfg.gemm_backend
    b = x_t.shape[0]
    hh, dh = cfg.n_heads, cfg.resolved_head_dim

    def heads(t):
        return t.reshape(b, hh, dh).float()

    q = heads(linear(x_t, p["wq"], qm, be, col=True)[:, 0]) * (dh ** -0.5)
    k = heads(linear(x_t, p["wk"], qm, be, col=True)[:, 0]) * (dh ** -0.5)
    v = heads(linear(x_t, p["wv"], qm, be, col=True)[:, 0])
    i = torch.sigmoid(_gates(x_t, p, "w_igate", cfg))[:, 0][..., None]
    f = torch.sigmoid(_gates(x_t, p, "w_fgate", cfg))[:, 0][..., None]
    C = f[..., None] * state["C"] + (i * k)[..., :, None] * v[..., None, :]
    n = f * state["n"] + i * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.clamp_min(torch.einsum("bhd,bhd->bh", q, n).abs()[..., None], 1.0)
    h = (num / den).reshape(b, 1, hh * dh)
    o = torch.sigmoid(linear(x_t, p["w_ogate"], qm, be, col=True).float())
    out = linear((o * h).to(x_t.dtype), p["w_out"], qm, be, row=True)
    return out, {"C": C, "n": n}


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, recurrent block-diagonal weights)
# ---------------------------------------------------------------------------

def init_slstm(cfg: ModelConfig, gen, device, stack=()):
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    return {
        "w_zifo": init_linear(gen, device, (*stack, d, 4 * d)),
        "r_zifo": truncated_normal_init(gen, device, (*stack, 4, h, dh, dh), scale=0.02),
        "w_out": init_linear(gen, device, (*stack, d, d)),
    }


def _slstm_step(r_zifo, carry, zifo_t):
    """carry: (c, n, h) each (B, H, dh); zifo_t: (B, 4, H, dh) pre-activations;
    ``r_zifo`` (4, H, dh, dh) f32."""
    c, n, h = carry
    rec = torch.einsum("bhd,ghde->bghe", h, r_zifo)
    z_t, i_t, f_t, o_t = (zifo_t[:, g] + rec[:, g] for g in range(4))
    z = torch.tanh(z_t)
    i = torch.sigmoid(i_t)
    f = torch.sigmoid(f_t)
    o = torch.sigmoid(o_t)
    c1 = f * c + i * z
    n1 = f * n + i
    h1 = o * c1 / torch.clamp_min(n1, 1e-6)
    return (c1, n1, h1), h1


def _slstm_zifo(x, p, cfg: ModelConfig):
    """The (B, S, 4, H, dh) f32 gate pre-activations of the rank's H heads.
    ``w_zifo`` is column-parallel, and its column block is not a head
    block (at tp=2 one rank holds gates z and i of every head): the
    ranks' columns are gathered whole and the rank keeps its heads.  Under
    autograd the gather's backward keeps the rank's columns of a gradient
    that ``rank_block``'s backward made whole (every rank's heads), and
    ``x`` enters the column-parallel ``w_zifo`` through *f*."""
    b, s, d = x.shape
    hh, dh = cfg.n_heads, cfg.resolved_head_dim
    z = whole(linear(model_input(x), p["w_zifo"], cfg.quant_mode, cfg.gemm_backend,
                     col=True), 4 * d)
    return rank_block(z.float().reshape(b, s, 4, d // dh, dh), hh, dim=3)


def _slstm_r(p, cfg: ModelConfig):
    """``r_zifo`` (4, H, dh, dh) f32 of the rank's heads: a rank holds
    whole heads of it (``shard.core._by_head``), so nothing is gathered."""
    return p["r_zifo"].float()


def _slstm_out(x, p, cfg: ModelConfig, hs):
    b, s, _ = x.shape
    h = torch.stack(hs, dim=1).reshape(b, s, -1).to(x.dtype)
    return linear(h, p["w_out"], cfg.quant_mode, cfg.gemm_backend, row=True)


def slstm_block(x, p, cfg: ModelConfig, state=None):
    """x: (B, S, d) -> (out, new state or None); ``state`` is the carried
    ``{"c","n","h"}`` (None starts from zeros and returns no state)."""
    b, s, _ = x.shape
    zifo = _slstm_zifo(x, p, cfg)
    if state is None:
        zeros = torch.zeros((b, cfg.n_heads, cfg.resolved_head_dim), dtype=torch.float32,
                            device=x.device)
        carry = (zeros, zeros, zeros)
    else:
        carry = (state["c"], state["n"], state["h"])
    r = _slstm_r(p, cfg)
    hs = []
    for t in range(s):
        carry, h1 = _slstm_step(r, carry, zifo[:, t])
        hs.append(h1)
    out = _slstm_out(x, p, cfg, hs)
    c, n, h_last = carry
    return out, (None if state is None else {"c": c, "n": n, "h": h_last})


def slstm_chunk(x, p, cfg: ModelConfig, state, n_valid: int):
    """Chunked-prefill step over a (1, C, d) chunk whose first ``n_valid``
    rows are real: pad steps are computed and their carry discarded, so the
    carried (c, n, h) are the exact-length run's."""
    zifo = _slstm_zifo(x, p, cfg)
    carry = (state["c"], state["n"], state["h"])
    r = _slstm_r(p, cfg)
    hs = []
    for t in range(x.shape[1]):
        stepped, h1 = _slstm_step(r, carry, zifo[:, t])
        if t < n_valid:
            carry = stepped
        hs.append(h1)
    out = _slstm_out(x, p, cfg, hs)
    c, n, h = carry
    return out, {"c": c, "n": n, "h": h}


def slstm_decode(x_t, p, cfg: ModelConfig, state):
    b = x_t.shape[0]
    zifo = _slstm_zifo(x_t, p, cfg)[:, 0]
    (c, n, h), h_out = _slstm_step(_slstm_r(p, cfg), (state["c"], state["n"], state["h"]),
                                   zifo)
    out = linear(h_out.reshape(b, 1, -1).to(x_t.dtype), p["w_out"], cfg.quant_mode,
                 cfg.gemm_backend, row=True)
    return out, {"c": c, "n": n, "h": h}


CELLS = {"rglru": (rglru_block, rglru_chunk, rglru_decode),
         "mlstm": (mlstm_block, mlstm_chunk, mlstm_decode),
         "slstm": (slstm_block, slstm_chunk, slstm_decode)}
