"""Model entry points: init / forward / loss / caches / prefill / decode / verify
for every architecture of the reference (decoder-only, encoder-decoder,
frontend-fed).

Port of ``repro/models/model.py``.  Parameter layout mirrors the
reference's (plain dicts of tensors):

    {"embed": (V, d) bf16,
     "head_blocks": [per-layer trees of the first_k_dense layers],
     "blocks": (slot_0_tree, ...),   # leaves stacked over n_periods
     "tail_blocks": [per-layer trees],
     "final_norm": (d,) f32,
     "head": (V, d) bf16 (absent if tied),
     # encoder-decoder only:
     "enc_blocks": (attn slot tree stacked over n_encoder_layers,),
     "enc_tail_blocks": [],
     "enc_final_norm": (d,) f32,
     "cross_blocks": {"xattn": {wq, wk, wv, wo}, "norm_x"}  # over n_periods}

A batch is the reference's dict: ``{"tokens": (B, S)}``, precomputed
frontend embeddings ``{"embeds": (B, S, d)}``, or for an encoder-decoder
``{"src_embeds": (B, Ssrc, d), "tgt_tokens": (B, St)}``.  The encoder is
causal, as the reference's ``_run_encoder`` runs it.  After each decoder
period an encoder-decoder runs its cross-attention block on
``rmsnorm(h, norm_x)`` and adds it to the stream: :func:`forward`
projects the encoder's K/V anew in each period, :func:`prefill` once per
period into ``cache["cross_kv"]``, which :func:`decode_step` reads.

The reference's ``lax.scan`` over periods is a Python loop here.  Decode
runs over a contiguous (slot) cache or a paged one; its writes land in the
cache in place.

:func:`lm_loss` is the training loss: the chunked cross-entropy of
:func:`_chunked_ce` plus the MoE load-balance loss; with ``cfg.remat``
each period recomputes in the backward (:func:`_remat_period`).  Under
FSDP (``runtime.collectives.data_sharded``, entered by the sharded train
step, or a dry-run cell's prefill or decode step) every layer's leaves
are gathered over "data" just before the layer runs, one period's slice
of a stacked leaf at a time (``collectives.gather_params``); a
rematerialized period gathers again in its recompute instead of keeping
the gathered weights alive.  On a
tensor-parallel mesh the head's logits are vocab-parallel and gathered
over "model" before the cross-entropy.

``forward``, ``lm_loss``, ``prefill``, ``decode_step`` and ``verify_step`` run inside
the numerics watchdog's context when ``cfg.numerics_watchdog`` is set
(:func:`_watched`); each period of a stack reuses the first period's
GEMM labels, as the reference's scanned body does.

Each of them also takes ``mesh=`` (a ``launch.mesh.Mesh``): the call then
runs inside ``runtime.collectives.model_parallel(mesh)`` on the rank's
part of the weights (``shard.shard_params``) and of the cache, with the
full config turned into the rank's (``shard.local_config``: its own query
and KV heads).  A caller that keeps the rank's config itself (the serving
engine) enters the context once and passes that config, without
``mesh=``.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig, pages_for
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
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
    init_embedding,
    init_rmsnorm,
    rmsnorm,
    rmsnorm_columns,
    unembed,
)
from repro_torch.obs import watchdog as _watchdog
from repro_torch.runtime.collectives import batch_total, gather_params, model_parallel
from repro_torch.shard.core import local_config


def _watched(tag: str):
    """Run a ``(params, cfg, ...)`` entry point inside the numerics
    watchdog's context when ``cfg.numerics_watchdog`` asks for it: every
    quantized GEMM below labels itself (``<tag>.<site>.k<K>n<N>``) and
    stages its stats on the device, and the context copies them to the
    host once, when the entry point returns."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(params, cfg, *args, mesh=None, **kw):
            if mesh is not None:
                with model_parallel(mesh):
                    return wrapper(params, local_config(cfg, mesh.shape.get("model", 1)),
                                   *args, **kw)
            with _watchdog.watching(tag if cfg.numerics_watchdog else None):
                return fn(params, cfg, *args, **kw)
        return wrapper
    return deco


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder's stack: ``n_encoder_layers`` attention layers."""
    return cfg.with_(block_pattern=("attn",), n_layers=cfg.n_encoder_layers,
                     is_encoder_decoder=False)


def _init_stack(cfg: ModelConfig, gen, dev):
    lead, n_periods, tail = layer_layout(cfg)
    return {
        "head_blocks": [tfm.init_block(cfg, gen, dev, "dense_ffn_layer")
                        for _ in range(lead)],
        "blocks": tuple(tfm.init_block(cfg, gen, dev, kind, stack=(n_periods,))
                        for kind in cfg.block_pattern) if n_periods else (),
        "tail_blocks": [tfm.init_block(cfg, gen, dev, kind) for kind in tail],
    }


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Random weights from a ``torch.Generator`` seeded with ``seed``, made
    on ``device`` (default CUDA).  Same distributions as the reference's
    ``init_params``; not the same numbers (use ``weights.params_from_jax``
    to carry the reference's weights across).  ``device="meta"`` gives the
    layout (names, shapes, dtypes) without memory."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    params = {"embed": init_embedding(gen, dev, cfg.vocab_size, cfg.d_model)}
    params.update(_init_stack(cfg, gen, dev))
    params["final_norm"] = init_rmsnorm(cfg.d_model, dev)
    if not cfg.tie_embeddings:
        params["head"] = init_embedding(gen, dev, cfg.vocab_size, cfg.d_model)
    if cfg.is_encoder_decoder:
        enc = _init_stack(_encoder_cfg(cfg), gen, dev)
        params["enc_blocks"] = enc["blocks"]
        params["enc_tail_blocks"] = enc["tail_blocks"]
        params["enc_final_norm"] = init_rmsnorm(cfg.d_model, dev)
        _, n_periods, _ = layer_layout(cfg)
        params["cross_blocks"] = {
            "xattn": attn.init_cross_attention(cfg, gen, dev, stack=(n_periods,)),
            "norm_x": torch.ones((n_periods, cfg.d_model), dtype=torch.float32, device=dev),
        } if n_periods else ()
    return params


def param_shapes(cfg: ModelConfig):
    """The parameter tree's layout (names, shapes, dtypes) as ``meta``
    tensors, no memory."""
    return init_params(cfg, device="meta")


def _head_table(params, cfg: ModelConfig):
    return params["embed"] if cfg.tie_embeddings else params["head"]


def _vocab_shape(cfg: ModelConfig) -> tuple:
    return (cfg.vocab_size, cfg.d_model)


def embed_tokens(tokens, params, cfg: ModelConfig, table=None):
    """The token embedding (vocab-parallel on a tensor-parallel mesh);
    ``table``: the embedding already gathered over "data" (FSDP)."""
    table = gather_params(params["embed"]) if table is None else table
    return embed(tokens, table, _vocab_shape(cfg))


def head_logits(h, params, cfg: ModelConfig):
    """f32 logits of the final-normed ``h`` (gathered over a tensor-parallel
    mesh's ranks)."""
    return unembed(h, gather_params(_head_table(params, cfg)), _vocab_shape(cfg))


def _stack(trees):
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


# ---------------------------------------------------------------------------
# Backbone forward (full sequence)
# ---------------------------------------------------------------------------

def _plan(cfg: ModelConfig, carry_out: bool = False):
    """``transformer.layer_plan`` plus a sixth field, ``cross``: True for an
    encoder-decoder's last slot of a period, after which the period's
    cross-attention step runs.  That slot's output then stays f32 into
    ``norm_x`` (it is not the scan's carry: the cross add ends the period,
    rounded).  Each period of ``blocks`` starts at the watchdog's period
    mark, so all periods share the first one's GEMM labels."""
    last = len(cfg.block_pattern) - 1
    for group, idx, period, kind, carry in tfm.layer_plan(cfg, carry_out):
        if group == "blocks" and idx == 0:
            _watchdog.period_start(period == 0)
        cross = cfg.is_encoder_decoder and group == "blocks" and idx == last
        yield group, idx, period, kind, carry or cross, cross


def _cross_step(x, params, cfg: ModelConfig, period: int, enc_kv):
    """Period ``period``'s cross-attention: ``x + xattn(rmsnorm(x, norm_x),
    enc_kv)``, the sum rounded to bf16."""
    cross_p = gather_params(params["cross_blocks"], period)
    hx = rmsnorm(x, cross_p["norm_x"], cfg.norm_eps, dtype=COMPUTE_DTYPE)
    return x.to(COMPUTE_DTYPE) + attn.cross_attention_block(hx, enc_kv, cross_p["xattn"], cfg)


def _cross_kv(enc_out, params, cfg: ModelConfig, period: int):
    return attn.encode_cross_kv(
        enc_out, gather_params(params["cross_blocks"]["xattn"], period), cfg)


def _embed_input(params, cfg: ModelConfig, batch, table=None):
    """(x (B, S, d) bf16, positions (B, S)) of ``batch["embeds"]`` or of
    the tokens ``batch["tokens"]``; ``batch["positions"]`` when given."""
    if "embeds" in batch:
        x = batch["embeds"].to(COMPUTE_DTYPE)
    else:
        x = embed_tokens(batch["tokens"], params, cfg, table)
    b, s = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    return x, positions


def _layer(x, params, cfg: ModelConfig, positions, entry, causal: bool, enc_out, aux_out):
    """One entry of :func:`_plan`: the block, then (``cross``) the period's
    cross-attention step against ``enc_out``."""
    group, idx, period, kind, carry, cross = entry
    x, _ = tfm.apply_block(x, gather_params(params[group][idx], period), kind, cfg,
                           positions, carry=carry, causal=causal, aux_out=aux_out)
    if cross:
        x = _cross_step(x, params, cfg, period, _cross_kv(enc_out, params, cfg, period))
    return x


# outputs the "dots" remat policy keeps (the reference's checkpoint_dots)
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default,
                      torch.ops.aten._int_mm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_period(x, entries, params, cfg: ModelConfig, positions, causal: bool, enc_out,
                  aux_out):
    """One period's layers under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint`` of the scanned period): the backward recomputes the
    period from its bf16 input carry, so only the carry is kept.
    ``remat_policy="dots"`` keeps the matmul outputs and recomputes the
    rest.  The recompute runs the same ops on the same inputs, so the loss
    and gradients equal those without remat bit for bit."""
    def period(h):
        auxes = []
        for entry in entries:
            h = _layer(h, params, cfg, positions, entry, causal, enc_out, auxes)
        return (h, *auxes)

    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _dots_policy)
    h, *auxes = checkpoint(period, x, use_reentrant=False, **kw)
    if aux_out is not None:
        aux_out.extend(auxes)
    return h


def _run_stack(x, params, cfg: ModelConfig, positions, *, causal: bool = True,
               enc_out=None, carry_out: bool = False, aux_out=None):
    """The stack's layers over the full sequence (the cross-attention steps
    against ``enc_out`` for an encoder-decoder).  ``carry_out``: leave a
    last tail layer's output f32 for the final norm.  With ``cfg.remat``
    and grad enabled each period of ``blocks`` runs under
    :func:`_remat_period`; the lead and tail layers do not, as in the
    reference."""
    remat = cfg.remat and torch.is_grad_enabled()
    last = len(cfg.block_pattern) - 1
    pending = []
    for entry in _plan(cfg, carry_out):
        if remat and entry[0] == "blocks":
            pending.append(entry)
            if entry[1] == last:
                x = _remat_period(x, pending, params, cfg, positions, causal, enc_out,
                                  aux_out)
                pending = []
            continue
        x = _layer(x, params, cfg, positions, entry, causal, enc_out, aux_out)
    return x


def _run_encoder(src, params, cfg: ModelConfig):
    """The encoder over ``src`` (B, Ssrc, d) embeddings, cast to bf16:
    causal, as the reference runs it.  Returns rmsnorm'd (B, Ssrc, d) bf16."""
    b, s = src.shape[0], src.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=src.device).expand(b, s)
    enc = {"head_blocks": [], "blocks": params["enc_blocks"],
           "tail_blocks": params.get("enc_tail_blocks", [])}
    x = _run_stack(src.to(COMPUTE_DTYPE), enc, _encoder_cfg(cfg), positions)
    return rmsnorm(x, gather_params(params["enc_final_norm"]), cfg.norm_eps)


def backbone(params, cfg: ModelConfig, batch, table=None):
    """-> (final-normed hidden (B, S, d) bf16, MoE load-balance loss f32).
    ``table``: the token embedding already gathered (the tied head's)."""
    aux = []
    if cfg.is_encoder_decoder:
        enc_out = _run_encoder(batch["src_embeds"], params, cfg)
        x, positions = _embed_input(params, cfg, {"tokens": batch["tgt_tokens"]}, table)
    else:
        enc_out = None
        x, positions = _embed_input(params, cfg, batch, table)
    x = _run_stack(x, params, cfg, positions, enc_out=enc_out, carry_out=True, aux_out=aux)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for a in aux:
        total = total + a
    return rmsnorm(x, gather_params(params["final_norm"]), cfg.norm_eps,
                   dtype=COMPUTE_DTYPE), total


@_watched("forward")
def forward(params, cfg: ModelConfig, batch):
    """Full logits (B, S, V) f32 of ``batch`` -- for small configs and
    tests: prefill and decode are held against it."""
    h, _ = backbone(params, cfg, batch)
    return head_logits(h, params, cfg)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

LOSS_CHUNK = 512
AUX_LOSS_WEIGHT = 0.01


def _ce_chunk(hc, lc, mc, table, shape):
    """One chunk's masked NLL sum and mask count (f32 0-d tensors); the
    logits whole (gathered over a tensor-parallel mesh's ranks)."""
    logits = unembed(hc, table, shape)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
    nll = (logz - gold) * mc
    return nll.sum(), mc.sum()


def _chunked_ce(hidden, labels, mask, table, cfg: ModelConfig):
    """Cross-entropy over sequence chunks of ``LOSS_CHUNK`` rows (one chunk
    unless that divides ``S`` into more than one), so no (B, S, V) logits
    buffer exists: with grad enabled each chunk runs under
    ``torch.utils.checkpoint``, and its logits are recomputed in the
    backward instead of kept (the reference's ``jax.checkpoint`` of its
    scan body).  ``table`` is the head (a vocab-parallel rank's rows on a
    tensor-parallel mesh).  Returns the masked mean, f32; in a
    data-parallel training step, this rank's share of the global batch's
    masked mean (its NLL sum over the count of every rank's labelled
    tokens, times the data ranks that the step's mean divides by)."""
    s = hidden.shape[1]
    c = LOSS_CHUNK if s % LOSS_CHUNK == 0 and s > LOSS_CHUNK else s
    remat = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, c):
        args = (hidden[:, i:i + c], labels[:, i:i + c], mask[:, i:i + c], table,
                _vocab_shape(cfg))
        nll, n = (checkpoint(_ce_chunk, *args, use_reentrant=False) if remat
                  else _ce_chunk(*args))
        tot = tot + nll
        cnt = cnt + n
    ranks, cnt = batch_total(cnt)
    return tot * ranks / torch.clamp_min(cnt, 1.0)


def _next_token_labels(tokens):
    """Labels ``tokens[:, 1:]`` padded with 0 and their mask (1, the pad 0)."""
    labels = torch.nn.functional.pad(tokens[:, 1:], (0, 1))
    mask = torch.nn.functional.pad(
        torch.ones(tokens[:, 1:].shape, dtype=torch.float32, device=tokens.device), (0, 1))
    return labels, mask


@_watched("loss")
def lm_loss(params, cfg: ModelConfig, batch):
    """Next-token (or label) cross-entropy + the MoE load-balance loss
    (weight ``AUX_LOSS_WEIGHT``); a 0-d f32 tensor.  Labels are the next
    tokens of ``batch["tokens"]`` (of ``"tgt_tokens"`` for an
    encoder-decoder), or ``batch["labels"]`` with -1 masked (frontend
    archs)."""
    # a tied table is gathered once for the lookup and the head
    table = gather_params(_head_table(params, cfg))
    h, aux = backbone(params, cfg, batch, table if cfg.tie_embeddings else None)
    if cfg.is_encoder_decoder:
        labels, mask = _next_token_labels(batch["tgt_tokens"])
    elif "labels" in batch:
        labels = batch["labels"]
        mask = (labels >= 0).float()
        labels = torch.clamp_min(labels, 0)
    else:
        labels, mask = _next_token_labels(batch["tokens"])
    ce = _chunked_ce(h, labels, mask, table, cfg)
    return ce + AUX_LOSS_WEIGHT * aux


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def cache_shapes(cfg: ModelConfig, batch: int, cache_len: int, cross_len: int = 0):
    """(shape, dtype) tree of the contiguous cache (the layout :func:`prefill`
    returns).  The lead layers' caches are keyed ``one("attn")`` as in the
    reference.  An encoder-decoder's cache adds ``cross_kv``: the encoder's
    K/V for each period, (n_periods, batch, cross_len, Hkv, D) bf16."""
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
    if cfg.is_encoder_decoder:
        kv = ((n_periods, batch, cross_len, cfg.n_kv_heads, cfg.resolved_head_dim),
              COMPUTE_DTYPE)
        shapes["cross_kv"] = {"k": kv, "v": kv}
    return shapes


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device, cross_len: int = 0):
    """Zero contiguous cache of :func:`cache_shapes` on ``device``."""
    return zeros_like_shapes(cache_shapes(cfg, batch, cache_len, cross_len), device)


def paged_cache_shapes(cfg: ModelConfig, n_lanes: int, cache_len: int,
                       page_size: int, n_pages: int):
    """(shape, dtype) tree of the paged decode cache: KV in global page
    pools (stacked over periods) indexed through ``block_tables``
    ``(n_lanes, pages_for(cache_len))`` int32.  The lead layers' pools are
    keyed ``one("dense_ffn_layer")`` as in the reference.  Decoder-only
    stacks only, as in the reference."""
    if cfg.is_encoder_decoder:
        raise ValueError("paged caches support decoder-only stacks")
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


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------

@_watched("prefill")
def prefill(params, cfg: ModelConfig, batch, cache_len: int, lengths=None):
    """Process the prompts of ``batch`` (``{"tokens": (B, S)}``,
    ``{"embeds": (B, S, d)}``, or ``{"src_embeds", "tgt_tokens"}`` for an
    encoder-decoder); return (last-position logits (B, V) f32, contiguous
    cache with rows [0, S) filled).

    ``lengths`` (B,) are the true lengths of right-padded prompts: logits
    come from position ``lengths - 1`` and the cache ``pos`` starts at
    ``lengths``, so padded rows are overwritten before any query can
    attend them.  An encoder-decoder runs the encoder once and keeps each
    period's cross K/V in ``cache["cross_kv"]``."""
    _, n_periods, _ = layer_layout(cfg)
    cross_kv = None
    if cfg.is_encoder_decoder:
        enc_out = _run_encoder(batch["src_embeds"], params, cfg)
        cross_kv = []
        for i in range(n_periods):
            _watchdog.period_start(i == 0)
            cross_kv.append(_cross_kv(enc_out, params, cfg, i))
        x, positions = _embed_input(params, cfg, {"tokens": batch["tgt_tokens"]})
    else:
        x, positions = _embed_input(params, cfg, batch)
    b, s = x.shape[0], x.shape[1]
    head_caches, tail_caches = [], []
    per_slot = [[] for _ in cfg.block_pattern]
    for group, idx, period, kind, carry, cross in _plan(cfg):
        x, c = tfm.apply_block_prefill(x, gather_params(params[group][idx], period), kind,
                                       cfg, positions, cache_len, carry=carry)
        (per_slot[idx] if group == "blocks" else
         head_caches if group == "head_blocks" else tail_caches).append(c)
        if cross:
            x = _cross_step(x, params, cfg, period, cross_kv[period])
    cache = {
        "head_blocks": head_caches,
        "blocks": tuple(_stack(per) for per in per_slot) if n_periods else (),
        "tail_blocks": tail_caches,
    }
    if cross_kv is not None:
        cache["cross_kv"] = {"k": torch.stack([k for k, _ in cross_kv]),
                             "v": torch.stack([v for _, v in cross_kv])}
    if lengths is None:
        cache["pos"] = torch.full((b,), s, dtype=torch.int32, device=x.device)
        x_last = x[:, -1:, :]
    else:
        lengths = lengths.to(torch.int32)
        cache["pos"] = lengths
        idx = torch.clamp(lengths.long() - 1, 0, s - 1)
        x_last = x[torch.arange(b, device=x.device), idx][:, None, :]
    h = rmsnorm(x_last, params["final_norm"], cfg.norm_eps)
    return head_logits(h, params, cfg)[:, 0, :], cache


@_watched("decode")
def decode_step(params, cfg: ModelConfig, tokens, cache, active=None):
    """One token for every lane.  tokens: (B,) int, or (B, d) embeddings.

    A ``block_tables`` key in ``cache`` marks a paged cache (see
    :func:`paged_cache_shapes`); without one, ``cache`` is the contiguous
    layout of :func:`init_cache` / :func:`prefill`.  ``active`` (B,) bool
    marks lanes serving a request: idle lanes still ride the fixed-shape
    step, but their ``pos`` is pinned to 0; their paged writes go to the
    trash page, their slot writes stay in their own lane at row 0.
    ``active=None`` advances every lane.  An encoder-decoder attends
    ``cache["cross_kv"]`` after each period.  The cache is updated in place
    and returned with ``pos`` advanced.  Returns (logits (B, V), cache)."""
    pos = cache["pos"]
    tables = cache.get("block_tables")
    if tokens.ndim == 1:
        x = embed_tokens(tokens[:, None], params, cfg)
    else:
        x = tokens[:, None, :].to(COMPUTE_DTYPE)
    for group, idx, period, kind, carry, cross in _plan(cfg, carry_out=True):
        x, _ = tfm.apply_block_decode(x, gather_params(params[group][idx], period), kind, cfg,
                                      tfm.plan_entry(cache, group, idx, period), pos,
                                      tables=tables, active=active, carry=carry)
        if cross:
            xkv = cache["cross_kv"]
            x = _cross_step(x, params, cfg, period, (xkv["k"][period], xkv["v"][period]))
    cache["pos"] = (pos + 1 if active is None
                    else torch.where(active, pos + 1, torch.zeros_like(pos)))
    h = rmsnorm(x, params["final_norm"], cfg.norm_eps, dtype=COMPUTE_DTYPE)
    return head_logits(h, params, cfg)[:, 0, :], cache


@_watched("verify")
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
    x = embed_tokens(tokens, params, cfg)
    for group, idx, period, kind, carry, _ in _plan(cfg):
        x, _ = tfm.apply_block_verify(x, gather_params(params[group][idx], period), kind, cfg,
                                      tfm.plan_entry(cache, group, idx, period), pos,
                                      tables=tables, active=active, carry=carry)
    h = rmsnorm_columns(x, params["final_norm"], cfg.norm_eps)
    return head_logits(h, params, cfg), cache
