"""Chunked prefill over the paged cache: admit a long prompt in
page-aligned chunks interleaved with decode steps.

Port of ``repro/paging/prefill.py``.  One chunk step embeds
``chunk_len`` prompt tokens at absolute offset ``start`` and runs them
through the stack (lead dense layers, periods, tail): each attention block
writes the chunk's K/V (or MLA latents) into the lane's pages and attends
the gathered prefix + chunk under the causal mask
(``models/attention.attention_chunk`` / ``mla_chunk``); each recurrent
block runs its ``*_chunk`` cell (``models/recurrent.py``) from the lane's
carried state (zeros for the first chunk) and writes the state back.  It
returns the logits of the chunk's last valid row (only the final chunk's
are used).

Chunkable kinds come in two tiers, as in the reference:

* ``chunkable``: the kinds whose math is row-independent, ``attn`` (MLA
  included) and dense FFN layers.  Every per-row computation is
  position-independent and the bf16 cache round trip is lossless, so on
  bf16 pools a chunked admission gives the unchunked prefill's tokens;
  the prefix cache and speculative verify need exactly this.
* ``chunkable_with_state``: also the recurrent kinds (``rglru``,
  ``mlstm``, ``slstm``), whose cells carry their state across chunk
  boundaries with the pad rows neutralized; a chunk boundary regroups
  the scans' float sums, so chunked equals one-shot to a tolerance, not
  bitwise.  This is the engine's ``prefill_chunk`` gate.

Excluded by construction: ``moe`` (expert capacity is ``ceil(S * k / E *
cf)``, so it depends on how many tokens share the dispatch) and
``local_attn`` (its ring is written modulo the window, which a partial
chunk would wrap wrongly).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import recurrent as rec
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import embed, rmsnorm, unembed
from repro_torch.models.transformer import layer_layout

CHUNKABLE_KINDS = frozenset({"attn", "mla", "dense_ffn_layer"})
# state-carrying kinds the chunk step can also run (token-equivalent, not
# bitwise: see the module docstring)
STATEFUL_CHUNK_KINDS = tfm.RECURRENT_KINDS


def stack_kinds(cfg: ModelConfig) -> frozenset[str]:
    """Effective block kinds across the whole stack (lead dense layers +
    periods + tail remainder): the one place layout-derived kind sets come
    from, shared by the engine's paged-pool detection and the
    chunkability checks."""
    lead, n_periods, tail = layer_layout(cfg)
    kinds = {"dense_ffn_layer"} if lead else set()
    if n_periods:
        kinds |= {tfm.effective_kind(k, cfg) for k in cfg.block_pattern}
    kinds |= {tfm.effective_kind(k, cfg) for k in tail}
    return frozenset(kinds)


def chunkable(cfg: ModelConfig) -> bool:
    """Can this stack prefill in chunks bitwise like the unchunked prefill?
    (The contract the prefix cache and speculative verify need.)"""
    if cfg.is_encoder_decoder or cfg.frontend is not None:
        return False
    return stack_kinds(cfg) <= CHUNKABLE_KINDS


def chunkable_with_state(cfg: ModelConfig) -> bool:
    """Can this stack prefill in chunks at all, allowing state-carrying
    recurrent cells (the engine's ``prefill_chunk`` gate)?  The stricter
    :func:`chunkable` still gates the prefix cache and speculation."""
    if cfg.is_encoder_decoder or cfg.frontend is not None:
        return False
    return stack_kinds(cfg) <= (CHUNKABLE_KINDS | STATEFUL_CHUNK_KINDS)


def _apply_block_chunk(x, p, kind: str, cfg: ModelConfig, cache, table_row, start: int,
                       positions, lane: int = 0, true_len=None, carry: bool = False):
    """One block over a (1, C, d) chunk against the paged cache (written in
    place).  A recurrent block reads lane ``lane``'s state (zeros when
    ``start == 0``: a freed lane's leaves hold its last occupant's state),
    runs the chunk cell over the first ``true_len`` rows and writes the
    state back.  ``carry``: see ``transformer.layer_plan``."""
    kind = tfm.effective_kind(kind, cfg)
    if kind in STATEFUL_CHUNK_KINDS:
        state = {k: (torch.zeros_like(v[lane:lane + 1]) if start == 0 else v[lane:lane + 1])
                 for k, v in cache.items()}
        a, state = rec.CELLS[kind][1](tfm._norm1(x, p, cfg), p["cell"], cfg, state,
                                      x.shape[1] if true_len is None else true_len)
        for k, v in state.items():
            cache[k][lane:lane + 1] = v.to(cache[k].dtype)
        if kind == "rglru":
            return tfm._residual_mlp(x, a, p, cfg, carry=carry)
        return tfm._add(x, a, carry)
    h = tfm._norm1(x, p, cfg)
    if kind in ("attn", "dense_ffn_layer"):
        a, _ = attn.attention_chunk(h, p["attn"], cfg, cache, table_row, start,
                                    positions=positions)
    elif kind == "mla":
        a, _ = attn.mla_chunk(h, p["attn"], cfg, cache, table_row, start,
                              positions=positions)
    else:
        raise ValueError(f"block kind {kind!r} is not chunkable")
    return tfm._residual_mlp(x, a, p, cfg, carry=carry)


def make_chunk_step(cfg: ModelConfig, chunk_len: int):
    """Build the chunk step

        chunk_step(params, cache, tokens, lane, start, true_len)
            -> last-valid-row logits (1, V)

    ``tokens``: (1, chunk_len) right-padded; ``start``: absolute position
    of the chunk's first token; ``true_len``: valid tokens in the chunk.
    The paged ``cache`` is written in place; the lane's ``pos`` becomes
    ``start + true_len``, so the final chunk leaves the lane decode-ready.
    Padded tail rows write rows that the next chunk (or the first decode
    step) overwrites before any query can attend them."""
    if not chunkable_with_state(cfg):
        raise ValueError(
            f"{cfg.name}: stack has non-chunkable kinds "
            f"{sorted(stack_kinds(cfg) - CHUNKABLE_KINDS - STATEFUL_CHUNK_KINDS)}")
    plan = tfm.layer_plan(cfg)

    def chunk_step(params, cache, tokens, lane: int, start: int, true_len: int):
        full = (cfg.vocab_size, cfg.d_model)
        x = embed(tokens, params["embed"], full)
        positions = (start + torch.arange(chunk_len, dtype=torch.int32,
                                          device=tokens.device))[None, :]
        table_row = cache["block_tables"][lane:lane + 1]
        for group, idx, period, kind, carry in plan:
            x = _apply_block_chunk(x, tfm.plan_entry(params, group, idx, period), kind, cfg,
                                   tfm.plan_entry(cache, group, idx, period), table_row,
                                   start, positions, lane=lane, true_len=true_len,
                                   carry=carry)
        cache["pos"][lane] = start + true_len
        last = min(max(true_len - 1, 0), chunk_len - 1)
        h = rmsnorm(x[:, last:last + 1], params["final_norm"], cfg.norm_eps)
        table = params["embed"] if cfg.tie_embeddings else params["head"]
        return unembed(h, table, full)[:, 0, :]

    return chunk_step
