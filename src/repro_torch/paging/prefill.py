"""Chunked prefill over the paged cache: admit a long prompt in
page-aligned chunks interleaved with decode steps.

Port of ``repro/paging/prefill.py`` for the ``"attn"`` kind.  One chunk
step embeds ``chunk_len`` prompt tokens at absolute offset ``start`` and
runs them through the stack: each attention block writes the chunk's K/V
into the lane's pages and attends the gathered prefix + chunk under the
causal mask (``models/attention.attention_chunk``).  It returns the
logits of the chunk's last valid row (only the final chunk's are used).
Every per-row computation is position-independent and the bf16 cache
round trip is lossless, so on bf16 pools a chunked admission gives the
unchunked prefill's tokens.

``chunkable`` is the reference's bitwise tier (the kinds whose math is
row-independent); ``chunkable_with_state`` adds the recurrent cells that
carry state across chunks.  The port serves the ``"attn"`` kind only, so
both tiers are ``{"attn"}`` until MLA, dense FFN layers and the recurrent
chunk cells are ported (ROADMAP queue 1, item 7).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import embed, rmsnorm, unembed
from repro_torch.models.model import layer_layout

CHUNKABLE_KINDS = frozenset({"attn"})


def stack_kinds(cfg: ModelConfig) -> frozenset[str]:
    """Block kinds across the whole stack (periods + tail remainder)."""
    n_periods, tail = layer_layout(cfg)
    kinds = set(cfg.block_pattern) if n_periods else set()
    return frozenset(kinds | set(tail))


def chunkable(cfg: ModelConfig) -> bool:
    """Can this stack prefill in chunks bitwise like the unchunked prefill?"""
    return stack_kinds(cfg) <= CHUNKABLE_KINDS


# Can this stack prefill in chunks at all (the engine's ``prefill_chunk``
# gate)?  The same predicate as ``chunkable`` until the recurrent chunk
# cells are ported.
chunkable_with_state = chunkable


def _apply_block_chunk(x, p, kind: str, cfg: ModelConfig, cache, table_row, start: int,
                       positions):
    """One block over a (1, C, d) chunk against the paged cache (written in
    place)."""
    if kind != "attn":
        raise ValueError(f"block kind {kind!r} is not chunkable")
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    a, _ = attn.attention_chunk(h, p["attn"], cfg, cache, table_row, start,
                                positions=positions)
    return tfm._residual_mlp(x, a, p, cfg)


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
        raise ValueError(f"{cfg.name}: stack has non-chunkable kinds "
                         f"{sorted(stack_kinds(cfg) - CHUNKABLE_KINDS)}")
    n_periods, tail = layer_layout(cfg)

    def chunk_step(params, cache, tokens, lane: int, start: int, true_len: int):
        x = embed(tokens, params["embed"])
        positions = (start + torch.arange(chunk_len, dtype=torch.int32,
                                          device=tokens.device))[None, :]
        table_row = cache["block_tables"][lane:lane + 1]
        for i in range(n_periods):
            for slot, kind in enumerate(cfg.block_pattern):
                x = _apply_block_chunk(x, tfm.period_params(params["blocks"][slot], i), kind,
                                       cfg, tfm.period_params(cache["blocks"][slot], i),
                                       table_row, start, positions)
        for p, kind, c in zip(params["tail_blocks"], tail, cache["tail_blocks"]):
            x = _apply_block_chunk(x, p, kind, cfg, c, table_row, start, positions)
        cache["pos"][lane] = start + true_len
        last = min(max(true_len - 1, 0), chunk_len - 1)
        h = rmsnorm(x[:, last:last + 1], params["final_norm"], cfg.norm_eps)
        table = params["embed"] if cfg.tie_embeddings else params["head"]
        return unembed(h, table)[:, 0, :]

    return chunk_step
