"""Static-batch lockstep baseline (port of ``repro/api/baseline.py``).

``serve_batch`` prefills a whole rectangular batch together and decodes
``gen_tokens`` greedy steps in lockstep over a slot cache.  It is the
reference the continuous-batching engine is held against: scheduling must
not change a request's greedy stream.  It is also the serving path of the
encoder-decoder and frontend archs, which the engine does not admit.
"""

from __future__ import annotations

import time

import torch

from repro_torch.models import model as model_lib
from repro_torch.serving.sampling import greedy_tokens


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_batch(cfg, params, batch, *, cache_len: int, gen_tokens: int):
    """Every sequence of ``batch`` prefills together and decodes
    ``gen_tokens`` steps together (greedy).  ``batch`` is the reference's
    dict: ``{"tokens": (B, S) int}``, ``{"embeds": (B, S, d)}`` for a
    frontend arch, or ``{"src_embeds": (B, Ssrc, d), "tgt_tokens": (B, St)}``
    for an encoder-decoder.  Returns ((B, gen_tokens) int32 tokens,
    {"prefill_s", "decode_s"})."""
    device = next(iter(batch.values())).device
    t0 = time.perf_counter()
    logits, cache = model_lib.prefill(params, cfg, batch, cache_len)
    tok = greedy_tokens(logits)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(gen_tokens - 1):
        logits, cache = model_lib.decode_step(params, cfg, tok, cache)
        tok = greedy_tokens(logits)
        out.append(tok)
    _sync(device)
    decode_s = time.perf_counter() - t0
    return torch.stack(out, dim=1), {"prefill_s": prefill_s, "decode_s": decode_s}
