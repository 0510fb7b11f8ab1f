"""Static-batch lockstep baseline (port of ``repro/api/baseline.py``).

``serve_batch`` prefills a whole rectangular batch together and decodes
``gen_tokens`` greedy steps in lockstep over a slot cache.  It is the
reference the continuous-batching engine is held against: scheduling must
not change a request's greedy stream.  It is also the serving path of the
encoder-decoder and frontend archs, which the engine does not admit.

``mesh=`` (a ``launch.mesh.Mesh``) serves the batch tensor-parallel: every
rank passes its part of the weights (``shard.shard_params``) and the same
batch, and the model entry points run on the rank's heads and columns --
the port's counterpart of the reference calling ``serve_batch`` on the
params ``shard_params`` committed to a mesh.  The logits are gathered, so
every rank decodes the same tokens.
"""

from __future__ import annotations

import time

import torch

from repro_torch.models import model as model_lib
from repro_torch.serving.sampling import greedy_tokens


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_batch(cfg, params, batch, *, cache_len: int, gen_tokens: int, mesh=None):
    """Every sequence of ``batch`` prefills together and decodes
    ``gen_tokens`` steps together (greedy).  ``batch`` is the reference's
    dict: ``{"tokens": (B, S) int}``, ``{"embeds": (B, S, d)}`` for a
    frontend arch, or ``{"src_embeds": (B, Ssrc, d), "tgt_tokens": (B, St)}``
    for an encoder-decoder.  ``mesh``: see the module docstring.  Returns
    ((B, gen_tokens) int32 tokens, {"prefill_s", "decode_s"})."""
    device = next(iter(batch.values())).device
    t0 = time.perf_counter()
    logits, cache = model_lib.prefill(params, cfg, batch, cache_len, mesh=mesh)
    tok = greedy_tokens(logits)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(gen_tokens - 1):
        logits, cache = model_lib.decode_step(params, cfg, tok, cache, mesh=mesh)
        tok = greedy_tokens(logits)
        out.append(tok)
    _sync(device)
    decode_s = time.perf_counter() - t0
    return torch.stack(out, dim=1), {"prefill_s": prefill_s, "decode_s": decode_s}
