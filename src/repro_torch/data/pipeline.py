"""Deterministic, shardable synthetic token pipeline (the port of
``repro/data/pipeline.py``).

Stateless by construction: batch ``i`` is a pure function of ``(seed,
step=i)`` -- a CPU ``torch.Generator`` seeded with a splitmix64 mix of the
two -- so a restarted worker (fault tolerance) regenerates exactly the
same stream with no iterator state to checkpoint.  Per-host slicing takes
the host's batch shard by index.  ``jax.random``'s bits cannot be matched,
so the tokens are not the reference's; their structure is: ``base + 13 *
drift + noise (mod V)``, ``base`` one uniform token a row, ``drift`` a
cumulative count of Bernoulli(0.1) jumps and ``noise`` uniform in [0, 7),
so a model shows a real, decreasing loss.  Batches land on ``device``
(default: the card).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.serving.sampling import _MASK64, _splitmix64


def batch_specs(cfg: ModelConfig, shape: ShapeConfig):
    """One global batch of the shape cell as a ``(shape, dtype)``-leaf
    tree (``shard.core.as_shapes`` turns it into ``"meta"`` tensors): the
    tokens, or the frontend's embeddings and labels, or an
    encoder-decoder's source embeddings and target tokens."""
    b, s = shape.global_batch, shape.seq_len
    i32, f = torch.int32, torch.bfloat16
    if shape.kind == "train":
        if cfg.is_encoder_decoder:
            return {"src_embeds": ((b, s, cfg.d_model), f), "tgt_tokens": ((b, s), i32)}
        if cfg.frontend is not None:
            return {"embeds": ((b, s, cfg.d_model), f), "labels": ((b, s), i32)}
        return {"tokens": ((b, s), i32)}
    if shape.kind == "prefill":
        if cfg.is_encoder_decoder:
            return {"src_embeds": ((b, s, cfg.d_model), f), "tgt_tokens": ((b, 1), i32)}
        if cfg.frontend is not None:
            return {"embeds": ((b, s, cfg.d_model), f)}
        return {"tokens": ((b, s), i32)}
    # decode: one new token against a cache of seq_len
    return {"tokens": ((b,), i32)}


@dataclasses.dataclass(frozen=True)
class SyntheticTokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    device: Optional[str] = None

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts

    def _global_cpu(self, step: int) -> torch.Tensor:
        key = _splitmix64(_splitmix64(int(self.seed) & _MASK64) ^ (int(step) & _MASK64))
        gen = torch.Generator().manual_seed(key >> 1)
        v = max(self.vocab_size, 4)
        b, s = self.global_batch, self.seq_len
        base = torch.randint(0, v, (b, 1), generator=gen)
        drift = torch.cumsum((torch.rand((b, s), generator=gen) < 0.1).long(), dim=1)
        noise = torch.randint(0, 7, (b, s), generator=gen)
        return ((base + 13 * drift + noise) % self.vocab_size).to(torch.int32)

    def global_batch_at(self, step: int) -> torch.Tensor:
        """(global_batch, seq_len) int32 tokens; pure function of step."""
        return self._global_cpu(step).to(resolve_device(self.device))

    def host_batch_at(self, step: int) -> torch.Tensor:
        hb = self.host_batch
        g = self._global_cpu(step)[self.host_id * hb:(self.host_id + 1) * hb]
        return g.to(resolve_device(self.device))

    def __iter__(self):
        step = 0
        while True:
            yield self.host_batch_at(step)
            step += 1
