"""Modality frontend STUBS (port of ``repro/models/frontends.py``).

The vision and audio entries specify the transformer backbone only: the
model takes precomputed patch or frame embeddings, ``(B, S, d_model)``.
These helpers make deterministic fake embeddings for smoke runs and
describe their shape and dtype.

The stubs draw from a ``torch.Generator`` seeded with ``seed`` (normal
times 0.02 in f32, then cast to bf16), not from ``jax.random``, so their
numbers differ from the reference's for the same seed; carry the
reference's embeddings across through numpy where the two must agree.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import COMPUTE_DTYPE


def embed_spec(cfg: ModelConfig, batch: int, seq: int) -> torch.Tensor:
    """Shape and dtype of precomputed frontend embeddings, as a ``meta``
    tensor (the counterpart of the reference's ``ShapeDtypeStruct``)."""
    return torch.empty((batch, seq, cfg.d_model), dtype=COMPUTE_DTYPE, device="meta")


def _fake_embeds(seed: int, cfg: ModelConfig, batch: int, seq: int, device):
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((batch, seq, cfg.d_model), generator=gen, dtype=torch.float32,
                    device=dev)
    return (x * 0.02).to(COMPUTE_DTYPE)


def fake_vision_embeds(seed: int, cfg: ModelConfig, batch: int, seq: int, device=None):
    """Stand-in for the LLaVA-NeXT anyres tiling -> CLIP -> projector path."""
    return _fake_embeds(seed, cfg, batch, seq, device)


def fake_audio_frames(seed: int, cfg: ModelConfig, batch: int, seq: int, device=None):
    """Stand-in for the SeamlessM4T speech frontend (fbank -> conformer adaptor)."""
    return _fake_embeds(seed, cfg, batch, seq, device)
