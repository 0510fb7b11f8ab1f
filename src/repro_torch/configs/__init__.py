"""Config registry of the port: ``get_config(name)`` returns the published
config, ``reduced(cfg)`` a test-sized config of the same family (the same
reduction as ``repro/configs/__init__.py``, so the two packages build equal
configs for their parity tests)."""

from __future__ import annotations

import dataclasses

from repro_torch.configs import llama32_1b
from repro_torch.configs.base import (
    DEFAULT_PAGE_SIZE,
    KV_CACHE_HEADROOM,
    ModelConfig,
    default_cache_len,
    default_page_count,
    pages_for,
)

ARCHS = {
    "llama3.2-1b": llama32_1b.CONFIG,
}

__all__ = [
    "ARCHS",
    "DEFAULT_PAGE_SIZE",
    "KV_CACHE_HEADROOM",
    "ModelConfig",
    "default_cache_len",
    "default_page_count",
    "get_config",
    "pages_for",
    "reduced",
]


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)} "
                       "(other archs are later slices of the port)")
    return ARCHS[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test config of the same family: tiny dims, same block pattern."""
    return dataclasses.replace(
        cfg,
        n_layers=2 * cfg.pattern_period,
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        head_dim=32,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab_size=512,
    )
