"""Config registry of the port: ``get_config(name)`` returns the published
config, ``reduced(cfg)`` a test-sized config of the same family (the same
reduction as ``repro/configs/__init__.py``, field for field, so the two
packages build equal configs for their parity tests)."""

from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    deepseek_moe_16b,
    granite_moe_3b,
    llama32_1b,
    llava_next_mistral_7b,
    minicpm3_4b,
    mistral_large_123b,
    mistral_nemo_12b,
    recurrentgemma_9b,
    seamless_m4t_large_v2,
    xlstm_125m,
)
from repro_torch.configs.base import (
    DEFAULT_PAGE_SIZE,
    KV_CACHE_HEADROOM,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SHAPES,
    ShapeConfig,
    default_cache_len,
    default_page_count,
    pages_for,
)

ARCHS = {
    "mistral-large-123b": mistral_large_123b.CONFIG,
    "minicpm3-4b": minicpm3_4b.CONFIG,
    "mistral-nemo-12b": mistral_nemo_12b.CONFIG,
    "llama3.2-1b": llama32_1b.CONFIG,
    "granite-moe-3b-a800m": granite_moe_3b.CONFIG,
    "deepseek-moe-16b": deepseek_moe_16b.CONFIG,
    "xlstm-125m": xlstm_125m.CONFIG,
    "llava-next-mistral-7b": llava_next_mistral_7b.CONFIG,
    "seamless-m4t-large-v2": seamless_m4t_large_v2.CONFIG,
    "recurrentgemma-9b": recurrentgemma_9b.CONFIG,
}

# archs with bounded-state sequence mixing (the reference runs its
# 500k-token decode cell on these only)
SUBQUADRATIC = ("xlstm-125m", "recurrentgemma-9b")

__all__ = [
    "ARCHS",
    "DEFAULT_PAGE_SIZE",
    "KV_CACHE_HEADROOM",
    "MLAConfig",
    "ModelConfig",
    "MoEConfig",
    "SHAPES",
    "SUBQUADRATIC",
    "ShapeConfig",
    "cells",
    "default_cache_len",
    "default_page_count",
    "get_config",
    "pages_for",
    "reduced",
]


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def cells(include_skipped: bool = False):
    """All assigned (arch x shape) dry-run cells, as ``(arch, shape name,
    skipped)``: 40 in all, 32 runnable (the 500k-token decode runs on the
    two ``SUBQUADRATIC`` archs only)."""
    out = []
    for arch in ARCHS:
        for shape in SHAPES.values():
            skipped = shape.name == "long_500k" and arch not in SUBQUADRATIC
            if skipped and not include_skipped:
                continue
            out.append((arch, shape.name, skipped))
    return out


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test config of the same family: tiny dims, same block pattern."""
    period = cfg.pattern_period
    lead = cfg.moe.first_k_dense if cfg.moe else 0
    n_layers = lead + 2 * period + (1 if cfg.name == "recurrentgemma-9b" else 0)
    kw = dict(
        n_layers=n_layers,
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        head_dim=32,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab_size=512,
        lru_width=128 if cfg.lru_width else None,
        sliding_window=32 if cfg.sliding_window else None,
        n_encoder_layers=2 if cfg.is_encoder_decoder else 0,
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            num_experts=8,
            top_k=2,
            num_shared_experts=cfg.moe.num_shared_experts,
            d_expert=64,
            # high capacity: no token drops at smoke scale, so prefill and
            # decode agree with the full forward (capacity is per sequence)
            capacity_factor=8.0,
            first_k_dense=cfg.moe.first_k_dense,
            d_ff_dense=256 if cfg.moe.d_ff_dense else 0,
        )
    if cfg.use_mla:
        kw["mla"] = MLAConfig(
            q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16,
        )
    return dataclasses.replace(cfg, **kw)
