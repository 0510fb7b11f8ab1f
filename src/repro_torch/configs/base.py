"""Model configuration dataclass and KV-cache sizing policy.

The port's own copy of what it needs from ``repro/configs/base.py``: the
dense-attention fields of ``ModelConfig`` plus the cache sizing helpers
the serving engine shares with the reference, so both packages agree on
cache shapes for the same workload.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.backends.spec import QUANT_MODES, parse_quant_mode

# Headroom beyond prompt + generation: covers rounding prompt lengths up to
# a prefill bucket and extra decode steps past a request's nominal budget.
KV_CACHE_HEADROOM = 8

# Token rows per KV page (paged cache, repro_torch/paging/).
DEFAULT_PAGE_SIZE = 16

# Block kinds this package serves; other kinds of the reference
# (MLA, MoE, recurrent, local attention) are later slices of the port.
SUPPORTED_KINDS = ("attn",)


def default_cache_len(prompt_len: int, gen_tokens: int,
                      headroom: int = KV_CACHE_HEADROOM) -> int:
    """Cache length for serving ``prompt_len`` + ``gen_tokens`` decode steps."""
    return prompt_len + gen_tokens + headroom


def pages_for(tokens: int, page_size: int = DEFAULT_PAGE_SIZE) -> int:
    """Pages covering ``tokens`` cache rows (ceil division)."""
    return -(-max(int(tokens), 0) // page_size)


def default_page_count(n_lanes: int, cache_len: int,
                       page_size: int = DEFAULT_PAGE_SIZE) -> int:
    """Pool size matching the slot-cache KV budget: ``n_lanes`` worst-case
    requests, plus the reserved trash page 0 (see paging/manager.py)."""
    return n_lanes * pages_for(cache_len, page_size) + 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None       # defaults to d_model // n_heads
    block_pattern: tuple = ("attn",)     # cycled through the stack
    rope_theta: float = 10_000.0
    # "bf16" or a quantized mode (backends/spec.py)
    quant_mode: str = "bf16"
    # GEMM backend registry name ("cuda_spoga", "cuda_deas", ...); None =
    # auto-select by dataflow family and the tensors' device
    # (backends/registry.py)
    gemm_backend: Optional[str] = None
    norm_eps: float = 1e-6
    act: str = "silu"
    tie_embeddings: bool = False
    # KV cache storage: "bf16" | "int8" (int8 payload + per-(pos, head) scale)
    kv_cache_dtype: str = "bf16"
    # paged decode attention follows the tensors' device: the CUDA kernel
    # on CUDA tensors, the gather twin on CPU tensors.  "gather" names the
    # twin and is refused on CUDA tensors (models/attention.py)
    paged_attn_impl: Optional[str] = None

    def __post_init__(self):
        if self.quant_mode not in QUANT_MODES:
            try:
                parse_quant_mode(self.quant_mode)
            except ValueError:
                raise ValueError(
                    f"quant_mode must be in {QUANT_MODES} or a parametric "
                    f"'w<bits>a<bits>[_s<slice>]' string, got {self.quant_mode!r}"
                ) from None
        if self.gemm_backend is not None:
            from repro_torch.backends import get_backend  # lazy: keeps layering one-way

            get_backend(self.gemm_backend)  # raises KeyError on unknown names
        if self.paged_attn_impl not in (None, "gather"):
            raise ValueError("paged_attn_impl must be None (auto) or 'gather', "
                             f"got {self.paged_attn_impl!r}")
        if self.kv_cache_dtype not in ("bf16", "int8"):
            raise ValueError("kv_cache_dtype must be 'bf16' or 'int8', got "
                             f"{self.kv_cache_dtype!r}")
        bad = sorted(set(self.block_pattern) - set(SUPPORTED_KINDS))
        if bad:
            raise NotImplementedError(
                f"block kinds {bad} are not ported yet (ROADMAP queue 1, "
                f"item 7); this package serves {SUPPORTED_KINDS}")
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
