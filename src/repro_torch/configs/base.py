"""Model configuration dataclasses and KV-cache sizing policy.

The port's own copy of what it needs from ``repro/configs/base.py``: the
``ModelConfig`` fields the serving path reads (with ``MoEConfig`` and
``MLAConfig``) plus the cache sizing helpers the serving engine shares
with the reference, so both packages agree on cache shapes for the same
workload.  Every one of the reference's architectures builds.  The
training fields (``remat``, ``remat_policy``, plus ``scan_layers`` and
``scan_unroll``, which the port's Python loop over periods reads as the
reference's fully unrolled scan) and ``TrainConfig``.  ``ShapeConfig``
and ``SHAPES`` are the dry run's cells (``launch.dryrun``).
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
class MoEConfig:
    num_experts: int = 0          # routed experts
    top_k: int = 0
    num_shared_experts: int = 0   # DeepSeekMoE-style always-on experts
    d_expert: int = 0             # per-expert FFN hidden size
    capacity_factor: float = 1.25
    first_k_dense: int = 0        # leading layers that use a dense FFN
    d_ff_dense: int = 0           # hidden size of those dense FFN layers


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


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
    # cycled through the stack; entries in
    # {"attn", "local_attn", "moe", "mlstm", "slstm", "rglru"}
    block_pattern: tuple = ("attn",)
    # attention
    sliding_window: Optional[int] = None  # for local_attn blocks
    rope_theta: float = 10_000.0
    use_mla: bool = False
    mla: Optional[MLAConfig] = None
    # MoE
    moe: Optional[MoEConfig] = None
    # recurrent (rglru / xlstm)
    conv_width: int = 4
    lru_width: Optional[int] = None
    # encoder-decoder
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    # modality frontend stub: None | "vision" | "audio"
    frontend: Optional[str] = None
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
    # scan/remat.  The port walks the periods in a Python loop, so
    # ``scan_layers`` and ``scan_unroll`` change nothing here; they are kept
    # so that configs round-trip with the reference's.  ``remat``: each
    # period is recomputed in the backward (only when grad is enabled).
    scan_layers: bool = True
    remat: bool = True
    # "nothing" -- recompute the whole period in the backward (min memory)
    # "dots"    -- save matmul outputs, recompute the rest
    remat_policy: str = "nothing"
    scan_unroll: bool = False
    # numerics watchdog (obs/watchdog.py): every quantized GEMM inside a
    # model entry point stages per-layer saturation / amax / quant-error
    # stats.  Part of the frozen config (and its hash), as in the reference
    numerics_watchdog: bool = False

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
        if self.remat_policy not in ("nothing", "dots"):
            raise ValueError("remat_policy must be 'nothing' or 'dots', got "
                             f"{self.remat_policy!r}")
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.family == "moe" and self.moe is None:
            raise ValueError("moe family requires moe config")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    def layer_type(self, i: int) -> str:
        if self.moe is not None and i < self.moe.first_k_dense:
            return "dense_ffn_layer"
        return self.block_pattern[i % len(self.block_pattern)]

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RankConfig(ModelConfig):
    """The config one rank of a ``tp``-way "model" axis runs
    (``shard.local_config``): its own query (and KV) heads in
    ``n_heads`` / ``n_kv_heads``, every other field the full model's.  The
    layers and the cache layouts read ``tp`` for the widths they split
    (MLA latents, the RG-LRU width, the single KV head's columns);
    ``kv_split``: the one KV head of an MQA stack is not split by head but
    by its ``head_dim`` columns over the model axis."""

    tp: int = 1
    kv_split: bool = False


def model_ways(cfg) -> int:
    """How many ways the "model" axis splits ``cfg``'s layers (1 for a
    plain ``ModelConfig``)."""
    return cfg.tp if isinstance(cfg, RankConfig) else 1


def kv_split(cfg) -> bool:
    """Whether ``cfg``'s one KV head is split by its columns
    (``RankConfig.kv_split``; False for a plain ``ModelConfig``)."""
    return isinstance(cfg, RankConfig) and cfg.kv_split


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell of the dry run."""
    name: str           # train_4k | prefill_32k | decode_32k | long_500k
    kind: str           # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "cosine"      # cosine | linear | constant
    zero1: bool = True            # shard optimizer state over the data axis (launch.steps)
    fsdp: bool = True             # ZeRO-3 weight sharding over the data axis (launch.steps)
    microbatches: int = 1         # gradient accumulation steps per update
    grad_compression: bool = False  # int8 compressed gradient all-reduce (launch.steps)
    # dtype the gradients are cast to before the update: "f32" (exact) or
    # "bf16" (the reference's halved reduce-scatter payload; AdamW still
    # updates the f32 master copy)
    grad_reduce_dtype: str = "f32"
