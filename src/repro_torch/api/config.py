"""Layered runtime configuration for the ``repro_torch.api`` facade.

Port of ``repro/api/config.py``: the same frozen sub-configs with the same
fields, defaults and validation messages.

* ``QuantRuntime``     — GEMM execution: quant mode + backend registry name.
* ``KVConfig``         — KV cache: slot vs paged, dtype (bf16 / byte-size
                         int8), page geometry, paged-attention impl.
* ``SchedulerConfig``  — admission: slots, buckets, chunking, stacked
                         admission, defrag threshold.
* ``SamplingDefaults`` — the default per-request sampling policy.

``resolve()`` derives the ``ModelConfig`` overrides (``ModelConfig.with_``)
and the ``EngineConfig`` the port's engine consumes.

``build_policies()`` maps the scheduler settings to the engine's
``EnginePolicies`` (admission order, eviction, defrag threshold).

A setting that validates but that the port's engine does not serve yet
raises ``NotImplementedError`` naming its ROADMAP item, from
:meth:`RuntimeConfig.check_served` (called by ``resolve_engine`` and by
``LLM``): the prefix cache and prefix-aware admission, stochastic
sampling, and the ``mesh``, ``spec`` and ``obs`` sub-configs (their
classes are not ported yet; ``None`` stands for the reference's disabled
defaults).  ``to_dict``/``from_dict``, presets and ``load_runtime`` are
not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

from repro_torch.backends.spec import QUANT_MODES, parse_quant_mode
from repro_torch.configs.base import DEFAULT_PAGE_SIZE, ModelConfig, default_cache_len
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.policies import (
    BucketBatchedAdmission,
    BudgetOrEOSEviction,
    DeadlineAdmission,
    DeadlinePreemption,
    EnginePolicies,
    FIFOAdmission,
    NeverDefrag,
    PriorityAdmission,
    ThresholdDefrag,
)
from repro_torch.serving.sampling import SamplingParams

# None = auto (the kernel on CUDA tensors, the gather twin on CPU tensors)
_PAGED_ATTN_IMPLS = (None, "gather")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1, item {item})")


@dataclasses.dataclass(frozen=True)
class QuantRuntime:
    """GEMM execution mode (the paper's byte-size integer pipelines)."""

    # "bf16" | "int8_spoga" | parametric "w<bits>a<bits>[_s<slices>]"
    mode: str = "bf16"
    # GEMM backend registry name (None = auto-select by family/device)
    gemm_backend: Optional[str] = None

    def __post_init__(self):
        if self.mode not in QUANT_MODES:
            try:
                parse_quant_mode(self.mode)
            except ValueError:
                raise ValueError(
                    f"QuantRuntime.mode must be in {QUANT_MODES} or a "
                    f"parametric 'w<bits>a<bits>[_s<slice>]' string, got "
                    f"{self.mode!r}") from None
        if self.gemm_backend is not None:
            from repro_torch.backends import get_backend, list_backends

            try:
                get_backend(self.gemm_backend)
            except KeyError:
                raise ValueError(
                    f"unknown gemm_backend {self.gemm_backend!r}; known: "
                    f"{list_backends()}") from None


@dataclasses.dataclass(frozen=True)
class KVConfig:
    """KV-cache storage: slot vs paged pool, dtype, page geometry."""

    mode: str = "slot"               # "slot" | "paged"
    dtype: str = "bf16"              # "bf16" | "int8" (byte-size + scales)
    # total rows per lane; None = derive from the workload at resolution
    # time (default_cache_len(prompt_len, gen_tokens))
    cache_len: Optional[int] = None
    page_size: int = DEFAULT_PAGE_SIZE
    # pool size in pages; None = the slot-equivalent KV budget
    n_pages: Optional[int] = None
    # paged-attention impl: None (auto) | "gather" (the CPU twin)
    paged_attn_impl: Optional[str] = None
    # shared-prefix KV cache (paged mode only)
    prefix_cache: bool = False
    # skip matches shorter than this many pages (1 = adopt any full page)
    prefix_min_pages: int = 1

    def __post_init__(self):
        if self.mode not in ("slot", "paged"):
            raise ValueError(f"KVConfig.mode must be 'slot' or 'paged', got "
                             f"{self.mode!r}")
        if self.dtype not in ("bf16", "int8"):
            raise ValueError(f"KVConfig.dtype must be 'bf16' or 'int8', got "
                             f"{self.dtype!r}")
        if self.cache_len is not None and self.cache_len < 1:
            raise ValueError("KVConfig.cache_len must be >= 1")
        if self.page_size < 1:
            raise ValueError("KVConfig.page_size must be >= 1")
        if self.n_pages is not None:
            if self.mode != "paged":
                raise ValueError("KVConfig.n_pages requires mode='paged'")
            if self.n_pages < 2:
                raise ValueError("KVConfig.n_pages must be >= 2 "
                                 "(page 0 is the trash page)")
        if self.paged_attn_impl not in _PAGED_ATTN_IMPLS:
            raise ValueError(
                f"KVConfig.paged_attn_impl must be one of {_PAGED_ATTN_IMPLS}, "
                f"got {self.paged_attn_impl!r}")
        if self.prefix_cache and self.mode != "paged":
            raise ValueError("KVConfig.prefix_cache requires mode='paged' "
                             "(shared pages live in the page pool)")
        if self.prefix_min_pages < 1:
            raise ValueError("KVConfig.prefix_min_pages must be >= 1")


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Admission / scheduling: lanes, buckets, chunking, engine policies."""

    n_slots: int = 4
    max_prefills_per_step: int = 1
    # None = exact-length prefill; "auto" = power-of-two buckets derived at
    # resolution time; a tuple = explicit bucket lengths
    prefill_buckets: Union[None, str, Tuple[int, ...]] = None
    # paged mode: admit prompts longer than this in page-aligned chunks
    prefill_chunk: Optional[int] = None
    # stack >=2 same-bucket waiting prompts into ONE batched prefill
    batched_admission: bool = False
    # admission ordering: "fifo" | "priority" | "prefix-aware" | "deadline"
    admission: str = "fifo"
    # eviction policy: "budget" | "deadline-preempt"
    eviction: str = "budget"
    # paged mode: compact the pool when fragmentation crosses this
    # threshold; None disables auto-defrag
    defrag_threshold: Optional[float] = 0.5

    def __post_init__(self):
        if self.n_slots < 1:
            raise ValueError("SchedulerConfig.n_slots must be >= 1")
        if self.max_prefills_per_step < 1:
            raise ValueError("SchedulerConfig.max_prefills_per_step must be >= 1")
        if self.admission not in ("fifo", "priority", "prefix-aware",
                                  "deadline"):
            raise ValueError("SchedulerConfig.admission must be 'fifo', "
                             f"'priority', 'prefix-aware' or 'deadline', got "
                             f"{self.admission!r}")
        if self.eviction not in ("budget", "deadline-preempt"):
            raise ValueError("SchedulerConfig.eviction must be 'budget' or "
                             f"'deadline-preempt', got {self.eviction!r}")
        if self.admission != "fifo" and self.batched_admission:
            raise ValueError("batched_admission stacks FIFO bucket-mates; "
                             "combine it with admission='fifo'")
        if isinstance(self.prefill_buckets, str):
            if self.prefill_buckets != "auto":
                raise ValueError("prefill_buckets must be None, 'auto' or a "
                                 f"tuple of lengths, got {self.prefill_buckets!r}")
        elif self.prefill_buckets is not None:
            object.__setattr__(self, "prefill_buckets",
                               tuple(int(b) for b in self.prefill_buckets))
            if any(b < 1 for b in self.prefill_buckets):
                raise ValueError("prefill bucket lengths must be >= 1")
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError("SchedulerConfig.prefill_chunk must be >= 1")
        if self.defrag_threshold is not None and not (
                0.0 <= self.defrag_threshold < 1.0):
            raise ValueError("SchedulerConfig.defrag_threshold must be in "
                             "[0, 1) or None")


@dataclasses.dataclass(frozen=True)
class SamplingDefaults:
    """Default per-request sampling policy (overridable per call)."""

    greedy: bool = True
    temperature: float = 1.0
    top_k: int = 0
    seed: int = 0

    def __post_init__(self):
        # the reference's SamplingParams validation
        if not self.greedy and self.temperature <= 0:
            raise ValueError("temperature must be > 0 for stochastic sampling "
                             "(use greedy=True for argmax decoding)")

    def to_params(self) -> SamplingParams:
        return SamplingParams(greedy=self.greedy)


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """The one runtime surface: everything that is not the architecture.

    Resolution overwrites the corresponding ``ModelConfig`` fields (quant
    mode, GEMM backend, KV dtype, paged-attention impl), so there is
    exactly one place a deployment's runtime behaviour is specified.
    """

    quant: QuantRuntime = dataclasses.field(default_factory=QuantRuntime)
    kv: KVConfig = dataclasses.field(default_factory=KVConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    sampling: SamplingDefaults = dataclasses.field(default_factory=SamplingDefaults)
    # sharded serving, speculative decoding and observability: the
    # reference's MeshConfig / SpecConfig / ObsConfig are not ported yet;
    # None is their disabled default
    mesh: Optional[object] = None
    spec: Optional[object] = None
    obs: Optional[object] = None
    # default generation budget for requests that don't specify one
    max_new_tokens: int = 16
    eos_token: Optional[int] = None
    # smoke-size the architecture config (configs.reduced) before use
    reduced: bool = False

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError("RuntimeConfig.max_new_tokens must be >= 1")
        s, kv = self.scheduler, self.kv
        if s.prefill_chunk is not None:
            if kv.mode != "paged":
                raise ValueError("scheduler.prefill_chunk requires "
                                 "kv.mode='paged' (chunks live in pages)")
            if s.prefill_chunk % kv.page_size:
                raise ValueError(
                    f"scheduler.prefill_chunk ({s.prefill_chunk}) must be a "
                    f"multiple of kv.page_size ({kv.page_size})")
        if isinstance(s.prefill_buckets, tuple) and kv.cache_len is not None \
                and max(s.prefill_buckets) > kv.cache_len:
            raise ValueError("largest prefill bucket exceeds kv.cache_len")

    def check_served(self) -> None:
        """Raise ``NotImplementedError`` for a setting the port's engine
        does not serve yet, naming its ROADMAP item."""
        s, kv = self.scheduler, self.kv
        refused = [
            (kv.prefix_cache, "KVConfig.prefix_cache", "6"),
            (s.admission == "prefix-aware", "SchedulerConfig.admission='prefix-aware'", "6"),
            (not self.sampling.greedy, "stochastic sampling (SamplingDefaults.greedy=False)",
             "5"),
            (self.mesh is not None, "RuntimeConfig.mesh (sharded serving)", "10"),
            (self.spec is not None, "RuntimeConfig.spec (speculative decoding)", "6"),
            (self.obs is not None, "RuntimeConfig.obs (observability)", "8"),
        ]
        for hit, what, item in refused:
            if hit:
                raise _not_ported(what, item)

    # -- resolution --------------------------------------------------------
    def resolve_model(self, cfg: ModelConfig) -> ModelConfig:
        """Apply the runtime's model-side overrides."""
        return cfg.with_(
            quant_mode=self.quant.mode,
            gemm_backend=self.quant.gemm_backend,
            kv_cache_dtype=self.kv.dtype,
            paged_attn_impl=self.kv.paged_attn_impl,
        )

    def resolve_engine(self, cfg: ModelConfig,
                       prompt_len: Optional[int] = None,
                       gen_tokens: Optional[int] = None) -> EngineConfig:
        """Derive the ``EngineConfig``.  ``prompt_len``/``gen_tokens`` are
        workload hints used when ``kv.cache_len`` is None (sized by the
        shared ``default_cache_len`` policy) and when buckets are 'auto'.
        (The reference drops 'auto' buckets for recurrent stacks; the port
        serves attention stacks only.)"""
        self.check_served()
        if self.kv.cache_len is not None:
            cache_len = self.kv.cache_len
        elif prompt_len is not None and gen_tokens is not None:
            cache_len = default_cache_len(prompt_len, gen_tokens)
        else:
            raise ValueError(
                "cannot size the KV cache: set kv.cache_len or pass "
                "prompt_len/gen_tokens workload hints to resolve_engine")
        buckets = self.scheduler.prefill_buckets
        if buckets == "auto":
            buckets = auto_buckets(prompt_len or cache_len)
        return EngineConfig(
            n_slots=self.scheduler.n_slots,
            cache_len=cache_len,
            max_prefills_per_step=self.scheduler.max_prefills_per_step,
            prefill_buckets=buckets,
            eos_token=self.eos_token,
            cache_mode=self.kv.mode,
            page_size=self.kv.page_size,
            n_pages=self.kv.n_pages,
            prefill_chunk=self.scheduler.prefill_chunk,
        )

    def resolve(self, cfg: ModelConfig, prompt_len: Optional[int] = None,
                gen_tokens: Optional[int] = None
                ) -> tuple[ModelConfig, EngineConfig]:
        """The single resolution step: (ModelConfig with runtime overrides,
        EngineConfig)."""
        model_cfg = self.resolve_model(cfg)
        return model_cfg, self.resolve_engine(model_cfg, prompt_len, gen_tokens)

    def build_policies(self) -> EnginePolicies:
        """The engine policies the scheduler settings imply: FIFO, priority,
        deadline or stacked-prefill admission, budget-or-EOS or
        deadline-preempting eviction, threshold or no defrag."""
        self.check_served()
        s = self.scheduler
        if s.admission == "priority":
            admission = PriorityAdmission()
        elif s.admission == "deadline":
            admission = DeadlineAdmission()
        elif s.batched_admission:
            admission = BucketBatchedAdmission()
        else:
            admission = FIFOAdmission()
        eviction = (DeadlinePreemption() if s.eviction == "deadline-preempt"
                    else BudgetOrEOSEviction())
        defrag = (ThresholdDefrag(s.defrag_threshold) if s.defrag_threshold is not None
                  else NeverDefrag())
        return EnginePolicies(admission=admission, eviction=eviction, defrag=defrag)


def auto_buckets(prompt_len: int) -> tuple[int, ...]:
    """Power-of-two buckets covering [1, prompt_len] — bounds the number of
    distinct prefill shapes while padding any prompt by at most 2x."""
    buckets, b = [], 8
    while b < prompt_len:
        buckets.append(b)
        b *= 2
    buckets.append(prompt_len)
    return tuple(buckets)
