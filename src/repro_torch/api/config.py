"""Layered runtime configuration for the ``repro_torch.api`` facade.

Port of ``repro/api/config.py``: the same frozen sub-configs with the same
fields, defaults and validation messages.

* ``QuantRuntime``     — GEMM execution: quant mode + backend registry name.
* ``KVConfig``         — KV cache: slot vs paged, dtype (bf16 / byte-size
                         int8), page geometry, paged-attention impl.
* ``SchedulerConfig``  — admission: slots, buckets, chunking, stacked
                         admission, defrag threshold.
* ``SamplingDefaults`` — the default per-request sampling policy.
* ``ObsConfig``        — observability (``repro_torch/obs/``): spans, the
                         event log, the step profiler, ``/metrics``, the
                         numerics watchdog and the flight recorder; all
                         off by default.
* ``MeshConfig``       — the (data, model) mesh of sharded serving
                         (``repro_torch/shard/``); off by default.

``resolve()`` derives the ``ModelConfig`` overrides (``ModelConfig.with_``)
and the ``EngineConfig`` the port's engine consumes.

``build_policies()`` maps the scheduler settings to the engine's
``EnginePolicies`` (admission order, eviction, defrag threshold, prefix
reuse).  ``to_dict``/``from_dict`` round-trip through plain JSON dicts
(partial dicts take their defaults); named presets (``register_preset``,
``get_preset``, ``list_presets``, the five built-in ones) and
``load_runtime`` (a JSON file or a preset name) are the reference's.

A ``mesh`` that is not a ``MeshConfig`` is refused with ``TypeError`` by
:meth:`RuntimeConfig.check_served` (called by ``resolve_engine``,
``build_policies``, ``to_dict`` and ``LLM``).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from typing import Optional, Tuple, Union

from repro_torch.backends.spec import QUANT_MODES, parse_quant_mode
from repro_torch.configs.base import DEFAULT_PAGE_SIZE, ModelConfig, default_cache_len
from repro_torch.models.transformer import RECURRENT_KINDS
from repro_torch.obs.config import ObsConfig
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.policies import (
    BucketBatchedAdmission,
    BudgetOrEOSEviction,
    DeadlineAdmission,
    DeadlinePreemption,
    EnginePolicies,
    FIFOAdmission,
    NeverDefrag,
    PrefixAwareAdmission,
    PriorityAdmission,
    SharedPrefix,
    ThresholdDefrag,
)
from repro_torch.serving.sampling import SamplingParams
from repro_torch.spec.config import SpecConfig

# None = auto (the kernel on CUDA tensors, the gather twin on CPU tensors)
_PAGED_ATTN_IMPLS = (None, "gather")


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
class MeshConfig:
    """Mesh of sharded serving (``repro_torch/shard/``).

    ``tp`` shards attention heads, MoE experts and GEMM operands over the
    "model" axis; ``dp`` is data parallelism (engine replicas in serving,
    batch slices in training).  ``enable=True`` at ``tp=1`` builds a
    genuine one-rank mesh -- the bitwise-vs-unsharded test configuration;
    the default ``enable=None`` turns the mesh on iff an axis exceeds 1.
    Axis names stay ``("data", "model")`` to match the sharding rules in
    ``runtime/sharding.py``; they are configurable only so that the JSON
    form is explicit about what the mesh means.  A mesh of ``dp * tp > 1``
    runs in that many ranks (``torchrun`` or ``launch.mesh.spawn``)."""

    tp: int = 1
    dp: int = 1
    enable: Optional[bool] = None
    axes: Tuple[str, str] = ("data", "model")

    def __post_init__(self):
        if self.tp < 1:
            raise ValueError("MeshConfig.tp must be >= 1")
        if self.dp < 1:
            raise ValueError("MeshConfig.dp must be >= 1")
        object.__setattr__(self, "axes", tuple(str(a) for a in self.axes))
        if len(self.axes) != 2 or len(set(self.axes)) != 2:
            raise ValueError(f"MeshConfig.axes must be two distinct axis "
                             f"names, got {self.axes!r}")

    @property
    def enabled(self) -> bool:
        return self.enable if self.enable is not None else (
            self.tp > 1 or self.dp > 1)


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
        # mirror SamplingParams' own validation at config-build time
        SamplingParams(**dataclasses.asdict(self))

    def to_params(self) -> SamplingParams:
        return SamplingParams(greedy=self.greedy, temperature=self.temperature,
                              top_k=self.top_k, seed=self.seed)


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
    # sharded serving (repro_torch/shard/): the (data, model) mesh.  The
    # default 1x1 config is disabled -- the engine runs exactly the
    # unsharded path; tp>1 (or enable=True) shards params, pools and every
    # engine dispatch over the launched ranks
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    # speculative decoding (repro_torch/spec/): draft-verify greedy decode,
    # off by default (SpecConfig.enabled=False)
    spec: SpecConfig = dataclasses.field(default_factory=SpecConfig)
    # observability (repro_torch/obs/): spans, the scheduler event log, the
    # step profiler, /metrics, the numerics watchdog, the flight recorder.
    # All off by default: the engine's hot path sees only null sinks
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)
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
        """Raise for a setting the port cannot serve: a ``mesh`` that is not
        a ``MeshConfig`` (``TypeError``)."""
        if not isinstance(self.mesh, MeshConfig):
            raise TypeError(f"RuntimeConfig.mesh must be a MeshConfig, got "
                            f"{type(self.mesh).__name__}")

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        """Plain JSON-serializable nested dict (tuples become lists)."""
        self.check_served()
        d = dataclasses.asdict(self)
        b = d["scheduler"]["prefill_buckets"]
        if isinstance(b, tuple):
            d["scheduler"]["prefill_buckets"] = list(b)
        d["mesh"]["axes"] = list(d["mesh"]["axes"])
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "RuntimeConfig":
        """Inverse of ``to_dict``; also accepts partial dicts (missing keys
        take their defaults) and the reference's ``to_dict`` output."""
        d = copy.deepcopy(dict(d))
        sched = dict(d.pop("scheduler", {}))
        b = sched.get("prefill_buckets")
        if b is not None and not isinstance(b, str):
            sched["prefill_buckets"] = tuple(b)
        return cls(
            quant=QuantRuntime(**d.pop("quant", {})),
            kv=KVConfig(**d.pop("kv", {})),
            scheduler=SchedulerConfig(**sched),
            sampling=SamplingDefaults(**d.pop("sampling", {})),
            mesh=MeshConfig(**d.pop("mesh", {})),
            spec=SpecConfig(**d.pop("spec", {})),
            obs=ObsConfig(**d.pop("obs", {})),
            **d,
        )

    # -- resolution --------------------------------------------------------
    def resolve_model(self, cfg: ModelConfig) -> ModelConfig:
        """Apply the runtime's model-side overrides (the numerics watchdog
        included: it is a ``ModelConfig`` field, as in the reference)."""
        return cfg.with_(
            quant_mode=self.quant.mode,
            gemm_backend=self.quant.gemm_backend,
            kv_cache_dtype=self.kv.dtype,
            paged_attn_impl=self.kv.paged_attn_impl,
            numerics_watchdog=self.obs.watchdog,
        )

    def resolve_engine(self, cfg: ModelConfig,
                       prompt_len: Optional[int] = None,
                       gen_tokens: Optional[int] = None) -> EngineConfig:
        """Derive the ``EngineConfig``.  ``prompt_len``/``gen_tokens`` are
        workload hints used when ``kv.cache_len`` is None (sized by the
        shared ``default_cache_len`` policy) and when buckets are 'auto'
        ('auto' means exact-length prefill for a recurrent stack, whose
        state would integrate the padding)."""
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
            recurrent = bool(RECURRENT_KINDS & set(cfg.block_pattern))
            buckets = None if recurrent else auto_buckets(prompt_len or cache_len)
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
            prefix_cache=self.kv.prefix_cache,
            spec=self.spec if self.spec.enabled else None,
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
        prefix-aware, deadline or stacked-prefill admission, budget-or-EOS
        or deadline-preempting eviction, threshold or no defrag, and the
        shared-prefix matching policy."""
        self.check_served()
        s = self.scheduler
        if s.admission == "priority":
            admission = PriorityAdmission()
        elif s.admission == "prefix-aware":
            admission = PrefixAwareAdmission()
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
        return EnginePolicies(admission=admission, eviction=eviction, defrag=defrag,
                              prefix=SharedPrefix(self.kv.prefix_min_pages))


def auto_buckets(prompt_len: int) -> tuple[int, ...]:
    """Power-of-two buckets covering [1, prompt_len] — bounds the number of
    distinct prefill shapes while padding any prompt by at most 2x."""
    buckets, b = [], 8
    while b < prompt_len:
        buckets.append(b)
        b *= 2
    buckets.append(prompt_len)
    return tuple(buckets)


# ---------------------------------------------------------------------------
# Preset registry: named deployment profiles
# ---------------------------------------------------------------------------

_PRESETS: dict[str, RuntimeConfig] = {}


def register_preset(name: str, runtime: RuntimeConfig, overwrite: bool = False) -> None:
    """Register a named deployment profile.  Presets are ordinary
    ``RuntimeConfig``s: validated at registration, JSON round-trippable,
    resolvable like any hand-built config."""
    if not isinstance(runtime, RuntimeConfig):
        raise TypeError(f"preset {name!r} must be a RuntimeConfig")
    if name in _PRESETS and not overwrite:
        raise ValueError(f"preset {name!r} already registered "
                         "(pass overwrite=True to replace)")
    _PRESETS[name] = runtime


def get_preset(name: str) -> RuntimeConfig:
    try:
        return _PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown runtime preset {name!r}; known: "
                       f"{list_presets()}") from None


def list_presets() -> list[str]:
    return sorted(_PRESETS)


def load_runtime(spec: str) -> RuntimeConfig:
    """Resolve a ``--runtime`` spec: a JSON file path (loaded through
    ``RuntimeConfig.from_dict``) or a registered preset name."""
    if os.path.isfile(spec):
        with open(spec) as f:
            return RuntimeConfig.from_dict(json.load(f))
    if spec in _PRESETS:
        return _PRESETS[spec]
    raise ValueError(f"--runtime {spec!r} is neither a JSON file nor a "
                     f"registered preset (known: {list_presets()})")


# Built-in profiles (the reference's).  None pins cache_len: presets stay
# workload-sized, so one profile serves smoke tests and real prompt lengths.
register_preset("slot-throughput", RuntimeConfig(
    kv=KVConfig(mode="slot"),
    scheduler=SchedulerConfig(prefill_buckets="auto", batched_admission=True),
))
register_preset("paged-server", RuntimeConfig(
    kv=KVConfig(mode="paged", page_size=DEFAULT_PAGE_SIZE),
    scheduler=SchedulerConfig(prefill_chunk=2 * DEFAULT_PAGE_SIZE, defrag_threshold=0.5),
))
register_preset("prefix-interactive", RuntimeConfig(
    kv=KVConfig(mode="paged", page_size=DEFAULT_PAGE_SIZE, prefix_cache=True),
    scheduler=SchedulerConfig(prefill_chunk=DEFAULT_PAGE_SIZE, defrag_threshold=0.5),
))
register_preset("int8-byte-serving", RuntimeConfig(
    quant=QuantRuntime(mode="int8_spoga"),
    kv=KVConfig(mode="paged", dtype="int8", page_size=DEFAULT_PAGE_SIZE, prefix_cache=True),
    scheduler=SchedulerConfig(prefill_chunk=DEFAULT_PAGE_SIZE, defrag_threshold=0.5),
))
register_preset("priority-slot", RuntimeConfig(
    kv=KVConfig(mode="slot"),
    scheduler=SchedulerConfig(prefill_buckets="auto", admission="priority"),
))
