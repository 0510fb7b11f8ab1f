"""``repro_torch.api`` — the public facade of the port (port of ``repro.api``).

    from repro_torch.api import LLM, RuntimeConfig, QuantRuntime, KVConfig

    out, = LLM("llama3.2-1b").generate([1, 2, 3, 4], max_new_tokens=8)

    llm = LLM(arch="llama3.2-1b",
              runtime=RuntimeConfig(quant=QuantRuntime(mode="int8_spoga"),
                                    kv=KVConfig(mode="paged", dtype="int8")))

``QuantRuntime(mode=...)`` picks the paper's dataflow: ``int8_spoga`` (the
fused kernel with its dequant epilogue; ``gemm_backend="cuda_spoga"`` for
the int32 kernel plus the epilogue after it), ``int8_deas`` (the
prior-work baseline kernels) or ``int8_direct`` (the plain int8 product).
The KV cache is a slot cache by default (``KVConfig()``), or a page pool
with ``KVConfig(mode="paged")``.  Named deployment profiles load by name
or from JSON: ``LLM("llama3.2-1b", runtime=load_runtime("int8-byte-serving"))``
(``list_presets()`` names them).  Entry points run on the card; pass
``device="cpu"`` to run the plain versions on the CPU.  ``serve_batch`` is
the static-batch lockstep baseline the engine is held against.
``RuntimeConfig(obs=ObsConfig(...))`` turns on spans, the event log, the
step profiler, ``/metrics``, the numerics watchdog and the flight
recorder (``LLM.replay``).  ``RuntimeConfig(mesh=MeshConfig(tp=2))`` serves
tensor-parallel over two launched ranks (``repro_torch.launch.mesh``).
"""

from repro_torch.api.baseline import serve_batch
from repro_torch.api.config import (
    KVConfig,
    MeshConfig,
    QuantRuntime,
    RuntimeConfig,
    SamplingDefaults,
    SchedulerConfig,
    auto_buckets,
    get_preset,
    list_presets,
    load_runtime,
    register_preset,
)
from repro_torch.api.llm import LLM
from repro_torch.api.outputs import RequestOutput
from repro_torch.obs import ObsConfig, Observability
from repro_torch.serving.sampling import SamplingParams
from repro_torch.spec.config import SpecConfig

__all__ = [
    "KVConfig",
    "LLM",
    "MeshConfig",
    "ObsConfig",
    "Observability",
    "QuantRuntime",
    "RequestOutput",
    "RuntimeConfig",
    "SamplingDefaults",
    "SamplingParams",
    "SchedulerConfig",
    "SpecConfig",
    "auto_buckets",
    "get_preset",
    "list_presets",
    "load_runtime",
    "register_preset",
    "serve_batch",
]
