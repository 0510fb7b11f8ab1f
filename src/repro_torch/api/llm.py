"""The ``LLM`` facade: one entry point over configs, params and the
continuous-batching engine (port of ``repro/api/llm.py``).

    from repro_torch.api import LLM, RuntimeConfig, QuantRuntime, KVConfig

    outs = LLM("llama3.2-1b").generate([[1, 2, 3]])    # bf16 GEMMs, slot bf16 KV
    llm = LLM(arch="llama3.2-1b",
              runtime=RuntimeConfig(quant=QuantRuntime(mode="int8_deas"),
                                    kv=KVConfig(mode="paged", dtype="int8")))
    outs = llm.generate([[1, 2, 3], [4, 5]], max_new_tokens=8)

``LLM`` owns parameter init, resolves the layered ``RuntimeConfig`` into
the ``ModelConfig`` overrides + engine config, and drives the engine.  It
runs on the card unless ``device="cpu"`` is passed (the kernels' plain
versions then serve).  The engine is built lazily: when ``kv.cache_len``
is unset, the first ``generate``/``stream`` call sizes the cache from its
own workload (the shared ``default_cache_len`` policy) and later, larger
workloads rebuild it between calls, growing monotonically.

Weights come from ``params=`` (the port's tree, for example
``models.params_from_jax`` of the reference's weights), from
``checkpoint_dir=`` (the latest step of a directory in the reference's
checkpoint format, ``checkpoint.restore_checkpoint``), or else from
``init_params(seed)``.  ``policies=`` overrides the engine policies that
``RuntimeConfig.build_policies`` derives; one policy object serves every
engine the ``LLM`` builds.

Not ported yet, and refused with ``NotImplementedError``: ``replay`` and
the metrics server (the observability stack), plus every runtime setting
that ``RuntimeConfig.check_served`` names.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional, Sequence, Union

import numpy as np

from repro_torch.api.config import RuntimeConfig
from repro_torch.api.outputs import RequestOutput
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs import get_config, reduced as reduce_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.policies import EnginePolicies
from repro_torch.serving.request import RequestState, default_detokenizer
from repro_torch.serving.sampling import SamplingParams

Prompt = Sequence[int]


class LLM:
    """One generation endpoint: ``LLM(arch=...)`` then ``.generate`` /
    ``.stream``.  Advanced callers reach the underlying ``ServingEngine``
    via ``.engine`` (e.g. for staggered-arrival workloads)."""

    def __init__(self, arch: Optional[str] = None, *,
                 runtime: Optional[RuntimeConfig] = None,
                 config=None, params=None,
                 tokenizer: Optional[Callable[[Sequence[int]], str]] = None,
                 checkpoint_dir: Optional[str] = None,
                 policies: Optional[EnginePolicies] = None,
                 seed: int = 0, device=None):
        if (arch is None) == (config is None):
            raise ValueError("pass exactly one of arch= (registry name) or "
                             "config= (a ModelConfig)")
        if params is not None and checkpoint_dir is not None:
            raise ValueError("pass at most one of params= and checkpoint_dir=")
        self.runtime = runtime if runtime is not None else RuntimeConfig()
        self.runtime.check_served()
        base = get_config(arch) if config is None else config
        if self.runtime.reduced:
            base = reduce_config(base)
        self.config = self.runtime.resolve_model(base)
        self.device = resolve_device(device)
        if checkpoint_dir is not None:
            _, params, _ = restore_checkpoint(checkpoint_dir, None, self.config,
                                              device=self.device)
        self.params = (params if params is not None
                       else init_params(self.config, seed=seed, device=self.device))
        self.tokenizer = tokenizer or default_detokenizer
        self._policies = policies if policies is not None else self.runtime.build_policies()
        self._engine: Optional[ServingEngine] = None

    @staticmethod
    def replay(bundle_path: str, runtime_transform=None, max_steps: int = 100_000):
        raise NotImplementedError("flight-recorder replay is not ported yet "
                                  "(ROADMAP queue 1, item 8)")

    # -- engine lifecycle --------------------------------------------------
    def _ensure_engine(self, prompt_len: int, gen_tokens: int) -> ServingEngine:
        need = prompt_len + gen_tokens
        if self._engine is not None:
            if (need <= self._engine.engine_cfg.cache_len + 1
                    or self.runtime.kv.cache_len is not None):
                # fits — or the user pinned cache_len, in which case
                # add_request raises its own sizing error
                return self._engine
            if self._engine.has_work:
                raise RuntimeError(
                    "cannot grow the KV cache while requests are in flight; "
                    "drain the engine first or set kv.cache_len up front")
        ecfg = self.runtime.resolve_engine(self.config, prompt_len, gen_tokens)
        old = self._engine
        if old is not None:
            # grow monotonically so earlier workloads keep fitting
            ecfg = dataclasses.replace(
                ecfg, cache_len=max(ecfg.cache_len, old.engine_cfg.cache_len))
        self._engine = ServingEngine(self.config, self.params, ecfg, device=self.device,
                                     policies=self._policies)
        if old is not None:
            # metrics accumulate across rebuilds, with the new pool geometry
            carried = old.metrics
            carried.set_gauge("pages_total", self._engine.metrics.pages_total)
            carried.set_gauge("page_size", self._engine.metrics.page_size)
            self._engine.metrics = carried
        return self._engine

    def build_engine(self, prompt_len: int, gen_tokens: int) -> ServingEngine:
        """Build (or reuse) the engine for a nominal workload — the hints
        size the cache when ``kv.cache_len`` is unset and anchor the
        'auto' prefill-bucket ladder to real prompt lengths."""
        return self._ensure_engine(prompt_len, gen_tokens)

    @property
    def engine(self) -> ServingEngine:
        """The underlying engine (built on demand; requires ``kv.cache_len``
        when no generate/stream/build_engine call has sized it yet)."""
        if self._engine is None:
            if self.runtime.kv.cache_len is None:
                raise RuntimeError(
                    "engine not built yet: set RuntimeConfig.kv.cache_len, "
                    "call build_engine(prompt_len, gen_tokens), or issue a "
                    "generate()/stream() call to size it from the workload")
            self._ensure_engine(0, 1)
        return self._engine

    @property
    def metrics(self):
        return self._engine.metrics if self._engine is not None else None

    # -- sampling plumbing -------------------------------------------------
    def _sampling_for(self, n: int, sampling) -> list[SamplingParams]:
        if sampling is None:
            return [self.runtime.sampling.to_params()] * n
        if isinstance(sampling, SamplingParams):
            return [sampling] * n
        sampling = list(sampling)
        if len(sampling) != n:
            raise ValueError(f"got {len(sampling)} SamplingParams for {n} prompts")
        return sampling

    # -- the public calls --------------------------------------------------
    def generate(self, prompts: Union[Prompt, Sequence[Prompt]],
                 sampling: Union[SamplingParams, Sequence[SamplingParams], None] = None,
                 max_new_tokens: Optional[int] = None,
                 detokenize: bool = False) -> list[RequestOutput]:
        """Generate for one prompt (flat token-id list) or many.  Returns
        ``RequestOutput``s in prompt order; scheduling is output-invisible,
        so each entry's greedy tokens equal a solo decode of that prompt."""
        prompts = list(prompts)
        if prompts and isinstance(prompts[0], (int, np.integer)):
            prompts = [prompts]
        if not prompts:
            return []
        gen = max_new_tokens if max_new_tokens is not None else self.runtime.max_new_tokens
        per_req = self._sampling_for(len(prompts), sampling)
        engine = self._ensure_engine(max(len(p) for p in prompts), gen)
        reqs = [engine.add_request(p, gen, sampling=s, detokenizer=self.tokenizer)
                for p, s in zip(prompts, per_req)]
        while engine.has_work:
            engine.step()
        detok = self.tokenizer if detokenize else None
        return [RequestOutput.from_request(r, detok) for r in reqs]

    def stream(self, prompt: Prompt,
               sampling: Optional[SamplingParams] = None,
               max_new_tokens: Optional[int] = None,
               eos_token: Optional[int] = None,
               detokenize: bool = False) -> Iterator[Union[int, str]]:
        """Submit one request and yield its output as the engine produces
        it — token ids by default, detokenized text fragments with
        ``detokenize=True``.  Other queued requests advance normally
        between yields."""
        gen = max_new_tokens if max_new_tokens is not None else self.runtime.max_new_tokens
        engine = self._ensure_engine(len(prompt), gen)
        emitted: list = []
        hook = ({"on_text": emitted.append, "detokenizer": self.tokenizer}
                if detokenize else {"on_token": emitted.append})
        req = engine.add_request(prompt, gen,
                                 sampling=self._sampling_for(1, sampling)[0],
                                 eos_token=eos_token, **hook)
        i = 0
        while True:
            while i < len(emitted):
                yield emitted[i]
                i += 1
            if req.state is RequestState.FINISHED or not engine.has_work:
                break
            engine.step()
        yield from emitted[i:]
