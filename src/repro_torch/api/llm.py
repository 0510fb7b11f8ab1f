"""The ``LLM`` facade: one entry point over configs, params and the
continuous-batching engine (port of ``repro/api/llm.py``).

    from repro_torch.api import LLM, RuntimeConfig, QuantRuntime, KVConfig

    outs = LLM("llama3.2-1b").generate([[1, 2, 3]])    # bf16 GEMMs, slot bf16 KV
    llm = LLM(arch="llama3.2-1b",
              runtime=RuntimeConfig(quant=QuantRuntime(mode="int8_deas"),
                                    kv=KVConfig(mode="paged", dtype="int8")))
    outs = llm.generate([[1, 2, 3], [4, 5]], max_new_tokens=8)
    llm = LLM("llama3.2-1b", runtime=load_runtime("int8-byte-serving"))

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

Every decoder-only arch serves: ``llama3.2-1b``, ``mistral-nemo-12b``
(GQA), ``minicpm3-4b`` (MLA), ``deepseek-moe-16b`` and
``granite-moe-3b-a800m`` (routed experts), ``xlstm-125m`` (mLSTM and
sLSTM cells) and ``recurrentgemma-9b`` (RG-LRU cells and local attention
over a window ring).  ``mistral-large-123b`` (229 GiB of bf16 weights)
serves tensor-parallel: ``RuntimeConfig(mesh=MeshConfig(tp=N))`` in N
launched ranks (``torchrun --nproc-per-node N`` or
``launch.mesh.spawn``), each rank building the same ``LLM``; the weights
are made (or loaded) whole and sliced to the rank's part
(``shard.shard_params``), so a rank must hold the whole tree once.  Every
arch runs at tp>1 (a MoE stack expert-parallel where tp divides its
experts, with tensor parallelism inside the experts where it does not),
the numerics watchdog too; the encoder-decoder and frontend archs serve through
``api.serve_batch(..., mesh=llm.mesh)``.  Every runtime the
reference can build for them serves, the five presets included
(``load_runtime("int8-byte-serving")``): the prefix cache with
prefix-aware admission, speculative decoding (``RuntimeConfig(spec=
SpecConfig(enabled=True))``) and stochastic ``SamplingParams``; a MoE
stack refuses chunked prefill, the prefix cache and speculation, and a
recurrent stack refuses prefill buckets, the prefix cache and speculation
(recurrentgemma's rings chunked prefill too), each with the reference's
``ValueError``.  The encoder-decoder and frontend archs
(``seamless-m4t-large-v2``, ``llava-next-mistral-7b``) build their
parameters, but the engine refuses them with the reference's
``ValueError`` at ``generate``: they serve through ``api.serve_batch``
with a batch dict.

``RuntimeConfig.obs`` (an ``ObsConfig``) turns observability on: one
``Observability`` bundle per ``LLM`` (``llm.obs``; it outlives engine
rebuilds, and ``llm.obs.save()`` writes the trace and event sinks),
per-request timelines on the outputs, a live ``/metrics`` server
(``metrics_port``; ``llm.metrics_server``), the numerics watchdog
(``watchdog``) and the flight recorder (``record_path``), whose bundles
``LLM.replay`` reproduces bitwise.  ``close()`` stops the server and
closes the sinks.
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
from repro_torch.models import init_params, params_from_jax
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.policies import EnginePolicies
from repro_torch.serving.request import default_detokenizer
from repro_torch.serving.sampling import SamplingParams
from repro_torch.shard import build_mesh, local_config, shard_params

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
        self.mesh = build_mesh(self.runtime.mesh, device=self.device)
        if self.mesh is not None:
            local_config(self.config, self.mesh.shape["model"])   # refuses early
        if checkpoint_dir is not None:
            _, tree, _ = restore_checkpoint(
                checkpoint_dir, None, init_params(self.config, device="meta"), device=self.device)
            params = params_from_jax(tree, self.config, self.device)
        self.params = (params if params is not None
                       else init_params(self.config, seed=seed, device=self.device))
        if self.mesh is not None:
            # the rank's part of the weights (pure TP, as the reference serves)
            self.params = shard_params(self.params, self.mesh, self.config)
        self.tokenizer = tokenizer or default_detokenizer
        self._policies = policies if policies is not None else self.runtime.build_policies()
        # one observability bundle per LLM: it outlives engine rebuilds
        # (spans and events accumulate across them, like metrics)
        self.obs = self.runtime.obs.build()
        if self.obs.recorder is not None:
            # flight recorder armed: stamp what replay needs to rebuild the model
            self.obs.recorder.set_run_info(arch=arch, runtime=self.runtime, seed=seed,
                                           checkpoint_dir=checkpoint_dir)
        self._engine: Optional[ServingEngine] = None
        # live telemetry: a stdlib HTTP server polling the engine's registry
        # (and the watchdog's) on each scrape; nothing on the dispatch path
        # knows about it
        self.metrics_server = None
        if self.runtime.obs.metrics_port is not None:
            from repro_torch.obs.server import MetricsServer

            self.metrics_server = MetricsServer(
                self._collect_metrics, port=self.runtime.obs.metrics_port,
                events=lambda: self.obs.events).start()

    def _collect_metrics(self):
        """Scrape-time collector: registries + cheap derived gauges.  The
        derived values read host-side counters only (no ``report()``, no
        device sync), so a scrape never perturbs the run."""
        from repro_torch.obs import watchdog

        regs, derived = [], {}
        m = self._engine.metrics if self._engine is not None else None
        if m is not None:
            regs.append(m.registry)
            wall = m.wall_s
            toks = m.generated_tokens
            derived["wall_seconds"] = wall
            derived["generated_tokens"] = float(toks)
            derived["tokens_per_second"] = toks / max(wall, 1e-9)
            derived["goodput_tokens_per_second"] = m.goodput_tokens / max(wall, 1e-9)
            derived["requests_finished"] = float(len(m.finished))
        wreg = watchdog.peek_registry()
        if wreg is not None:
            regs.append(wreg)
        return regs, derived

    def close(self) -> None:
        """Stop the metrics server (if any) and close the event, trace and
        recorder sinks.  Idempotent; the LLM stays usable for generate /
        stream afterwards, minus the closed sinks."""
        if self.metrics_server is not None:
            self.metrics_server.close()
            self.metrics_server = None
        self.obs.close()

    @staticmethod
    def replay(bundle_path: str, runtime_transform=None, max_steps: int = 100_000,
               device=None):
        """Replay a flight-recorder bundle (``ObsConfig.record_path``): rebuild
        the recorded engine, re-feed the recorded arrivals on their step
        schedule, and compare token streams and the decision journal
        bitwise.  Returns an ``obs.replay.ReplayResult``;
        ``runtime_transform`` perturbs the rebuilt ``RuntimeConfig`` on
        purpose so the differ names the first decision that changes.
        ``device``: where the replay runs (default the card)."""
        from repro_torch.obs.replay import replay_bundle

        return replay_bundle(bundle_path, runtime_transform=runtime_transform,
                             max_steps=max_steps, device=device)

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
                                     policies=self._policies, obs=self.obs, mesh=self.mesh)
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
        # with observability on, each output carries its scheduler timeline
        return [RequestOutput.from_request(
            r, detok, timeline=self.obs.events.timeline(r.req_id) or None) for r in reqs]

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
        yield from engine.follow(req, emitted)
