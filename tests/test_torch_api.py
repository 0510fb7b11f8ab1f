"""The port's ``api`` facade against the JAX package's.

``RuntimeConfig`` validates as the reference does (same errors, same
messages for the fields both packages serve), resolves to the same model
and engine settings, serializes to the reference's dicts and loads them,
and has the reference's five presets; ``mesh`` is the reference's
``MeshConfig`` (a value that is not one is refused with ``TypeError``;
``obs`` is served since observability was ported).
``LLM``
serves the reference's weights (the JAX ``init_params`` tree with its
projection weights scaled up, so that greedy decoding does not collapse
onto one repeated token, carried across with ``params_from_jax``) in paged
mode, and its greedy token streams equal the JAX ``LLM``'s, prompt by
prompt, in the SPOGA and DEAS dataflows over bf16 and int8 KV.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.api import LLM as JaxLLM
from repro.api import KVConfig as JaxKVConfig
from repro.api import QuantRuntime as JaxQuantRuntime
from repro.api import RuntimeConfig as JaxRuntimeConfig
from repro.api import SchedulerConfig as JaxSchedulerConfig
from repro.api import auto_buckets as jax_auto_buckets
from repro.api import get_preset as jax_get_preset
from repro.api import list_presets as jax_list_presets
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro_torch import configs as tconfigs
from repro_torch.api import (
    LLM,
    KVConfig,
    MeshConfig,
    ObsConfig,
    QuantRuntime,
    RequestOutput,
    RuntimeConfig,
    SamplingDefaults,
    SchedulerConfig,
    SpecConfig,
    auto_buckets,
    get_preset,
    list_presets,
    load_runtime,
    register_preset,
)
from repro_torch.kernels import deas_gemm as deas_mod
from repro_torch.kernels import spoga_gemm_dequant as dequant_mod
from repro_torch.models import params_from_jax
from repro_torch.serving import EngineConfig, SamplingParams

WEIGHT_SCALE = 8.0
PAGED = dict(mode="paged", page_size=8)


# ---------------------------------------------------------------------------
# RuntimeConfig: validation and resolution
# ---------------------------------------------------------------------------

# test_api.py's invalid settings, plus the fields' other checks
BAD = [
    dict(quant=dict(mode="w3a9z")),
    dict(kv=dict(mode="virtual")),
    dict(kv=dict(dtype="fp8")),
    dict(kv=dict(cache_len=0)),
    dict(kv=dict(page_size=0)),
    dict(kv=dict(n_pages=8)),                      # n_pages without paged
    dict(kv=dict(mode="paged", n_pages=1)),        # trash page needs >= 2
    dict(kv=dict(prefix_cache=True)),              # prefix cache without paged
    dict(kv=dict(mode="paged", prefix_min_pages=0)),
    dict(scheduler=dict(n_slots=0)),
    dict(scheduler=dict(max_prefills_per_step=0)),
    dict(scheduler=dict(prefill_buckets="buckets")),
    dict(scheduler=dict(prefill_buckets=(8, 0))),
    dict(scheduler=dict(defrag_threshold=1.5)),
    dict(scheduler=dict(admission="sjf")),
    dict(scheduler=dict(eviction="lru")),
    dict(scheduler=dict(admission="priority", batched_admission=True)),
    dict(scheduler=dict(prefill_chunk=8)),         # chunking without paged
    dict(kv=dict(PAGED), scheduler=dict(prefill_chunk=12)),   # not a page multiple
    dict(kv=dict(cache_len=16), scheduler=dict(prefill_buckets=(8, 32))),
    dict(sampling=dict(greedy=False, temperature=0.0)),
    dict(max_new_tokens=0),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the host's cores; small ops slow down
    when torch's intra-op threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(pkg, bad):
    """RuntimeConfig of package ``pkg`` from a BAD entry, or the error."""
    classes = {"quant": pkg["QuantRuntime"], "kv": pkg["KVConfig"],
               "scheduler": pkg["SchedulerConfig"], "sampling": pkg["SamplingDefaults"]}
    try:
        subs = {k: cls(**bad.get(k, {})) for k, cls in classes.items()}
        return pkg["RuntimeConfig"](**subs, max_new_tokens=bad.get("max_new_tokens", 16))
    except (ValueError, KeyError) as e:
        return e


def _jax_pkg():
    from repro.api import SamplingDefaults as JaxSamplingDefaults
    return {"QuantRuntime": JaxQuantRuntime, "KVConfig": JaxKVConfig,
            "SchedulerConfig": JaxSchedulerConfig, "SamplingDefaults": JaxSamplingDefaults,
            "RuntimeConfig": JaxRuntimeConfig}


PORT = {"QuantRuntime": QuantRuntime, "KVConfig": KVConfig, "SchedulerConfig": SchedulerConfig,
        "SamplingDefaults": SamplingDefaults, "RuntimeConfig": RuntimeConfig}


@pytest.mark.parametrize("bad", BAD, ids=[str(b) for b in BAD])
def test_validation_errors_match_jax(bad):
    want = _build(_jax_pkg(), bad)
    got = _build(PORT, bad)
    assert isinstance(want, Exception), "the reference accepts this setting"
    assert type(got) is type(want) and str(got) == str(want)


def test_backend_and_impl_validation():
    with pytest.raises(ValueError, match="unknown gemm_backend 'pallas_spoga'"):
        QuantRuntime(mode="int8_spoga", gemm_backend="pallas_spoga")
    QuantRuntime(mode="int8_deas", gemm_backend="cuda_deas")
    with pytest.raises(KeyError):
        tconfigs.get_config("llama3.2-1b").with_(gemm_backend="jnp_spoga")
    assert tconfigs.get_config("llama3.2-1b").with_(gemm_backend="cuda_spoga").gemm_backend \
        == "cuda_spoga"
    with pytest.raises(ValueError, match="paged_attn_impl"):
        KVConfig(paged_attn_impl="pallas")
    KVConfig(mode="paged", paged_attn_impl="gather")


def test_defaults_match_jax():
    """Same fields and defaults as the reference's sub-configs, the mesh's
    included."""
    from repro.api import MeshConfig as JaxMeshConfig
    from repro.api import SamplingDefaults as JaxSamplingDefaults
    from repro.api import SpecConfig as JaxSpecConfig
    pairs = [(QuantRuntime, JaxQuantRuntime), (KVConfig, JaxKVConfig),
             (SchedulerConfig, JaxSchedulerConfig), (SamplingDefaults, JaxSamplingDefaults),
             (SpecConfig, JaxSpecConfig), (MeshConfig, JaxMeshConfig)]
    for port_cls, jax_cls in pairs:
        assert dataclasses.asdict(port_cls()) == dataclasses.asdict(jax_cls()), port_cls
    port_fields = [f.name for f in dataclasses.fields(RuntimeConfig)]
    assert port_fields == [f.name for f in dataclasses.fields(JaxRuntimeConfig)]
    rc, jrc = RuntimeConfig(), JaxRuntimeConfig()
    for name in ("max_new_tokens", "eos_token", "reduced"):
        assert getattr(rc, name) == getattr(jrc, name)
    assert rc.mesh == MeshConfig() and not rc.mesh.enabled and rc.spec == SpecConfig()
    assert dataclasses.asdict(rc.obs) == dataclasses.asdict(jrc.obs)
    for n in (1, 8, 30, 64, 100):
        assert auto_buckets(n) == jax_auto_buckets(n)


def test_resolution_matches_jax():
    jbase = jax_reduced(jax_get_config("llama3.2-1b")).with_(remat=False)
    tbase = tconfigs.reduced(tconfigs.get_config("llama3.2-1b"))
    kw = dict(quant=("int8_deas", "cuda_deas", "pallas_deas"),
              kv=dict(mode="paged", dtype="int8", cache_len=48, page_size=8, n_pages=20),
              scheduler=dict(n_slots=3, prefill_buckets=(8, 16)), eos_token=5)
    rc = RuntimeConfig(quant=QuantRuntime(*kw["quant"][:2]), kv=KVConfig(**kw["kv"]),
                       scheduler=SchedulerConfig(**kw["scheduler"]), eos_token=5)
    jrc = JaxRuntimeConfig(quant=JaxQuantRuntime(kw["quant"][0], kw["quant"][2]),
                           kv=JaxKVConfig(**kw["kv"]),
                           scheduler=JaxSchedulerConfig(**kw["scheduler"]), eos_token=5)
    tcfg, tecfg = rc.resolve(tbase)
    jcfg, jecfg = jrc.resolve(jbase)
    for f in ("quant_mode", "kv_cache_dtype", "paged_attn_impl", "n_layers", "d_model"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tcfg.gemm_backend == "cuda_deas"
    for f in ("n_slots", "cache_len", "prefill_buckets", "eos_token", "cache_mode",
              "page_size", "n_pages", "prefill_chunk", "prefix_cache"):
        assert getattr(tecfg, f) == getattr(jecfg, f), f
    assert tecfg == EngineConfig(n_slots=3, cache_len=48, prefill_buckets=(8, 16),
                                 eos_token=5, cache_mode="paged", page_size=8, n_pages=20)
    # workload-derived sizing + auto buckets
    auto = RuntimeConfig(kv=KVConfig(**PAGED), scheduler=SchedulerConfig(prefill_buckets="auto"))
    jauto = JaxRuntimeConfig(kv=JaxKVConfig(**PAGED),
                             scheduler=JaxSchedulerConfig(prefill_buckets="auto"))
    got = auto.resolve_engine(tbase, prompt_len=32, gen_tokens=16)
    want = jauto.resolve_engine(jbase, prompt_len=32, gen_tokens=16)
    assert (got.cache_len, got.prefill_buckets) == (want.cache_len, want.prefill_buckets)
    with pytest.raises(ValueError, match="cannot size the KV cache"):
        auto.resolve_engine(tbase)


REFUSED = [
    dict(mesh=object()),
    dict(mesh=object(), obs=ObsConfig(enabled=True)),   # obs is served; a non-MeshConfig is not
]


@pytest.mark.parametrize("kw", REFUSED, ids=[str(sorted(k)) + str(i) for i, k in
                                            enumerate(REFUSED)])
def test_unserved_settings_raise_not_implemented(kw):
    """A ``mesh`` that is not a ``MeshConfig`` is refused where the runtime
    is used (the mesh itself is served since distribution was ported)."""
    kw = {"kv": KVConfig(**PAGED), **kw}
    rc = RuntimeConfig(**kw)          # constructs ...
    tbase = tconfigs.reduced(tconfigs.get_config("llama3.2-1b"))
    with pytest.raises(TypeError, match="must be a MeshConfig"):
        rc.resolve_engine(tbase, prompt_len=8, gen_tokens=4)
    with pytest.raises(TypeError, match="must be a MeshConfig"):
        LLM(arch="llama3.2-1b", runtime=dataclasses.replace(rc, reduced=True), device="cpu")


# settings refused until the scheduler policies, chunked prefill and defrag
# were ported
SERVED = [
    dict(scheduler=SchedulerConfig(prefill_chunk=8)),
    dict(scheduler=SchedulerConfig(batched_admission=True)),
    dict(scheduler=SchedulerConfig(max_prefills_per_step=2)),
    dict(scheduler=SchedulerConfig(admission="priority")),
    dict(scheduler=SchedulerConfig(admission="deadline")),
    dict(scheduler=SchedulerConfig(eviction="deadline-preempt")),
    dict(scheduler=SchedulerConfig(defrag_threshold=0.25)),
]


@pytest.mark.parametrize("kw", SERVED, ids=[str(k["scheduler"]) for k in SERVED])
def test_policy_settings_are_served(kw):
    """Each setting resolves to the reference's ``EngineConfig`` fields and
    an ``LLM`` serves it (paged KV, reduced model, CPU)."""
    rc = RuntimeConfig(kv=KVConfig(**PAGED), **kw)
    jrc = JaxRuntimeConfig(kv=JaxKVConfig(**PAGED), scheduler=JaxSchedulerConfig(
        **dataclasses.asdict(kw["scheduler"])))
    tbase = tconfigs.reduced(tconfigs.get_config("llama3.2-1b"))
    jbase = jax_reduced(jax_get_config("llama3.2-1b")).with_(remat=False)
    got = rc.resolve_engine(tbase, prompt_len=8, gen_tokens=4)
    want = jrc.resolve_engine(jbase, prompt_len=8, gen_tokens=4)
    for f in ("n_slots", "cache_len", "max_prefills_per_step", "prefill_buckets",
              "cache_mode", "page_size", "n_pages", "prefill_chunk"):
        assert getattr(got, f) == getattr(want, f), f
    llm = LLM(arch="llama3.2-1b", runtime=dataclasses.replace(rc, reduced=True), device="cpu")
    out, = llm.generate([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], max_new_tokens=3)
    assert len(out.token_ids) == 3


def test_served_settings_pass():
    for sched in (SchedulerConfig(), SchedulerConfig(defrag_threshold=None),
                  SchedulerConfig(prefill_buckets="auto", n_slots=2)):
        for kv in (KVConfig(**PAGED), KVConfig(), KVConfig(dtype="int8")):
            RuntimeConfig(kv=kv, scheduler=sched).check_served()
    RuntimeConfig().check_served()               # the default: slot mode


# ---------------------------------------------------------------------------
# LLM.generate against the JAX LLM, same weights
# ---------------------------------------------------------------------------

def _scaled_tree():
    jcfg = jax_reduced(jax_get_config("llama3.2-1b")).with_(remat=False)
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))

    def scale(path, a):
        if "'w" in jax.tree_util.keystr(path):
            return (a.astype(np.float32) * WEIGHT_SCALE).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(scale, tree)


def _pair(mode, kv_dtype, tree, **runtime_kw):
    kv = dict(mode="paged", dtype=kv_dtype, page_size=8)
    jllm = JaxLLM(arch="llama3.2-1b", params=jax.tree_util.tree_map(jax.numpy.asarray, tree),
                  runtime=JaxRuntimeConfig(reduced=True, quant=JaxQuantRuntime(mode=mode),
                                           kv=JaxKVConfig(**kv),
                                           scheduler=JaxSchedulerConfig(n_slots=2),
                                           **runtime_kw))
    rc = RuntimeConfig(reduced=True, quant=QuantRuntime(mode=mode), kv=KVConfig(**kv),
                       scheduler=SchedulerConfig(n_slots=2), **runtime_kw)
    tcfg = rc.resolve_model(tconfigs.reduced(tconfigs.get_config("llama3.2-1b")))
    tllm = LLM(arch="llama3.2-1b", runtime=rc, params=params_from_jax(tree, tcfg, "cpu"),
               device="cpu")
    return jllm, tllm


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("mode", ["int8_spoga", "int8_deas"])
def test_llm_generate_matches_jax_llm(mode, kv_dtype):
    """test_api.py::test_llm_generate_matches_solo's prompts and budget:
    three prompts over two lanes, 5 new tokens each."""
    jllm, tllm = _pair(mode, kv_dtype, _scaled_tree())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tllm.config.vocab_size, n).tolist() for n in (5, 13, 3)]
    want = jllm.generate(prompts, max_new_tokens=5)
    plain = dequant_mod.PLAIN_CALLS, deas_mod.PLAIN_CALLS
    got = tllm.generate(prompts, max_new_tokens=5)
    # CPU tensors run the plain twins of the registry, never a kernel wrapper
    assert (dequant_mod.PLAIN_CALLS, deas_mod.PLAIN_CALLS) == plain
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    assert len({t for o in got for t in o.token_ids}) > 2, "streams collapsed"
    for out, ref, prompt in zip(got, want, prompts):
        assert isinstance(out, RequestOutput)
        assert out.finish_reason == "length" and out.prompt_token_ids == prompt
        assert out.ttft_s > 0 and out.latency_s > 0
        # observability off: no timeline, so no queue wait (the reference's
        # contract: it is read off the timeline); the cost counts as the
        # reference's does
        assert out.timeline is None and out.deadline_hit is None and out.queue_wait_s is None
        assert ref.queue_wait_s is None
        for key in ("dispatches", "page_steps"):
            assert out.cost[key] == ref.cost[key], key
    assert [o.request_id for o in got] == [0, 1, 2]
    assert tllm.metrics.report()["requests"] == 3
    assert tllm.engine.engine_cfg.cache_len == jllm.engine.engine_cfg.cache_len


def test_llm_single_prompt_eos_and_stream_match_jax():
    tree = _scaled_tree()
    jllm, tllm = _pair("int8_spoga", "int8", tree)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, tllm.config.vocab_size, 6).tolist()
    out, = tllm.generate(prompt, max_new_tokens=4)      # flat list = one prompt
    ref, = jllm.generate(prompt, max_new_tokens=4)
    assert out.token_ids == ref.token_ids
    assert list(tllm.stream(prompt, max_new_tokens=4)) == ref.token_ids
    text = "".join(tllm.stream(prompt, max_new_tokens=4, detokenize=True))
    assert text == "".join(f"<{t}>" for t in ref.token_ids)
    out, = tllm.generate(prompt, max_new_tokens=4, detokenize=True)
    assert out.text == text
    # EOS on the stream's own second token -> early stop + "stop" reason
    jeos, teos = _pair("int8_spoga", "int8", tree, eos_token=ref.token_ids[1])
    got, = teos.generate(prompt, max_new_tokens=4)
    want, = jeos.generate(prompt, max_new_tokens=4)
    assert got.token_ids == want.token_ids == ref.token_ids[:2]
    assert got.finish_reason == want.finish_reason == "stop"


def test_llm_engine_grows_between_calls():
    """A larger workload rebuilds the engine with a longer cache; metrics
    carry over; the output equals a fresh LLM's."""
    tree = _scaled_tree()
    _, tllm = _pair("int8_deas", "int8", tree)
    rng = np.random.default_rng(2)
    short = rng.integers(0, 512, 4).tolist()
    long = rng.integers(0, 512, 20).tolist()
    tllm.generate(short, max_new_tokens=3)
    small = tllm.engine.engine_cfg.cache_len
    out, = tllm.generate(long, max_new_tokens=6)
    assert tllm.engine.engine_cfg.cache_len > small
    assert tllm.metrics.report()["requests"] == 2
    _, fresh = _pair("int8_deas", "int8", tree)
    assert fresh.generate(long, max_new_tokens=6)[0].token_ids == out.token_ids


def test_llm_refusals_and_device():
    rc = RuntimeConfig(reduced=True, kv=KVConfig(**PAGED))
    with pytest.raises(ValueError, match="exactly one"):
        LLM(runtime=rc, device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        LLM(arch="llama3.2-1b", runtime=rc, checkpoint_dir="no-such-dir", device="cpu")
    with pytest.raises(FileNotFoundError, match="not a flight-recorder bundle"):
        LLM.replay("bundle", device="cpu")
    default = LLM(arch="llama3.2-1b", runtime=RuntimeConfig(reduced=True), device="cpu")
    assert default.runtime.kv.mode == "slot"     # served since slot mode was ported
    llm = LLM(arch="llama3.2-1b", runtime=rc, device="cpu")
    assert llm.params["embed"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="engine not built"):
        llm.engine
    assert llm.metrics is None
    with pytest.raises(TypeError, match="must be a MeshConfig"):
        LLM(arch="llama3.2-1b", runtime=dataclasses.replace(rc, mesh=object()), device="cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        LLM(arch="llama3.2-1b", runtime=dataclasses.replace(rc, mesh=MeshConfig(tp=2)),
            device="cpu")
    out, = llm.generate([1, 2, 3], sampling=SamplingParams(greedy=False), max_new_tokens=2)
    assert len(out.token_ids) == 2               # stochastic sampling is served
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LLM(arch="llama3.2-1b", runtime=rc)


# ---------------------------------------------------------------------------
# Settings served since the prefix cache, speculation and sampling were ported
# ---------------------------------------------------------------------------

NEWLY_SERVED = [
    dict(kv=KVConfig(prefix_cache=True, **PAGED)),
    dict(kv=KVConfig(prefix_cache=True, **PAGED),
         scheduler=SchedulerConfig(admission="prefix-aware")),
    dict(sampling=SamplingDefaults(greedy=False, temperature=0.7, top_k=5, seed=3)),
    dict(spec=SpecConfig(enabled=True, k=3)),
    dict(spec=SpecConfig(enabled=True, k=2, drafter="model", draft_layers=1)),
]


@pytest.mark.parametrize("kw", NEWLY_SERVED, ids=["prefix_cache", "prefix-aware", "sampling",
                                                  "spec-ngram", "spec-model"])
def test_prefix_spec_and_sampling_settings_are_served(kw):
    """Each setting resolves to the reference's ``EngineConfig`` fields and
    policies, and an ``LLM`` serves it (paged KV, reduced model, CPU)."""
    from repro.api import SamplingDefaults as JaxSamplingDefaults
    from repro.api import SpecConfig as JaxSpecConfig
    kw = {"kv": KVConfig(**PAGED), **kw}
    rc = RuntimeConfig(**kw)
    jax_classes = {"kv": JaxKVConfig, "scheduler": JaxSchedulerConfig,
                   "sampling": JaxSamplingDefaults, "spec": JaxSpecConfig}
    jrc = JaxRuntimeConfig(**{k: jax_classes[k](**dataclasses.asdict(v)) for k, v in kw.items()})
    tbase = tconfigs.reduced(tconfigs.get_config("llama3.2-1b"))
    jbase = jax_reduced(jax_get_config("llama3.2-1b")).with_(remat=False)
    got = rc.resolve_engine(tbase, prompt_len=8, gen_tokens=4)
    want = jrc.resolve_engine(jbase, prompt_len=8, gen_tokens=4)
    for f in ("cache_len", "cache_mode", "page_size", "prefill_chunk", "prefix_cache"):
        assert getattr(got, f) == getattr(want, f), f
    assert (got.spec is None) == (want.spec is None)
    if got.spec is not None:
        assert dataclasses.asdict(got.spec) == dataclasses.asdict(want.spec)
    pol, jpol = rc.build_policies(), jrc.build_policies()
    for name in ("admission", "eviction", "defrag", "prefix"):
        assert type(getattr(pol, name)).__name__ == type(getattr(jpol, name)).__name__
    assert pol.prefix.min_pages == jpol.prefix.min_pages
    llm = LLM(arch="llama3.2-1b", runtime=dataclasses.replace(rc, reduced=True), device="cpu")
    out, = llm.generate([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], max_new_tokens=3)
    assert len(out.token_ids) == 3


# ---------------------------------------------------------------------------
# Serialization, presets and load_runtime
# ---------------------------------------------------------------------------

CUSTOM = RuntimeConfig(
    quant=QuantRuntime(mode="int8_deas", gemm_backend="cuda_deas"),
    kv=KVConfig(mode="paged", dtype="int8", cache_len=96, page_size=8, n_pages=40,
                prefix_cache=True, prefix_min_pages=2),
    scheduler=SchedulerConfig(n_slots=3, prefill_buckets=(16, 32), prefill_chunk=16,
                              admission="prefix-aware", defrag_threshold=None),
    sampling=SamplingDefaults(greedy=False, temperature=0.9, top_k=7, seed=4),
    spec=SpecConfig(enabled=True, k=3, drafter="model", draft_layers=3),
    max_new_tokens=9, eos_token=2, reduced=True)


@pytest.mark.parametrize("rc", [RuntimeConfig(), CUSTOM,
                                RuntimeConfig(scheduler=SchedulerConfig(prefill_buckets="auto"))],
                         ids=["default", "custom", "auto-buckets"])
def test_to_dict_from_dict_round_trip(rc):
    """``to_dict`` is plain JSON (tuples as lists; ``mesh`` and ``obs`` as
    the reference writes their disabled defaults) and ``from_dict`` inverts
    it."""
    import json
    d = rc.to_dict()
    assert json.loads(json.dumps(d)) == d
    back = RuntimeConfig.from_dict(json.loads(json.dumps(d)))
    assert back == rc
    assert isinstance(back.scheduler.prefill_buckets, (tuple, str, type(None)))
    assert d["mesh"] == {"tp": 1, "dp": 1, "enable": None, "axes": ["data", "model"]}
    assert d["obs"]["enabled"] is None and d["obs"]["trace"] is None


def test_partial_dicts_take_defaults():
    assert RuntimeConfig.from_dict({}) == RuntimeConfig()
    rc = RuntimeConfig.from_dict({"kv": {"mode": "paged"},
                                  "scheduler": {"prefill_buckets": [8, 16]},
                                  "spec": {"enabled": True}, "max_new_tokens": 4})
    assert rc.kv == KVConfig(mode="paged") and rc.scheduler.prefill_buckets == (8, 16)
    assert rc.spec == SpecConfig(enabled=True) and rc.max_new_tokens == 4
    jrc = JaxRuntimeConfig.from_dict(rc.to_dict())   # the port's dict loads in the reference
    assert jrc.to_dict() == rc.to_dict()


@pytest.mark.parametrize("sub,item", [
    ({"mesh": {"tp": 2}}, "10"), ({"mesh": {"enable": True}}, "10"),
    ({"obs": {"trace": "t.json"}}, "8"), ({"obs": {"enabled": True}}, "8"),
    ({"obs": {"watchdog": True}}, "8"), ({"obs": {"metrics_port": 0}}, "8"),
    ({"obs": {"profile_steps": 5}}, "8")])
def test_from_dict_refuses_mesh_and_obs_turned_on(sub, item):
    """A ``mesh`` or an ``obs`` turned on loads into its ``MeshConfig`` /
    ``ObsConfig`` (item 10, distribution, and item 8, observability, are
    ported), as the reference's ``from_dict`` loads them; unknown keys are
    refused."""
    from repro.api import MeshConfig as JaxMeshConfig
    if "mesh" in sub:
        got = RuntimeConfig.from_dict(sub)
        assert got.mesh == MeshConfig(**sub["mesh"]) and got.mesh.enabled
        want = JaxRuntimeConfig.from_dict(sub).mesh
        assert dataclasses.asdict(got.mesh) == dataclasses.asdict(want) == \
            dataclasses.asdict(JaxMeshConfig(**sub["mesh"]))
        assert got.to_dict()["mesh"] == JaxRuntimeConfig.from_dict(sub).to_dict()["mesh"]
    else:
        assert RuntimeConfig.from_dict(sub).obs == ObsConfig(**sub["obs"])
    assert RuntimeConfig.from_dict({"mesh": {"tp": 1, "enable": None},
                                    "obs": {"enabled": None, "trace": None}}) == RuntimeConfig()
    with pytest.raises(TypeError, match="unexpected keyword argument 'no_such_knob'"):
        RuntimeConfig.from_dict({"mesh": {"no_such_knob": 1}})
    with pytest.raises(TypeError):
        RuntimeConfig.from_dict({"obs": {"no_such_knob": 1}})


@pytest.mark.parametrize("name", sorted(jax_list_presets()))
def test_presets_match_jax(name):
    """The same five presets: the port's ``to_dict`` is the reference's, the
    reference's ``to_dict`` loads into the port, and both resolve to the
    same model and engine fields."""
    assert list_presets() == jax_list_presets()
    rc, jrc = get_preset(name), jax_get_preset(name)
    assert rc.to_dict() == jrc.to_dict()
    assert RuntimeConfig.from_dict(jrc.to_dict()) == rc
    tbase = tconfigs.reduced(tconfigs.get_config("llama3.2-1b"))
    jbase = jax_reduced(jax_get_config("llama3.2-1b")).with_(remat=False)
    (tcfg, tecfg), (jcfg, jecfg) = rc.resolve(tbase, 40, 8), jrc.resolve(jbase, 40, 8)
    for f in ("quant_mode", "kv_cache_dtype", "paged_attn_impl", "gemm_backend"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    for f in ("n_slots", "cache_len", "max_prefills_per_step", "prefill_buckets", "eos_token",
              "cache_mode", "page_size", "n_pages", "prefill_chunk", "prefix_cache", "spec"):
        assert getattr(tecfg, f) == getattr(jecfg, f), f


@pytest.mark.parametrize("name", sorted(jax_list_presets()))
def test_every_preset_builds_and_serves_on_cpu(name):
    llm = LLM(arch="llama3.2-1b", runtime=dataclasses.replace(load_runtime(name), reduced=True),
              device="cpu")
    llm.build_engine(24, 4)
    outs = llm.generate([[5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21],
                         [1, 2, 3]], max_new_tokens=4)
    assert [len(o.token_ids) for o in outs] == [4, 4]
    assert llm.engine.prefix is not None if llm.runtime.kv.prefix_cache \
        else llm.engine.prefix is None


def test_load_runtime_from_file_and_name(tmp_path):
    import json
    path = tmp_path / "rt.json"
    path.write_text(json.dumps(get_preset("int8-byte-serving").to_dict()))
    assert load_runtime(str(path)) == get_preset("int8-byte-serving")
    assert load_runtime("paged-server") is get_preset("paged-server")
    with pytest.raises(ValueError, match="neither a JSON file nor a registered preset"):
        load_runtime("no-such-preset")
    with pytest.raises(KeyError, match="unknown runtime preset"):
        get_preset("no-such-preset")


def test_register_preset_guard():
    with pytest.raises(TypeError, match="must be a RuntimeConfig"):
        register_preset("bad", {"kv": {}})
    with pytest.raises(ValueError, match="already registered"):
        register_preset("paged-server", RuntimeConfig())
    register_preset("torch-test-preset", CUSTOM)
    try:
        assert get_preset("torch-test-preset") is CUSTOM
        register_preset("torch-test-preset", RuntimeConfig(), overwrite=True)
        assert get_preset("torch-test-preset") == RuntimeConfig()
    finally:
        from repro_torch.api import config as config_mod
        config_mod._PRESETS.pop("torch-test-preset")
