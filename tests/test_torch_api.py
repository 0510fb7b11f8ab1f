"""The port's ``api`` facade against the JAX package's.

``RuntimeConfig`` validates as the reference does (same errors, same
messages for the fields both packages serve) and resolves to the same
model and engine settings; each setting the port's engine does not serve
yet raises ``NotImplementedError`` naming its ROADMAP item.  ``LLM``
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
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro_torch import configs as tconfigs
from repro_torch.api import (
    LLM,
    KVConfig,
    QuantRuntime,
    RequestOutput,
    RuntimeConfig,
    SamplingDefaults,
    SchedulerConfig,
    auto_buckets,
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
    """Same fields and defaults as the reference's sub-configs (the mesh,
    spec and obs sub-configs are not ported: None is their disabled
    default)."""
    from repro.api import SamplingDefaults as JaxSamplingDefaults
    pairs = [(QuantRuntime, JaxQuantRuntime), (KVConfig, JaxKVConfig),
             (SchedulerConfig, JaxSchedulerConfig), (SamplingDefaults, JaxSamplingDefaults)]
    for port_cls, jax_cls in pairs:
        assert dataclasses.asdict(port_cls()) == dataclasses.asdict(jax_cls()), port_cls
    port_fields = [f.name for f in dataclasses.fields(RuntimeConfig)]
    assert port_fields == [f.name for f in dataclasses.fields(JaxRuntimeConfig)]
    rc, jrc = RuntimeConfig(), JaxRuntimeConfig()
    for name in ("max_new_tokens", "eos_token", "reduced"):
        assert getattr(rc, name) == getattr(jrc, name)
    assert (rc.mesh, rc.spec, rc.obs) == (None, None, None)
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
    dict(kv=KVConfig(prefix_cache=True, **PAGED)),
    dict(scheduler=SchedulerConfig(admission="prefix-aware")),
    dict(sampling=SamplingDefaults(greedy=False, temperature=0.7)),
    dict(mesh=object()),
    dict(spec=object()),
    dict(obs=object()),
]


@pytest.mark.parametrize("kw", REFUSED, ids=[str(sorted(k)) + str(i) for i, k in
                                            enumerate(REFUSED)])
def test_unserved_settings_raise_not_implemented(kw):
    kw = {"kv": KVConfig(**PAGED), **kw}
    rc = RuntimeConfig(**kw)          # a valid configuration ...
    tbase = tconfigs.reduced(tconfigs.get_config("llama3.2-1b"))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item"):
        rc.resolve_engine(tbase, prompt_len=8, gen_tokens=4)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item"):
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
        # no timeline before the observability stack; the queue wait comes
        # from the request, the cost counts as the reference's does
        assert out.timeline is None and out.deadline_hit is None and out.queue_wait_s >= 0
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LLM.replay("bundle")
    default = LLM(arch="llama3.2-1b", runtime=RuntimeConfig(reduced=True), device="cpu")
    assert default.runtime.kv.mode == "slot"     # served since slot mode was ported
    llm = LLM(arch="llama3.2-1b", runtime=rc, device="cpu")
    assert llm.params["embed"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="engine not built"):
        llm.engine
    assert llm.metrics is None
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        llm.generate([1, 2, 3], sampling=SamplingParams(greedy=False))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LLM(arch="llama3.2-1b", runtime=rc)
