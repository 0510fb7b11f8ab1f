"""Slot-mode serving of the port against the JAX package.

The port's slot path (``attention.attention_decode``, ``serving/slots.py``,
the engine's ``cache_mode="slot"``, ``api.serve_batch`` and ``LLM`` with
its default runtime) is held against the reference module at the same
relative path, on the same weights: the JAX ``init_params`` tree with its
projection weights scaled by 8 (so that greedy decoding does not collapse
onto one repeated token), carried across with ``params_from_jax``.  Each
test names the reference test whose contract it carries over.

Tolerances: with 4 KV heads everything is bitwise equal.  With 2 KV heads
the logits and the attention output carry ROADMAP queue 3's residue (f32
sums taken in another order by XLA's CPU code and by PyTorch's, one bf16
ulp now and then): within RESIDUE_TOL of the output's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import LLM as JaxLLM
from repro.api import KVConfig as JaxKVConfig
from repro.api import QuantRuntime as JaxQuantRuntime
from repro.api import RuntimeConfig as JaxRuntimeConfig
from repro.api import SchedulerConfig as JaxSchedulerConfig
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models.attention import attention_decode as jax_attention_decode
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import SlotCache as JaxSlotCache
from repro_torch import configs as tconfigs
from repro_torch.api import LLM, KVConfig, QuantRuntime, RuntimeConfig, SchedulerConfig
from repro_torch.api import serve_batch
from repro_torch.kernels import deas_gemm as deas_mod
from repro_torch.kernels import paged_attention as attn_mod
from repro_torch.kernels import spoga_gemm_dequant as gemm_mod
from repro_torch.models import params_from_jax, prefill
from repro_torch.models.attention import attention_decode
from repro_torch.models.transformer import period_params
from repro_torch.serving import EngineConfig, RequestState, ServingEngine, SlotCache
from repro_torch.serving.slots import batch_axes

WEIGHT_SCALE = 8.0
# the 2-KV-head residue (ROADMAP queue 3), relative to the largest magnitude
RESIDUE_TOL = 2e-2
SLOT = dict(n_slots=2, cache_len=32, prefill_buckets=(8, 16), cache_mode="slot")


def _configs(quant_mode="bf16", kv_dtype="bf16", n_kv_heads=4):
    kw = dict(quant_mode=quant_mode, kv_cache_dtype=kv_dtype, n_kv_heads=n_kv_heads)
    jcfg = jax_reduced(jax_get_config("llama3.2-1b")).with_(remat=False, **kw)
    tcfg = tconfigs.reduced(tconfigs.get_config("llama3.2-1b")).with_(**kw)
    return jcfg, tcfg


def _scaled_tree(jcfg, seed=0):
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(seed)))

    def scale(path, a):
        if "'w" in jax.tree_util.keystr(path):
            return (a.astype(np.float32) * WEIGHT_SCALE).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(scale, tree)


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _arrivals(vocab):
    """test_serving.py::test_engine_matches_solo_staggered's arrivals:
    unequal prompts, staggered, more requests than lanes."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, n).tolist() for n in (5, 9, 3, 7)]
    gens = [6, 4, 8, 5]
    return [(0, prompts[0], gens[0]), (0, prompts[1], gens[1]),
            (2, prompts[2], gens[2]), (4, prompts[3], gens[3])]


def _streams(metrics):
    return {r.req_id: r.output_tokens for r in metrics.finished}


# ---------------------------------------------------------------------------
# models/attention.py: attention_decode
# ---------------------------------------------------------------------------

def _random_slot_layer(rng, cfg, lanes, cache_len):
    """One layer's slot cache, random, as numpy: bf16 K/V, or int8
    payloads with f32 scales."""
    shp = (lanes, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {"k": rng.integers(-127, 128, shp).astype(np.int8),
                "v": rng.integers(-127, 128, shp).astype(np.int8),
                "k_scale": (rng.random(shp[:3]) * 0.05 + 1e-3).astype(np.float32),
                "v_scale": (rng.random(shp[:3]) * 0.05 + 1e-3).astype(np.float32)}
    return {"k": rng.normal(size=shp).astype(jnp.bfloat16),
            "v": rng.normal(size=shp).astype(jnp.bfloat16)}


def _to_port(a):
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("n_kv_heads", [4, 2])
def test_attention_decode_matches_jax(n_kv_heads, kv_dtype):
    """One decode token over a random slot cache (lanes at positions 5, 15
    and 0, the second on the last row) at ``int8_spoga``: the output and
    the written cache against the reference's jitted ``attention_decode``.
    The cache bitwise; the output bitwise at 4 KV heads and within
    RESIDUE_TOL of its scale at 2."""
    jcfg, tcfg = _configs("int8_spoga", kv_dtype, n_kv_heads)
    tree = _scaled_tree(jcfg)
    rng = np.random.default_rng(n_kv_heads)
    layer = _random_slot_layer(rng, tcfg, 3, 16)
    x = (rng.normal(size=(3, 1, jcfg.d_model)) * 0.5).astype(jnp.bfloat16)
    pos = np.asarray([5, 15, 0], np.int32)
    jout, jnew = jax.jit(lambda *a: jax_attention_decode(*a[:2], jcfg, *a[2:]))(
        jnp.asarray(x), jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                                               tree["blocks"][0]["attn"]),
        jax.tree_util.tree_map(jnp.asarray, layer), jnp.asarray(pos))
    tlayer = {k: _to_port(v) for k, v in layer.items()}
    tattn = period_params(params_from_jax(tree, tcfg, "cpu")["blocks"][0]["attn"], 0)
    tout, tnew = attention_decode(_to_port(x), tattn, tcfg, tlayer, torch.from_numpy(pos))
    assert tnew is tlayer                       # written in place
    for name, leaf in tnew.items():
        np.testing.assert_array_equal(_np(leaf), _jnp(jnew[name]), err_msg=name)
    assert not np.array_equal(_np(tnew["k"]), _jnp(layer["k"]))
    want, got = _jnp(jout), _np(tout)
    if n_kv_heads == 4:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=RESIDUE_TOL * np.abs(want).max())
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 7"):
        attention_decode(_to_port(x), tattn, tcfg, tlayer, torch.from_numpy(pos), window=8)


# ---------------------------------------------------------------------------
# serving/slots.py
# ---------------------------------------------------------------------------

def test_slot_cache_insert_free_roundtrip():
    """test_serving.py::test_slot_cache_insert_free_roundtrip, in both
    packages on the same weights (``int8_spoga``, whose projections are
    exact): the pools agree leaf by leaf."""
    jcfg, tcfg = _configs("int8_spoga")
    tree = _scaled_tree(jcfg)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (1, 6)).astype(np.int32)
    _, jsingle = jax_prefill(jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
                             {"tokens": jnp.asarray(tokens)}, cache_len=16)
    _, single = prefill(params_from_jax(tree, tcfg, "cpu"), tcfg, torch.from_numpy(tokens),
                        cache_len=16)
    jpool = JaxSlotCache(jcfg, n_slots=3, cache_len=16)
    pool = SlotCache(tcfg, n_slots=3, cache_len=16, device="cpu")
    assert batch_axes(pool.cache)["blocks"][0]["k"] == 1
    assert batch_axes(pool.cache)["pos"] == 0
    jpool.insert(jsingle, 1)
    pool.insert(single, 1)
    assert pool.pos.tolist() == [0, 6, 0] == jpool.pos.tolist()
    k_pool = _np(pool.cache["blocks"][0]["k"][:, 1])
    np.testing.assert_array_equal(k_pool, _np(single["blocks"][0]["k"][:, 0]))
    np.testing.assert_array_equal(k_pool, _jnp(jpool.cache["blocks"][0]["k"][:, 1]))
    assert not pool.cache["blocks"][0]["k"][:, 0].any()
    pool.free(1)
    jpool.free(1)
    assert pool.pos.tolist() == [0, 0, 0] == jpool.pos.tolist()


def test_free_lane_pos_stays_pinned():
    """test_serving.py::test_free_lane_pos_stays_pinned: a freed lane's pos
    stays 0 while the other lane decodes, and its idle writes stay in its
    own lane at row 0 (rows 1.. keep what its request left)."""
    jcfg, tcfg = _configs()
    tparams = params_from_jax(_scaled_tree(jcfg), tcfg, "cpu")
    rng = np.random.default_rng(0)
    long = rng.integers(0, tcfg.vocab_size, 4).tolist()
    short = rng.integers(0, tcfg.vocab_size, 4).tolist()
    engine = ServingEngine(tcfg, tparams, EngineConfig(**SLOT), device="cpu")
    engine.add_request(long, 12)                 # lane 0
    first = engine.add_request(short, 2)         # lane 1, evicted early
    k = engine.store.cache["blocks"][0]["k"]
    kept, idle_steps = None, 0
    while engine.has_work:
        engine.step()
        if first.state is RequestState.FINISHED and engine.scheduler.running:
            if kept is None:
                kept = k[:, 1, 1:].clone()
            idle_steps += 1
            assert engine.store.pos.tolist()[1] == 0
    assert idle_steps > 5
    assert torch.equal(k[:, 1, 1:], kept)
    assert engine.store.pos.tolist() == [0, 0]
    assert len(engine.metrics.finished) == 2


# ---------------------------------------------------------------------------
# serving/engine.py slot mode against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("quant_mode", ["int8_spoga", "int8_deas"])
def test_slot_engine_matches_jax_engine(quant_mode, kv_dtype):
    """test_torch_engine.py's pattern in slot mode: the port's greedy
    streams equal the JAX engine's, and no kernel wrapper runs on CPU
    tensors."""
    jcfg, tcfg = _configs(quant_mode, kv_dtype)
    tree = _scaled_tree(jcfg)
    arrivals = _arrivals(jcfg.vocab_size)
    jeng = JaxServingEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                            JaxEngineConfig(**SLOT))
    want = _streams(jeng.run(arrivals))
    teng = ServingEngine(tcfg, params_from_jax(tree, tcfg, "cpu"), EngineConfig(**SLOT),
                         device="cpu")
    launches = (gemm_mod.LAUNCHES, attn_mod.LAUNCHES, deas_mod.NIBBLE_LAUNCHES,
                attn_mod.PLAIN_CALLS)
    got = _streams(teng.run(arrivals))
    assert (gemm_mod.LAUNCHES, attn_mod.LAUNCHES, deas_mod.NIBBLE_LAUNCHES,
            attn_mod.PLAIN_CALLS) == launches
    assert got == want
    assert len({t for s in got.values() for t in s}) > 2, "streams collapsed"
    rep = teng.metrics.report()
    assert rep["requests"] == 4 and rep["peak_running"] == 2
    assert teng.store.pos.tolist() == [0, 0]


# ---------------------------------------------------------------------------
# inside the port: slot == paged, engine == solo serve_batch
# ---------------------------------------------------------------------------

def test_engine_paged_int8_matches_slot_int8():
    """test_serving.py::test_engine_paged_int8_matches_slot_int8: int8 pages
    quantize exactly like the int8 slot cache, so the two modes' greedy
    streams are identical."""
    jcfg, tcfg = _configs("int8_spoga", "int8")
    tparams = params_from_jax(_scaled_tree(jcfg), tcfg, "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, n).tolist() for n in (6, 11, 4)]
    outs = {}
    for mode in ("slot", "paged"):
        engine = ServingEngine(tcfg, tparams, EngineConfig(**{**SLOT, "cache_mode": mode,
                                                              "page_size": 8}),
                               device="cpu")
        outs[mode] = _streams(engine.run([(0, prompts[0], 5), (1, prompts[1], 5),
                                          (2, prompts[2], 5)]))
    assert outs["paged"] == outs["slot"]
    assert len({t for s in outs["slot"].values() for t in s}) > 2


@pytest.mark.parametrize("kv", [KVConfig(), KVConfig(dtype="int8"),
                                KVConfig(mode="paged", dtype="int8", page_size=8)],
                         ids=["slot-bf16", "slot-int8", "paged-int8"])
def test_llm_generate_matches_solo(kv):
    """test_api.py::test_llm_generate_matches_solo: ``LLM.generate``'s greedy
    tokens are bitwise the solo ``serve_batch`` stream."""
    jcfg, tcfg = _configs()
    llm = LLM(arch="llama3.2-1b", params=params_from_jax(_scaled_tree(jcfg), tcfg, "cpu"),
              runtime=RuntimeConfig(reduced=True, quant=QuantRuntime(mode="int8_spoga"),
                                    kv=kv, scheduler=SchedulerConfig(n_slots=2)),
              device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, llm.config.vocab_size, n).tolist() for n in (5, 13, 3)]
    outs = llm.generate(prompts, max_new_tokens=5)
    assert [o.request_id for o in outs] == [0, 1, 2]
    cache_len = llm.engine.engine_cfg.cache_len
    for out, prompt in zip(outs, prompts):
        solo, times = serve_batch(llm.config, llm.params,
                                  torch.tensor([prompt], dtype=torch.int32),
                                  cache_len=cache_len, gen_tokens=5)
        assert solo.shape == (1, 5) and solo.dtype == torch.int32
        assert out.token_ids == solo[0].tolist()
        assert out.finish_reason == "length" and times["decode_s"] >= 0


def test_llm_default_runtime_matches_jax_llm():
    """``LLM("llama3.2-1b")`` with the default runtime (bf16 GEMMs, slot
    bf16 KV), reduced, on the same weights as the reference ``LLM``: the
    same greedy streams, and an EOS stop as the reference stops."""
    jcfg, tcfg = _configs()
    tree = _scaled_tree(jcfg)
    jllm = JaxLLM("llama3.2-1b", runtime=JaxRuntimeConfig(reduced=True),
                  params=jax.tree_util.tree_map(jnp.asarray, tree))
    llm = LLM("llama3.2-1b", runtime=RuntimeConfig(reduced=True),
              params=params_from_jax(tree, tcfg, "cpu"), device="cpu")
    assert llm.runtime.kv.mode == "slot" and llm.config.quant_mode == "bf16"
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tcfg.vocab_size, n).tolist() for n in (6, 3, 10)]
    got = llm.generate(prompts, max_new_tokens=4)
    want = jllm.generate(prompts, max_new_tokens=4)
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    assert len({t for o in got for t in o.token_ids}) > 2
    assert llm.engine.engine_cfg.cache_mode == "slot"
    assert llm.engine.engine_cfg.cache_len == jllm.engine.engine_cfg.cache_len
    eos = want[0].token_ids[1]
    jeos = JaxLLM("llama3.2-1b", runtime=JaxRuntimeConfig(reduced=True, eos_token=eos),
                  params=jax.tree_util.tree_map(jnp.asarray, tree))
    teos = LLM("llama3.2-1b", runtime=RuntimeConfig(reduced=True, eos_token=eos),
               params=params_from_jax(tree, tcfg, "cpu"), device="cpu")
    g, = teos.generate(prompts[0], max_new_tokens=4)
    w, = jeos.generate(prompts[0], max_new_tokens=4)
    assert g.token_ids == w.token_ids and g.finish_reason == w.finish_reason == "stop"


def test_slot_runtime_resolves_like_jax():
    """The default ``KVConfig`` resolves to a slot ``EngineConfig`` with the
    reference's fields."""
    jbase = jax_reduced(jax_get_config("llama3.2-1b")).with_(remat=False)
    tbase = tconfigs.reduced(tconfigs.get_config("llama3.2-1b"))
    kw = dict(dtype="int8", cache_len=40)
    got = RuntimeConfig(quant=QuantRuntime(mode="int8_deas"), kv=KVConfig(**kw),
                        scheduler=SchedulerConfig(n_slots=3)).resolve_engine(tbase)
    want = JaxRuntimeConfig(quant=JaxQuantRuntime(mode="int8_deas"), kv=JaxKVConfig(**kw),
                            scheduler=JaxSchedulerConfig(n_slots=3)).resolve_engine(jbase)
    for f in ("n_slots", "cache_len", "prefill_buckets", "eos_token", "cache_mode",
              "page_size", "n_pages"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.cache_mode == "slot" == EngineConfig().cache_mode
    with pytest.raises(ValueError, match="cache_mode"):
        ServingEngine(tbase, {"embed": torch.zeros(1)},
                      EngineConfig(cache_mode="virtual"), device="cpu")
