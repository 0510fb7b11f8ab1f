"""Chunked prefill of the port against the JAX package.

``models/attention.attention_chunk``, ``paging/prefill.make_chunk_step``
and the engine's chunked admissions are held against the reference
modules at the same relative paths, on the same weights: the JAX
``init_params`` tree of the reduced llama3.2-1b (4 KV heads) with its
projection weights scaled by 8 (so that greedy decoding does not collapse
onto one repeated token), carried across with ``params_from_jax``.  Every
comparison is bitwise.  Each test names the reference test whose contract
it carries over.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch.serve import serve_batch as jax_serve_batch
from repro.models import init_params as jax_init_params
from repro.models.attention import attention_chunk as jax_attention_chunk
from repro.paging import PagedCache as JaxPagedCache
from repro.paging import make_chunk_step as jax_make_chunk_step
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch import configs as tconfigs
from repro_torch.api import serve_batch
from repro_torch.kernels import paged_attention as attn_mod
from repro_torch.kernels import spoga_gemm_dequant as gemm_mod
from repro_torch.models import params_from_jax
from repro_torch.models.attention import attention_chunk
from repro_torch.models.transformer import period_params
from repro_torch.paging import PagedCache, chunkable, chunkable_with_state, make_chunk_step
from repro_torch.serving import EngineConfig, ServingEngine

WEIGHT_SCALE = 8.0
CHUNKED = dict(n_slots=2, cache_len=32, cache_mode="paged", page_size=8, prefill_chunk=8)


def _configs(quant_mode="bf16", kv_dtype="bf16"):
    kw = dict(quant_mode=quant_mode, kv_cache_dtype=kv_dtype, n_kv_heads=4)
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


def _to_port(a):
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _streams(metrics):
    return {r.req_id: r.output_tokens for r in metrics.finished}


def _chunk_arrivals(vocab):
    """test_serving.py::test_engine_chunked_prefill_matches_solo's traffic:
    prompts spanning several 8-token chunks, staggered."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, n).tolist() for n in (13, 21, 3, 17)]
    gens = [5, 4, 6, 5]
    return [(0, prompts[0], gens[0]), (0, prompts[1], gens[1]),
            (2, prompts[2], gens[2]), (4, prompts[3], gens[3])]


# ---------------------------------------------------------------------------
# models/attention.py: attention_chunk
# ---------------------------------------------------------------------------

def _random_pool(rng, cfg, n_pages, page_size):
    shp = (n_pages, page_size, cfg.n_kv_heads, cfg.resolved_head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {"kp": rng.integers(-127, 128, shp).astype(np.int8),
                "vp": rng.integers(-127, 128, shp).astype(np.int8),
                "kp_scale": (rng.random(shp[:3]) * 0.05 + 1e-3).astype(np.float32),
                "vp_scale": (rng.random(shp[:3]) * 0.05 + 1e-3).astype(np.float32)}
    return {"kp": rng.normal(size=shp).astype(jnp.bfloat16),
            "vp": rng.normal(size=shp).astype(jnp.bfloat16)}


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("quant_mode", ["bf16", "int8_spoga"])
def test_attention_chunk_matches_jax(quant_mode, kv_dtype):
    """One 8-row chunk at offset 12 (mid-page) of a lane whose table holds
    pages 5, 2, 7, 1, over a random pool: the output and the written pool
    against the reference's jitted ``attention_chunk``, bitwise."""
    jcfg, tcfg = _configs(quant_mode, kv_dtype)
    tree = _scaled_tree(jcfg)
    rng = np.random.default_rng(3)
    pool = _random_pool(rng, tcfg, 9, 8)
    table = np.asarray([[5, 2, 7, 1]], np.int32)
    start, cs = 12, 8
    x = (rng.normal(size=(1, cs, jcfg.d_model)) * 0.5).astype(jnp.bfloat16)
    positions = (start + np.arange(cs, dtype=np.int32))[None]
    jout, jpool = jax.jit(lambda xx, p, c, t, s, pos: jax_attention_chunk(
        xx, p, jcfg, c, t, s, positions=pos))(
        jnp.asarray(x), jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                                               tree["blocks"][0]["attn"]),
        jax.tree_util.tree_map(jnp.asarray, pool), jnp.asarray(table),
        jnp.asarray([start], jnp.int32), jnp.asarray(positions))
    tpool = {k: _to_port(v) for k, v in pool.items()}
    tattn = period_params(params_from_jax(tree, tcfg, "cpu")["blocks"][0]["attn"], 0)
    tout, tnew = attention_chunk(_to_port(x), tattn, tcfg, tpool, torch.from_numpy(table),
                                 start, positions=torch.from_numpy(positions))
    assert tnew is tpool                         # written in place
    for name, leaf in tpool.items():
        np.testing.assert_array_equal(_np(leaf), _jnp(jpool[name]), err_msg=name)
    assert not np.array_equal(_np(tpool["kp"]), _jnp(pool["kp"]))
    np.testing.assert_array_equal(_np(tout), _jnp(jout))


# ---------------------------------------------------------------------------
# paging/prefill.py: make_chunk_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_chunk_step_matches_jax(kv_dtype):
    """A 21-token prompt fed in three 8-token chunks into lane 1 of a
    2-lane pool (the lane's pages allocated out of order by an earlier
    lane-0 admission) at ``int8_spoga``: each chunk's last-valid-row
    logits and, after the last chunk, every pool leaf, ``pos`` and the
    block tables against the reference's chunk step, bitwise."""
    jcfg, tcfg = _configs("int8_spoga", kv_dtype)
    tree = _scaled_tree(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = params_from_jax(tree, tcfg, "cpu")
    jstore = JaxPagedCache(jcfg, 2, 32, 8)
    tstore = PagedCache(tcfg, 2, 32, 8, device="cpu")
    for store in (jstore, tstore):
        store.manager.admit(0, 8)
        store.manager.alloc(0, 1)
        store.manager.admit(1, 24)
        store.manager.ensure(1, 24)
        store.manager.dirty = True
        store.sync_tables()
    jstep = jax.jit(jax_make_chunk_step(jcfg, 8))
    tstep = make_chunk_step(tcfg, 8)
    prompt = np.random.default_rng(5).integers(0, jcfg.vocab_size, 21).astype(np.int32)
    for start in (0, 8, 16):
        n = min(8, 21 - start)
        tokens = np.zeros((1, 8), np.int32)
        tokens[0, :n] = prompt[start:start + n]
        jlogits, jstore.cache = jstep(jparams, jstore.cache, jnp.asarray(tokens),
                                      jnp.int32(1), jnp.asarray([start], jnp.int32),
                                      jnp.asarray([n], jnp.int32))
        tlogits = tstep(tparams, tstore.cache, torch.from_numpy(tokens), 1, start, n)
        np.testing.assert_array_equal(_np(tlogits), _jnp(jlogits), err_msg=str(start))
    assert tstore.cache["pos"].tolist() == np.asarray(jstore.cache["pos"]).tolist() == [0, 21]
    np.testing.assert_array_equal(_np(tstore.cache["block_tables"]),
                                  np.asarray(jstore.cache["block_tables"]))
    for name, leaf in tstore.cache["blocks"][0].items():
        np.testing.assert_array_equal(_np(leaf), _jnp(jstore.cache["blocks"][0][name]),
                                      err_msg=name)


def test_chunked_prefill_gate_tiers():
    """test_serving.py::test_chunked_prefill_gate_tiers, its ``"attn"`` part:
    llama is chunkable in both tiers, and a slot engine refuses chunking."""
    _, tcfg = _configs()
    assert chunkable(tcfg) and chunkable_with_state(tcfg)
    tparams = params_from_jax(_scaled_tree(_configs()[0]), tcfg, "cpu")
    with pytest.raises(ValueError, match="chunked prefill requires cache_mode='paged'"):
        ServingEngine(tcfg, tparams, EngineConfig(**{**CHUNKED, "cache_mode": "slot"}),
                      device="cpu")
    with pytest.raises(ValueError, match="multiple of page_size"):
        ServingEngine(tcfg, tparams, EngineConfig(**{**CHUNKED, "prefill_chunk": 12}),
                      device="cpu")


# ---------------------------------------------------------------------------
# serving/engine.py: chunked admissions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant_mode", ["bf16", "int8_spoga"])
def test_engine_chunked_prefill_matches_solo(quant_mode):
    """test_serving.py::test_engine_chunked_prefill_matches_solo (llama):
    prompts of 13, 21 and 17 tokens admit in 8-token chunks interleaved
    with running decodes.  The streams equal the JAX chunked engine's and
    each equals the port's solo ``serve_batch``; no kernel wrapper runs on
    CPU tensors."""
    jcfg, tcfg = _configs(quant_mode)
    tree = _scaled_tree(jcfg)
    arrivals = _chunk_arrivals(jcfg.vocab_size)
    jeng = JaxServingEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                            JaxEngineConfig(**CHUNKED))
    jmetrics = jeng.run(arrivals)
    tparams = params_from_jax(tree, tcfg, "cpu")
    teng = ServingEngine(tcfg, tparams, EngineConfig(**CHUNKED), device="cpu")
    launches = gemm_mod.LAUNCHES, attn_mod.LAUNCHES
    metrics = teng.run(arrivals)
    assert (gemm_mod.LAUNCHES, attn_mod.LAUNCHES) == launches
    got = _streams(metrics)
    assert got == _streams(jmetrics)
    assert len({t for s in got.values() for t in s}) > 2, "streams collapsed"
    assert metrics.chunk_steps == jmetrics.chunk_steps == 2 + 3 + 3
    assert metrics.prefill_dispatches == jmetrics.prefill_dispatches
    for rid, (_, prompt, gen) in enumerate(arrivals):
        solo, _ = serve_batch(tcfg, tparams, torch.tensor([prompt], dtype=torch.int32),
                              cache_len=CHUNKED["cache_len"], gen_tokens=gen)
        assert got[rid] == solo[0].tolist(), rid
    assert teng.store.manager.pages_in_use == 0
    assert not teng.store.manager.invariant_violations()


def test_engine_chunked_int8_pool_matches_jax():
    """On int8 pools the chunks attend dequantized pages, as the
    reference's do: the port's chunked streams equal the JAX chunked
    engine's (``int8_spoga``, int8 paged KV)."""
    jcfg, tcfg = _configs("int8_spoga", "int8")
    tree = _scaled_tree(jcfg)
    arrivals = _chunk_arrivals(jcfg.vocab_size)
    want = _streams(JaxServingEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                                     JaxEngineConfig(**CHUNKED)).run(arrivals))
    teng = ServingEngine(tcfg, params_from_jax(tree, tcfg, "cpu"), EngineConfig(**CHUNKED),
                         device="cpu")
    got = _streams(teng.run(arrivals))
    assert got == want
    assert len({t for s in got.values() for t in s}) > 2, "streams collapsed"
    assert teng.metrics.chunk_steps == 8


def test_engine_paged_admissions_serialize_on_capacity():
    """test_serving.py::test_engine_paged_admissions_serialize_on_capacity:
    two requests that each fit the pool but not together admit one after
    the other, even with two admissions allowed a step."""
    jcfg, tcfg = _configs()
    tree = _scaled_tree(jcfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, 16).tolist() for _ in range(2)]
    ecfg = dict(n_slots=2, cache_len=32, cache_mode="paged", page_size=8, n_pages=6,
                max_prefills_per_step=2)
    engine = ServingEngine(tcfg, params_from_jax(tree, tcfg, "cpu"), EngineConfig(**ecfg),
                           device="cpu")
    metrics = engine.run([(0, prompts[0], 8), (0, prompts[1], 8)])
    jmetrics = JaxServingEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                                JaxEngineConfig(**ecfg)).run([(0, prompts[0], 8),
                                                              (0, prompts[1], 8)])
    assert len(metrics.finished) == 2
    assert metrics.peak_running == jmetrics.peak_running == 1   # 3 + 3 pages > 5
    assert engine.store.manager.pages_in_use == 0
    assert _streams(metrics) == _streams(jmetrics)
