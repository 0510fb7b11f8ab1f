"""The port's speculative decoding against the JAX package.

``models/attention`` (``attention_verify``, ``paged_attention_verify``),
``models/model.verify_step``, ``spec/verify.py``, the two drafters and the
engine's draft-verify loop are held against the reference on the CPU, on
the reduced llama3.2-1b (4 KV heads, ``int8_spoga`` GEMMs) with the JAX
``init_params`` tree scaled by 8, carried across with ``params_from_jax``.
The headline: greedy streams with speculation on equal those with it off
and the JAX engine's, bitwise, over paged bf16 and int8 pools and slot KV,
whatever the drafter proposes, and each request's solo decode wherever the
admission computes what the solo prefill computes (bf16 pools, slot KV).
Each case names the ``tests/test_spec.py`` case it carries over.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro.models.attention import attention_verify as jax_attention_verify
from repro.models.attention import paged_attention_verify as jax_paged_attention_verify
from repro.prefix import PrefixTree as JaxPrefixTree
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro.spec import NgramDrafter as JaxNgramDrafter
from repro.spec import SpecConfig as JaxSpecConfig
from repro.spec.draft_model import DraftModelDrafter as JaxDraftModelDrafter
from repro.spec.draft_model import draft_config as jax_draft_config
from repro_torch import configs as tconfigs
from repro_torch.api import serve_batch
from repro_torch.kernels import paged_attention as attn_mod
from repro_torch.models import params_from_jax
from repro_torch.models.attention import attention_verify, paged_attention_verify
from repro_torch.models.transformer import period_params
from repro_torch.prefix import PrefixTree
from repro_torch.serving import EngineConfig, SamplingParams, ServingEngine
from repro_torch.spec import NgramDrafter, SpecConfig
from repro_torch.spec.draft_model import DraftModelDrafter, draft_config

WEIGHT_SCALE = 8.0
ENGINE = dict(n_slots=2, cache_len=48, cache_mode="paged", page_size=8, prefill_chunk=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes that share the host's
    cores; torch's intra-op threads then spin against each other and small
    ops slow down a hundredfold.  This file's tensors are small: one thread
    each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(kv_dtype="bf16", quant_mode="int8_spoga", arch="llama3.2-1b"):
    kw = dict(quant_mode=quant_mode, kv_cache_dtype=kv_dtype, n_kv_heads=4)
    jcfg = jax_reduced(jax_get_config(arch)).with_(remat=False, **kw)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch)).with_(**kw)
    return jcfg, tcfg


def _scaled_tree(jcfg):
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))

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


def _pair(kv_dtype="bf16", spec=None, arch="llama3.2-1b", **ecfg_kw):
    """(JAX engine, port engine) on the same weights and settings."""
    jcfg, tcfg = _configs(kv_dtype, arch=arch)
    tree = _scaled_tree(jcfg)
    ecfg = {**ENGINE, **ecfg_kw}
    jspec = None if spec is None else JaxSpecConfig(**spec.to_dict())
    jeng = JaxServingEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                            JaxEngineConfig(**ecfg, spec=jspec))
    teng = ServingEngine(tcfg, params_from_jax(tree, tcfg, "cpu"),
                         EngineConfig(**ecfg, spec=spec), device="cpu")
    return jeng, teng


def _solo(engine, prompt, gen, cache_len=48):
    """The prompt's solo slot-cache decode on the port (``serve_batch``)."""
    out, _ = serve_batch(engine.cfg, engine.params,
                         {"tokens": torch.tensor([prompt], dtype=torch.int32)},
                         cache_len=cache_len, gen_tokens=gen)
    return out[0].tolist()


def _run_checked(engine, arrivals):
    """``engine.run(arrivals)``, the page bookkeeping checked every step."""
    pending = sorted(arrivals, key=lambda a: a[0])
    i = 0
    while i < len(pending) or engine.has_work:
        while i < len(pending) and pending[i][0] <= engine._step_idx:
            engine.add_request(*pending[i][1:])
            i += 1
        if not engine.has_work:
            engine._step_idx = pending[i][0]
            continue
        engine.step()
        if engine.paged:
            engine.store.manager.check_invariants()
    return engine.metrics


def _mixed_workload(rng, n=3):
    """test_spec.py's ``_mixed_workload``: repetitive prompts (draftable)
    mixed with random ones."""
    arrivals = []
    for i in range(n):
        if i % 2 == 0:
            pat = rng.integers(0, 512, 4).tolist()
            prompt = (pat * 4)[:12 + i]
        else:
            prompt = rng.integers(0, 512, 12 + i).tolist()
        arrivals.append((2 * i, prompt, 8 + i))
    return arrivals


class ScriptedDrafter:
    """test_spec.py's test-only drafter: maps a lane's history to a
    scripted draft, to pin the accept and reject paths."""

    def __init__(self, fn, k):
        self.fn, self.k = fn, k

    def admit(self, slot, history):
        pass

    def release(self, slot):
        pass

    def propose(self, slots, histories):
        return [list(self.fn(h))[:self.k] for h in histories]


def _oracle_fn(refs):
    """The true greedy continuation of a history (every draft accepted)."""
    def fn(hist):
        for p, ref in refs.items():
            if tuple(hist[:len(p)]) == p:
                return ref[len(hist) - len(p):]
        raise AssertionError("history matches no known prompt")
    return fn


def _adversarial_fn(refs, vocab):
    """Every draft is (true token + 1) mod vocab: every window rolls back."""
    oracle = _oracle_fn(refs)
    return lambda hist: [(t + 1) % vocab for t in oracle(hist)]


# ---------------------------------------------------------------------------
# models/attention.py: the verify window against the reference's
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


def _layer(jcfg, tcfg):
    tree = _scaled_tree(jcfg)
    jattn = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), tree["blocks"][0]["attn"])
    tattn = period_params(params_from_jax(tree, tcfg, "cpu")["blocks"][0]["attn"], 0)
    return jattn, tattn


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_paged_attention_verify_matches_jax(kv_dtype):
    """A 5-row window for 3 lanes (one inactive) whose windows start
    mid-page and cross a page edge, over a random pool: the output and the
    written pool against the reference's jitted ``paged_attention_verify``,
    bitwise.  On CPU tensors the port attends the gathered view, as the
    reference does; no kernel and no kernel plain version runs."""
    jcfg, tcfg = _configs(kv_dtype)
    jattn, tattn = _layer(jcfg, tcfg)
    rng = np.random.default_rng(3)
    pool = _random_pool(rng, tcfg, 12, 8)
    tables = np.asarray([[5, 2, 7, 1], [3, 9, 4, 0], [6, 8, 10, 11]], np.int32)
    pos = np.asarray([13, 6, 0], np.int32)
    active = np.asarray([True, True, False])
    x = (rng.normal(size=(3, 5, jcfg.d_model)) * 0.5).astype(jnp.bfloat16)
    jout, jpool = jax.jit(lambda xx, p, c, ps, t, a: jax_paged_attention_verify(
        xx, p, jcfg, c, ps, t, active=a))(
        jnp.asarray(x), jattn, jax.tree_util.tree_map(jnp.asarray, pool), jnp.asarray(pos),
        jnp.asarray(tables), jnp.asarray(active))
    tpool = {k: _to_port(v) for k, v in pool.items()}
    plain = attn_mod.PLAIN_CALLS
    tout, tnew = paged_attention_verify(_to_port(x), tattn, tcfg, tpool, torch.from_numpy(pos),
                                        torch.from_numpy(tables),
                                        active=torch.from_numpy(active))
    assert attn_mod.PLAIN_CALLS == plain and tnew is tpool
    for name, leaf in tpool.items():
        np.testing.assert_array_equal(_np(leaf), _jnp(jpool[name]), err_msg=name)
    np.testing.assert_array_equal(_np(tout)[:2], _jnp(jout)[:2])


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_attention_verify_matches_jax(kv_dtype):
    """Slot-cache verify: 2 lanes of 32 rows, windows at rows 9 and 27
    (the second clamped at the lane's end, as ``dynamic_update_slice``
    clamps): output and cache against the reference's, bitwise."""
    jcfg, tcfg = _configs(kv_dtype)
    jattn, tattn = _layer(jcfg, tcfg)
    rng = np.random.default_rng(4)
    shp = (2, 32, tcfg.n_kv_heads, tcfg.resolved_head_dim)
    if kv_dtype == "int8":
        cache = {"k": rng.integers(-127, 128, shp).astype(np.int8),
                 "v": rng.integers(-127, 128, shp).astype(np.int8),
                 "k_scale": (rng.random(shp[:3]) * 0.05 + 1e-3).astype(np.float32),
                 "v_scale": (rng.random(shp[:3]) * 0.05 + 1e-3).astype(np.float32)}
    else:
        cache = {"k": rng.normal(size=shp).astype(jnp.bfloat16),
                 "v": rng.normal(size=shp).astype(jnp.bfloat16)}
    pos = np.asarray([9, 27], np.int32)
    x = (rng.normal(size=(2, 5, jcfg.d_model)) * 0.5).astype(jnp.bfloat16)
    jout, jcache = jax.jit(lambda xx, p, c, ps: jax_attention_verify(xx, p, jcfg, c, ps))(
        jnp.asarray(x), jattn, jax.tree_util.tree_map(jnp.asarray, cache), jnp.asarray(pos))
    tcache = {k: _to_port(v) for k, v in cache.items()}
    tout, _ = attention_verify(_to_port(x), tattn, tcfg, tcache, torch.from_numpy(pos))
    for name, leaf in tcache.items():
        np.testing.assert_array_equal(_np(leaf), _jnp(jcache[name]), err_msg=name)
    np.testing.assert_array_equal(_np(tout), _jnp(jout))


def test_rmsnorm_columns_is_rmsnorm_per_column():
    """The verify window's norm reduces column by column: each column is
    bitwise :func:`rmsnorm` of that column alone (the decode step's
    shape), f32 and bf16 in, bf16 out."""
    from repro_torch.models.layers import rmsnorm, rmsnorm_columns
    g = torch.Generator().manual_seed(0)
    gamma = torch.rand(256, generator=g) + 0.5
    for x in (torch.randn((4, 5, 256), generator=g).bfloat16(),
              torch.randn((4, 5, 256), generator=g) * 3):
        got = rmsnorm_columns(x, gamma, 1e-6, dtype=torch.bfloat16)
        for c in range(5):
            assert torch.equal(got[:, c:c + 1],
                               rmsnorm(x[:, c:c + 1].contiguous(), gamma, 1e-6,
                                       dtype=torch.bfloat16))


def test_verify_window_is_the_decode_step():
    """Row c of a verify window computes what the decode step computes at
    that position: a 4-row window's logits equal 4 teacher-forced decode
    steps', bitwise, and both leave the same pool."""
    from repro_torch.models import decode_step, verify_step
    from repro_torch.paging import PagedCache
    jcfg, tcfg = _configs("int8")
    params = params_from_jax(_scaled_tree(jcfg), tcfg, "cpu")
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, 512, (2, 4)).astype(np.int32))
    stores = []
    for _ in range(2):
        store = PagedCache(tcfg, 2, 32, 8, device="cpu")
        for lane in range(2):
            store.manager.admit(lane, 16)
            store.manager.ensure(lane, 16)
        store.manager.dirty = True
        store.sync_tables()
        store.cache["pos"].copy_(torch.tensor([3, 9], dtype=torch.int32))
        stores.append(store)
    logits, _ = verify_step(params, tcfg, toks, stores[0].cache)
    assert stores[0].cache["pos"].tolist() == [3, 9]        # pos unchanged
    steps = [decode_step(params, tcfg, toks[:, c], stores[1].cache)[0] for c in range(4)]
    np.testing.assert_array_equal(_np(logits), _np(torch.stack(steps, dim=1)))
    for a, b in zip(stores[0].cache["blocks"][0].values(), stores[1].cache["blocks"][0].values()):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The engine: spec on == off == solo == the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kv", [
    pytest.param("llama3.2-1b", "bf16", id="bf16"),          # GQA pages
    pytest.param("llama3.2-1b", "int8", id="int8"),          # int8 pages + scales
    pytest.param("minicpm3-4b", "bf16", id="minicpm3-4b"),   # MLA verify window
])
def test_spec_is_bitwise_invisible_paged(arch, kv):
    """``test_spec_is_bitwise_invisible_paged``: the n-gram drafter over
    paged KV; streams with speculation on equal off and the JAX engine's
    (spec on), with the reference's verify and draft counts; on the bf16
    pool also the solo decode (an int8 pool's chunked prefill attends
    dequantized pages, the solo one-shot prefill its bf16 K/V, so on int8
    the cache-off paged engine is the reference stream)."""
    arrivals = _mixed_workload(np.random.default_rng(0))
    outs = {}
    for spec in (None, SpecConfig(enabled=True, k=4)):
        jeng, teng = _pair(kv, spec=spec, arch=arch)
        m, jm = _run_checked(teng, arrivals), jeng.run(arrivals)
        outs[spec is not None] = _streams(m)
        assert _streams(m) == _streams(jm)
        if spec is not None:
            assert m.verify_dispatches > 0
            for key in ("verify_dispatches", "decode_steps", "spec_proposed", "spec_accepted"):
                assert getattr(m, key) == getattr(jm, key), key
            assert teng.store.manager.pages_in_use == 0
    assert outs[True] == outs[False]
    for i, (_, p, g) in enumerate(arrivals):
        if kv == "bf16":
            assert outs[True][i] == _solo(teng, p, g), i


@pytest.mark.parametrize("arch,kv", [
    pytest.param("llama3.2-1b", "bf16", id="bf16"),          # GQA pages
    pytest.param("llama3.2-1b", "int8", id="int8"),          # int8 pages + scales
    pytest.param("minicpm3-4b", "bf16", id="minicpm3-4b"),   # MLA verify window
])
@pytest.mark.parametrize("mode", ["oracle", "adversarial"])
def test_spec_accept_and_reject_paths_exact(mode, arch, kv):
    """``test_spec_accept_and_reject_paths_exact``: an oracle drafter (every
    draft accepted) and an adversarial one (every draft rejected) both
    reproduce the spec-off streams and the JAX engine's, with the
    reference's accept counts."""
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, 512, n).tolist() for n in (12, 14)]
    gens = [9, 8]
    arrivals = [(0, prompts[0], gens[0]), (1, prompts[1], gens[1])]
    _, off = _pair(kv, arch=arch)
    base = _streams(_run_checked(off, arrivals))
    refs = {tuple(p): base[i] for i, p in enumerate(prompts)}
    spec = SpecConfig(enabled=True, k=3)
    jeng, teng = _pair(kv, spec=spec, arch=arch)
    fn = _oracle_fn(refs) if mode == "oracle" else _adversarial_fn(refs, 512)
    teng._drafter = ScriptedDrafter(fn, spec.k)
    jeng._drafter = ScriptedDrafter(fn, spec.k)
    m, jm = _run_checked(teng, arrivals), jeng.run(arrivals)
    outs = _streams(m)
    assert outs == _streams(jm)
    for i, p in enumerate(prompts):
        assert outs[i] == refs[tuple(p)]
    assert m.spec_proposed > 0
    assert m.spec_accepted == (m.spec_proposed if mode == "oracle" else 0)
    for key in ("verify_dispatches", "spec_proposed", "spec_accepted"):
        assert getattr(m, key) == getattr(jm, key), key
    assert teng.store.manager.pages_in_use == 0


@pytest.mark.parametrize("arch,kv", [
    pytest.param("llama3.2-1b", "bf16", id="bf16"),          # GQA pages
    pytest.param("llama3.2-1b", "int8", id="int8"),          # int8 pages + scales
    pytest.param("minicpm3-4b", "bf16", id="minicpm3-4b"),   # MLA verify window
])
def test_spec_is_bitwise_invisible_slot_mode(arch, kv):
    """``test_spec_is_bitwise_invisible_slot_mode``, with the oracle drafter
    so every window is accepted in full: slot KV, spec on == off == solo ==
    the JAX engine (slot admissions prefill in one shot on both pools)."""
    rng = np.random.default_rng(1)
    arrivals = _mixed_workload(rng)
    kw = dict(cache_mode="slot", prefill_chunk=None, arch=arch)
    _, off = _pair(kv, **kw)
    base = _streams(_run_checked(off, arrivals))
    spec = SpecConfig(enabled=True, k=4)
    jeng, teng = _pair(kv, spec=spec, **kw)
    fn = _oracle_fn({tuple(p): base[i] for i, (_, p, _) in enumerate(arrivals)})
    teng._drafter = ScriptedDrafter(fn, spec.k)
    jeng._drafter = ScriptedDrafter(fn, spec.k)
    m, jm = _run_checked(teng, arrivals), jeng.run(arrivals)
    assert _streams(m) == _streams(jm) == base
    assert m.spec_accepted == m.spec_proposed > 0
    for i, (_, p, g) in enumerate(arrivals):
        assert base[i] == _solo(teng, p, g), i


def test_spec_draft_model_drafter_matches_jax():
    """``test_spec_draft_model_drafter_exact``: the draft-model drafter
    carrying the JAX drafter's weights proposes what the JAX drafter
    proposes (admission, full accept, partial accept, release), and the
    engine's streams stay solo-exact and equal the JAX engine's."""
    spec = SpecConfig(enabled=True, k=3, drafter="model", draft_layers=2)
    jcfg, tcfg = _configs("bf16")
    jd = JaxDraftModelDrafter(JaxSpecConfig(**spec.to_dict()), jcfg, 2, 48)
    td = DraftModelDrafter(spec, tcfg, 2, 48, device="cpu")
    assert td.cfg.n_layers == jd.cfg.n_layers == 2
    td.params = params_from_jax(jax.tree_util.tree_map(np.asarray, jd.params), td.cfg, "cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 512, n).tolist() for n in (11, 14)]
    for d in (jd, td):
        for slot, p in enumerate(prompts):
            d.admit(slot, p)
    hists = [p + [int(t)] for p, t in zip(prompts, rng.integers(0, 512, 2))]   # + t0
    props = td.propose([0, 1], hists)
    assert props == jd.propose([0, 1], hists) and all(len(p) == 3 for p in props)
    # lane 0 accepts every draft (+ a bonus token), lane 1 rejects the second
    hists = [hists[0] + props[0] + [7], hists[1] + props[1][:1] + [(props[1][1] + 1) % 512]]
    assert td.propose([0, 1], hists) == jd.propose([0, 1], hists)
    td.release(1)
    assert set(td._fed) == {0}

    arrivals = _mixed_workload(rng)
    jeng, teng = _pair("bf16", spec=spec)
    teng._drafter.params = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jeng._drafter.params), teng._drafter.cfg, "cpu")
    m, jm = _run_checked(teng, arrivals), jeng.run(arrivals)
    assert m.verify_dispatches > 0 and m.spec_proposed > 0
    for key in ("spec_proposed", "spec_accepted", "verify_dispatches"):
        assert getattr(m, key) == getattr(jm, key), key
    assert _streams(m) == _streams(jm)
    for i, (_, p, g) in enumerate(arrivals):
        assert _streams(m)[i] == _solo(teng, p, g), i
    assert teng._drafter._fed == {}


def test_draft_config_and_arch_refusal():
    _, tcfg = _configs("bf16")
    assert draft_config(tcfg, SpecConfig(draft_layers=1)).n_layers == 1
    assert draft_config(tcfg, SpecConfig(draft_arch="llama3.2-1b")).vocab_size == 512
    mla = draft_config(tcfg, SpecConfig(draft_arch="minicpm3-4b"))
    assert mla.use_mla and mla.vocab_size == 512
    # a recurrent or encoder-decoder draft arch is derived as the reference
    # derives it (reduced, the target's vocab)
    xl = draft_config(tcfg, SpecConfig(draft_arch="xlstm-125m"))
    want = jax_draft_config(_configs("bf16")[0], JaxSpecConfig(draft_arch="xlstm-125m"))
    assert (xl.block_pattern, xl.n_layers, xl.d_model, xl.vocab_size) == \
        (want.block_pattern, want.n_layers, want.d_model, want.vocab_size) == \
        (("mlstm", "mlstm", "mlstm", "slstm"), 8, 128, 512)
    sm = draft_config(tcfg, SpecConfig(draft_arch="seamless-m4t-large-v2"))
    want = jax_draft_config(_configs("bf16")[0],
                            JaxSpecConfig(draft_arch="seamless-m4t-large-v2"))
    assert (sm.is_encoder_decoder, sm.frontend, sm.n_layers, sm.n_encoder_layers,
            sm.d_model, sm.vocab_size) == \
        (want.is_encoder_decoder, want.frontend, want.n_layers, want.n_encoder_layers,
         want.d_model, want.vocab_size) == (True, "audio", 2, 2, 128, 512)
    # such a drafter takes no token prompts: the port refuses it when it is
    # built (the reference fails later, at its first admission)
    with pytest.raises(ValueError, match="cannot draft"):
        DraftModelDrafter(SpecConfig(draft_arch="seamless-m4t-large-v2"), tcfg, 2, 32,
                          device="cpu")


def test_spec_respects_eos_and_budget():
    """``test_spec_respects_eos_and_budget``: EOS inside an accepted window
    truncates the stream where plain decode would; a 1-token budget still
    admits (no drafts)."""
    rng = np.random.default_rng(3)
    prompt = (rng.integers(0, 512, 4).tolist() * 4)[:13]
    _, off = _pair("bf16")
    ref = _solo(off, prompt, 12)
    eos = ref[5]
    for spec in (None, SpecConfig(enabled=True, k=4)):
        _, teng = _pair("bf16", spec=spec, eos_token=eos)
        if spec is not None:
            teng._drafter = ScriptedDrafter(_oracle_fn({tuple(prompt): ref}), spec.k)
        outs = _streams(_run_checked(teng, [(0, prompt, 12), (0, prompt, 1)]))
        assert outs[0] == ref[:ref.index(eos) + 1]
        assert outs[1] == ref[:1]


def test_spec_rollback_under_cow_shared_pages():
    """``test_spec_rollback_under_cow_shared_pages``: rejected drafts roll
    back lanes whose window overlapped tree-shared pages (CoW-forked before
    the verify), so the shared trunk is never corrupted; streams equal the
    solo decode and the JAX engine's."""
    prompt = np.random.default_rng(4).integers(0, 512, 16).tolist()   # 2 pages
    spec = SpecConfig(enabled=True, k=4)
    jeng, teng = _pair("bf16", spec=spec, prefix_cache=True)
    ref = _solo(teng, prompt, 10)
    fn = _adversarial_fn({tuple(prompt): ref}, 512)
    teng._drafter = ScriptedDrafter(fn, spec.k)
    jeng._drafter = ScriptedDrafter(fn, spec.k)
    arrivals = [(0, prompt, 10), (2, prompt, 10)]      # the second is a full hit
    m, jm = _run_checked(teng, arrivals), jeng.run(arrivals)
    assert m.prefix_hits == 1 and m.prefix_cow_forks >= 1
    assert m.spec_proposed > 0 and m.spec_accepted == 0
    assert m.prefix_cow_forks == jm.prefix_cow_forks
    assert all(r.output_tokens == ref for r in m.finished)
    assert _streams(m) == _streams(jm)
    assert teng.store.manager.pages_in_use == m.prefix_tree_pages


def test_spec_overshoot_reserved_in_admission():
    """``test_spec_overshoot_reserved_in_admission``: admission reserves the
    k rows a verify window writes past the accepted position."""
    _, teng = _pair("bf16", spec=SpecConfig(enabled=True, k=4))
    with pytest.raises(ValueError, match="cache positions"):
        teng.add_request(list(range(100, 136)), 10)   # 36 + 10 + 4 > 48 + 1
    req = teng.add_request(list(range(100, 136)), 5)
    assert teng._reserve_tokens(req) == 36 + 5 + 4


def test_spec_mixed_sampling_falls_back_to_plain_decode():
    """``test_spec_mixed_sampling_falls_back_to_plain_decode``: a stochastic
    lane in the batch turns speculation off for the step; the streams equal
    the spec-off engine's."""
    rng = np.random.default_rng(6)
    p1, p2 = (rng.integers(0, 512, 12).tolist() for _ in range(2))
    sto = SamplingParams(greedy=False, temperature=0.8, top_k=4, seed=7)
    outs = {}
    for spec in (None, SpecConfig(enabled=True, k=4)):
        _, teng = _pair("bf16", spec=spec)
        m = _run_checked(teng, [(0, p2, 14, sto), (0, p1, 6)])
        outs[spec is not None] = _streams(m)
        if spec is not None:
            assert m.verify_dispatches == 0
    assert outs[True] == outs[False]


# ---------------------------------------------------------------------------
# N-gram drafter: the reference's unit cases, port and reference side by side
# ---------------------------------------------------------------------------

NGRAM_CASES = [
    (dict(k=3, ngram_max=3), [1, 2, 3, 4, 5, 6, 1, 2, 3], [4, 5, 6]),    # self lookup
    (dict(k=3, ngram_max=3), [1, 2, 9, 1, 2, 7, 1, 2], [7, 1, 2]),       # most recent wins
    (dict(k=3, ngram_max=3), [7, 8, 9, 7], [8, 9, 7]),                   # shorter-n fallback
    (dict(k=3, ngram_max=3), [3, 1, 4, 1, 5, 9, 2, 6], []),              # no earlier match
    (dict(k=3, ngram_max=3), [1, 2, 3, 4], []),
    (dict(k=2, ngram_max=3), [9, 5, 6, 7, 8, 9, 4, 7, 0, 5, 6, 7], [8, 9]),  # longest wins
]


@pytest.mark.parametrize("kw,hist,want", NGRAM_CASES)
def test_ngram_drafter_matches_reference(kw, hist, want):
    got = NgramDrafter(SpecConfig(enabled=True, **kw)).propose([0], [hist])
    assert got == JaxNgramDrafter(JaxSpecConfig(enabled=True, **kw)).propose([0], [hist])
    assert got == [want]


def test_ngram_drafter_tree_fallback_deterministic():
    drafts = []
    for tree_cls, drafter_cls, spec_cls in ((PrefixTree, NgramDrafter, SpecConfig),
                                            (JaxPrefixTree, JaxNgramDrafter, JaxSpecConfig)):
        tree = tree_cls(4)
        tree.insert([7, 8, 1, 2, 3, 4, 5, 6], [1, 2])
        tree.insert([7, 8, 9, 9, 1, 2, 3, 4], [1, 3])
        d = drafter_cls(spec_cls(enabled=True, k=2, ngram_max=2), tree=tree)
        drafts.append(d.propose([0], [[50, 51, 2, 3]]) + d.propose([0], [[50, 51, 2, 3]]))
    assert drafts[0] == drafts[1] == [[4, 5], [4, 5]]
