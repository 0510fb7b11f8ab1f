"""Tensor-parallel serving of MLA, the recurrent archs, the encoder-decoder
and frontend archs and the numerics watchdog, against the JAX package and
the unsharded port.

Gloo ranks on the CPU, spawned once per world size for the whole file
(``launch.mesh.spawn``: 2 ranks, then 4; every reduced config's heads,
latents and widths divide by 4):

* minicpm3-4b (MLA), xlstm-125m (mLSTM, sLSTM) and recurrentgemma-9b
  (RG-LRU, and local attention over a ring with one KV head) serve through
  ``LLM(runtime=RuntimeConfig(mesh=MeshConfig(tp=N)))`` at ``int8_spoga``
  in slot and paged mode; their greedy streams equal the JAX package's
  unsharded ``LLM`` (parity (i));
* seamless-m4t-large-v2 and llava-next-mistral-7b serve through
  ``api.serve_batch(mesh=)``; their greedy tokens equal the JAX
  package's unsharded ``serve_batch``;
* all five archs' prefill and decode logits over a slot cache are bitwise
  the unsharded port's (``LOGIT_TOL`` = 0, parity (ii)): every rank
  computes its columns whole, the row-parallel GEMMs sum exact int32
  accumulators, and where a rank needs a whole width (an MQA head, the
  MLA latents, the RG-LRU branch, the sLSTM gates) it gathers it, so no
  f32 sum is split across ranks and parity (iii) has no case here;
* at tp=2 the numerics watchdog's report on every rank equals the
  unsharded port's: counters, ``amax`` and the accumulator bound exactly,
  the mean relative error within ``ERR_RTOL``;
* each rank holds the bytes the reference's specs give it: params
  ``== tree_device_bytes``, the engine's slot and paged caches the bytes
  of ``pool_shardings`` of the full cache tree; the sLSTM and MQA layouts
  are the ones ``models/kvcache.py`` states.

The weights are the JAX ``init_params`` trees with the projections scaled
up (``WEIGHT_SCALE``) so greedy decoding does not collapse.  The file
reports its own time; about 120 s in one process (the two spawns about 30
s each, most of it the ranks importing the JAX package with this module).
"""

import functools
import time
import types

import jax
import numpy as np
import pytest
import torch

from repro.api import LLM as JaxLLM
from repro.api import KVConfig as JaxKVConfig
from repro.api import QuantRuntime as JaxQuantRuntime
from repro.api import RuntimeConfig as JaxRuntimeConfig
from repro.api import SchedulerConfig as JaxSchedulerConfig
from repro.api import serve_batch as jax_serve_batch
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro_torch import configs as tconfigs
from repro_torch.api import (
    LLM,
    KVConfig,
    MeshConfig,
    QuantRuntime,
    RuntimeConfig,
    SchedulerConfig,
)
from repro_torch.launch.mesh import spawn
from repro_torch.models import params_from_jax

WEIGHT_SCALE = 8.0
ENGINE_ARCHS = ("minicpm3-4b", "xlstm-125m", "recurrentgemma-9b")
BATCH_ARCHS = ("seamless-m4t-large-v2", "llava-next-mistral-7b")
CACHE_MODES = ("slot", "paged")
# sharded against unsharded logits at int8_spoga (parity (ii))
LOGIT_TOL = 0.0
# the watchdog's mean relative error: the row-parallel site sums |err| and
# |x| in f64 over the ranks' K slices, the unsharded one takes two f32
# means over the whole K; they differ in the last few f32 ulps
ERR_RTOL = 1e-5
GEN = 5
SRC = 8
_T0 = time.perf_counter()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    print(f"\n[test_torch_tp_archs] {time.perf_counter() - _T0:.1f} s")


@functools.lru_cache(maxsize=None)
def _tree(arch):
    jcfg = jax_reduced(jax_get_config(arch)).with_(remat=False)
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))

    def scale(path, a):
        if "'w" in jax.tree_util.keystr(path):
            return (a.astype(np.float32) * WEIGHT_SCALE).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(scale, tree)


def _kv(mode):
    return dict(mode=mode, dtype="int8", page_size=8)


def _runtime(mode, mesh=MeshConfig(), **kw):
    return RuntimeConfig(reduced=True, quant=QuantRuntime(mode="int8_spoga"),
                         kv=KVConfig(**_kv(mode)), scheduler=SchedulerConfig(n_slots=2),
                         mesh=mesh, **kw)


def _cfg(arch, **kw):
    return _runtime("slot").resolve_model(tconfigs.reduced(tconfigs.get_config(arch))).with_(**kw)


def _prompts(n=(5, 11, 3)):
    rng = np.random.default_rng(0)
    # the longest prompt + GEN + headroom is a whole number of pages (a
    # ring stack serves paged only so)
    return [rng.integers(0, 512, k).tolist() for k in n]


def _batch(cfg, seed=2, s=8):
    """The reference tests' batch (numpy): source frames and target
    tokens, or patch embeddings; embeddings f32 x 0.02."""
    rng = np.random.default_rng(seed)
    if cfg.is_encoder_decoder:
        return {"src_embeds": (rng.standard_normal((2, SRC, cfg.d_model)) * 0.02)
                .astype(np.float32),
                "tgt_tokens": rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)}
    return {"embeds": (rng.standard_normal((2, s, cfg.d_model)) * 0.02).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _jax_streams(arch):
    """The JAX package's unsharded streams, over paged KV: its slot engine
    serves the same streams (the reference's engine tests hold the two
    modes equal), so one JAX run is the reference of both port modes."""
    jllm = JaxLLM(arch=arch, params=jax.tree_util.tree_map(jax.numpy.asarray, _tree(arch)),
                  runtime=JaxRuntimeConfig(reduced=True, quant=JaxQuantRuntime(mode="int8_spoga"),
                                           kv=JaxKVConfig(**_kv("paged")),
                                           scheduler=JaxSchedulerConfig(n_slots=2)))
    return [o.token_ids for o in jllm.generate(_prompts(), max_new_tokens=GEN)]


@functools.lru_cache(maxsize=None)
def _jax_batch(arch):
    jcfg = jax_reduced(jax_get_config(arch)).with_(remat=False, quant_mode="int8_spoga",
                                                   kv_cache_dtype="int8")
    batch = _batch(jcfg)
    want, _ = jax_serve_batch(jcfg, jax.tree_util.tree_map(jax.numpy.asarray, _tree(arch)),
                              {k: jax.numpy.asarray(v) for k, v in batch.items()},
                              cache_len=24, gen_tokens=GEN)
    return np.asarray(want)


def _stub_mesh(tp):
    return types.SimpleNamespace(shape={"data": 1, "model": tp}, axis_names=("data", "model"))


def _nbytes(tree) -> int:
    from repro_torch.tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def _shape_bytes(tree) -> int:
    from repro_torch.shard.core import as_shapes
    return _nbytes(as_shapes(tree))


# ---------------------------------------------------------------------------
# What each rank runs
# ---------------------------------------------------------------------------

def _engine_case(arch, tree, mode, dev, tp):
    """Greedy streams of the sharded ``LLM``, the rank's param bytes and
    the bytes of its cache store."""
    cfg = _cfg(arch)
    llm = LLM(arch, runtime=_runtime(mode, MeshConfig(tp=tp)),
              params=params_from_jax(tree, cfg, dev), device=dev)
    streams = [o.token_ids for o in llm.generate(_prompts(), max_new_tokens=GEN)]
    eng = llm.engine
    store = eng.store
    return dict(streams=streams, param_bytes=_nbytes(llm.params),
                cache_bytes=_nbytes(store.cache),
                cache_args=(store.n_lanes, store.cache_len, store.page_size, store.n_pages)
                if mode == "paged" else (store.n_slots, store.cache_len),
                leaves={k: tuple(v.shape) for k, v in
                        store.cache["blocks"][len(cfg.block_pattern) - 1].items()})


def _logit_case(arch, tree, mesh):
    """Prefill and 3 decode steps over a slot cache, sharded against
    unsharded: the largest absolute logit difference of each."""
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.shard import shard_params

    cfg = _cfg(arch)
    full = params_from_jax(tree, cfg, "cpu")
    mine = shard_params(full, mesh, cfg)
    if cfg.is_encoder_decoder or cfg.frontend is not None:
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed=1, s=9).items()}
    else:
        batch = {"tokens": torch.from_numpy(
            np.random.default_rng(1).integers(0, 512, (2, 9)).astype(np.int32))}
    want, wcache = prefill(full, cfg, batch, 32)
    got, gcache = prefill(mine, cfg, batch, 32, mesh=mesh)
    diffs = [float((got - want).abs().max())]
    tok = want.argmax(-1).to(torch.int32)
    for i in range(3):
        step = tok
        if cfg.frontend is not None and not cfg.is_encoder_decoder:
            step = torch.from_numpy(_batch(cfg, seed=10 + i, s=1)["embeds"][:, 0])
        want, wcache = decode_step(full, cfg, step, wcache)
        got, gcache = decode_step(mine, cfg, step, gcache, mesh=mesh)
        diffs.append(float((got - want).abs().max()))
        tok = want.argmax(-1).to(torch.int32)
    return diffs


def _batch_case(arch, tree, mesh):
    """``serve_batch`` on the rank's part of the weights."""
    from repro_torch.api import serve_batch
    from repro_torch.shard import shard_params

    cfg = _cfg(arch)
    mine = shard_params(params_from_jax(tree, cfg, "cpu"), mesh, cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    got, _ = serve_batch(cfg, mine, batch, cache_len=24, gen_tokens=GEN, mesh=mesh)
    return dict(tokens=got.numpy(), param_bytes=_nbytes(mine))


def _watch_report():
    from repro_torch.obs import watchdog
    reg = watchdog.peek_registry()
    return dict(counters={k: c.value for k, c in reg.counters.items()},
                gauges={k: g.value for k, g in reg.gauges.items()},
                samples={k: sorted(h.samples) for k, h in reg.histograms.items()},
                saturation=watchdog.saturation_report())


def _watchdog_case(arch, tree, mesh):
    """The watchdog's registry after a prefill and 2 decode steps, sharded
    and unsharded (each from a fresh registry)."""
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.obs import watchdog
    from repro_torch.shard import shard_params

    cfg = _cfg(arch, numerics_watchdog=True)
    full = params_from_jax(tree, cfg, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 512, (2, 7)).astype(np.int32))
    out = {}
    for name, params, kw in (("unsharded", full, {}),
                             ("sharded", shard_params(full, mesh, cfg), {"mesh": mesh})):
        watchdog.reset()
        logits, cache = prefill(params, cfg, {"tokens": tokens}, 16, **kw)
        for _ in range(2):
            logits, cache = decode_step(params, cfg, logits.argmax(-1).to(torch.int32), cache,
                                        **kw)
        out[name] = _watch_report()
    watchdog.reset()
    return out


def _layout_case(mesh):
    """The rank's sLSTM and MQA layouts: the ring leaves and recurrent
    state of the stores, the shards of ``w_zifo``, ``r_zifo`` and the MQA
    projections."""
    from repro_torch.models.model import init_cache, init_params
    from repro_torch.shard import local_config, shard_params

    out = {}
    for arch in ("xlstm-125m", "recurrentgemma-9b"):
        cfg = _cfg(arch)
        params = shard_params(init_params(cfg, device="cpu"), mesh, cfg)
        cache = init_cache(local_config(cfg, mesh.shape["model"]), 2, 40, "cpu")
        out[arch] = dict(
            params={k: tuple(v.shape) for blk in params["blocks"] for k, v in
                    {**blk.get("cell", {}), **blk.get("attn", {})}.items()},
            cache={k: tuple(v.shape) for blk in cache["blocks"] for k, v in blk.items()})
    return out


def _rank(rank, dev, tp, trees, with_extras):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(1, tp, backend="gloo", device=dev)
    out = {"engine": {}, "logits": {}, "batch": {}}
    for arch in ENGINE_ARCHS:
        for mode in CACHE_MODES:
            out["engine"][arch, mode] = _engine_case(arch, trees[arch], mode, dev, tp)
    for arch in ENGINE_ARCHS + BATCH_ARCHS:
        out["logits"][arch] = _logit_case(arch, trees[arch], mesh)
    for arch in BATCH_ARCHS:
        out["batch"][arch] = _batch_case(arch, trees[arch], mesh)
    if with_extras:
        out["watchdog"] = {arch: _watchdog_case(arch, trees[arch], mesh)
                           for arch in ("llama3.2-1b", "minicpm3-4b", "recurrentgemma-9b",
                                        "xlstm-125m")}
        out["layout"] = _layout_case(mesh)
    return out


@functools.lru_cache(maxsize=None)
def _results(tp):
    archs = ENGINE_ARCHS + BATCH_ARCHS + ("llama3.2-1b",)
    return spawn(_rank, tp, "gloo", device="cpu",
                 args=(tp, {a: _tree(a) for a in archs}, tp == 2))


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("mode", CACHE_MODES)
@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_tp_engine_streams_equal_jax(arch, mode, tp):
    want = _jax_streams(arch)
    assert len({t for s in want for t in s}) > 2, "streams collapsed"
    for res in _results(tp):
        assert res["engine"][arch, mode]["streams"] == want


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ENGINE_ARCHS + BATCH_ARCHS)
def test_tp_logits_bitwise_unsharded(arch, tp):
    for res in _results(tp):
        assert max(res["logits"][arch]) <= LOGIT_TOL, res["logits"][arch]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", BATCH_ARCHS)
def test_tp_serve_batch_equals_jax(arch, tp):
    want = _jax_batch(arch)
    assert len(np.unique(want)) > 2, "tokens collapsed"
    for res in _results(tp):
        np.testing.assert_array_equal(res["batch"][arch]["tokens"], want)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ENGINE_ARCHS + BATCH_ARCHS)
def test_tp_rank_holds_the_spec_bytes(arch, tp):
    """Params: ``tree_device_bytes`` under the serving specs.  Caches: the
    bytes of ``pool_shardings`` of the full config's slot or paged tree,
    on every rank (the layouts that depart from the spec's axis keep its
    bytes)."""
    from repro_torch.models import param_shapes
    from repro_torch.models.model import cache_shapes, paged_cache_shapes
    from repro_torch.runtime.sharding import param_specs
    from repro_torch.shard import pool_shardings, tree_device_bytes

    cfg = _cfg(arch)
    mesh = _stub_mesh(tp)
    meta = param_shapes(cfg)
    want = tree_device_bytes(meta, param_specs(meta, mesh, cfg, fsdp=False), mesh)
    assert want < _nbytes(meta)
    for res in _results(tp):
        if arch in BATCH_ARCHS:
            assert res["batch"][arch]["param_bytes"] == want
            continue
        for mode in CACHE_MODES:
            got = res["engine"][arch, mode]
            assert got["param_bytes"] == want
            shapes = (paged_cache_shapes(cfg, *got["cache_args"]) if mode == "paged"
                      else cache_shapes(cfg, *got["cache_args"]))
            assert got["cache_bytes"] == _shape_bytes(pool_shardings(shapes, mesh)), mode
            assert got["cache_bytes"] < _shape_bytes(shapes)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "minicpm3-4b", "recurrentgemma-9b",
                                  "xlstm-125m"])
def test_tp_watchdog_report_equals_unsharded(arch):
    """Every rank's watchdog report at tp=2: the same labels (global K and
    N), counters (rail hits, element counts, calls, clamped bits) and
    gauges, the same ``amax`` and accumulator-bound samples, and the mean
    relative error within ``ERR_RTOL``."""
    for res in _results(2):
        got, want = res["watchdog"][arch]["sharded"], res["watchdog"][arch]["unsharded"]
        assert got["counters"] == want["counters"]
        assert got["gauges"] == want["gauges"]
        assert got["saturation"] == want["saturation"]
        assert set(got["samples"]) == set(want["samples"])
        assert any("watchdog_act_sat" in k and v for k, v in got["counters"].items())
        for key, samples in want["samples"].items():
            if "watchdog_quant_err" in key:
                np.testing.assert_allclose(got["samples"][key], samples, rtol=ERR_RTOL)
            else:
                assert got["samples"][key] == samples, key


def test_tp_slstm_and_mqa_layouts():
    """At tp=2: ``w_zifo``'s column block is two of the four gates (the
    rank gathers the gates and keeps its heads), ``r_zifo`` holds half the
    heads whole (the spec's bytes: half of each head's columns), and the
    xLSTM states hold the rank's heads whole; recurrentgemma's one KV head keeps ``wk`` / ``wv`` at half its
    ``head_dim`` columns, the ring at half of them too, the query heads
    halved, and the RG-LRU state half the channels."""
    xl, rg = _cfg("xlstm-125m"), _cfg("recurrentgemma-9b")
    d, dh, h = xl.d_model, xl.resolved_head_dim, xl.n_heads
    for res in _results(2):
        x = res["layout"]["xlstm-125m"]
        assert x["params"]["w_zifo"][-1] == 2 * d
        assert x["params"]["r_zifo"][-4:] == (4, h // 2, dh, dh)
        assert x["params"]["wq"][-1] == d // 2
        assert x["cache"]["C"][-3:] == (h // 2, dh, dh)
        assert x["cache"]["c"][-2:] == (h // 2, dh)
        r = res["layout"]["recurrentgemma-9b"]
        hd = rg.resolved_head_dim
        assert rg.n_kv_heads == 1
        assert r["params"]["wk"][-1] == r["params"]["wv"][-1] == hd // 2
        assert r["params"]["wq"][-1] == rg.n_heads * hd // 2
        assert r["cache"]["k"][-2:] == (1, hd // 2)
        assert r["cache"]["k_scale"][-1] == 1
        assert r["cache"]["h"][-1] == rg.lru_width // 2


@pytest.mark.parametrize("tp", [2, 4])
def test_slstm_r_zifo_cut_by_head_round_trips(tp):
    """A rank's ``r_zifo`` is its whole heads, in rank order, and the
    ranks' blocks assemble back to the full leaf (the gather a sharded
    checkpoint save makes)."""
    from repro_torch.models.model import init_params
    from repro_torch.runtime.sharding import param_specs
    from repro_torch.shard.core import _assemble, shard_params

    cfg = _cfg("xlstm-125m")
    params = init_params(cfg, device="cpu")
    mesh = types.SimpleNamespace(shape={"data": 1, "model": tp}, axis_names=("data", "model"),
                                 device_mesh=types.SimpleNamespace(
                                     mesh=torch.arange(tp).reshape(1, tp)))
    specs = param_specs(params, mesh, cfg, fsdp=False)
    parts = [shard_params(params, mesh, cfg, coords={"data": 0, "model": r}) for r in range(tp)]
    seen = 0
    for i, blk in enumerate(params["blocks"]):
        if "r_zifo" not in blk.get("cell", {}):
            continue
        full, h = blk["cell"]["r_zifo"], cfg.n_heads
        got = [p["blocks"][i]["cell"]["r_zifo"] for p in parts]
        for r, g in enumerate(got):
            assert torch.equal(g, full[..., r * h // tp:(r + 1) * h // tp, :, :])
        spec = specs["blocks"][i]["cell"]["r_zifo"]
        assert torch.equal(_assemble(got, spec, mesh, cfg, ("blocks", i, "cell", "r_zifo")), full)
        seen += 1
    assert seen


@pytest.mark.parametrize("tp", [2, 4])
def test_mla_rank_heads_are_the_unsharded_heads(tp):
    """MLA's absorbed attention of a rank, from its heads' queries and its
    columns of ``w_uk`` / ``w_uv`` with nothing gathered, is bitwise those
    heads' outputs of the unsharded run."""
    from repro_torch.models.attention import _mla_attend_rows
    from repro_torch.runtime import collectives
    from repro_torch.shard import local_config

    cfg = _cfg("minicpm3-4b")
    m, h, b, s = cfg.mla, cfg.n_heads, 3, 20
    gen = torch.Generator().manual_seed(tp)

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(torch.bfloat16)

    q_nope, q_rope = rnd(b, 1, h, m.qk_nope_head_dim), rnd(b, 1, h, m.qk_rope_head_dim)
    ckv, kr = rnd(b, s, m.kv_lora_rank), rnd(b, s, m.qk_rope_head_dim)
    p = {"w_uk": rnd(m.kv_lora_rank, h * m.qk_nope_head_dim),
         "w_uv": rnd(m.kv_lora_rank, h * m.v_head_dim)}
    valid = torch.arange(s)[None, :] < torch.tensor([20, 7, 13])[:, None]
    full = _mla_attend_rows(q_nope, q_rope, ckv, kr, valid, p, cfg)
    local, hl = local_config(cfg, tp), h // tp
    for r in range(tp):
        heads = slice(r * hl, (r + 1) * hl)
        pr = {"w_uk": p["w_uk"][:, r * hl * m.qk_nope_head_dim:(r + 1) * hl * m.qk_nope_head_dim],
              "w_uv": p["w_uv"][:, r * hl * m.v_head_dim:(r + 1) * hl * m.v_head_dim]}
        # the rank's coordinate on the model axis (no collective runs)
        collectives._MODEL_AXES.append(collectives.Axis(None, tp, r, "gloo"))
        try:
            got = _mla_attend_rows(q_nope[:, :, heads], q_rope[:, :, heads], ckv, kr, valid,
                                   pr, local)
        finally:
            collectives._MODEL_AXES.pop()
        assert torch.equal(got, full[:, :, heads]), r


@pytest.mark.parametrize("watchdog", [False, True])
@pytest.mark.parametrize("arch", ENGINE_ARCHS + BATCH_ARCHS)
def test_local_config_serves_the_arch(arch, watchdog):
    """``local_config`` at tp 2 and 4: the rank's query heads, its KV heads
    (an MQA head stays whole in the config and splits by columns), every
    other field the full config's, the watchdog on or off."""
    from repro_torch.shard import local_config
    full = _cfg(arch, numerics_watchdog=watchdog)
    for tp in (2, 4):
        local = local_config(full, tp)
        assert (local.tp, local.n_heads * tp, local.numerics_watchdog) == \
            (tp, full.n_heads, watchdog)
        mqa = full.n_kv_heads == 1
        assert local.kv_split == mqa
        assert local.n_kv_heads == (1 if mqa else full.n_kv_heads // tp)
        assert local.resolved_head_dim == full.resolved_head_dim
        assert (local.d_model, local.mla, local.lru_width, local.vocab_size) == \
            (full.d_model, full.mla, full.lru_width, full.vocab_size)


@pytest.mark.parametrize("arch,field,tp", [
    ("minicpm3-4b", "n_heads", 3),
    ("recurrentgemma-9b", "head_dim", 2),
    ("minicpm3-4b", "kv_lora_rank", 2),
    ("recurrentgemma-9b", "lru_width", 2),
    ("xlstm-125m", "d_model", 2),
])
def test_local_config_refuses_a_width_tp_does_not_divide(arch, field, tp):
    """A rank cannot hold 1/tp of a width tp does not divide (the specs
    would replicate it): the query heads, the MQA head's columns, the MLA
    latent rank, the RG-LRU width, the xLSTM width."""
    import dataclasses
    from repro_torch.shard import local_config
    cfg = _cfg(arch)
    if field == "head_dim":
        cfg = cfg.with_(head_dim=cfg.resolved_head_dim + 1)
    elif field == "kv_lora_rank":
        cfg = cfg.with_(mla=dataclasses.replace(cfg.mla, kv_lora_rank=cfg.mla.kv_lora_rank + 1))
    elif field == "lru_width":
        cfg = cfg.with_(lru_width=cfg.lru_width + 1)
    elif field == "d_model":
        cfg = cfg.with_(d_model=cfg.d_model + 1)
    with pytest.raises(ValueError, match=f"tp={tp} must divide"):
        local_config(cfg, tp)
