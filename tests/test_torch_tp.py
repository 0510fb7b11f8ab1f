"""Tensor-parallel serving of the port against the unsharded port and the
JAX package.

Gloo ranks on the CPU, spawned once per world size for the whole file
(``launch.mesh.spawn``: 2 ranks, then 4):

* the row-parallel ``linear`` (each rank holds K/tp of the activation and
  the weight) gives int32 accumulators and outputs bitwise equal to the
  unsharded call at ``int8_spoga``, ``int8_deas``, ``int8_direct`` and
  ``w16a16`` (whose accumulator clamp reads the global K), and within
  ``BF16_ULPS`` bf16 ulps at ``bf16``; the column-parallel one is the
  unsharded output's column block;
* reduced llama3.2-1b, mistral-large-123b and deepseek-moe-16b (expert
  parallel) serve through ``LLM(runtime=RuntimeConfig(mesh=MeshConfig(
  tp=N)))`` at ``int8_spoga`` over paged KV, and their greedy streams
  equal the JAX package's unsharded ``LLM``; their prefill and decode
  logits are bitwise the unsharded port's (``LOGIT_TOL`` = 0);
* the page pool keeps ``check_invariants`` under eviction and defrag at
  tp=2, with the streams of the unsharded engine.

In this process: ``MeshConfig(enable=True)`` (a one-rank mesh) is bitwise
the unsharded engine in slot, paged, paged+prefix and paged+spec modes.
The weights are the JAX ``init_params`` trees with the projections (and
experts) scaled up so greedy decoding does not collapse.  About 80 s in one
process (the 4-rank spawn about 30 s of it).
"""

import functools
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
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro_torch import configs as tconfigs
from repro_torch.api import (
    LLM,
    ObsConfig,
    KVConfig,
    MeshConfig,
    QuantRuntime,
    RuntimeConfig,
    SchedulerConfig,
    SpecConfig,
)
from repro_torch.launch.mesh import spawn
from repro_torch.models import params_from_jax

WEIGHT_SCALE = 8.0
ARCHS = ("llama3.2-1b", "mistral-large-123b", "deepseek-moe-16b")
LINEAR_MODES = ("int8_spoga", "int8_deas", "int8_direct", "w16a16", "bf16")
# the row-parallel bf16 product sums f32 partials and rounds once; the
# unsharded one rounds its own f32 sum: they differ by at most this many
# bf16 ulps of the largest output
BF16_ULPS = 1
# sharded against unsharded logits at int8_spoga: the row-parallel GEMMs
# sum exact int32 accumulators, the vocab-parallel head gathers columns
LOGIT_TOL = 0.0
PAGED = dict(mode="paged", dtype="bf16", page_size=8)
GEN = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _tree(arch):
    jcfg = jax_reduced(jax_get_config(arch)).with_(remat=False)
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))

    def scale(path, a):
        key = jax.tree_util.keystr(path)
        if "'w" in key or "'experts" in key:
            return (a.astype(np.float32) * WEIGHT_SCALE).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(scale, tree)


def _runtime(mesh=MeshConfig(), **kw):
    return RuntimeConfig(reduced=True, quant=QuantRuntime(mode="int8_spoga"),
                         kv=KVConfig(**{**PAGED, **kw.pop("kv", {})}),
                         scheduler=SchedulerConfig(n_slots=2, **kw.pop("scheduler", {})),
                         mesh=mesh, **kw)


def _cfg(arch):
    return _runtime().resolve_model(tconfigs.reduced(tconfigs.get_config(arch)))


def _prompts(vocab=512, seed=0, n=(5, 13, 3), shared=0):
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, shared).tolist()
    return [pre + rng.integers(0, vocab, k).tolist() for k in n]


@functools.lru_cache(maxsize=None)
def _jax_streams(arch):
    jllm = JaxLLM(arch=arch, params=jax.tree_util.tree_map(jax.numpy.asarray, _tree(arch)),
                  runtime=JaxRuntimeConfig(reduced=True, quant=JaxQuantRuntime(mode="int8_spoga"),
                                           kv=JaxKVConfig(**PAGED),
                                           scheduler=JaxSchedulerConfig(n_slots=2)))
    return [o.token_ids for o in jllm.generate(_prompts(), max_new_tokens=GEN)]


# ---------------------------------------------------------------------------
# What each rank runs
# ---------------------------------------------------------------------------

def _linear_cases(mesh, rank, tp):
    """Row- and column-parallel ``linear`` against the unsharded call."""
    from repro_torch.backends import dynamic_quant, effective_bits, gemm_int
    from repro_torch.backends.pipeline import _global_quant
    from repro_torch.backends.spec import parse_quant_mode
    from repro_torch.models.layers import embed, linear, unembed
    from repro_torch.runtime.collectives import all_reduce, model_parallel

    gen = torch.Generator().manual_seed(0)
    m, k, n = 5, 512, 96
    x = torch.randn((2, m, k), generator=gen).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen) * 0.05).to(torch.bfloat16)
    ks, ns = k // tp, n // tp
    xr, wr = x[..., rank * ks:(rank + 1) * ks], w[rank * ks:(rank + 1) * ks]
    out = {}
    for mode in LINEAR_MODES:
        full = linear(x, w, mode)
        with model_parallel(mesh) as ax:
            row = linear(xr, wr, mode, row=True)
            col = linear(x, w[:, rank * ns:(rank + 1) * ns], mode)
            acc = acc_full = None
            if mode != "bf16":
                spec, _ = parse_quant_mode(mode)
                a_bits, w_bits = effective_bits(spec, k)
                xq, _, wq, _ = _global_quant(xr, wr, a_bits, w_bits, ax)
                acc = all_reduce(gemm_int(xq.to(spec.a_dtype), wq.to(spec.w_dtype),
                                          quant_mode=mode), ax, "sum")
                fxq, _ = dynamic_quant(x, dim=-1, bits=a_bits)
                fwq, _ = dynamic_quant(w, dim=0, bits=w_bits)
                acc_full = gemm_int(fxq.to(spec.a_dtype), fwq.to(spec.w_dtype), quant_mode=mode)
        out[mode] = dict(full=full, row=row, col=col, col_want=full[..., rank * ns:(rank + 1) * ns],
                         acc=acc, acc_full=acc_full)
    # the embedding and the head: vocab-parallel (512 rows divide) and
    # width-parallel (511 rows do not, so the spec shards d_model)
    h = torch.randn((2, 3, 64), generator=gen).to(torch.bfloat16)
    for v in (512, 511):
        table = torch.randn((v, 64), generator=gen).to(torch.bfloat16)
        tokens = torch.randint(0, v, (2, 3), generator=gen)
        mine = (table[rank * v // tp:(rank + 1) * v // tp] if v % tp == 0
                else table[:, rank * 64 // tp:(rank + 1) * 64 // tp])
        with model_parallel(mesh):
            got = (embed(tokens, mine, (v, 64)), unembed(h, mine, (v, 64)))
        out[f"table{v}"] = dict(got=got, want=(embed(tokens, table), unembed(h, table)))
    return out


def _logit_cases(arch, tree, mesh):
    """Prefill and 3 decode steps, sharded against unsharded: the largest
    absolute logit difference of each."""
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.shard import shard_params

    cfg = _cfg(arch)
    full = params_from_jax(tree, cfg, "cpu")
    mine = shard_params(full, mesh, cfg)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, 9)).astype(np.int32))
    want, wcache = prefill(full, cfg, {"tokens": tokens}, 32)
    got, gcache = prefill(mine, cfg, {"tokens": tokens}, 32, mesh=mesh)
    diffs = [float((got - want).abs().max())]
    tok = want.argmax(-1).to(torch.int32)
    for _ in range(3):
        want, wcache = decode_step(full, cfg, tok, wcache)
        got, gcache = decode_step(mine, cfg, tok, gcache, mesh=mesh)
        diffs.append(float((got - want).abs().max()))
        tok = want.argmax(-1).to(torch.int32)
    return diffs


def _invariant_case(tree, dev, mesh_cfg):
    """Admission churn, eviction and defrag at threshold 0.1 over 2 lanes;
    the sharded engine checks its pool and its ranks' tokens every step
    (``debug_invariants``)."""
    kw = dict(kv=dict(n_pages=12), scheduler=dict(prefill_chunk=16, defrag_threshold=0.1))
    prompts = _prompts(n=(13, 5, 17, 9, 21, 3), seed=3)
    cfg = _cfg("llama3.2-1b")
    out = {}
    for name, mc in (("sharded", mesh_cfg), ("unsharded", MeshConfig())):
        obs = ObsConfig(debug_invariants=mc.enabled)
        llm = LLM("llama3.2-1b", runtime=_runtime(mc, obs=obs, **kw),
                  params=params_from_jax(tree, cfg, dev), device=dev)
        eng = llm.build_engine(max(len(p) for p in prompts), 8)
        metrics = eng.run([(i, p, 8) for i, p in enumerate(prompts)])
        eng.store.manager.check_invariants()
        out[name] = [r.output_tokens for r in sorted(metrics.finished, key=lambda r: r.req_id)]
        out[f"{name}_defrags"] = int(eng.metrics.report().get("defrag_count", 0))
        out[f"{name}_pool"] = tuple(eng.store.cache["blocks"][0]["kp"].shape)
    return out


def _rank(rank, dev, tp, trees, with_extras):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(1, tp, backend="gloo", device=dev)
    out = {"streams": {}, "logits": {}}
    for arch, tree in trees.items():
        cfg = _cfg(arch)
        llm = LLM(arch, runtime=_runtime(MeshConfig(tp=tp)),
                  params=params_from_jax(tree, cfg, dev), device=dev)
        out["streams"][arch] = [o.token_ids for o in llm.generate(_prompts(), max_new_tokens=GEN)]
        out["logits"][arch] = _logit_cases(arch, tree, mesh)
        if arch == "llama3.2-1b":
            out["pool"] = tuple(llm.engine.store.cache["blocks"][0]["kp"].shape)
    if with_extras:
        out["linear"] = _linear_cases(mesh, rank, tp)
        out["invariants"] = _invariant_case(trees["llama3.2-1b"], dev, MeshConfig(tp=tp))
    return out


@functools.lru_cache(maxsize=None)
def _results(tp):
    return spawn(_rank, tp, "gloo", device="cpu",
                 args=(tp, {a: _tree(a) for a in ARCHS}, tp == 2))


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", LINEAR_MODES)
def test_row_and_column_parallel_linear_match_unsharded(mode):
    for r, res in enumerate(_results(2)):
        c = res["linear"][mode]
        assert torch.equal(c["col"], c["col_want"]), (mode, r)
        if mode == "bf16":
            ulp = 2.0 ** -7 * float(c["full"].float().abs().max())
            err = float((c["row"].float() - c["full"].float()).abs().max())
            assert err <= BF16_ULPS * ulp, (err, ulp)
        else:
            assert torch.equal(c["acc"], c["acc_full"]), (mode, r)
            assert torch.equal(c["row"], c["full"]), (mode, r)


@pytest.mark.parametrize("vocab", [512, 511])
def test_vocab_and_width_parallel_embedding_and_head(vocab):
    """A vocab-sharded table (the spec when tp divides the vocab) looks up
    and gathers bitwise; a width-sharded one (granite's 49,155 rows) looks
    up bitwise and its head's logits, f32 partials summed and rounded to
    bf16 once, are within one bf16 ulp of the unsharded ones."""
    for res in _results(2):
        c = res["linear"][f"table{vocab}"]
        assert torch.equal(c["got"][0], c["want"][0])
        if vocab % 2 == 0:
            assert torch.equal(c["got"][1], c["want"][1])
        else:
            ulp = 2.0 ** -7 * float(c["want"][1].abs().max())
            assert float((c["got"][1] - c["want"][1]).abs().max()) <= BF16_ULPS * ulp


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_greedy_streams_equal_jax(arch, tp):
    want = _jax_streams(arch)
    assert len({t for s in want for t in s}) > 2, "streams collapsed"
    for res in _results(tp):
        assert res["streams"][arch] == want
        assert max(res["logits"][arch]) <= LOGIT_TOL, res["logits"][arch]


def test_tp_pool_holds_its_kv_heads():
    """Each rank's pool has its KV-head slice of every page (pool_specs)."""
    from repro_torch.models.model import paged_cache_shapes
    from repro_torch.shard import pool_shardings
    cfg = _cfg("llama3.2-1b")
    for tp in (2, 4):
        res = _results(tp)[0]
        n_pages = res["pool"][1]
        want = pool_shardings(paged_cache_shapes(cfg, 2, 24, 8, n_pages),
                              types.SimpleNamespace(shape={"data": 1, "model": tp},
                                                    axis_names=("data", "model")))
        assert res["pool"] == want["blocks"][0]["kp"][0]
        assert res["pool"][-2] == cfg.n_kv_heads // tp


def test_tp_pool_invariants_under_eviction_and_defrag():
    for res in _results(2):
        inv = res["invariants"]
        assert inv["sharded"] == inv["unsharded"]
        assert inv["sharded_defrags"] == inv["unsharded_defrags"] > 0
        assert inv["sharded_pool"][-2] * 2 == inv["unsharded_pool"][-2]


@pytest.mark.parametrize("mode_kw", [
    dict(),
    dict(kv=dict(mode="slot", dtype="bf16", page_size=16)),
    dict(kv=dict(prefix_cache=True), scheduler=dict(prefill_chunk=16), shared=8),
    dict(spec=SpecConfig(enabled=True, k=3, drafter="ngram")),
], ids=["paged", "slot", "paged+prefix", "paged+spec"])
def test_tp1_mesh_bitwise_unsharded(mode_kw):
    """A genuine one-rank mesh (``enable=True`` at tp=1) runs the sharded
    path -- the mesh, ``shard_params``, the model-parallel context -- and
    its greedy outputs are the unsharded engine's in every engine mode."""
    kw = dict(mode_kw)
    shared = kw.pop("shared", 0)
    cfg = _cfg("llama3.2-1b")
    prompts = _prompts(shared=shared)
    outs = {}
    for name, mesh_cfg in (("off", MeshConfig()), ("on", MeshConfig(enable=True))):
        llm = LLM("llama3.2-1b", runtime=_runtime(mesh_cfg, **kw),
                  params=params_from_jax(_tree("llama3.2-1b"), cfg, "cpu"), device="cpu")
        assert (llm.mesh is None) == (name == "off")
        outs[name] = [o.token_ids for o in llm.generate(prompts, max_new_tokens=8)]
    assert outs["on"] == outs["off"]
    assert len({t for s in outs["on"] for t in s}) > 2

