"""The port's serving engine against the JAX engine, and the port's imports.

Both engines serve the same weights (the JAX ``init_params`` tree with its
projection weights scaled up, so that greedy decoding does not collapse
onto one repeated token) in paged mode, with the arrivals of
``test_serving.py::test_engine_matches_solo_staggered``: unequal prompts,
staggered, more requests than lanes.  Greedy streams must be equal, and
each equals the port's own solo run of that request.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch import configs as tconfigs
from repro_torch.kernels import paged_attention as attn_mod
from repro_torch.kernels import spoga_gemm_dequant as gemm_mod
from repro_torch.models import params_from_jax
from repro_torch.serving import EngineConfig, ServingEngine

ROOT = Path(__file__).resolve().parents[1]
WEIGHT_SCALE = 8.0
ENGINE = dict(n_slots=2, cache_len=32, prefill_buckets=(8, 16), cache_mode="paged",
              page_size=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the host's cores; small ops slow down
    when torch's intra-op threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrivals(vocab):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, n).tolist() for n in (5, 9, 3, 7)]
    gens = [6, 4, 8, 5]
    return [(0, prompts[0], gens[0]), (0, prompts[1], gens[1]),
            (2, prompts[2], gens[2]), (4, prompts[3], gens[3])]


def _setup(quant_mode, kv_dtype, n_kv_heads):
    kw = dict(quant_mode=quant_mode, kv_cache_dtype=kv_dtype, n_kv_heads=n_kv_heads)
    jcfg = jax_reduced(jax_get_config("llama3.2-1b")).with_(remat=False, **kw)
    tcfg = tconfigs.reduced(tconfigs.get_config("llama3.2-1b")).with_(**kw)
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))

    def scale(path, a):
        if "'w" in jax.tree_util.keystr(path):
            return (a.astype(np.float32) * WEIGHT_SCALE).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(scale, tree)
    return jcfg, tcfg, tree


def _streams(metrics):
    return {r.req_id: r.output_tokens for r in metrics.finished}


@pytest.mark.parametrize("quant_mode,kv_dtype,n_kv_heads", [
    ("int8_spoga", "int8", 4),
    ("int8_spoga", "bf16", 2),
    ("bf16", "int8", 2),
])
def test_engine_matches_jax_engine_and_solo(quant_mode, kv_dtype, n_kv_heads):
    jcfg, tcfg, tree = _setup(quant_mode, kv_dtype, n_kv_heads)
    arrivals = _arrivals(jcfg.vocab_size)

    jeng = JaxServingEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                            JaxEngineConfig(**ENGINE))
    want = _streams(jeng.run(arrivals))

    tparams = params_from_jax(tree, tcfg, "cpu")
    teng = ServingEngine(tcfg, tparams, EngineConfig(**ENGINE), device="cpu")
    launches = gemm_mod.LAUNCHES, attn_mod.LAUNCHES
    metrics = teng.run(arrivals)
    # CPU tensors never reach a CUDA kernel
    assert (gemm_mod.LAUNCHES, attn_mod.LAUNCHES) == launches
    got = _streams(metrics)
    assert got == want
    assert len({t for s in got.values() for t in s}) > 2, "streams collapsed"

    rep = metrics.report()
    assert rep["requests"] == 4 and rep["prefills"] == 4
    assert rep["generated_tokens"] == sum(a[2] for a in arrivals)
    assert rep["peak_running"] == 2
    mgr = teng.store.manager
    assert mgr.pages_in_use == 0 and not mgr.invariant_violations()

    for rid, (_, prompt, gen) in enumerate(arrivals):
        solo = ServingEngine(tcfg, tparams, EngineConfig(**{**ENGINE, "n_slots": 1}),
                             device="cpu")
        assert _streams(solo.run([(0, prompt, gen)]))[0] == got[rid], rid


# the new archs' cache mechanisms: MLA latent pages, MoE over GQA pages,
# MoE with a lead dense layer (``head_blocks``)
ARCHS = ["minicpm3-4b", "granite-moe-3b-a800m", "deepseek-moe-16b"]


def _arch_setup(arch, kv_dtype):
    """Reduced ``arch`` at ``int8_spoga`` in both packages, on the JAX tree
    with its projection and expert weights scaled up."""
    kw = dict(quant_mode="int8_spoga", kv_cache_dtype=kv_dtype)
    jcfg = jax_reduced(jax_get_config(arch)).with_(remat=False, **kw)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch)).with_(**kw)
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))

    def scale(path, a):
        key = jax.tree_util.keystr(path)
        if "'w" in key or "'experts" in key:
            return (a.astype(np.float32) * WEIGHT_SCALE).astype(a.dtype)
        return a

    return jcfg, tcfg, jax.tree_util.tree_map_with_path(scale, tree)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_archs_match_jax_engine_and_solo(arch, kv_dtype):
    """``test_serving.py::test_engine_paged_matches_solo`` for the MLA and
    MoE archs: the paged engine's greedy streams (staggered requests, more
    than lanes, bucketed prefills whose pad tokens route through the
    experts) equal the JAX engine's and each request's solo run, bitwise;
    the latent pools are bf16 whatever ``kv_cache_dtype`` says."""
    jcfg, tcfg, tree = _arch_setup(arch, kv_dtype)
    arrivals = _arrivals(jcfg.vocab_size)
    jeng = JaxServingEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                            JaxEngineConfig(**ENGINE))
    want = _streams(jeng.run(arrivals))
    tparams = params_from_jax(tree, tcfg, "cpu")
    teng = ServingEngine(tcfg, tparams, EngineConfig(**ENGINE), device="cpu")
    pools = {k: v.dtype for blk in teng.store.cache["blocks"] for k, v in blk.items()}
    if arch == "minicpm3-4b":
        assert pools == {"ckvp": torch.bfloat16, "krp": torch.bfloat16}
    got = _streams(teng.run(arrivals))
    assert got == want
    assert len({t for s in got.values() for t in s}) > 2, "streams collapsed"
    assert teng.store.manager.pages_in_use == 0
    for rid, (_, prompt, gen) in enumerate(arrivals):
        solo = ServingEngine(tcfg, tparams, EngineConfig(**{**ENGINE, "n_slots": 1}),
                             device="cpu")
        assert _streams(solo.run([(0, prompt, gen)]))[0] == got[rid], rid


def test_engine_refuses_chunking_prefix_and_spec_on_moe():
    """A routed FFN's capacity depends on how many tokens share a dispatch,
    so a MoE stack refuses chunked prefill, the prefix cache and
    speculation with the reference's ``ValueError`` (``test_serving.py``,
    ``test_prefix.py``, ``test_spec.py``)."""
    from repro_torch.spec import SpecConfig

    _, tcfg, tree = _arch_setup("granite-moe-3b-a800m", "bf16")
    tparams = params_from_jax(tree, tcfg, "cpu")
    paged = dict(cache_mode="paged", page_size=8)
    for kw, match in (({**paged, "prefill_chunk": 8}, "chunk"),
                      ({**paged, "prefix_cache": True}, "row-independent"),
                      ({"spec": SpecConfig(enabled=True, k=4)}, "row-independent")):
        with pytest.raises(ValueError, match=match):
            ServingEngine(tcfg, tparams, EngineConfig(**kw), device="cpu")


# the recurrent archs: per-lane cell states (xLSTM) and RG-LRU states with
# local-attention rings (recurrentgemma), in both cache modes
RECURRENT = ["xlstm-125m", "recurrentgemma-9b"]


def _recurrent_setup(arch, quant_mode):
    kw = dict(quant_mode=quant_mode,
              kv_cache_dtype="int8" if quant_mode == "int8_spoga" else "bf16")
    jcfg = jax_reduced(jax_get_config(arch)).with_(remat=False, **kw)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch)).with_(**kw)
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))

    def scale(path, a):
        if "'w" in jax.tree_util.keystr(path):
            return (a.astype(np.float32) * WEIGHT_SCALE).astype(a.dtype)
        return a

    return jcfg, tcfg, jax.tree_util.tree_map_with_path(scale, tree)


@pytest.mark.parametrize("arch", RECURRENT)
def test_engine_refuses_buckets_chunking_prefix_and_spec_on_recurrent(arch):
    """The reference's ``ValueError``s, message for message: prefill
    buckets on a recurrent stack, chunked prefill on recurrentgemma (its
    rings), a ring stack's paged cache_len off the page size, the prefix
    cache and speculation on both."""
    from repro.spec import SpecConfig as JaxSpecConfig
    from repro_torch.spec import SpecConfig

    jcfg, tcfg, tree = _recurrent_setup(arch, "bf16")
    tparams = params_from_jax(tree, tcfg, "cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    paged = dict(cache_mode="paged", page_size=8, cache_len=32)
    cases = [dict(prefill_buckets=(8, 16)),
             {**paged, "prefix_cache": True, "prefill_chunk": 8},
             {"spec": "on"}]
    if arch == "recurrentgemma-9b":
        cases += [{**paged, "prefill_chunk": 8}, {**paged, "cache_len": 36}]
    for kw in cases:
        spec = kw.pop("spec", None)
        with pytest.raises(ValueError) as jerr:
            JaxServingEngine(jcfg, jparams, JaxEngineConfig(
                **kw, spec=JaxSpecConfig(enabled=True, k=4) if spec else None))
        with pytest.raises(ValueError) as terr:
            ServingEngine(tcfg, tparams, EngineConfig(
                **kw, spec=SpecConfig(enabled=True, k=4) if spec else None), device="cpu")
        assert str(terr.value) == str(jerr.value), kw


def test_engine_evicts_on_eos():
    """A request stops at its EOS token, before its budget, and frees its
    lane and pages the same step."""
    _, tcfg, tree = _setup("int8_spoga", "int8", 4)
    tparams = params_from_jax(tree, tcfg, "cpu")
    arrivals = _arrivals(tcfg.vocab_size)
    full = _streams(ServingEngine(tcfg, tparams, EngineConfig(**ENGINE), device="cpu")
                    .run(arrivals))
    eos = full[2][3]                                  # request 2's fourth token
    eng = ServingEngine(tcfg, tparams, EngineConfig(**ENGINE, eos_token=eos), device="cpu")
    got = _streams(eng.run(arrivals))
    for rid, stream in full.items():
        cut = stream.index(eos) + 1 if eos in stream else len(stream)
        assert got[rid] == stream[:cut], rid
    assert len(got[2]) <= 4 < arrivals[2][2]
    assert eng.store.manager.pages_in_use == 0


def test_engine_refuses_what_is_not_ported():
    """A ``mesh`` that is not a ``launch.mesh.Mesh`` is refused (meshes are
    served since distribution was ported); observability, the prefix
    cache, speculation and stochastic sampling are served."""
    _, tcfg, tree = _setup("int8_spoga", "int8", 4)
    tparams = params_from_jax(tree, tcfg, "cpu")
    with pytest.raises(TypeError, match="mesh must be a repro_torch.launch.mesh.Mesh"):
        ServingEngine(tcfg, tparams, EngineConfig(**ENGINE), device="cpu", mesh=object())
    from repro_torch.obs import ObsConfig
    obs = ObsConfig(enabled=True).build()
    assert ServingEngine(tcfg, tparams, EngineConfig(**ENGINE), device="cpu",
                         obs=obs).obs is obs
    from repro_torch.serving import SamplingParams
    from repro_torch.spec import SpecConfig
    assert not SamplingParams(greedy=False).greedy
    served = ServingEngine(tcfg, tparams, EngineConfig(
        **{**ENGINE, "prefix_cache": True, "spec": SpecConfig(enabled=True)}), device="cpu")
    assert served.prefix is not None and served._drafter is not None
    eng = ServingEngine(tcfg, tparams, EngineConfig(**ENGINE), device="cpu")
    with pytest.raises(ValueError):
        eng.add_request([1, 2, 3], max_new_tokens=64)   # past cache_len
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServingEngine(tcfg, tparams, EngineConfig(**ENGINE))


def test_port_imports_no_jax_and_nothing_of_repro():
    """Loading the port's facade, serving stack and kernels pulls in no
    ``jax*`` module and no module of the JAX package."""
    code = (
        "import sys\n"
        "import repro_torch.serving, repro_torch.models, repro_torch.paging, repro_torch.api\n"
        "import repro_torch.checkpoint, repro_torch.obs, repro_torch.obs.replay\n"
        "import repro_torch.launch.replay\n"
        "import repro_torch.kernels.spoga_gemm_dequant, repro_torch.kernels.paged_attention\n"
        "import repro_torch.kernels.spoga_gemm, repro_torch.kernels.deas_gemm\n"
        "import repro_torch.kernels.ops, repro_torch.core.spoga, repro_torch.backends\n"
        "import repro_torch.spec, repro_torch.spec.draft_model, repro_torch.prefix\n"
        "import repro_torch.quant, repro_torch.optim, repro_torch.data, repro_torch.runtime\n"
        "import repro_torch.launch.steps, repro_torch.launch.train, repro_torch.tree\n"
        "import repro_torch.launch.dryrun, repro_torch.runtime.counters\n"
        "import repro_torch.launch.serve, repro_torch.kernels.ref, repro_torch.core\n"
        "import repro_torch.core.photonic_model, repro_torch.core.energy_model\n"
        "import repro_torch.core.workloads, repro_torch.core.accelerator_sim\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro',\n"
        "                                                      'ml_dtypes'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src"),
                                         "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def _imported_roots(path: Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_of_the_port_names_jax_or_repro():
    """Every module of the port, the chip smoke script and the port's
    examples (``examples/torch_*.py``), by their import statements (also
    the ones inside functions).  ``ml_dtypes`` is out too: the card's
    machine does not have it."""
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(examples) == 6, examples
    files = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + examples)
    assert len(files) > 20
    for new in ("api/llm.py", "api/config.py", "kernels/spoga_gemm.py",
                "kernels/deas_gemm.py", "kernels/ops.py", "checkpoint/checkpoint.py",
                "paging/prefill.py", "serving/policies.py", "serving/metrics.py",
                "obs/metrics.py", "obs/trace.py", "obs/events.py", "obs/profile.py",
                "obs/config.py", "obs/server.py", "obs/watchdog.py", "obs/recorder.py",
                "obs/replay.py", "launch/replay.py", "spec/config.py", "spec/verify.py",
                "spec/ngram.py", "spec/draft_model.py", "prefix/tree.py", "prefix/cache.py", "models/moe.py",
                "configs/minicpm3_4b.py", "configs/deepseek_moe_16b.py",
                "launch/serve.py", "kernels/ref.py", "core/photonic_model.py",
                "core/energy_model.py", "core/workloads.py", "core/accelerator_sim.py"):
        assert ROOT / "src" / "repro_torch" / new in files, new
    for f in files:
        assert not _imported_roots(f) & {"jax", "jaxlib", "repro", "ml_dtypes"}, f
