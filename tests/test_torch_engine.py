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
    _, tcfg, tree = _setup("int8_spoga", "int8", 4)
    tparams = params_from_jax(tree, tcfg, "cpu")
    for kw in ({"spec": object()}, {"prefix_cache": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 6"):
            ServingEngine(tcfg, tparams, EngineConfig(**{**ENGINE, **kw}), device="cpu")
    from repro_torch.serving import SamplingParams
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SamplingParams(greedy=False)
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
        "import repro_torch.checkpoint, repro_torch.obs\n"
        "import repro_torch.kernels.spoga_gemm_dequant, repro_torch.kernels.paged_attention\n"
        "import repro_torch.kernels.spoga_gemm, repro_torch.kernels.deas_gemm\n"
        "import repro_torch.kernels.ops, repro_torch.core.spoga, repro_torch.backends\n"
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
    """Every module of the port, and the chip smoke script, by their
    import statements (also the ones inside functions).  ``ml_dtypes`` is
    out too: the card's machine does not have it."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for new in ("api/llm.py", "api/config.py", "kernels/spoga_gemm.py",
                "kernels/deas_gemm.py", "kernels/ops.py", "checkpoint/checkpoint.py",
                "paging/prefill.py", "serving/policies.py", "serving/metrics.py",
                "obs/metrics.py"):
        assert ROOT / "src" / "repro_torch" / new in files, new
    for f in files:
        assert not _imported_roots(f) & {"jax", "jaxlib", "repro", "ml_dtypes"}, f
