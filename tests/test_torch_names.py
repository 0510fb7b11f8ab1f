"""The reference's public names, module by module, against the port's.

``test_port_has_every_public_name`` walks ``src/repro/`` and lists every
public name (a module's ``__all__``, else what the module itself defines)
that the port's module at the same relative path lacks.  The list must be
exactly ``MISSING``: names that exist only because of JAX or Pallas, each
with its reason.  Then the small names the port added under the reference's
names are held to the reference: ``serving.FIFOScheduler``,
``layers.init_embedding`` / ``init_rmsnorm`` / ``truncated_normal_init``,
``model.param_shapes`` / ``cache_shapes``,
``kernels.paged_attention.paged_attention_ref`` and the re-exported
constants.  About 14 s in one process (importing every reference module).
"""

import importlib
import inspect
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PALLAS_TILES = ("Pallas BlockSpec tile sizes; the CUDA kernels take no block "
                 "arguments (their tiling is compiled in csrc/spoga_tile.cuh)")

# module -> {name: why the port has no such name}
MISSING = {
    "repro.kernels.spoga_gemm": {
        "spoga_gemm_kernel": "the Pallas kernel body; the port's kernel is "
                             "csrc/spoga_gemm.cu",
        **{n: _PALLAS_TILES for n in ("DEFAULT_BLOCK_M", "DEFAULT_BLOCK_N", "DEFAULT_BLOCK_K")},
    },
    "repro.kernels.spoga_gemm_dequant": {
        n: _PALLAS_TILES for n in ("DEFAULT_BLOCK_M", "DEFAULT_BLOCK_N", "DEFAULT_BLOCK_K")},
    "repro.kernels.deas_gemm": {
        n: _PALLAS_TILES for n in ("DEFAULT_BLOCK_M", "DEFAULT_BLOCK_N", "DEFAULT_BLOCK_K")},
    "repro.spec": {"jitted_verify": "a jax.jit cache of verify_step; the port runs eagerly"},
    "repro.spec.verify": {"jitted_verify": "a jax.jit cache of verify_step; the port runs "
                                           "eagerly"},
    "repro.models.transformer": {
        n: "lax.scan over stacked periods; the port loops over the periods "
           "(transformer.layer_plan)"
        for n in ("scan_periods", "scan_periods_decode", "scan_periods_prefill",
                  "scan_periods_verify")},
    "repro.runtime": {"named": "wraps specs in jax.sharding.NamedSharding; the port "
                               "slices tensors per rank (shard.shard_params)"},
    "repro.runtime.sharding": {
        "named": "wraps specs in jax.sharding.NamedSharding; the port slices tensors "
                 "per rank (shard.shard_params)",
        "constrain_activations": "a GSPMD with_sharding_constraint hint; SPMD ranks hold "
                                 "their shard explicitly",
        "constrain_decode_carry": "a GSPMD with_sharding_constraint hint; SPMD ranks hold "
                                  "their shard explicitly",
        "sp_enter": "GSPMD sequence-parallel resharding hint",
        "sp_exit": "GSPMD sequence-parallel resharding hint",
    },
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _public(mod) -> set:
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n, v in vars(mod).items()
                 if not n.startswith("_") and not inspect.ismodule(v)
                 and getattr(v, "__module__", mod.__name__) == mod.__name__]
    return set(names)


def _reference_modules():
    for path in sorted((ROOT / "src" / "repro").rglob("*.py")):
        parts = list(path.relative_to(ROOT / "src").with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_port_has_every_public_name():
    missing = {}
    for name in _reference_modules():
        ref = importlib.import_module(name)
        try:
            have = set(dir(importlib.import_module("repro_torch" + name[len("repro"):])))
        except ModuleNotFoundError:
            have = set()
        lacks = sorted(n for n in _public(ref) if n not in have)
        if lacks:
            missing[name] = lacks
    assert missing == {m: sorted(names) for m, names in MISSING.items()}
    for names in MISSING.values():
        assert all(why for why in names.values())


# ---------------------------------------------------------------------------
# The small names, held to the reference
# ---------------------------------------------------------------------------

def test_fifo_scheduler_is_the_deprecated_fifo_scheduler():
    from repro.serving import FIFOScheduler as RefFIFO
    from repro_torch.serving import FIFOAdmission, FIFOScheduler, Scheduler

    with pytest.warns(DeprecationWarning, match="FIFOScheduler is deprecated"):
        ref = RefFIFO(3, 2)
    with pytest.warns(DeprecationWarning, match="FIFOScheduler is deprecated"):
        ours = FIFOScheduler(3, 2)
    assert isinstance(ours, Scheduler) and isinstance(ours.admission, FIFOAdmission)
    assert (ours.n_slots, ours.max_prefills_per_step, ours.free_slots) == (
        ref.n_slots, ref.max_prefills_per_step, ref.free_slots)
    assert type(ours.admission).__name__ == type(ref.admission).__name__


def test_init_embedding_and_truncated_normal_follow_the_reference():
    """Other numbers than ``jax.random`` for a seed, the same distribution:
    bf16, within [-2, 2] x scale, the truncated normal's spread."""
    from repro.models import layers as ref_layers
    from repro_torch.models import layers

    vocab, d = 4096, 64
    ours = layers.init_embedding(torch.Generator().manual_seed(0), "cpu", vocab, d).float()
    ref = np.asarray(ref_layers.init_embedding(jax.random.PRNGKey(0), vocab, d), np.float32)
    assert tuple(ours.shape) == ref.shape
    assert layers.init_embedding(None, "meta", vocab, d).dtype == torch.bfloat16
    scale = d ** -0.5
    assert float(ours.abs().max()) <= 2 * scale * (1 + 2 ** -8)
    assert np.abs(ref).max() <= 2 * scale
    assert abs(float(ours.std()) / float(ref.std()) - 1) < 0.02
    assert abs(float(ours.mean())) < 0.01 * scale and abs(ref.mean()) < 0.01 * scale
    t = layers.truncated_normal_init(torch.Generator().manual_seed(1), "cpu", (256, 64),
                                     scale=0.5, dtype=torch.float32)
    r = np.asarray(ref_layers.truncated_normal_init(jax.random.PRNGKey(1), (256, 64), scale=0.5,
                                                    dtype=jnp.float32))
    assert t.dtype == torch.float32 and r.dtype == np.float32
    assert float(t.abs().max()) <= 1.0 and np.abs(r).max() <= 1.0
    assert abs(float(t.std()) / float(r.std()) - 1) < 0.05
    np.testing.assert_array_equal(layers.init_rmsnorm(d).numpy(),
                                  np.asarray(ref_layers.init_rmsnorm(d)))
    assert layers.init_rmsnorm(d).dtype == torch.float32


def test_init_params_draws_the_embedding_first():
    """``init_params`` makes its embedding with ``init_embedding`` from its
    generator's first draws."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import init_params
    from repro_torch.models.layers import init_embedding

    cfg = reduced(get_config("llama3.2-1b"))
    emb = init_embedding(torch.Generator().manual_seed(3), "cpu", cfg.vocab_size, cfg.d_model)
    assert torch.equal(init_params(cfg, seed=3, device="cpu")["embed"], emb)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _leaves(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return flat


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-moe-16b", "recurrentgemma-9b",
                                  "seamless-m4t-large-v2", "minicpm3-4b"])
def test_param_and_cache_shapes_equal_reference(arch):
    from repro.configs import get_config as ref_get_config
    from repro.configs import reduced as ref_reduced
    from repro.models import cache_shapes as ref_cache_shapes
    from repro.models import param_shapes as ref_param_shapes
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import cache_shapes, init_cache, param_shapes

    cfg, rcfg = reduced(get_config(arch)), ref_reduced(ref_get_config(arch))
    ours = [(jax.tree_util.keystr(p), tuple(t.shape), _dtype_name(t.dtype))
            for p, t in _leaves(param_shapes(cfg))]
    ref = [(jax.tree_util.keystr(p), tuple(s.shape), str(s.dtype))
           for p, s in _leaves(ref_param_shapes(rcfg))]
    assert ours == ref
    assert all(t.device.type == "meta" for _, t in _leaves(param_shapes(cfg)))

    cross = 6 if cfg.is_encoder_decoder else 0
    pair = lambda x: (isinstance(x, tuple) and len(x) == 2  # noqa: E731
                      and isinstance(x[1], torch.dtype))
    ours = [(jax.tree_util.keystr(p), tuple(s[0]), _dtype_name(s[1]))
            for p, s in _leaves(cache_shapes(cfg, 2, 16, cross), pair)]
    ref = [(jax.tree_util.keystr(p), tuple(s.shape), str(s.dtype))
           for p, s in _leaves(ref_cache_shapes(rcfg, 2, 16, cross))]
    assert ours == ref
    zeros = [(jax.tree_util.keystr(p), tuple(t.shape), _dtype_name(t.dtype))
             for p, t in _leaves(init_cache(cfg, 2, 16, "cpu", cross))]
    assert zeros == ours


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_paged_attention_ref_matches_reference(kind):
    from repro.kernels.paged_attention import paged_attention_ref as jax_ref
    from repro_torch.kernels import paged_attention as attn_mod
    from repro_torch.kernels import paged_attention_ref

    rng = np.random.default_rng(5)
    b, hkv, g, d, ps, n_pages, n_tbl = 3, 2, 4, 32, 8, 16, 4
    q = rng.normal(size=(b, hkv, g, d)).astype(np.float32)
    tables = rng.permutation(np.arange(1, n_pages))[:b * n_tbl].reshape(b, n_tbl)
    tables = tables.astype(np.int32)
    lengths = np.array([1, 17, 32], np.int32)
    scales = {}
    if kind == "int8":
        kp = rng.integers(-127, 128, (n_pages, ps, hkv, d)).astype(np.int8)
        vp = rng.integers(-127, 128, (n_pages, ps, hkv, d)).astype(np.int8)
        scales = {k: rng.uniform(0.005, 0.02, (n_pages, ps, hkv)).astype(np.float32)
                  for k in ("k_scale", "v_scale")}
    else:
        kp = rng.normal(size=(n_pages, ps, hkv, d)).astype(np.float32)
        vp = rng.normal(size=(n_pages, ps, hkv, d)).astype(np.float32)
    args = (q, kp, vp, tables, lengths)
    want = np.asarray(jax_ref(*map(jnp.asarray, args),
                              **{k: jnp.asarray(v) for k, v in scales.items()}))
    targs = [torch.from_numpy(a) for a in args]
    tscales = {k: torch.from_numpy(v) for k, v in scales.items()}
    calls = attn_mod.PLAIN_CALLS
    got = paged_attention_ref(*targs, **tscales)
    assert attn_mod.PLAIN_CALLS == calls                 # the oracle is not counted
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    assert torch.equal(attn_mod.paged_attention_plain(*targs, **tscales), got)
    assert attn_mod.PLAIN_CALLS == calls + 1


def test_reexports_and_constants_equal_reference():
    import repro.backends as ref_backends
    import repro.paging as ref_paging
    import repro.serving.engine as ref_engine
    import repro_torch.api as api
    import repro_torch.backends as backends
    import repro_torch.kernels as kernels
    import repro_torch.paging as paging
    import repro_torch.prefix as prefix
    import repro_torch.runtime as runtime
    import repro_torch.serving as serving
    from repro_torch.kernels import ops
    from repro_torch.runtime import sharding
    from repro_torch.serving import engine, policies

    assert backends.FAMILIES == ref_backends.FAMILIES
    assert paging.CHUNKABLE_KINDS == ref_paging.CHUNKABLE_KINDS
    assert paging.STATEFUL_CHUNK_KINDS == ref_paging.STATEFUL_CHUNK_KINDS
    assert engine.PAGED_KINDS == ref_engine.PAGED_KINDS
    for name in ("AdmissionPolicy", "DefragPolicy", "EvictionPolicy", "PrefixPolicy",
                 "ThresholdDefrag", "NoPrefixReuse", "DeadlineAdmission"):
        assert getattr(api, name) is getattr(policies, name), name
    assert serving.PagedCache is paging.PagedCache and serving.PageManager is paging.PageManager
    assert serving.PrefixCache is prefix.PrefixCache and serving.PrefixTree is prefix.PrefixTree
    assert kernels.int8_gemm is ops.int8_gemm and kernels.int8_gemm_dequant is ops.int8_gemm_dequant
    for name in ("param_specs", "batch_pspec", "cache_specs", "opt_state_specs", "data_axes"):
        assert getattr(runtime, name) is getattr(sharding, name), name
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        import repro_torch.kernels.spoga_gemm as spoga_gemm_mod  # the module, not the function
    assert inspect.ismodule(spoga_gemm_mod) and inspect.ismodule(kernels.paged_attention)
