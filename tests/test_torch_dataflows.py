"""The paper's three GEMM dataflows in the port against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX kernels run through the Pallas interpreter, as ``test_kernels.py``
runs them on the CPU; the port's wrappers get CPU tensors, so they run
their plain versions.  Integer results are held bitwise, f32 results at
rtol 1e-6 (``test_kernels.py``'s contract for the dequantized GEMM).  The
reduced model is held as ``test_torch_model.py`` holds it: bitwise with 4
KV heads, within LOGIT_TOL of the logits' scale with greedy tokens equal
with 2 (f32 summation order, ROADMAP queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends import gemm_int as jax_gemm_int
from repro.backends import quant_mode_summary as jax_quant_mode_summary
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import spoga as jax_spoga
from repro.kernels.deas_gemm import deas_gemm as jax_deas_gemm
from repro.kernels.ops import int8_gemm as jax_int8_gemm
from repro.kernels.ops import int8_gemm_dequant as jax_int8_gemm_dequant
from repro.kernels.spoga_gemm import spoga_gemm as jax_spoga_gemm
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.paging import PagedCache as JaxPagedCache
from repro_torch import configs as tconfigs
from repro_torch.backends import (
    QUANT_MODES,
    gemm_int,
    get_backend,
    list_backends,
    quant_mode_summary,
    resolve_backend,
)
from repro_torch.core import spoga as tspoga
from repro_torch.kernels import deas_gemm as deas_mod
from repro_torch.kernels import spoga_gemm as spoga_mod
from repro_torch.kernels.deas_gemm import deas_gemm
from repro_torch.kernels.ops import int8_gemm, int8_gemm_dequant
from repro_torch.kernels.spoga_gemm import spoga_gemm
from repro_torch.models import decode_step, params_from_jax, prefill
from repro_torch.paging import PagedCache

# test_kernels.py's SHAPES: tiny, one tile, exact tiles, ragged, the
# paper's DPU shape, multi-tile K
SHAPES = [(8, 16, 8), (128, 128, 128), (256, 512, 256), (130, 257, 100),
          (1, 249, 16), (512, 1024, 256)]
BLOCKS = dict(block_m=128, block_n=128, block_k=128)

# (n_x, n_w, slice_bits, x dtype, w dtype, x bound, w bound): operands in
# [-bound, bound], W8A8 over the full int8 range as test_kernels.py draws it
SPECS = {
    "w8a8": (2, 2, 4, np.int8, np.int8, 128, 128),
    "w4a8": (2, 1, 4, np.int8, np.int8, 127, 7),
    "w16a16": (4, 4, 4, np.int16, np.int16, 32767, 32767),
}
# every shape at W8A8; the narrow and wide specs on the ragged and DPU shapes
SPOGA_CASES = ([(shape, "w8a8") for shape in SHAPES]
               + [(shape, spec) for spec in ("w4a8", "w16a16") for shape in SHAPES[3:5]])


def _ints(rng, lo, hi, shape, dtype):
    return rng.integers(lo, hi + 1, shape).astype(dtype)


def _bounded(rng, bound, shape, dtype):
    return _ints(rng, -bound, min(bound, np.iinfo(dtype).max), shape, dtype)


def _int8_pair(m, k, n, seed):
    """Full-range int8 operands, -128 included (as test_kernels.py draws them)."""
    rng = np.random.default_rng(seed)
    return _ints(rng, -128, 127, (m, k), np.int8), _ints(rng, -128, 127, (k, n), np.int8)


@pytest.mark.parametrize("shape,spec", SPOGA_CASES)
def test_spoga_gemm_matches_pallas(shape, spec):
    """Bitwise: the port's int32 SPOGA kernel wrapper on CPU tensors (its
    plain version) against the Pallas kernel under the interpreter."""
    m, k, n = shape
    nx, nw, bits, xdt, wdt, xb, wb = SPECS[spec]
    rng = np.random.default_rng(m * k + n)
    x = _bounded(rng, xb, (m, k), xdt)
    w = _bounded(rng, wb, (k, n), wdt)
    want = jax_spoga_gemm(jnp.asarray(x), jnp.asarray(w), n_x_slices=nx, n_w_slices=nw,
                          slice_bits=bits, interpret=True, **BLOCKS)
    calls = spoga_mod.PLAIN_CALLS
    got = spoga_gemm(torch.from_numpy(x), torch.from_numpy(w), n_x_slices=nx,
                     n_w_slices=nw, slice_bits=bits)
    assert spoga_mod.PLAIN_CALLS == calls + 1   # CPU tensors -> plain version
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,k,n", SHAPES[:4])
def test_deas_gemm_matches_pallas(m, k, n):
    """Bitwise: the port's DEAS wrapper on CPU tensors against the four
    Pallas nibble GEMMs + the Pallas combine under the interpreter."""
    x, w = _int8_pair(m, k, n, seed=m * 7 + k * 3 + n)
    want = jax_deas_gemm(jnp.asarray(x), jnp.asarray(w), interpret=True, **BLOCKS)
    calls = deas_mod.PLAIN_CALLS, deas_mod.CALLS
    got = deas_gemm(torch.from_numpy(x), torch.from_numpy(w))
    assert (deas_mod.PLAIN_CALLS, deas_mod.CALLS) == (calls[0] + 1, calls[1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_deas_gemm_refuses_what_the_kernels_do_not_take():
    x = torch.zeros((4, 8), dtype=torch.int8)
    with pytest.raises(TypeError):
        deas_gemm(x.to(torch.int16), torch.zeros((8, 3), dtype=torch.int16))
    with pytest.raises(ValueError):
        deas_gemm(x, torch.zeros((7, 3), dtype=torch.int8))
    with pytest.raises(ValueError):
        spoga_gemm(x, torch.zeros((8, 3), dtype=torch.int8), slice_bits=8)


@pytest.mark.parametrize("m,k,n", [(33, 70, 45), (8, 128, 16)])
def test_core_dataflows_match_jax(m, k, n):
    """spoga_matmul, deas_matmul and spoga_dot_slices, bitwise, over the
    full int8 range."""
    x, w = _int8_pair(m, k, n, seed=11 + m)
    x[0, :4] = [-128, 127, -1, 0]
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    want = np.asarray(jax_spoga.direct_matmul(jx, jw))
    for name in ("spoga_matmul", "deas_matmul"):
        j = np.asarray(getattr(jax_spoga, name)(jx, jw))
        t = getattr(tspoga, name)(tx, tw)
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
        np.testing.assert_array_equal(t.numpy(), want, err_msg=name)
    from repro.core.slicing import slice_tc as jax_slice_tc
    from repro_torch.core.slicing import slice_tc
    for a, b in zip(slice_tc(tx), jax_slice_tc(jx)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    j = jax_spoga.spoga_dot_slices(*jax_slice_tc(jx), *jax_slice_tc(jw))
    t = tspoga.spoga_dot_slices(*slice_tc(tx), *slice_tc(tw))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("mode", ["int8_spoga", "int8_deas", "int8_direct"])
@pytest.mark.parametrize("m,k,n", [(32, 64, 16), (33, 70, 45)])
def test_int8_gemm_matches_jax(mode, m, k, n):
    x, w = _int8_pair(m, k, n, seed=3 + m)
    want = np.asarray(jax_int8_gemm(jnp.asarray(x), jnp.asarray(w), mode=mode))
    got = int8_gemm(torch.from_numpy(x), torch.from_numpy(w), mode=mode)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        int8_gemm(torch.from_numpy(x), torch.from_numpy(w), mode="w4a8")


def test_int8_gemm_dequant_matches_jax():
    rng = np.random.default_rng(7)
    x, w = _int8_pair(33, 70, 45, seed=7)
    xs = rng.uniform(1e-3, 0.1, (33, 1)).astype(np.float32)
    ws = rng.uniform(1e-3, 0.1, (1, 45)).astype(np.float32)
    want = np.asarray(jax_int8_gemm_dequant(*map(jnp.asarray, (x, w, xs, ws))))
    got = int8_gemm_dequant(*map(torch.from_numpy, (x, w, xs, ws)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def _quantized_operands(mode, lead, k, n, seed):
    from repro_torch.backends import effective_bits, parse_quant_mode
    spec, _ = parse_quant_mode(mode)
    a_bits, w_bits = effective_bits(spec, k)
    rng = np.random.default_rng(seed)
    qa, qw = 2 ** (a_bits - 1) - 1, 2 ** (w_bits - 1) - 1
    xdt = np.int8 if spec.a_bits <= 8 else np.int16
    wdt = np.int8 if spec.w_bits <= 8 else np.int16
    return _ints(rng, -qa, qa, (*lead, k), xdt), _ints(rng, -qw, qw, (k, n), wdt)


MODES = [m for m in QUANT_MODES if m != "bf16"]
# the port's backends serving each mode on CPU tensors: the auto twin, and
# the CUDA backend whose wrapper runs the plain version
PORT_BACKENDS = {
    "int8_spoga": (None, "cuda_spoga", "cuda_spoga_dequant"),
    "int8_deas": (None, "cuda_deas"),
    "int8_direct": (None, "cuda_direct"),
    "w4a8": (None, "cuda_spoga"),
    "w4a4": (None, "cuda_spoga"),
    "w16a16": (None, "cuda_spoga"),
}


@pytest.mark.parametrize("mode", MODES)
def test_gemm_int_matches_jax(mode):
    """Already-quantized (2, 5, K) @ (K, N), leading dims flattened around
    the backend: every port backend equals the JAX pipeline bitwise."""
    x, w = _quantized_operands(mode, (2, 5), 70, 45, seed=len(mode))
    want = np.asarray(jax_gemm_int(jnp.asarray(x), jnp.asarray(w), quant_mode=mode))
    for backend in PORT_BACKENDS[mode]:
        got = gemm_int(torch.from_numpy(x), torch.from_numpy(w), quant_mode=mode,
                       backend=backend)
        assert got.dtype == torch.int32 and tuple(got.shape) == (2, 5, 45)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(backend))


@pytest.mark.parametrize("mode", ["int8_spoga", "int8_deas", "int8_direct"])
def test_quantized_matmul_matches_jax(mode):
    rng = np.random.default_rng(9)
    x, w = _int8_pair(6, 70, 45, seed=9)
    x = x.reshape(2, 3, 70)
    xs = rng.uniform(1e-3, 0.1, (2, 3, 1)).astype(np.float32)
    ws = rng.uniform(1e-3, 0.1, (45,)).astype(np.float32)
    want = np.asarray(jax_spoga.quantized_matmul(*map(jnp.asarray, (x, w, xs, ws)), mode=mode))
    got = tspoga.quantized_matmul(*map(torch.from_numpy, (x, w, xs, ws)), mode=mode)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 3, 45)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_registry_resolution_order():
    """An explicit backend, else auto by family and device; the CPU twins
    never serve CUDA tensors."""
    assert {"cuda_spoga", "cuda_spoga_dequant", "cuda_deas", "cuda_direct",
            "torch_spoga", "torch_deas", "direct"} <= set(list_backends())
    auto = {("int8_spoga", "cuda"): "cuda_spoga_dequant", ("int8_deas", "cuda"): "cuda_deas",
            ("int8_direct", "cuda"): "cuda_direct", ("w16a16", "cuda"): "cuda_spoga_dequant",
            ("int8_spoga", "cpu"): "torch_spoga", ("int8_deas", "cpu"): "torch_deas",
            ("int8_direct", "cpu"): "direct"}
    for (mode, dev), name in auto.items():
        assert resolve_backend(mode, dev)[0].name == name, (mode, dev)
    # an explicit backend beats auto on either device
    assert resolve_backend("int8_spoga", "cpu", "cuda_spoga")[0].name == "cuda_spoga"
    assert resolve_backend("int8_spoga", "cuda", "cuda_direct")[0].name == "cuda_direct"
    assert resolve_backend("int8_deas", "cuda", "cuda_spoga")[0].name == "cuda_spoga"
    assert resolve_backend("int8_spoga", "cuda", None)[0].name == "cuda_spoga_dequant"
    for twin in ("torch_spoga", "torch_deas", "direct"):
        with pytest.raises(ValueError, match="serves cpu"):
            resolve_backend("int8_spoga", "cuda", backend=twin)
    with pytest.raises(ValueError, match="does not support"):
        resolve_backend("w4a8", "cuda", backend="cuda_deas")      # DEAS is W8A8 only
    with pytest.raises(ValueError, match="does not support"):
        resolve_backend("w16a16", "cpu", backend="cuda_direct")   # int16 operands
    with pytest.raises(KeyError):
        resolve_backend("int8_spoga", "cuda", backend="pallas_spoga")
    with pytest.raises(KeyError):
        resolve_backend("int8_spoga", "cpu", backend="nope")
    for mode in MODES + ["w8a8_s2"]:
        assert quant_mode_summary(mode) == jax_quant_mode_summary(mode)


def test_cuda_backends_reach_their_wrappers_on_cpu_tensors():
    """A cuda_* backend given CPU tensors runs its kernel's plain version."""
    x, w = _int8_pair(4, 64, 8, seed=1)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    calls = spoga_mod.PLAIN_CALLS, deas_mod.PLAIN_CALLS
    gemm_int(tx, tw, quant_mode="int8_spoga", backend="cuda_spoga_dequant")
    gemm_int(tx, tw, quant_mode="int8_deas", backend="cuda_deas")
    assert (spoga_mod.PLAIN_CALLS, deas_mod.PLAIN_CALLS) == (calls[0] + 1, calls[1] + 1)
    assert get_backend("cuda_deas").supports(resolve_backend("int8_deas", "cpu")[1])


def test_int_mm_padding_is_exact():
    """The cuda_direct backend's padding to what torch._int_mm takes (M >
    16, K and N multiples of 8) is exact; here through the CPU _int_mm."""
    from repro_torch.backends.impls import int_mm_padded
    for m, k, n in [(1, 249, 16), (4, 70, 45), (33, 64, 8)]:
        x, w = _int8_pair(m, k, n, seed=m + k)
        got = int_mm_padded(torch.from_numpy(x), torch.from_numpy(w))
        assert tuple(got.shape) == (m, n)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax_spoga.direct_matmul(jnp.asarray(x), jnp.asarray(w))))


# ---------------------------------------------------------------------------
# reduced llama3.2-1b through each dataflow
# ---------------------------------------------------------------------------

WEIGHT_SCALE = 8.0
LOGIT_TOL = 2e-2          # test_torch_model.py's tolerance for 2 KV heads
PROMPTS = (11, 6)
CACHE_LEN, PAGE, SINGLE = 32, 8, 16

# (mode, port gemm_backend, JAX gemm_backend)
DATAFLOWS = [("int8_deas", "cuda_deas", "jnp_deas"),
             ("int8_direct", "cuda_direct", "direct"),
             ("int8_spoga", "cuda_spoga", "jnp_spoga")]


def _scaled_tree(jcfg):
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))

    def scale(path, a):
        if "'w" in jax.tree_util.keystr(path):
            return (a.astype(np.float32) * WEIGHT_SCALE).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(scale, tree)


def _close(got, want, what, exact):
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL * np.abs(want).max(),
                               err_msg=what)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1), err_msg=what)


@pytest.mark.parametrize("n_kv_heads", [4, 2])
@pytest.mark.parametrize("mode,port_backend,jax_backend", DATAFLOWS)
def test_model_dataflows_match_jax(mode, port_backend, jax_backend, n_kv_heads):
    """Prefill per lane into a paged int8 cache, then 4 batched decode
    steps with one idle lane: logits and greedy tokens against JAX."""
    kw = dict(n_kv_heads=n_kv_heads, quant_mode=mode, kv_cache_dtype="int8")
    jcfg = jax_reduced(jax_get_config("llama3.2-1b")).with_(
        remat=False, gemm_backend=jax_backend, **kw)
    tcfg = tconfigs.reduced(tconfigs.get_config("llama3.2-1b")).with_(
        gemm_backend=port_backend, **kw)
    exact = n_kv_heads == 4
    tree = _scaled_tree(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = params_from_jax(tree, tcfg, "cpu")
    rng = np.random.default_rng(n_kv_heads)
    jpool = JaxPagedCache(jcfg, 3, CACHE_LEN, PAGE)
    tpool = PagedCache(tcfg, 3, CACHE_LEN, PAGE, device="cpu")
    first = []
    for lane, n in enumerate(PROMPTS):
        toks = np.zeros((1, SINGLE), np.int32)
        toks[0, :n] = rng.integers(0, jcfg.vocab_size, n)
        lengths = np.asarray([n], np.int32)
        jl, jsingle = jax_prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, SINGLE,
                                  lengths=jnp.asarray(lengths))
        tl, tsingle = prefill(tparams, tcfg, torch.from_numpy(toks), SINGLE,
                              lengths=torch.from_numpy(lengths))
        _close(tl.numpy(), np.asarray(jl), f"{mode} prefill lane {lane}", exact)
        for pool in (jpool, tpool):
            pool.manager.admit(lane, CACHE_LEN)
            ids = pool.manager.alloc(lane, SINGLE // PAGE)
            pool.manager.set_length(lane, n)
        jpool.insert(jsingle, lane, ids, new_len=n)
        tpool.insert(tsingle, lane, ids, new_len=n)
        first.append(int(np.asarray(jl).argmax(-1)[0]))

    tokens = np.asarray(first + [0], np.int32)
    active = np.asarray([True, True, False])
    seen = set(first)
    for step in range(4):
        for pool in (jpool, tpool):
            for lane in range(len(PROMPTS)):
                pool.manager.ensure(lane, int(pool.manager.lengths[lane]) + 1)
            pool.sync_tables()
        jl, jpool.cache = jax_decode_step(jparams, jcfg, jnp.asarray(tokens), jpool.cache,
                                          jnp.asarray(active))
        tl, _ = decode_step(tparams, tcfg, torch.from_numpy(tokens), tpool.cache,
                            torch.from_numpy(active))
        for pool in (jpool, tpool):
            pool.manager.advance(range(len(PROMPTS)))
        jl = np.asarray(jl)[:2]
        _close(tl.numpy()[:2], jl, f"{mode} decode step {step}", exact)
        tokens = np.asarray(list(jl.argmax(-1)) + [0], np.int32)
        seen.update(tokens[:2].tolist())
    assert len(seen) > 2, "greedy streams collapsed"
