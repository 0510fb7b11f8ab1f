"""The port's SPOGA GEMM layer against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX kernel runs through the Pallas interpreter, as ``test_kernels.py`` runs
it on the CPU.  Integer results are held bitwise; the dequantized GEMM too,
since its epilogue is the same two f32 multiplies in the same order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends.pipeline import quantized_linear as jax_quantized_linear
from repro.core.spoga import direct_matmul as jax_direct_matmul
from repro.kernels.spoga_gemm_dequant import spoga_gemm_dequant as jax_gemm_dequant
from repro_torch.backends import (
    QUANT_MODES,
    effective_bits,
    get_backend,
    parse_quant_mode,
    quantized_linear,
    resolve_backend,
)
from repro_torch.core.slicing import reconstruct_planes, slice_planes
from repro_torch.kernels import spoga_gemm_dequant as gemm_mod
from repro_torch.kernels.spoga_gemm_dequant import spoga_gemm_dequant

# test_kernels.py's SHAPES: tiny, one tile, exact tiles, ragged, the
# paper's DPU shape, multi-tile K
SHAPES = [(8, 16, 8), (128, 128, 128), (256, 512, 256), (130, 257, 100),
          (1, 249, 16), (512, 1024, 256)]

# (n_x, n_w, slice_bits, x dtype, w dtype, x range, w range)
SPECS = {
    "w8a8": (2, 2, 4, np.int8, np.int8, 127, 127),
    "w4a8": (2, 1, 4, np.int8, np.int8, 127, 7),
    "w16a16": (4, 4, 4, np.int16, np.int16, 32767, 32767),
}

MODES = [m for m in QUANT_MODES if m != "bf16"] + ["w8a8_s2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the host's cores; small ops slow down
    when torch's intra-op threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(m, k, n, spec, seed):
    nx, nw, bits, xdt, wdt, xr, wr = SPECS[spec]
    rng = np.random.default_rng(seed)
    x = rng.integers(-xr, xr + 1, (m, k)).astype(xdt)
    w = rng.integers(-wr, wr + 1, (k, n)).astype(wdt)
    xs = rng.uniform(1e-3, 0.1, (m, 1)).astype(np.float32)
    ws = rng.uniform(1e-3, 0.1, (1, n)).astype(np.float32)
    return (nx, nw, bits), (x, w, xs, ws)


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_gemm_dequant_plain_matches_pallas(m, k, n, spec):
    """Bitwise: the port's kernel wrapper on CPU tensors (its plain version)
    against the Pallas kernel body under the interpreter."""
    (nx, nw, bits), ops = _operands(m, k, n, spec, seed=m * k + n)
    want = jax_gemm_dequant(*map(jnp.asarray, ops), n_x_slices=nx,
                            n_w_slices=nw, slice_bits=bits, interpret=True)
    calls = gemm_mod.PLAIN_CALLS
    got = spoga_gemm_dequant(*map(torch.from_numpy, ops), n_x_slices=nx,
                             n_w_slices=nw, slice_bits=bits)
    assert gemm_mod.PLAIN_CALLS == calls + 1  # CPU tensors -> plain version
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", MODES)
def test_int32_accumulators_bitwise(mode):
    """Every CPU backend's int32 accumulator equals the JAX direct_matmul,
    bitwise, on a ragged shape with operands at the mode's widths."""
    spec, _ = parse_quant_mode(mode)
    rng = np.random.default_rng(len(mode))
    m, k, n = 33, 70, 45
    a_bits, w_bits = effective_bits(spec, k)
    xdt = np.int8 if spec.a_bits <= 8 else np.int16
    wdt = np.int8 if spec.w_bits <= 8 else np.int16
    qa, qw = 2 ** (a_bits - 1) - 1, 2 ** (w_bits - 1) - 1
    x = rng.integers(-qa, qa + 1, (m, k)).astype(xdt)
    w = rng.integers(-qw, qw + 1, (k, n)).astype(wdt)
    want = np.asarray(jax_direct_matmul(jnp.asarray(x), jnp.asarray(w)))
    for name in ("torch_spoga", "torch_deas", "direct"):
        got = get_backend(name).gemm(torch.from_numpy(x), torch.from_numpy(w), spec)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{mode} {name}")


def test_int32_wraps_like_the_reference():
    """Past the int32 range the accumulators wrap mod 2^32, as the JAX
    int32 dot does."""
    spec, _ = parse_quant_mode("w16a16")
    x = np.full((2, 64), 32767, np.int16)
    w = np.full((64, 3), 32767, np.int16)
    want = np.asarray(jax_direct_matmul(jnp.asarray(x), jnp.asarray(w)))
    got = get_backend("torch_spoga").gemm(torch.from_numpy(x), torch.from_numpy(w), spec)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_slices,bits", [(2, 4), (1, 4), (4, 4), (4, 2), (3, 3)])
def test_slice_planes_reconstruct(n_slices, bits):
    x = torch.arange(-128, 128, dtype=torch.int8)
    planes = slice_planes(x, n_slices, bits)
    assert torch.equal(reconstruct_planes(planes, bits), x.long())
    for p in planes[:-1]:
        assert int(p.min()) >= 0 and int(p.max()) < 2 ** bits


@pytest.mark.parametrize("mode", ["int8_spoga", "w4a8", "w16a16", "int8_deas", "int8_direct"])
def test_quantized_linear_matches_jax_pipeline(mode):
    """Identical bf16 inputs through both pipelines give identical bf16
    outputs (the JAX one jitted, as the model runs it)."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(2, 5, 96)).astype(np.float32)).astype(jnp.bfloat16)
    w = jnp.asarray(rng.normal(size=(96, 40)).astype(np.float32) * 0.05).astype(jnp.bfloat16)
    want = jax.jit(lambda a, b: jax_quantized_linear(a, b, mode))(x, w)
    want = np.asarray(want.astype(jnp.float32))

    def to_torch(a):
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)

    got = quantized_linear(to_torch(x), to_torch(w), mode)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 5, 40)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_backend_resolution_follows_device():
    """The device alone picks the backend: the CUDA kernel for CUDA tensors,
    a plain twin for CPU tensors, and never a twin for CUDA tensors."""
    assert resolve_backend("int8_spoga", "cuda")[0].name == "cuda_spoga_dequant"
    assert resolve_backend("w16a16", "cuda")[0].name == "cuda_spoga_dequant"
    assert resolve_backend("int8_spoga", "cpu")[0].name == "torch_spoga"
    assert resolve_backend("int8_deas", "cpu")[0].name == "torch_deas"
    assert resolve_backend("int8_direct", "cpu")[0].name == "direct"
    assert resolve_backend("w4a8", "cpu")[0].name == "torch_spoga"
    assert resolve_backend("int8_deas", "cuda")[0].name == "cuda_deas"
    assert resolve_backend("int8_direct", "cuda")[0].name == "cuda_direct"
    for twin in ("torch_spoga", "torch_deas", "direct"):
        with pytest.raises(ValueError):
            resolve_backend("int8_spoga", "cuda", twin)
    with pytest.raises(ValueError):
        resolve_backend("w8a8_s8", "cuda")       # 8-bit planes: not int8
    with pytest.raises(KeyError):
        get_backend("pallas_spoga_dequant")


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((4, 8), dtype=torch.int8)
    w = torch.zeros((8, 3), dtype=torch.int8)
    xs = torch.ones((4, 1))
    ws = torch.ones((1, 3))
    with pytest.raises(TypeError):
        spoga_gemm_dequant(x.float(), w, xs, ws)
    with pytest.raises(ValueError):
        spoga_gemm_dequant(x, w[:7], xs, ws)
    with pytest.raises(ValueError):
        spoga_gemm_dequant(x, w, xs[:3], ws)
    with pytest.raises(TypeError):
        spoga_gemm_dequant(x, w, xs.double(), ws)
    with pytest.raises(ValueError):
        spoga_gemm_dequant(x, w, xs, ws, slice_bits=8)

