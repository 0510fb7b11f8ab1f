"""The port's nibble slicing, the ``encoding=`` dataflows and the kernel
oracles against the reference.

* ``slice_tc`` / ``slice_sm`` / ``slice_nibbles`` / ``reconstruct`` over
  all 256 int8 values, bitwise the reference's (``repro/core/slicing.py``),
  and the reference's dtype and encoding errors;
* ``spoga_matmul`` / ``deas_matmul`` with ``encoding="tc"`` and ``"sm"``,
  int32 bitwise the reference's and ``direct_matmul``;
* ``kernels/ref.py``'s oracles bitwise ``repro/kernels/ref.py``'s (the int8
  product chunked over K too), and the kernels' plain versions (what
  ``spoga_gemm`` / ``spoga_gemm_dequant`` run on CPU tensors) against them.

About 14 s in one process (the reference's graphs, one compile a shape).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.core import slicing as ref_slicing
from repro.core import spoga as ref_spoga
from repro.kernels import ref as ref_oracles
import repro_torch.core as core
from repro_torch.core import slicing, spoga
from repro_torch.kernels import ref as oracles
from repro_torch.kernels import spoga_gemm as spoga_gemm_mod
from repro_torch.kernels import spoga_gemm_dequant as dequant_mod

ALL_INT8 = np.arange(-128, 128, dtype=np.int8)
# (M, K, N): odd shapes, and a K past one oracle chunk at _CHUNK_ELEMS = 2**12
SHAPES = [(1, 7, 3), (5, 33, 7), (16, 300, 24), (8, 1000, 16)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ints(seed, shape, lo=-128, hi=128):
    return np.random.default_rng(seed).integers(lo, hi, shape, dtype=np.int8)


def _np(t):
    return np.asarray(t)


@pytest.mark.parametrize("encoding", ["tc", "sm"])
def test_slices_of_every_int8_equal_reference(encoding):
    msn, lsn = slicing.slice_nibbles(torch.from_numpy(ALL_INT8), encoding)
    rmsn, rlsn = ref_slicing.slice_nibbles(jnp.asarray(ALL_INT8), encoding)
    assert msn.dtype == lsn.dtype == torch.int8
    np.testing.assert_array_equal(msn.numpy(), _np(rmsn))
    np.testing.assert_array_equal(lsn.numpy(), _np(rlsn))
    fn = slicing.slice_tc if encoding == "tc" else slicing.slice_sm
    for a, b in zip(fn(torch.from_numpy(ALL_INT8)), (msn, lsn)):
        assert torch.equal(a, b)
    back = slicing.reconstruct(msn, lsn)
    assert back.dtype == torch.int8
    np.testing.assert_array_equal(back.numpy(), ALL_INT8)
    np.testing.assert_array_equal(back.numpy(), _np(ref_slicing.reconstruct(rmsn, rlsn)))


def test_sign_magnitude_lanes():
    """The paper's +/- lanes: both nibbles carry the operand's sign."""
    x = torch.from_numpy(ALL_INT8)
    msn, lsn = slicing.slice_sm(x)
    sign = torch.sign(x.to(torch.int32))
    assert bool(((msn.to(torch.int32) * sign) >= 0).all())
    assert bool(((lsn.to(torch.int32) * sign) >= 0).all())
    assert int(msn.min()) == -8 and int(lsn.min()) == -15 and int(lsn.max()) == 15


def test_reconstruct_takes_reference_nibble_ranges():
    """``reconstruct`` of every (msn, lsn) pair the two encodings can give,
    equal to the reference's (int8 wrap-around included)."""
    m, l = np.meshgrid(np.arange(-8, 9, dtype=np.int8), np.arange(-15, 16, dtype=np.int8))
    got = slicing.reconstruct(torch.from_numpy(m.copy()), torch.from_numpy(l.copy()))
    np.testing.assert_array_equal(got.numpy(), _np(ref_slicing.reconstruct(m, l)))


@pytest.mark.parametrize("fn", ["slice_tc", "slice_sm"])
def test_wrong_dtype_raises_as_reference(fn):
    x16 = np.zeros(4, np.int16)
    with pytest.raises(TypeError):
        getattr(ref_slicing, fn)(jnp.asarray(x16))
    with pytest.raises(TypeError, match="expects int8"):
        getattr(slicing, fn)(torch.from_numpy(x16))
    with pytest.raises(TypeError):
        slicing.slice_nibbles(torch.zeros(4, dtype=torch.int32), "sm")


def test_unknown_encoding_raises_as_reference():
    x = ALL_INT8[:4]
    with pytest.raises(ValueError, match="unknown slicing encoding"):
        ref_slicing.slice_nibbles(jnp.asarray(x), "xx")
    with pytest.raises(ValueError, match="unknown slicing encoding"):
        slicing.slice_nibbles(torch.from_numpy(x), "xx")
    with pytest.raises(ValueError):
        spoga.spoga_matmul(torch.from_numpy(x[None]), torch.from_numpy(x[:, None]),
                           encoding="xx")


def test_core_exports_the_reference_names():
    assert set(core.__all__) == set(ref_core.__all__)
    for name in core.__all__:
        assert callable(getattr(core, name)), name


@pytest.mark.parametrize("encoding", ["tc", "sm"])
@pytest.mark.parametrize("dataflow", ["spoga_matmul", "deas_matmul"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_encoding_matmuls_equal_reference_and_direct(dataflow, encoding, m, k, n):
    x, w = _ints(m * k, (m, k)), _ints(k * n + 1, (k, n))
    got = getattr(spoga, dataflow)(torch.from_numpy(x), torch.from_numpy(w), encoding=encoding)
    want = getattr(ref_spoga, dataflow)(jnp.asarray(x), jnp.asarray(w), encoding=encoding)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert torch.equal(got, spoga.direct_matmul(torch.from_numpy(x), torch.from_numpy(w)))


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_oracles_equal_reference_oracles(m, k, n, monkeypatch):
    # a small chunk so that the longer K is summed over several chunks
    monkeypatch.setattr(oracles, "_CHUNK_ELEMS", 1 << 12)
    x, w = _ints(m + k, (m, k)), _ints(n + k, (k, n))
    xs = np.random.default_rng(m).uniform(1e-3, 1e-1, (m, 1)).astype(np.float32)
    ws = np.random.default_rng(n).uniform(1e-3, 1e-1, (1, n)).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    for name in ("ref_int8_gemm", "ref_spoga_gemm"):
        got = getattr(oracles, name)(tx, tw)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), _np(getattr(ref_oracles, name)(jx, jw)))
    got = oracles.ref_spoga_gemm_dequant(tx, tw, torch.from_numpy(xs), torch.from_numpy(ws))
    want = ref_oracles.ref_spoga_gemm_dequant(jx, jw, jnp.asarray(xs), jnp.asarray(ws))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_kernel_wrappers_on_cpu_equal_oracles(m, k, n):
    """On CPU tensors the kernel wrappers run their plain versions; both
    must equal the oracles (the card script holds the CUDA kernels to the
    same oracles)."""
    x, w = torch.from_numpy(_ints(2 * m, (m, k))), torch.from_numpy(_ints(3 * n, (k, n)))
    xs = torch.rand((m, 1), generator=torch.Generator().manual_seed(m)) * 0.1
    ws = torch.rand((1, n), generator=torch.Generator().manual_seed(n)) * 0.1
    assert torch.equal(spoga_gemm_mod.spoga_gemm(x, w), oracles.ref_spoga_gemm(x, w))
    assert torch.equal(spoga_gemm_mod.spoga_gemm(x, w), oracles.ref_int8_gemm(x, w))
    assert torch.equal(dequant_mod.spoga_gemm_dequant(x, w, xs, ws),
                       oracles.ref_spoga_gemm_dequant(x, w, xs, ws))


def test_int32_wrap_equals_reference():
    """Past int32 the oracle wraps mod 2^32 like the reference's int32
    accumulator: int16 operands at K = 4 overflow on purpose."""
    x = np.full((2, 4), 32767, np.int16)
    w = np.full((4, 3), 32767, np.int16)
    got = oracles.ref_int8_gemm(torch.from_numpy(x), torch.from_numpy(w))
    want = ref_oracles.ref_int8_gemm(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_array_equal(got.numpy(), _np(want))
