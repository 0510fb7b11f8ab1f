"""The port's quantization substrate against the JAX package:
``quantize`` / ``QTensor`` / ``dequantize``, ``fake_quant`` and the
calibrators (mirrors ``test_quant.py`` and
``test_spoga_core.py::test_jit_and_grad_through_fake_quant``).

Every comparison is bitwise against the *jitted* reference, which divides
by the constant ``qmax`` as a multiply by its reciprocal (the port writes
it so); eager JAX divides and can differ in the last ulp of a scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends.pipeline import dynamic_quant as jax_dynamic_quant
from repro.quant.calibrate import absmax_calibrate as jax_absmax_calibrate
from repro.quant.calibrate import percentile_calibrate as jax_percentile_calibrate
from repro.quant.fake_quant import fake_quant as jax_fake_quant
from repro.quant.qtensor import quantize as jax_quantize
from repro_torch.backends import dynamic_quant
from repro_torch.quant import (
    QTensor,
    absmax_calibrate,
    dequantize,
    fake_quant,
    percentile_calibrate,
    quantize,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the host's cores; small ops slow down
    when torch's intra-op threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_jit_quantize = jax.jit(jax_quantize, static_argnames=("axis", "bits"))
_jit_fake_quant = jax.jit(jax_fake_quant)


def _sample(seed, shape=(37, 129)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * rng.uniform(0.01, 100)).astype(np.float32)


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("axis", [None, -1, 0])
def test_quantize_matches_reference(bits, axis):
    """``quantize`` returns a ``QTensor`` whose data (dtype and values) and
    scale are the reference's, and ``dequantize`` / ``QTensor.dequantize``
    give its values, at 4, 8 and 16 bits, per tensor, per row and per
    column."""
    for seed in range(4):
        x = _sample(seed)
        want = _jit_quantize(jnp.asarray(x), axis=axis, bits=bits)
        got = quantize(torch.from_numpy(x), dim=axis, bits=bits)
        assert isinstance(got, QTensor)
        assert got.dtype == (torch.int8 if bits <= 8 else torch.int16)
        assert got.shape == tuple(want.shape)
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
        deq = jax.jit(lambda q: q.dequantize())(want)
        np.testing.assert_array_equal(dequantize(got).numpy(), np.asarray(deq))
        np.testing.assert_array_equal(got.dequantize(torch.bfloat16).float().numpy(),
                                      np.asarray(want.dequantize(jnp.bfloat16), np.float32))


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_quantize_with_calibrated_scale(bits):
    """A precomputed ``scale`` wins over the absmax, as in the reference:
    values beyond it clip to ±qmax (the 4- and 8-bit codes reach the rail)."""
    x = _sample(5)
    for scale in (np.float32(0.05), np.full((37, 1), 0.3, np.float32),
                  np.abs(_sample(6, (1, 129))) / 50):
        want = jax.jit(lambda a, s: jax_quantize(a, scale=s, bits=bits))(
            jnp.asarray(x), jnp.asarray(scale))
        got = quantize(torch.from_numpy(x), scale=torch.as_tensor(scale), bits=bits)
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
        top = int(np.abs(got.data.numpy().astype(np.int32)).max())
        assert top == 2 ** (bits - 1) - 1 if bits <= 8 else top < 2 ** (bits - 1)


def test_dynamic_quant_keeps_the_reference_tuple():
    """The pipeline's one caller of ``quantize`` unpacks the ``QTensor`` and
    returns the reference's ``(q, scale)``."""
    x = _sample(7)
    q, s = dynamic_quant(torch.from_numpy(x), dim=-1, bits=8)
    jq, js = jax.jit(lambda a: jax_dynamic_quant(a, axis=-1, bits=8))(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_roundtrip_error_bound_and_int8_range():
    """test_quant.py's ``TestQTensor``: the round trip is within half a step
    of the row scale, and int8 codes stay in [-127, 127]."""
    x = torch.from_numpy(_sample(8, (64, 32)))
    q = quantize(x, dim=-1)
    assert ((dequantize(q) - x).abs() <= q.scale * 0.5 + 1e-7).all()
    big = torch.from_numpy(_sample(9, (128,))) * 100
    d = quantize(big).data
    assert d.dtype == torch.int8 and int(d.max()) <= 127 and int(d.min()) >= -127


@pytest.mark.parametrize("seed", range(4))
def test_fake_quant_matches_reference(seed):
    """``fake_quant`` is the jitted reference's bit for bit (row absmax
    scale, ``x + (dq - x)``), and its forward lands on the int8 grid."""
    x = _sample(seed)
    got = fake_quant(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(_jit_fake_quant(jnp.asarray(x))))
    scale = np.abs(x).max(axis=-1, keepdims=True) / 127.0
    codes = got.numpy() / scale
    np.testing.assert_allclose(codes, np.round(codes), atol=1e-3)


def test_fake_quant_gradient_is_identity():
    """Straight-through estimator: d(fake_quant)/dx is exactly 1, and the
    gradient of ``sum(fake_quant(x) ** 2)`` is the reference's jitted
    ``jax.grad`` (test_spoga_core.py::test_jit_and_grad_through_fake_quant)."""
    x = torch.from_numpy(_sample(10, (16,))).requires_grad_(True)
    (g,) = torch.autograd.grad(fake_quant(x).sum(), x)
    assert torch.equal(g, torch.ones_like(g))
    lin = torch.linspace(-1, 1, 64).requires_grad_(True)
    (g2,) = torch.autograd.grad((fake_quant(lin) ** 2).sum(), lin)
    want = jax.jit(jax.grad(lambda v: jnp.sum(jax_fake_quant(v) ** 2)))(
        jnp.asarray(lin.detach().numpy()))
    assert g2.shape == (64,) and torch.isfinite(g2).all()
    np.testing.assert_array_equal(g2.numpy(), np.asarray(want))


def test_absmax_calibrate_matches_reference():
    samples = [_sample(11, (40, 16)), _sample(12, (24, 16))]
    got = absmax_calibrate([torch.from_numpy(s) for s in samples])
    want = jax_absmax_calibrate([jnp.asarray(s) for s in samples])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got_ax = absmax_calibrate([torch.from_numpy(s) for s in samples], dim=0)
    want_ax = jax.jit(lambda a, b: jax_absmax_calibrate([a, b], axis=0))(
        *[jnp.asarray(s) for s in samples])
    np.testing.assert_array_equal(got_ax.numpy(), np.asarray(want_ax))
    np.testing.assert_allclose(
        float(absmax_calibrate([torch.tensor([1.0, -3.0]), torch.tensor([2.0, 0.5])])),
        3.0 / 127.0)


@pytest.mark.parametrize("pct", [99.9, 99.0, 50.0, 37.3])
def test_percentile_calibrate_matches_reference(pct):
    """``percentile_calibrate`` interpolates linearly between order
    statistics, as ``jnp.percentile`` does: bitwise on two batches."""
    x = _sample(13, (3001,))
    samples = [x[:1000], x[1000:]]
    got = percentile_calibrate([torch.from_numpy(s) for s in samples], pct=pct)
    want = jax_percentile_calibrate([jnp.asarray(s) for s in samples], pct=pct)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_percentile_clips_outliers():
    x = torch.cat([torch.ones(999), torch.tensor([1000.0])])
    np.testing.assert_allclose(float(percentile_calibrate([x], pct=99.0)), 1.0 / 127.0,
                               rtol=1e-3)
