"""The port's routed-expert FFN against the JAX package
(``tests/test_moe.py``'s contracts, on both packages).

The layer is the reduced granite-moe (8 experts, top-2, d_expert 64) or
deepseek-moe (the same plus 2 shared experts) with the JAX ``init_moe``
weights; inputs are bf16 activations made with numpy from a seed, as the
blocks feed the FFN (a normed bf16 hidden state).  Against the reference's
jitted ``moe_ffn`` the output is bitwise equal in every GEMM mode, at high
and at low capacity; the grouped GEMM's int32 accumulators are bitwise
the reference's.  The reference runs eagerly in ``tests/test_moe.py``;
eager JAX rounds some intermediates that its compiled graph keeps in f32,
and the engine runs compiled, so the port is held to the compiled graph.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends import dynamic_quant as jax_dynamic_quant
from repro.backends import parse_quant_mode as jax_parse_quant_mode
from repro.backends.pipeline import effective_bits as jax_effective_bits
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import spoga as jax_spoga
from repro.core.slicing import slice_planes as jax_slice_planes
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.models import moe as tmoe
from repro_torch.models.weights import _convert

INT8_MODES = ["int8_spoga", "int8_deas", "int8_direct"]
# tests/test_moe.py::test_matches_dense_reference_at_high_capacity: the
# sparse dispatch against the dense every-expert reference (bf16 compute)
DENSE_TOL = dict(rtol=5e-2, atol=5e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the host's cores; small ops slow down
    when torch's intra-op threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch="granite-moe-3b-a800m", quant_mode="bf16", capacity_factor=8.0):
    out = []
    for cfg in (jax_reduced(jax_get_config(arch)).with_(remat=False),
                tconfigs.reduced(tconfigs.get_config(arch))):
        moe = dataclasses.replace(cfg.moe, capacity_factor=capacity_factor)
        out.append(cfg.with_(quant_mode=quant_mode, moe=moe))
    return out


def _params(jcfg):
    p = jmoe.init_moe(jax.random.PRNGKey(1), jcfg)
    return p, _convert(jax.tree_util.tree_map(np.asarray, p), "cpu")


def _x(shape=(2, 16), d=128, seed=2):
    x = (np.random.default_rng(seed).normal(size=shape + (d,)) * 0.5).astype(jnp.bfloat16)
    return x, _convert(np.asarray(x), "cpu")


def _np(t):
    return t.float().numpy()


def _jax_moe(jcfg, jp, x):
    out, aux = jax.jit(lambda x, p: jmoe.moe_ffn(x, p, jcfg))(jnp.asarray(x), jp)
    return np.asarray(out.astype(jnp.float32)), float(aux)


@pytest.mark.parametrize("quant_mode", ["bf16", *INT8_MODES, "w4a8"])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-moe-16b"])
def test_moe_ffn_matches_jax(arch, quant_mode):
    """Routing, the per-row sort-based dispatch, the grouped GLU, the
    combine and the shared experts: output bitwise, aux loss equal."""
    jcfg, tcfg = _configs(arch, quant_mode)
    jp, tp = _params(jcfg)
    x, xt = _x()
    want, jaux = _jax_moe(jcfg, jp, x)
    out, aux = tmoe.moe_ffn(xt, tp, tcfg)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(out), want)
    assert float(aux) == jaux


def test_matches_dense_reference_at_high_capacity():
    """With capacity >= S*k no token drops: the sparse dispatch equals the
    dense every-expert reference within bf16 compute, and the port's dense
    reference equals the JAX one within the same tolerance (its combine
    weights come from router logits that XLA sums in another order, so
    they are not bitwise)."""
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg)
    x, xt = _x()
    sparse, _ = tmoe.moe_ffn(xt, tp, tcfg)
    dense = tmoe.moe_ffn_reference(xt, tp, tcfg)
    np.testing.assert_allclose(_np(sparse), _np(dense), **DENSE_TOL)
    jdense = jax.jit(lambda x, p: jmoe.moe_ffn_reference(x, p, jcfg))(jnp.asarray(x), jp)
    np.testing.assert_allclose(_np(dense), np.asarray(jdense.astype(jnp.float32)),
                               **DENSE_TOL)


def test_low_capacity_drops_gracefully():
    """At capacity factor 0.25 pairs drop into the trash row: the output
    stays finite, no larger than at full capacity, and bitwise the JAX
    output (the same pairs dropped)."""
    jcfg, tcfg = _configs(capacity_factor=0.25)
    assert tmoe.capacity(tcfg, 16) == 1
    jp, tp = _params(jcfg)
    x, xt = _x()
    out, aux = tmoe.moe_ffn(xt, tp, tcfg)
    assert torch.isfinite(out.float()).all() and np.isfinite(float(aux))
    full, _ = tmoe.moe_ffn(xt, tp, _configs()[1])
    assert _np(out).__abs__().mean() <= _np(full).__abs__().mean() * 1.5 + 1e-3
    assert not np.array_equal(_np(out), _np(full))
    np.testing.assert_array_equal(_np(out), _jax_moe(jcfg, jp, x)[0])


def test_capacity_is_per_row():
    """Routing is batch-local: permuting batch rows permutes outputs."""
    _, tcfg = _configs()
    _, tp = _params(_configs()[0])
    _, xt = _x()
    out, _ = tmoe.moe_ffn(xt, tp, tcfg)
    swapped, _ = tmoe.moe_ffn(xt.flip(0), tp, tcfg)
    assert torch.equal(swapped, out.flip(0))


def test_capacity_matches_the_reference_formula():
    """``ceil(S * k / E * cf)``, rounded up to a multiple of 128 above 128,
    at the full configs' expert counts."""
    for arch in ("granite-moe-3b-a800m", "deepseek-moe-16b"):
        cfg = tconfigs.get_config(arch)
        m = cfg.moe
        for s in (1, 4, 17, 128, 512, 4096):
            raw = max(1, int(np.ceil(s * m.top_k / m.num_experts * m.capacity_factor)))
            want = raw if raw <= 128 else -(-raw // 128) * 128
            assert tmoe.capacity(cfg, s) == want, (arch, s)


@pytest.mark.parametrize("mode", INT8_MODES)
def test_grouped_int8_modes_agree(mode):
    """Expert GEMMs under the three int8 dataflows are identical."""
    _, tcfg = _configs()
    _, tp = _params(_configs()[0])
    _, xt = _x()
    ref, _ = tmoe.moe_ffn(xt, tp, tcfg.with_(quant_mode="int8_spoga"))
    got, _ = tmoe.moe_ffn(xt, tp, tcfg.with_(quant_mode=mode))
    assert torch.equal(ref, got)


def _jax_grouped_acc(x, w, quant_mode):
    """The reference ``_grouped_matmul``'s int32 accumulator, by its own
    lines (the function returns only the dequantized product)."""
    spec, family = jax_parse_quant_mode(quant_mode)
    a_bits, w_bits = jax_effective_bits(spec, x.shape[-1])
    xq, _ = jax_dynamic_quant(x.astype(jnp.float32), axis=-1, bits=a_bits)
    wq, _ = jax_dynamic_quant(w.astype(jnp.float32), axis=1, bits=w_bits)
    e_axis = x.ndim - 3

    def dot(a, b):
        out = jax.lax.dot_general(a, b, (((a.ndim - 1,), (1,)), ((e_axis,), (0,))),
                                  preferred_element_type=jnp.int32)
        return jnp.moveaxis(out, 0, e_axis)

    if family == "direct":
        return dot(xq, wq)
    return jax_spoga.sliced_dot_planes(
        jax_slice_planes(xq, spec.n_a_slices, spec.slice_bits),
        jax_slice_planes(wq, spec.n_w_slices, spec.slice_bits),
        spec.slice_bits, dot_fn=dot, materialize=(family == "deas"))


@pytest.mark.parametrize("quant_mode", [*INT8_MODES, "w4a8", "w16a16"])
def test_grouped_matmul_int32_matches_jax(quant_mode):
    """The grouped product's int32 accumulators, (B, E, C, K) x (E, K, N)
    with a leading batch dim, bitwise the reference's, and the product
    itself bitwise its ``_grouped_matmul``."""
    jcfg, _ = _configs()
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 8, 6, 128)) * 0.7).astype(jnp.bfloat16)
    xt = _convert(np.asarray(x), "cpu")
    w, wt = jp["experts_up"], tp["experts_up"]
    want = np.asarray(jax.jit(lambda x, w: _jax_grouped_acc(x, w, quant_mode))(
        jnp.asarray(x), w))
    spec, family = tmoe.parse_quant_mode(quant_mode)
    a_bits, w_bits = tmoe.effective_bits(spec, 128)
    xq, _ = tmoe.dynamic_quant(xt.float(), dim=-1, bits=a_bits)
    wq, _ = tmoe.dynamic_quant(wt.float(), dim=1, bits=w_bits)
    acc = tmoe._grouped_int(xq, wq, spec, family)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want)
    jout = jax.jit(lambda x, w: jmoe._grouped_matmul(x, w, quant_mode))(jnp.asarray(x), w)
    np.testing.assert_array_equal(_np(tmoe._grouped_matmul(xt, wt, quant_mode)),
                                  np.asarray(jout.astype(jnp.float32)))


def test_aux_loss_uniform_router_is_one():
    """Uniform routing gives aux == 1 (Switch normalization): a zero router
    makes every probability 1/E."""
    _, tcfg = _configs()
    _, tp = _params(_configs()[0])
    tp["router"] = torch.zeros_like(tp["router"])
    _, xt = _x(shape=(4, 64))
    _, aux = tmoe.moe_ffn(xt, tp, tcfg)
    # equal probabilities: the stable top-k takes experts 0..k-1 for every
    # token, each mean probability is 1/E, so aux = E * (k / E) / k
    assert abs(float(aux) - 1.0) < 1e-6
