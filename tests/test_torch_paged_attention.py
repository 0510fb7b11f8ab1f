"""The port's paged decode attention against the JAX package.

The kernel's plain version is held to the Pallas kernel (run through the
interpreter) and to its gather reference at rtol/atol 2e-5 — the JAX
package's own contract (``test_paging.py``) — for f32, bf16 and int8
pools, at short and 2K-token tables, including stale rows past
``lengths``.  The layer-level ``paged_attention_decode`` is held
to the JAX layer on the same weights and pools, through both the gather
twin (``"gather"`` vs ``"jnp"``) and the kernel route (the wrapper's plain
version vs ``"pallas_interpret"``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jax_attn
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels.paged_attention import (
    paged_attention as jax_paged_attention,
    paged_attention_ref as jax_paged_attention_ref,
)
from repro.models import init_params as jax_init_params
from repro_torch import configs as tconfigs
from repro_torch.kernels import paged_attention as attn_mod
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import attention as tattn
from repro_torch.models import params_from_jax

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the host's cores; small ops slow down
    when torch's intra-op threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16))


def _to_torch(a):
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _pool_case(kind, seed, b=3, hkv=2, g=4, d=32, ps=8, n_pages=16, n_tbl=4,
               lengths=(1, 17, 32)):                 # partial / multi / full
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hkv, g, d)).astype(np.float32)
    tables = (rng.permutation(np.arange(1, n_pages))[:b * n_tbl]
              .reshape(b, n_tbl).astype(np.int32))
    lengths = np.asarray(lengths[:b], np.int32)
    scales = {}
    if kind == "int8":
        kp = rng.integers(-127, 128, (n_pages, ps, hkv, d)).astype(np.int8)
        vp = rng.integers(-127, 128, (n_pages, ps, hkv, d)).astype(np.int8)
        scales = dict(
            k_scale=rng.uniform(0.005, 0.02, (n_pages, ps, hkv)).astype(np.float32),
            v_scale=rng.uniform(0.005, 0.02, (n_pages, ps, hkv)).astype(np.float32))
    else:
        kp = rng.normal(size=(n_pages, ps, hkv, d)).astype(np.float32)
        vp = rng.normal(size=(n_pages, ps, hkv, d)).astype(np.float32)
        if kind == "bf16":
            q, kp, vp = _bf16(q), _bf16(kp), _bf16(vp)
    return q, kp, vp, tables, lengths, scales


# The card's kernel is held to the plain version up to 8K-token tables, so
# the plain version is held to the JAX package at a long table too: 128
# pages of 16 rows, lanes at 1 row, on page edges, and at the table's end.
LONG = dict(b=2, hkv=2, g=4, d=64, ps=16, n_pages=257, n_tbl=128)
POOL_CASES = {"short": {}, "long": dict(LONG, lengths=(1, 2048)),
              "long, page edges": dict(LONG, lengths=(1024, 1041))}


@pytest.mark.parametrize("case", list(POOL_CASES))
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_plain_matches_pallas_kernel(kind, case):
    q, kp, vp, tables, lengths, scales = _pool_case(kind, seed=0, **POOL_CASES[case])
    jargs = [jnp.asarray(a) for a in (q, kp, vp, tables, lengths)]
    jscales = {k: jnp.asarray(v) for k, v in scales.items()}
    want = jax_paged_attention(*jargs, interpret=True, **jscales)
    ref = jax_paged_attention_ref(*jargs, **jscales)
    calls = attn_mod.PLAIN_CALLS
    got = paged_attention(*map(_to_torch, (q, kp, vp, tables, lengths)),
                          **{k: _to_torch(v) for k, v in scales.items()})
    assert attn_mod.PLAIN_CALLS == calls + 1  # CPU tensors -> plain version
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_stale_rows_never_leak(kind):
    """Rows at or past ``lengths`` (stale rows of a partly filled page, a
    page past the length) must not change the output; a valid row must."""
    q, kp, vp, tables, _, scales = _pool_case(kind, seed=1, b=1, n_tbl=2)
    tables = np.asarray([[1, 2]], np.int32)
    length = np.asarray([5], np.int32)            # rows 0..4 of page 1 (ps=8)
    poison = 99 if kind == "int8" else 99.0

    def run(kp_, vp_, lengths):
        args = map(_to_torch, (q, kp_, vp_, tables, lengths))
        return paged_attention(*args, **{k: _to_torch(v) for k, v in scales.items()}).numpy()

    base = run(kp, vp, length)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[1, 5:] = poison
    vp2[1, 5:] = poison
    kp2[2] = -poison
    vp2[2] = -poison
    np.testing.assert_array_equal(run(kp2, vp2, length), base)
    jax_out = jax_paged_attention(
        *map(jnp.asarray, (q, kp2, vp2, tables, length)), interpret=True,
        **{k: jnp.asarray(v) for k, v in scales.items()})
    np.testing.assert_allclose(base, np.asarray(jax_out), **TOL)
    kp3 = kp.copy()
    kp3[1, 4] = poison                            # row 4 < length 5 counts
    assert not np.allclose(run(kp3, vp, length), base)


def _layer_case(kv_dtype, quant_mode, seed=0):
    jcfg = jax_reduced(jax_get_config("llama3.2-1b")).with_(
        remat=False, n_kv_heads=2, kv_cache_dtype=kv_dtype, quant_mode=quant_mode)
    tcfg = tconfigs.reduced(tconfigs.get_config("llama3.2-1b")).with_(
        n_kv_heads=2, kv_cache_dtype=kv_dtype, quant_mode=quant_mode)
    jp = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    layer = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"][0]["attn"])
    tp = params_from_jax(jp, tcfg, "cpu")
    tlayer = {k: v[0] for k, v in tp["blocks"][0]["attn"].items()}

    rng = np.random.default_rng(seed + 1)
    b, hkv, d, ps, n_pages, n_tbl = 3, 2, 32, 8, 12, 4
    x = _bf16(rng.normal(size=(b, 1, jcfg.d_model)).astype(np.float32))
    shp = (n_pages, ps, hkv, d)
    if kv_dtype == "int8":
        cache = {"kp": rng.integers(-127, 128, shp).astype(np.int8),
                 "vp": rng.integers(-127, 128, shp).astype(np.int8),
                 "kp_scale": rng.uniform(0.01, 0.05, shp[:3]).astype(np.float32),
                 "vp_scale": rng.uniform(0.01, 0.05, shp[:3]).astype(np.float32)}
    else:
        cache = {"kp": _bf16(rng.normal(size=shp).astype(np.float32)),
                 "vp": _bf16(rng.normal(size=shp).astype(np.float32))}
    tables = np.asarray([[1, 2, 3, 0], [4, 5, 6, 7], [0, 0, 0, 0]], np.int32)
    pos = np.asarray([9, 27, 0], np.int32)
    active = np.asarray([True, True, False])
    return jcfg, tcfg, layer, tlayer, x, cache, tables, pos, active


@pytest.mark.parametrize("quant_mode", ["bf16", "int8_spoga"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("route", ["gather", "kernel"])
def test_paged_attention_decode_matches_jax(route, kv_dtype, quant_mode, monkeypatch):
    """One decode layer over the same pools and weights: the written rows
    are equal, and the layer output agrees within bf16 rounding (the
    attention sums run in another order).  ``gather`` is held to JAX's
    ``"jnp"`` twin; ``kernel`` (the wrapper, which runs the plain version
    for CPU tensors) to the Pallas kernel under the interpreter."""
    jcfg, tcfg, layer, tlayer, x, cache, tables, pos, active = _layer_case(
        kv_dtype, quant_mode)
    jimpl = "jnp" if route == "gather" else "pallas_interpret"
    want, jcache = jax_attn.paged_attention_decode(
        jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, layer),
        jcfg.with_(paged_attn_impl=jimpl),
        {k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(pos),
        jnp.asarray(tables), active=jnp.asarray(active))
    monkeypatch.setattr(tattn, "_resolve_paged_impl", lambda cfg, dev: route)
    tcache = {k: _to_torch(v) for k, v in cache.items()}
    calls = attn_mod.PLAIN_CALLS
    got, tcache = tattn.paged_attention_decode(
        _to_torch(x), tlayer, tcfg, tcache, _to_torch(pos), _to_torch(tables),
        active=torch.from_numpy(active))
    assert attn_mod.PLAIN_CALLS == calls + (route == "kernel")
    # rows written by active lanes are identical; page 0 is the trash page
    for k in cache:
        j = np.asarray(jcache[k].astype(jnp.float32))[1:]
        t = tcache[k].float().numpy()[1:]
        np.testing.assert_array_equal(t, j, err_msg=k)
    want = np.asarray(want.astype(jnp.float32))[:2]
    got = got.float().numpy()[:2]
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    assert np.abs(got - want).mean() < 2e-3


def test_decode_route_follows_device():
    """CUDA tensors run the kernel, CPU tensors the gather twin; naming the
    twin in the config does not put it on CUDA tensors."""
    tcfg = tconfigs.reduced(tconfigs.get_config("llama3.2-1b"))
    assert tattn._resolve_paged_impl(tcfg, torch.device("cuda")) == "kernel"
    assert tattn._resolve_paged_impl(tcfg, torch.device("cpu")) == "gather"
    gather = tcfg.with_(paged_attn_impl="gather")
    assert tattn._resolve_paged_impl(gather, torch.device("cpu")) == "gather"
    with pytest.raises(ValueError, match="gather"):
        tattn._resolve_paged_impl(gather, torch.device("cuda"))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, kp, vp, tables, lengths, scales = _pool_case("int8", seed=2)
    args = [_to_torch(a) for a in (q, kp, vp, tables, lengths)]
    with pytest.raises(ValueError):
        paged_attention(*args, k_scale=_to_torch(scales["k_scale"]))
    with pytest.raises(ValueError):
        paged_attention(args[0][:, :1], *args[1:], **{k: _to_torch(v) for k, v in scales.items()})
    with pytest.raises(ValueError):
        paged_attention(*args[:3], args[3][:2], args[4])
    with pytest.raises(ValueError):
        paged_attention(*args, k_scale=_to_torch(scales["k_scale"])[:, :2],
                        v_scale=_to_torch(scales["v_scale"]))

