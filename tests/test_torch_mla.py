"""The port's Multi-head Latent Attention against the JAX package.

Each function of the MLA section of ``models/attention.py`` runs on the
reduced minicpm3-4b layer (4 heads, q_lora 64, kv_lora 32, nope 16 + rope
8, v 16) with the JAX ``init_mla`` weights scaled by 8 (so the latents and
scores are not all near zero), on the same random bf16 inputs and latent
caches, made with numpy from a seed, against the reference's jitted
function.  Every written cache leaf is bitwise equal, and so is every
output at ``int8_spoga``.  With bf16 GEMMs an output may differ from the
reference's in at most ``BF16_SHARE`` of its elements, each by at most
one bf16 ulp of the largest (``_out_eq``): XLA's CPU dot widens the bf16
operands to f32 and sums in another order than PyTorch's bf16 matmul
(the residue of ``test_torch_model.py``; ROADMAP queue 3).  The port
writes the caches in place.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import attention as jattn
from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models.weights import _convert

WEIGHT_SCALE = 8.0
PAGE, N_PAGES = 8, 9
TABLES = np.asarray([[5, 2, 7, 1], [3, 8, 4, 6]], np.int32)
MODES = ["bf16", "int8_spoga"]
# bf16 GEMMs: the share of output elements allowed to differ from JAX's
BF16_SHARE = 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the host's cores; small ops slow down
    when torch's intra-op threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(quant_mode):
    jcfg = jax_reduced(jax_get_config("minicpm3-4b")).with_(remat=False, quant_mode=quant_mode)
    tcfg = tconfigs.reduced(tconfigs.get_config("minicpm3-4b")).with_(quant_mode=quant_mode)
    p = jattn.init_mla(jax.random.PRNGKey(0), jcfg)
    p = {k: (v.astype(jnp.float32) * WEIGHT_SCALE).astype(v.dtype) if k.startswith("w_") or
         k == "wo" else v for k, v in p.items()}
    return jcfg, tcfg, p, _convert(jax.tree_util.tree_map(np.asarray, p), "cpu")


def _bf16(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(jnp.bfloat16)


def _port(a):
    return _convert(np.asarray(a), "cpu")


def _eq(got, want, what):
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32),
                                  err_msg=what)


def _out_eq(got, want, quant_mode):
    """Outputs: bitwise at ``int8_spoga``; within the module docstring's
    bf16-GEMM residue otherwise."""
    if quant_mode != "bf16":
        return _eq(got, want, "out")
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=ulp)
    assert (got != want).mean() <= BF16_SHARE


def _latent_pools(rng, cfg):
    m = cfg.mla
    return {"ckvp": _bf16(rng, (N_PAGES, PAGE, m.kv_lora_rank)),
            "krp": _bf16(rng, (N_PAGES, PAGE, m.qk_rope_head_dim))}


@pytest.mark.parametrize("quant_mode", MODES)
def test_mla_block_matches_jax(quant_mode):
    """The non-absorbed prefill of 2 prompts of 16 tokens: output and the
    fresh latents (c_kv, k_rope)."""
    jcfg, tcfg, jp, tp = _setup(quant_mode)
    rng = np.random.default_rng(0)
    x = _bf16(rng, (2, 16, jcfg.d_model))
    positions = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    jout, (jckv, jkr) = jax.jit(lambda x, p, pos: jattn.mla_block(x, p, jcfg, pos))(
        jnp.asarray(x), jp, jnp.asarray(positions))
    tout, (tckv, tkr) = tattn.mla_block(_port(x), tp, tcfg, torch.from_numpy(positions.copy()))
    _out_eq(tout, jout, quant_mode)
    _eq(tckv, jckv, "c_kv")
    _eq(tkr, jkr, "k_rope")


@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("quant_mode", MODES)
def test_mla_decode_and_verify_match_jax(quant_mode, w):
    """Absorbed attention over slot latent caches of 32 rows: one token
    (``mla_decode``) or a 4-row verify window (``mla_verify``, row c
    attending ``pos + c``) per lane, lanes at positions 5 and 27 (the
    window's start clamped so it fits, as ``dynamic_update_slice``
    clamps)."""
    jcfg, tcfg, jp, tp = _setup(quant_mode)
    m = jcfg.mla
    rng = np.random.default_rng(1)
    x = _bf16(rng, (2, w, jcfg.d_model))
    ckv, kr = _bf16(rng, (2, 32, m.kv_lora_rank)), _bf16(rng, (2, 32, m.qk_rope_head_dim))
    pos = np.asarray([5, 27 if w > 1 else 31], np.int32)
    jfn = jattn.mla_decode if w == 1 else jattn.mla_verify
    jout, (jckv, jkr) = jax.jit(lambda x, p, c, k, pos: jfn(x, p, jcfg, c, k, pos))(
        jnp.asarray(x), jp, jnp.asarray(ckv), jnp.asarray(kr), jnp.asarray(pos))
    tckv, tkr = _port(ckv), _port(kr)
    tfn = tattn.mla_decode if w == 1 else tattn.mla_verify
    tout, (nckv, nkr) = tfn(_port(x), tp, tcfg, tckv, tkr, torch.from_numpy(pos))
    assert nckv is tckv and nkr is tkr                   # written in place
    _out_eq(tout, jout, quant_mode)
    _eq(tckv, jckv, "ckv")
    _eq(tkr, jkr, "kr")


@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("quant_mode", MODES)
def test_mla_paged_decode_and_verify_match_jax(quant_mode, w):
    """The gather form over latent page pools (pages out of order, lane 1
    inactive for the decode case so its token goes to the trash page):
    ``mla_paged_decode`` (w=1) and ``mla_paged_verify`` (w=4)."""
    jcfg, tcfg, jp, tp = _setup(quant_mode)
    rng = np.random.default_rng(2)
    x = _bf16(rng, (2, w, jcfg.d_model))
    pools = _latent_pools(rng, jcfg)
    pos = np.asarray([13, 21], np.int32)
    active = np.asarray([True, w > 1])
    jfn = jattn.mla_paged_decode if w == 1 else jattn.mla_paged_verify
    jout, jpools = jax.jit(lambda x, p, c, pos, t, a: jfn(x, p, jcfg, c, pos, t, active=a))(
        jnp.asarray(x), jp, jax.tree_util.tree_map(jnp.asarray, pools), jnp.asarray(pos),
        jnp.asarray(TABLES), jnp.asarray(active))
    tpools = {k: _port(v) for k, v in pools.items()}
    tfn = tattn.mla_paged_decode if w == 1 else tattn.mla_paged_verify
    tout, tnew = tfn(_port(x), tp, tcfg, tpools, torch.from_numpy(pos),
                     torch.from_numpy(TABLES), active=torch.from_numpy(active))
    assert tnew is tpools
    _out_eq(tout, jout, quant_mode)
    for k in pools:
        _eq(tpools[k], jpools[k], k)
    assert not np.array_equal(tpools["ckvp"].float().numpy(), np.asarray(pools["ckvp"],
                                                                          np.float32))


@pytest.mark.parametrize("quant_mode", MODES)
def test_mla_chunk_matches_jax(quant_mode):
    """One 8-row chunk at offset 12 (mid-page) of a lane whose table holds
    pages 5, 2, 7, 1: the latents written, K/V recomputed from the gathered
    latents, the output."""
    jcfg, tcfg, jp, tp = _setup(quant_mode)
    rng = np.random.default_rng(3)
    pools = _latent_pools(rng, jcfg)
    start, cs = 12, 8
    x = _bf16(rng, (1, cs, jcfg.d_model))
    positions = (start + np.arange(cs, dtype=np.int32))[None]
    table = TABLES[:1]
    jout, jpools = jax.jit(lambda x, p, c, t, s, pos: jattn.mla_chunk(
        x, p, jcfg, c, t, s, positions=pos))(
        jnp.asarray(x), jp, jax.tree_util.tree_map(jnp.asarray, pools), jnp.asarray(table),
        jnp.asarray([start], jnp.int32), jnp.asarray(positions))
    tpools = {k: _port(v) for k, v in pools.items()}
    tout, tnew = tattn.mla_chunk(_port(x), tp, tcfg, tpools, torch.from_numpy(table), start,
                                 positions=torch.from_numpy(positions))
    assert tnew is tpools
    _out_eq(tout, jout, quant_mode)
    for k in pools:
        _eq(tpools[k], jpools[k], k)


def test_mla_verify_rows_are_decode_steps():
    """Inside the port, each row of a verify window computes what a decode
    step at its position computes, bitwise (the window's rows attend one
    at a time and its norms reduce column by column)."""
    _, tcfg, _, tp = _setup("int8_spoga")
    m = tcfg.mla
    rng = np.random.default_rng(4)
    x = _port(_bf16(rng, (2, 4, tcfg.d_model)))
    ckv = _port(_bf16(rng, (2, 32, m.kv_lora_rank)))
    kr = _port(_bf16(rng, (2, 32, m.qk_rope_head_dim)))
    pos = torch.tensor([3, 17], dtype=torch.int32)
    vckv, vkr = ckv.clone(), kr.clone()
    vout, _ = tattn.mla_verify(x, tp, tcfg, vckv, vkr, pos)
    for c in range(4):
        out, _ = tattn.mla_decode(x[:, c:c + 1], tp, tcfg, ckv, kr, pos + c)
        assert torch.equal(out[:, 0], vout[:, c]), c
    assert torch.equal(ckv, vckv) and torch.equal(kr, vkr)
