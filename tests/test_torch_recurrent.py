"""The recurrent cells and the local-attention ring of the port against
the JAX package.

``models/recurrent.py`` (RG-LRU, mLSTM, sLSTM: the full-sequence blocks,
the chunked-prefill cells and the decode steps), the conv helpers of
``models/layers.py``, the windowed paths of ``models/attention.py`` (the
key band of ``multihead_attention`` and the decode ring) and the ring of
``models/transformer.apply_block_prefill`` are held against the reference
module at the same relative path, each jitted, on the same inputs: the
reduced configs of ``recurrentgemma-9b`` (7 layers, d 128, window 32, lru
128) and ``xlstm-125m`` (8 layers, d 128, 4 heads), weights from the
reference's ``init_*`` with their projections scaled by 8, inputs from
numpy seeds.

Tolerances, and their cause (ROADMAP queue 3):

* the associative scan (``rglru_scan_coeffs``) and ``xla_cumsum`` are
  bitwise: the port adds in XLA's order, the scan's combine as one fused
  multiply-add as XLA:CPU contracts it;
* every f32 quantity that passes through a transcendental function or a
  contraction (the RG-LRU coefficients, the cells' states) differs from
  XLA's by a few ulps: XLA's CPU ``exp``, ``tanh``, ``log1p`` and logistic
  are its own approximations, and its dots sum in another order than
  PyTorch's.  Within ``F32_TOL`` of the largest magnitude;
* bf16 outputs (a block's output rows) then differ where that residue
  crosses a bf16 rounding: at most ``BF16_ULPS`` bf16 ulps of the largest
  magnitude.  With bf16 GEMMs the projections themselves differ by that
  much (XLA's dot order), and every state computed from them carries it:
  at ``quant_mode="bf16"`` the states are held to ``BF16_ULPS`` too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import attention as jattn
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models import recurrent as jrec
from repro.models.kvcache import block_cache_shape as jax_block_cache_shape
from repro.models.layers import causal_conv1d as jax_causal_conv1d
from repro.models.layers import conv1d_decode as jax_conv1d_decode
from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models import decode_step, params_from_jax, prefill
from repro_torch.models import recurrent as trec
from repro_torch.models.layers import causal_conv1d, conv1d_decode
from repro_torch.models.weights import _convert

WEIGHT_SCALE = 8.0
# f32 residue of XLA's transcendental functions and dot order, relative to
# the largest magnitude (see the docstring)
F32_TOL = 2e-5
# bf16 outputs: bf16 ulps of the largest magnitude
BF16_ULPS = 1
# logits, relative to their largest magnitude (test_torch_archs.LOGIT_TOL)
LOGIT_TOL = 2e-2
QUANT_MODES = ["bf16", "int8_spoga"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the host's cores; small ops slow down
    when torch's intra-op threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, quant_mode="bf16", kv_dtype="bf16"):
    kw = dict(quant_mode=quant_mode, kv_cache_dtype=kv_dtype)
    return (jax_reduced(jax_get_config(arch)).with_(remat=False, **kw),
            tconfigs.reduced(tconfigs.get_config(arch)).with_(**kw))


def _scaled(tree):
    def scale(path, a):
        a = np.asarray(a)
        if "'w" in jax.tree_util.keystr(path):
            return (a.astype(np.float32) * WEIGHT_SCALE).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(scale, tree)


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _to_port(a):
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _state_close(got, want, key, quant_mode, err_msg=""):
    """A cell state's leaf: RG-LRU's ``conv`` holds raw branch rows, bf16
    values of a projection (BF16_ULPS), as does every leaf computed from
    bf16 GEMMs; at ``int8_spoga`` the others are f32 math (F32_TOL)."""
    close = _bf16_close if key == "conv" or quant_mode == "bf16" else _f32_close
    close(got, want, err_msg=f"{key} {err_msg}")


def _f32_close(got, want, err_msg=""):
    want = _jnp(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=F32_TOL * max(np.abs(want).max(), 1e-30), err_msg=err_msg)


def _bf16_close(got, want, err_msg=""):
    want = _jnp(want).astype(np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=BF16_ULPS * ulp, err_msg=err_msg)


# ---------------------------------------------------------------------------
# The scan and the cumsum, in XLA's order: bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 2, 7, 64, 257])
def test_rglru_scan_coeffs_is_bitwise_the_jitted_scan(s):
    """``jax.lax.associative_scan`` over the RG-LRU combine, with a carried
    state folded into the first step: the port's mirror of its recursion,
    the combine as one fused multiply-add, gives the same bits."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.9, 0.999, (2, s, 64)).astype(np.float32)
    b = rng.standard_normal((2, s, 64)).astype(np.float32)
    h0 = rng.standard_normal((2, 64)).astype(np.float32)
    jh, jlast = jax.jit(jrec.rglru_scan_coeffs)(a, b, h0)
    th, tlast = trec.rglru_scan_coeffs(*map(torch.from_numpy, (a, b, h0)))
    np.testing.assert_array_equal(_np(th), np.asarray(jh))
    np.testing.assert_array_equal(_np(tlast), np.asarray(jlast))


@pytest.mark.parametrize("n", [1, 5, 16, 37, 256])
def test_xla_cumsum_is_bitwise_the_jitted_cumsum(n):
    """The mLSTM's ``jnp.cumsum`` of the log forget gates, compiled: XLA
    folds tiles of 16 and offsets them by the earlier tiles' totals;
    ``torch.cumsum`` adds in another order."""
    x = (np.random.default_rng(n).standard_normal((2, 4, n)) * 0.3 - 1).astype(np.float32)
    want = np.asarray(jax.jit(lambda t: jnp.cumsum(t, axis=-1))(x))
    np.testing.assert_array_equal(_np(trec.xla_cumsum(torch.from_numpy(x))), want)


def test_conv_helpers_are_bitwise():
    """``causal_conv1d`` (bf16 in, f32 taps, bf16 out) and ``conv1d_decode``
    (f32 state) against the reference's, bitwise."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 21, 64)).astype(jnp.bfloat16)
    w = (rng.standard_normal((4, 64)) * 0.1).astype(jnp.bfloat16)
    want = jax.jit(jax_causal_conv1d)(jnp.asarray(x), jnp.asarray(w))
    got = causal_conv1d(_to_port(x), _to_port(w))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _jnp(want))
    state = rng.standard_normal((2, 3, 64)).astype(np.float32)
    jy, jstate = jax.jit(jax_conv1d_decode)(jnp.asarray(x[:, 0]), jnp.asarray(state),
                                            jnp.asarray(w))
    ty, tstate = conv1d_decode(_to_port(x[:, 0]), torch.from_numpy(state), _to_port(w))
    np.testing.assert_array_equal(_np(ty), _jnp(jy))
    np.testing.assert_array_equal(_np(tstate), _jnp(jstate))


@pytest.mark.parametrize("quant_mode", QUANT_MODES)
def test_rglru_scan_matches_jax(quant_mode):
    """``rglru_scan`` with its coefficients (the gates' projections, the
    logistic, softplus and exp): the scan is bitwise, the coefficients
    carry XLA's transcendental residue (F32_TOL)."""
    jcfg, _ = _configs("recurrentgemma-9b", quant_mode)
    jp = _scaled(jrec.init_rglru(jax.random.PRNGKey(1), jcfg))
    tp = _convert(jp, "cpu")
    rng = np.random.default_rng(2)
    xb = rng.standard_normal((2, 37, jcfg.lru_width)).astype(jnp.bfloat16)
    h0 = rng.standard_normal((2, jcfg.lru_width)).astype(np.float32)
    jh, jlast = jax.jit(lambda x, p, h: jrec.rglru_scan(x, p, quant_mode, h))(
        jnp.asarray(xb), jp, h0)
    th, tlast = trec.rglru_scan(_to_port(xb), tp, quant_mode, torch.from_numpy(h0))
    _f32_close(th, jh)
    _f32_close(tlast, jlast)


# ---------------------------------------------------------------------------
# The cells: *_block, *_chunk (ragged last chunk) and *_decode
# ---------------------------------------------------------------------------

_CELL_ARCH = {"rglru": "recurrentgemma-9b", "mlstm": "xlstm-125m", "slstm": "xlstm-125m"}


def _cell_setup(cell, quant_mode):
    jcfg, tcfg = _configs(_CELL_ARCH[cell], quant_mode)
    jp = _scaled(getattr(jrec, f"init_{cell}")(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(4)
    shapes = jax_block_cache_shape(cell, jcfg, 2, 64)
    state = {k: (rng.standard_normal(v.shape) * 0.5).astype(np.float32)
             for k, v in shapes.items()}
    if "n" in state and cell == "slstm":
        state["n"] = np.abs(state["n"]) + 1.0       # a normalizer state is positive
    return jcfg, tcfg, jp, _convert(jp, "cpu"), rng, state


@pytest.mark.parametrize("quant_mode", QUANT_MODES)
@pytest.mark.parametrize("cell", ["rglru", "mlstm", "slstm"])
def test_block_matches_jax(cell, quant_mode):
    """``*_block`` over 32 rows from a carried state (the prefill form):
    the output within BF16_ULPS, the state after the last row within
    F32_TOL.  RG-LRU's state is the scan's last row and the raw conv
    rows; it starts from zeros, as its block does."""
    jcfg, tcfg, jp, tp, rng, state = _cell_setup(cell, quant_mode)
    x = rng.standard_normal((2, 32, jcfg.d_model)).astype(jnp.bfloat16)
    if cell == "rglru":
        state = {k: np.zeros_like(v) for k, v in state.items()}
    fn = getattr(jrec, f"{cell}_block")
    jout, jstate = jax.jit(lambda xx, p, s: fn(xx, p, jcfg, s))(
        jnp.asarray(x), jp, jax.tree_util.tree_map(jnp.asarray, state))
    tout, tstate = getattr(trec, f"{cell}_block")(
        _to_port(x), tp, tcfg, {k: torch.from_numpy(v) for k, v in state.items()})
    _bf16_close(tout, jout)
    for k in jstate:
        _state_close(tstate[k], jstate[k], k, quant_mode)


@pytest.mark.parametrize("quant_mode", QUANT_MODES)
@pytest.mark.parametrize("cell", ["rglru", "mlstm", "slstm"])
def test_chunk_matches_jax(cell, quant_mode):
    """``*_chunk``: a 16-row chunk from a carried state whose last chunk is
    ragged (11 valid rows, the reference's ``test_serving.py`` chunked
    cells): the valid rows' output within BF16_ULPS, the carried state
    within F32_TOL, and a second chunk from that state too."""
    jcfg, tcfg, jp, tp, rng, state = _cell_setup(cell, quant_mode)
    fn = getattr(jrec, f"{cell}_chunk")
    jit = jax.jit(lambda xx, p, s, n: fn(xx, p, jcfg, s, n), static_argnums=3)
    jstate = jax.tree_util.tree_map(jnp.asarray, {k: v[:1] for k, v in state.items()})
    tstate = {k: torch.from_numpy(v[:1]) for k, v in state.items()}
    for n_valid in (16, 11):
        x = rng.standard_normal((1, 16, jcfg.d_model)).astype(jnp.bfloat16)
        jout, jstate = jit(jnp.asarray(x), jp, jstate, n_valid)
        tout, tstate = getattr(trec, f"{cell}_chunk")(_to_port(x), tp, tcfg, tstate, n_valid)
        _bf16_close(tout[:, :n_valid], jout[:, :n_valid])
        for k in jstate:
            _state_close(tstate[k], jstate[k], k, quant_mode, f"{n_valid} valid rows")


@pytest.mark.parametrize("quant_mode", QUANT_MODES)
@pytest.mark.parametrize("cell", ["rglru", "mlstm", "slstm"])
def test_decode_matches_jax(cell, quant_mode):
    """``*_decode``: four steps from a carried state, each step's output
    within BF16_ULPS and its new state within F32_TOL."""
    jcfg, tcfg, jp, tp, rng, state = _cell_setup(cell, quant_mode)
    fn = getattr(jrec, f"{cell}_decode")
    jit = jax.jit(lambda xx, p, s: fn(xx, p, jcfg, s))
    jstate = jax.tree_util.tree_map(jnp.asarray, state)
    tstate = {k: torch.from_numpy(v) for k, v in state.items()}
    for step in range(4):
        x = rng.standard_normal((2, 1, jcfg.d_model)).astype(jnp.bfloat16)
        jout, jstate = jit(jnp.asarray(x), jp, jstate)
        tout, tstate = getattr(trec, f"{cell}_decode")(_to_port(x), tp, tcfg, tstate)
        _bf16_close(tout, jout, err_msg=f"step {step}")
        for k in jstate:
            _state_close(tstate[k], jstate[k], k, quant_mode, f"step {step}")


# ---------------------------------------------------------------------------
# Local attention: the key band and the ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [32, 100])
def test_multihead_attention_window_matches_jax(window):
    """``multihead_attention(window=)`` over 128 query rows (chunks of 64):
    window 32 reads a 96-row key band a chunk, window 100 a band longer than
    the keys (all of them); against the reference within one bf16 ulp of
    the largest output (XLA's CPU dots sum in another order from 128 rows
    on, ROADMAP queue 3)."""
    rng = np.random.default_rng(window)
    q = rng.standard_normal((1, 128, 4, 32)).astype(jnp.bfloat16)
    k = rng.standard_normal((1, 128, 2, 32)).astype(jnp.bfloat16)
    v = rng.standard_normal((1, 128, 2, 32)).astype(jnp.bfloat16)
    want = jax.jit(lambda *a: jattn.multihead_attention(*a, window=window))(
        *map(jnp.asarray, (q, k, v)))
    got = tattn.multihead_attention(*map(_to_port, (q, k, v)), window=window)
    _bf16_close(got, want)
    # the band changes nothing: the same rows over every key, masked
    full = torch.cat([tattn._attend_chunk(
        _to_port(q).reshape(1, 128, 2, 2, 32)[:, i:i + 64], _to_port(k).float(),
        _to_port(v).float(), i, torch.bfloat16, 0, window) for i in (0, 64)], dim=1)
    _bf16_close(got, _np(full.reshape(1, 128, 4, 32)))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("prompt", [20, 40])
def test_ring_prefill_and_decode_across_the_wrap(prompt, kv_dtype):
    """The local-attention ring alone: recurrentgemma's reduced config as one
    ``local_attn`` layer (4 KV heads, window 32) at ``int8_spoga``, a
    64-row cache, so a 32-row ring.  A 20-token prefill writes rows 0..19
    and 16 decode steps wrap the ring; a 40-token prefill keeps the last 32
    positions rolled by 40 % 32, then 4 decode steps, both packages fed the
    same tokens.  The ring (payloads and scales, each row a projection of
    the token embedded there) against the jitted reference bitwise at every
    step; the logits within ``LOGIT_TOL`` of their scale (the attention's
    f32 sums, ROADMAP queue 3) and the greedy tokens equal."""
    kw = dict(block_pattern=("local_attn",), n_layers=1, n_kv_heads=4)
    jcfg, tcfg = (c.with_(**kw) for c in _configs("recurrentgemma-9b", "int8_spoga",
                                                      kv_dtype))
    tree = _scaled(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = params_from_jax(tree, tcfg, "cpu")
    tokens = np.random.default_rng(prompt).integers(0, 512, (2, prompt)).astype(np.int32)
    logits, cache = prefill(tp, tcfg, {"tokens": torch.from_numpy(tokens)}, 64)
    jlogits, jcache = jax.jit(lambda p, t: jax_prefill(p, jcfg, {"tokens": t}, 64))(
        jp, jnp.asarray(tokens))
    assert tuple(cache["blocks"][0]["k"].shape)[:3] == (1, 2, 32)   # periods, lanes, rows
    jdecode = jax.jit(lambda p, t, c: jax_decode_step(p, jcfg, t, c))
    for step in range(16 if prompt == 20 else 4):
        want = np.asarray(jlogits)
        np.testing.assert_allclose(_np(logits), want, rtol=0,
                                   atol=LOGIT_TOL * np.abs(want).max(), err_msg=f"step {step}")
        np.testing.assert_array_equal(_np(logits).argmax(-1), want.argmax(-1))
        for name, leaf in jcache["blocks"][0].items():
            np.testing.assert_array_equal(_np(cache["blocks"][0][name]), _jnp(leaf),
                                          err_msg=f"{name} step {step}")
        np.testing.assert_array_equal(_np(cache["pos"]), np.asarray(jcache["pos"]))
        tok = logits.argmax(-1).to(torch.int32)
        logits, cache = decode_step(tp, tcfg, tok, cache)
        jlogits, jcache = jdecode(jp, jnp.asarray(tok.numpy()), jcache)


def test_params_from_jax_carries_the_recurrent_leaves():
    """``params_from_jax`` carries every leaf of both stacks bit for bit:
    ``lam`` f32, ``conv_w`` and ``r_zifo`` bf16, the cells' linears."""
    for arch in ("recurrentgemma-9b", "xlstm-125m"):
        jcfg, tcfg = _configs(arch)
        tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(5)))
        tparams = params_from_jax(tree, tcfg, "cpu")
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        names = {jax.tree_util.keystr(p) for p, _ in flat}
        for leaf in ("'lam'", "'conv_w'", "'r_zifo'", "'w_zifo'", "'w_igate'", "'w_rec_gate'"):
            assert any(leaf in n for n in names) == (
                leaf in ("'lam'", "'conv_w'", "'w_rec_gate'") if arch == "recurrentgemma-9b"
                else leaf in ("'r_zifo'", "'w_zifo'", "'w_igate'")), (arch, leaf)
        for path, a in flat:
            got = tparams
            for part in path:
                got = got[getattr(part, "key", getattr(part, "idx", None))]
            assert str(got.dtype).replace("torch.", "") == str(a.dtype), path
            if "'lam'" in jax.tree_util.keystr(path):
                assert got.dtype == torch.float32
            np.testing.assert_array_equal(_np(got), _jnp(a), err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# api/llm.py: LLM(arch) for the recurrent archs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant_mode", QUANT_MODES)
@pytest.mark.parametrize("arch", ["xlstm-125m", "recurrentgemma-9b"])
def test_llm_matches_jax_llm(arch, quant_mode):
    """``LLM(arch)`` (reduced) with the default runtime, slot bf16 KV, at
    bf16 and ``int8_spoga`` GEMMs: the same prompts and weights as the
    JAX ``LLM`` give the same greedy streams; 'auto' prefill buckets
    resolve to exact-length prefill on a recurrent stack, as in the
    reference."""
    from repro.api import LLM as JaxLLM
    from repro.api import QuantRuntime as JaxQuantRuntime
    from repro.api import RuntimeConfig as JaxRuntimeConfig
    from repro_torch.api import LLM, QuantRuntime, RuntimeConfig, load_runtime

    jcfg, tcfg = _configs(arch, quant_mode)
    tree = _scaled(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8, 9], [10, 11, 12], [7, 300, 41, 5, 9]]
    jllm = JaxLLM(arch, runtime=JaxRuntimeConfig(reduced=True,
                                                 quant=JaxQuantRuntime(mode=quant_mode)),
                  params=jax.tree_util.tree_map(jnp.asarray, tree))
    llm = LLM(arch, runtime=RuntimeConfig(reduced=True, quant=QuantRuntime(mode=quant_mode)),
              params=params_from_jax(tree, tcfg, "cpu"), device="cpu")
    assert llm.runtime.kv.mode == "slot" and llm.config.quant_mode == quant_mode
    want = [o.token_ids for o in jllm.generate(prompts, max_new_tokens=6)]
    got = [o.token_ids for o in llm.generate(prompts, max_new_tokens=6)]
    assert got == want
    assert len({t for s in got for t in s}) > 2, "streams collapsed"
    auto = load_runtime("slot-throughput")
    assert auto.resolve_engine(tcfg, 16, 4).prefill_buckets is None
