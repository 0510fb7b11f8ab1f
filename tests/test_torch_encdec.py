"""The port's ``model.forward`` and its encoder-decoder stack against the
JAX package.

* ``forward`` of seven archs (one per cache mechanism, as
  ``tests/test_serving.py`` picks them, plus the frontend-fed llava) on
  the reference's weights: the reduced config, the JAX ``init_params``
  tree with its projection and expert weights scaled by 8 (so greedy
  decoding does not collapse), carried across with ``params_from_jax``,
  against the jitted JAX ``forward``.  At ``int8_spoga`` the logits are
  bitwise but for a few one-ulp f32 differences of the bf16 unembed's
  sums; with bf16 GEMMs XLA's CPU dots and transcendental functions leave
  ROADMAP queue 3's residue.  Either way: within ``LOGIT_TOL`` of the
  largest logit (the tolerance of ``test_torch_archs.py``), greedy tokens
  equal.
* the port's prefill and decode against its own ``forward``, in the form
  and with the tolerance of ``tests/test_serving.py::
  test_prefill_decode_matches_forward``.
* seamless-m4t-large-v2 through ``serve_batch`` (8 source frames, the
  reference's batch dict): greedy streams equal to the JAX package's
  ``serve_batch`` on the same weights and frames.
* ``params_from_jax`` carries the encoder and cross-attention leaves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import serve_batch as jax_serve_batch
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced as jax_reduced
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro_torch import configs as tconfigs
from repro_torch.api import serve_batch
from repro_torch.models import decode_step, forward, params_from_jax, prefill

WEIGHT_SCALE = 8.0
# logits against JAX, relative to their largest magnitude
LOGIT_TOL = 2e-2
# prefill / decode against forward (tests/test_serving.py's tolerance)
SERVING_TOL = 2e-2
FORWARD_ARCHS = ["llama3.2-1b", "minicpm3-4b", "granite-moe-3b-a800m", "xlstm-125m",
                 "recurrentgemma-9b", "seamless-m4t-large-v2", "llava-next-mistral-7b"]
S_PROMPT, S_GEN, BATCH, SRC = 12, 4, 2, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the host's cores; small ops slow down
    when torch's intra-op threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scaled_tree(jcfg):
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))

    def scale(path, a):
        key = jax.tree_util.keystr(path)
        if "'w" in key or "'experts" in key:
            return (a.astype(np.float32) * WEIGHT_SCALE).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(scale, tree)


def _configs(arch, quant_mode):
    jcfg = jax_reduced(JAX_ARCHS[arch]).with_(remat=False, quant_mode=quant_mode)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch)).with_(quant_mode=quant_mode)
    return jcfg, tcfg


def _batch(cfg, seed, s):
    """The reference tests' batch of ``cfg`` (numpy): source frames and
    target tokens, patch embeddings, or tokens; embeddings f32 x 0.02."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (BATCH, s)).astype(np.int32)
    if cfg.is_encoder_decoder:
        src = (rng.standard_normal((BATCH, SRC, cfg.d_model)) * 0.02).astype(np.float32)
        return {"src_embeds": src, "tgt_tokens": toks}
    if cfg.frontend is not None:
        return {"embeds": (rng.standard_normal((BATCH, s, cfg.d_model)) * 0.02)
                .astype(np.float32)}
    return {"tokens": toks}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, tol=LOGIT_TOL):
    """Within ``tol`` of the largest magnitude, greedy tokens equal."""
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("quant_mode", ["int8_spoga", "bf16"])
@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_forward_matches_jax(arch, quant_mode):
    """Full logits (B, S, V) of the port's ``forward`` against the jitted
    JAX ``forward`` on the same weights and batch."""
    jcfg, tcfg = _configs(arch, quant_mode)
    tree = _scaled_tree(jcfg)
    batch = _batch(tcfg, 0, 16)
    want = np.asarray(jax.jit(lambda p, b: jax_forward(p, jcfg, b))(
        jax.tree_util.tree_map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()}))
    got = forward(params_from_jax(tree, tcfg, "cpu"), tcfg, _torch(batch))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got.numpy(), want)


@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_prefill_decode_matches_forward(arch):
    """``tests/test_serving.py::test_prefill_decode_matches_forward`` on the
    port, on that test's weights (the reference's init, unscaled): prefill
    on the first 12 positions, then decode the rest one by one (frontend
    embeddings fed as (B, d) rows), each step's logits against the port's
    own ``forward`` over all 16."""
    jcfg, cfg = _configs(arch, "bf16")
    tree = jax_init_params(jcfg, jax.random.fold_in(jax.random.PRNGKey(0), 1))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, tree), cfg, "cpu")
    total = S_PROMPT + S_GEN
    full = _torch(_batch(cfg, 1, total))
    ref = forward(params, cfg, full).numpy()
    key = next(k for k in ("tgt_tokens", "embeds", "tokens") if k in full)
    pre = dict(full)
    pre[key] = full[key][:, :S_PROMPT]
    logits, cache = prefill(params, cfg, pre, cache_len=total)
    np.testing.assert_allclose(logits.numpy(), ref[:, S_PROMPT - 1], rtol=SERVING_TOL,
                               atol=SERVING_TOL)
    for t in range(S_PROMPT, total):
        logits, cache = decode_step(params, cfg, full[key][:, t], cache)
        np.testing.assert_allclose(logits.numpy(), ref[:, t], rtol=SERVING_TOL,
                                   atol=SERVING_TOL, err_msg=f"{arch}: position {t}")


@pytest.mark.parametrize("quant_mode", ["int8_spoga", "bf16"])
def test_seamless_serve_batch_matches_jax(quant_mode):
    """seamless-m4t-large-v2 through ``serve_batch`` as the reference's
    static serving path serves it (``launch/serve.py`` ``_static_main``: source
    frames and 8 target tokens): 6 greedy tokens a row equal to the JAX
    ``serve_batch``'s.  The prefill's cross K/V are bf16 in every mode, as
    the reference stores them."""
    jcfg, tcfg = _configs("seamless-m4t-large-v2", quant_mode)
    tree = _scaled_tree(jcfg)
    batch = _batch(tcfg, 2, 8)
    want, _ = jax_serve_batch(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              cache_len=24, gen_tokens=6)
    params = params_from_jax(tree, tcfg, "cpu")
    got, times = serve_batch(tcfg, params, _torch(batch), cache_len=24, gen_tokens=6)
    assert got.dtype == torch.int32 and set(times) == {"prefill_s", "decode_s"}
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _, cache = prefill(params, tcfg, _torch(batch), 24)
    for name in ("k", "v"):
        assert cache["cross_kv"][name].dtype == torch.bfloat16
        assert tuple(cache["cross_kv"][name].shape) == (2, BATCH, SRC, 4, 32)


def test_params_from_jax_carries_the_encoder_and_cross_leaves():
    """Every leaf of the reference's encoder-decoder tree arrives, with its
    dtype and bits; a tree without the encoder leaves, or stacked over
    another depth, is refused."""
    jcfg, tcfg = _configs("seamless-m4t-large-v2", "bf16")
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    params = params_from_jax(tree, tcfg, "cpu")
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    assert {"enc_blocks", "enc_tail_blocks", "enc_final_norm", "cross_blocks"} <= set(params)
    for (_, g), (_, w) in zip(got, want):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32))
    with pytest.raises(ValueError, match="enc_blocks"):
        params_from_jax({k: v for k, v in tree.items() if k != "enc_blocks"}, tcfg, "cpu")
    with pytest.raises(ValueError, match="enc_blocks are stacked"):
        params_from_jax(tree, tcfg.with_(n_encoder_layers=3), "cpu")
