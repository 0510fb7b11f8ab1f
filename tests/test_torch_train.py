"""The port's training numerics against the JAX package: the
straight-through quantized linear, ``lm_loss`` and its gradients, remat
and the numerics watchdog's ``loss`` tag.

Both packages run the same weights (the JAX ``init_params`` tree carried
across with ``params_from_jax``) and batches made from a seed with numpy,
and the reference runs jitted (its compiled graph is what the port's
rounding mirrors).  Tolerances, each with its reason:

* ``linear``'s straight-through gradients are the reference's bit for bit
  for a bf16 input; for an f32 input ``dw`` is and ``dx`` stays within
  ``F32_ULP_TOL`` of its largest magnitude (one f32 ulp: XLA's f32 product
  sums in another order before the bf16 rounding it mirrors).
* ``LOSS_RTOL`` = 1e-4: the loss sums the chunks' NLL in another order
  than XLA's reduction, and bf16 attention sums flip an ulp now and then
  (``test_torch_model.py``); at ``int8_spoga`` the llama and deepseek
  losses are bitwise.
* ``GRAD_TOL`` = 2e-2 of each leaf's largest magnitude: a gradient leaf
  is bf16 (for bf16 weights) and flows back through bf16 activations, so a
  one-ulp difference in an f32 sum (the f32 backward products, the norms,
  the attention, the tied embedding's two contributions) flips a bf16
  rounding, by 2^-8 of the value, and a few compound through the layers
  (measured worst 1.2%).  The zero pattern of each leaf is the
  reference's: the routed experts' integer-mode gradients flow only
  through the absmax scales, as in the reference (ROADMAP queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro.models.layers import linear as jax_linear
from repro.models.model import lm_loss as jax_lm_loss
from repro.obs import watchdog as jax_watchdog
from repro_torch import configs as tconfigs
from repro_torch.models import lm_loss, params_from_jax
from repro_torch.models.layers import linear
from repro_torch.obs import watchdog
from repro_torch.tree import leaves, named_leaves

F32_ULP_TOL = 2 ** -22
LOSS_RTOL = 1e-4
GRAD_TOL = 2e-2
ARCHS = sorted(tconfigs.ARCHS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the host's cores; small ops slow down
    when torch's intra-op threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _configs(arch, **kw):
    jcfg = jax_reduced(jax_get_config(arch)).with_(remat=False, **kw)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch)).with_(remat=False, **kw)
    return jcfg, tcfg


def _batch(cfg, seed=1, b=2, s=32):
    """A numpy batch for ``cfg``: tokens; encoder embeddings and target
    tokens (encoder-decoder); frontend embeddings and labels with the first
    5 positions masked (-1)."""
    rng = np.random.default_rng(seed)
    if cfg.is_encoder_decoder:
        return {"src_embeds": rng.standard_normal((b, 16, cfg.d_model)).astype(jnp.bfloat16),
                "tgt_tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.frontend is not None:
        labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        labels[:, :5] = -1
        return {"embeds": rng.standard_normal((b, s, cfg.d_model)).astype(jnp.bfloat16),
                "labels": labels}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def _tree(jcfg, seed=0):
    return jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(seed)))


# ---------------------------------------------------------------------------
# The straight-through quantized linear
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("mode", ["int8_spoga", "w4a8"])
def test_linear_ste_matches_jax_vjp(mode, x_dtype):
    """``linear``'s ``dx`` / ``dw`` against the jitted reference's
    ``jax.vjp`` of ``linear``: the straight-through f32 products, ``dw`` of
    the bf16-rounded input, ``dx`` rounded to bf16 then cast to the input's
    dtype.  Almost every weight gradient is non-zero (the gradient of the
    integer pipeline alone would flow through the absmax scales only)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, 96)).astype(np.float32)
    if x_dtype == "bf16":
        x = x.astype(jnp.bfloat16)
    w = (rng.standard_normal((96, 80)) * 0.05).astype(jnp.bfloat16)
    g = rng.standard_normal((2, 24, 80)).astype(jnp.bfloat16)

    def vjp(x, w, g):
        y, pull = jax.vjp(lambda a, b: jax_linear(a, b, mode), x, w)
        return (y,) + pull(g)

    y, dx, dw = jax.jit(vjp)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(g))
    tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    ty = linear(tx, tw, mode)
    gx, gw = torch.autograd.grad(ty, (tx, tw), _t(g))
    assert gx.dtype == tx.dtype and gw.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(gw), _bits(dw))
    assert (gw != 0).float().mean() > 0.99
    if x_dtype == "bf16":
        np.testing.assert_array_equal(_bits(ty), _bits(y))
        np.testing.assert_array_equal(_bits(gx), _bits(dx))
    else:
        dx = _f32(dx)
        np.testing.assert_allclose(_f32(gx), dx, rtol=0,
                                   atol=F32_ULP_TOL * np.abs(dx).max())


def test_linear_ste_forward_is_the_pipeline():
    """The straight-through forward is ``quantized_linear`` itself (the same
    bits with and without grad), and it keeps nothing for a no-grad call."""
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal((8, 64)).astype(jnp.bfloat16))
    w = _t((rng.standard_normal((64, 32)) * 0.05).astype(jnp.bfloat16))
    with torch.no_grad():
        plain = linear(x, w, "int8_spoga")
    assert plain.grad_fn is None
    y = linear(x, w.clone().requires_grad_(True), "int8_spoga")
    assert y.grad_fn is not None and torch.equal(y.detach(), plain)


# ---------------------------------------------------------------------------
# lm_loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_jax(arch):
    """``lm_loss`` of every reduced arch at bf16 against the jitted
    reference: token labels, an encoder-decoder's ``tgt_tokens``, a
    frontend arch's ``labels`` with -1 masked, the MoE aux term."""
    jcfg, tcfg = _configs(arch)
    tree, batch = _tree(jcfg), _batch(tcfg)
    want = jax.jit(jax_lm_loss, static_argnums=1)(
        jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
        {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = lm_loss(params_from_jax(tree, tcfg, "cpu"), tcfg,
                      {k: _t(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def _value_and_grad(tcfg, params, batch):
    flat = leaves(params)
    for t in flat:
        t.requires_grad_(True)
    loss = lm_loss(params, tcfg, batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(flat, grads)]


GRAD_CASES = [("llama3.2-1b", "bf16"), ("llama3.2-1b", "int8_spoga"),
              ("llama3.2-1b", "w4a8"), ("deepseek-moe-16b", "int8_spoga"),
              ("recurrentgemma-9b", "int8_spoga"), ("seamless-m4t-large-v2", "int8_spoga"),
              ("llava-next-mistral-7b", "int8_spoga")]


@pytest.mark.parametrize("arch,mode,b,s", [(a, m, 2, 32) for a, m in GRAD_CASES]
                         + [("llama3.2-1b", "int8_spoga", 1, 1024)])
def test_loss_and_grads_match_jax(arch, mode, b, s):
    """Value and gradient of every leaf against the jitted reference's
    ``jax.value_and_grad(lm_loss)``: the leaf's dtype, its zero pattern and
    its values within GRAD_TOL of its largest magnitude.  In integer modes
    the dense projections' weight gradients are the straight-through ones
    (non-zero almost everywhere); the routed experts' are the reference's
    scale-only ones (about one non-zero per expert and column).  At 1,024
    tokens the attention runs two 512-row query chunks and the loss two
    chunks, each recomputed in the backward."""
    jcfg, tcfg = _configs(arch, quant_mode=mode)
    tree, batch = _tree(jcfg), _batch(tcfg, b=b, s=s)
    jl, jg = jax.jit(jax.value_and_grad(jax_lm_loss), static_argnums=1)(
        jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(tree, tcfg, "cpu")
    loss, grads = _value_and_grad(tcfg, params, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    want = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(jg)[0]}
    names = [n for n, _ in named_leaves(params)]
    assert sorted(names) == sorted(want)
    for name, g in zip(names, grads):
        ref = np.asarray(want[name])
        assert g.dtype == (torch.bfloat16 if ref.dtype.name == "bfloat16"
                           else torch.float32), name
        a, b = _f32(ref), _f32(g)
        scale = np.abs(a).max()
        np.testing.assert_allclose(b, a, rtol=0, atol=GRAD_TOL * scale, err_msg=name)
        assert abs((a != 0).mean() - (b != 0).mean()) <= 1e-3, name
        if mode != "bf16" and "'experts_" in name:
            assert (b != 0).mean() < 0.05, name          # scale-only
        elif mode != "bf16" and name.split("[")[-1].startswith("'w"):
            assert (b != 0).mean() > 0.99, name          # straight-through


@pytest.mark.parametrize("arch,mode", [("llama3.2-1b", "int8_spoga"),
                                       ("deepseek-moe-16b", "int8_spoga"),
                                       ("seamless-m4t-large-v2", "bf16"),
                                       ("recurrentgemma-9b", "bf16")])
def test_remat_is_bitwise(arch, mode):
    """Remat on (``"nothing"`` and ``"dots"``) against off: the same loss
    and every gradient bit for bit (the recompute runs the same ops on the
    same inputs); the encoder-decoder's period includes its cross step."""
    _, tcfg = _configs(arch, quant_mode=mode)
    jcfg = _configs(arch)[0]
    tree, batch = _tree(jcfg), {k: _t(v) for k, v in _batch(tcfg).items()}
    base = None
    for remat, policy in ((False, "nothing"), (True, "nothing"), (True, "dots")):
        cfg = tcfg.with_(remat=remat, remat_policy=policy)
        loss, grads = _value_and_grad(cfg, params_from_jax(tree, cfg, "cpu"), batch)
        if base is None:
            base = (loss, grads)
            continue
        assert torch.equal(loss, base[0]), (remat, policy)
        for g, h in zip(grads, base[1]):
            assert torch.equal(g, h), (remat, policy)


# ---------------------------------------------------------------------------
# The numerics watchdog's "loss" tag
# ---------------------------------------------------------------------------

@pytest.fixture
def _fresh_watchdogs():
    watchdog.reset()
    jax_watchdog.reset()
    yield
    watchdog.reset()
    jax_watchdog.reset()


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-moe-16b"])
def test_loss_watchdog_matches_reference(arch, _fresh_watchdogs):
    """``lm_loss`` with ``numerics_watchdog`` on, twice (the second call
    reuses the reference's trace): the registry's keys (labels
    ``loss.<site>.k<K>n<N>``, every period reusing its first period's) and
    integer counters are the reference's, ``amax`` exact.  A backward (its
    remat recompute included) stages nothing: a value-and-grad records what
    the forward alone records."""
    jcfg, tcfg = _configs(arch, quant_mode="w4a8", numerics_watchdog=True)
    tree, batch = _tree(jcfg), _batch(tcfg)
    fn = jax.jit(jax_lm_loss, static_argnums=1)
    params = params_from_jax(tree, tcfg, "cpu")
    for _ in range(2):
        want = fn(jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
                  {k: jnp.asarray(v) for k, v in batch.items()})
        with torch.no_grad():
            got = lm_loss(params, tcfg, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    jax.effects_barrier()
    reg, jreg = watchdog.peek_registry(), jax_watchdog.peek_registry()
    assert sorted(reg.counters) == sorted(jreg.counters)
    assert {k: c.value for k, c in reg.counters.items()} == \
        {k: c.value for k, c in jreg.counters.items()}
    assert set(reg.histograms) == set(jreg.histograms)
    for k, h in reg.histograms.items():
        assert h.counts == jreg.histograms[k].counts, k
        if k.startswith("watchdog_amax"):
            assert sorted(h.samples) == sorted(jreg.histograms[k].samples), k
    assert all("loss." in k for k in reg.counters)
    once = {}
    for grad in (False, True):
        watchdog.reset()
        if grad:
            _value_and_grad(tcfg.with_(remat=True), params, {k: _t(v) for k, v in batch.items()})
        else:
            with torch.no_grad():
                lm_loss(params, tcfg, {k: _t(v) for k, v in batch.items()})
        once[grad] = {k: c.value for k, c in watchdog.peek_registry().counters.items()}
    assert once[True] == once[False]
