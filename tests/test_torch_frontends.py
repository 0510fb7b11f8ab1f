"""The frontend-fed stack (llava-next-mistral-7b), the frontend stubs, the
non-GLU MLP and LayerNorm, and the engine's ``stream`` and
``EngineConfig.for_workload``, each against the JAX package.

* ``models/frontends.py``: the stubs draw from a ``torch.Generator``, so
  their numbers are the port's own; their shape, dtype and scale are the
  reference's, and ``embed_spec`` describes what they return.
* llava through ``serve_batch`` from patch embeddings (the reference's
  batch dict), on the JAX ``init_params`` tree with its projection weights
  scaled by 8 (so greedy decoding does not collapse) and the same
  embeddings, carried across through numpy: greedy streams equal to the
  JAX package's ``serve_batch``.
* ``layers.layernorm`` and ``layers.mlp`` against the jitted reference
  functions: the bf16 LayerNorm and the ReLU MLP bitwise, the f32
  LayerNorm within ``F32_ULPS`` f32 ulps of its scale (XLA's CPU
  ``rsqrt`` and sums), the GELU and SiLU
  MLPs within the bounds ``test_mlp_matches_jax`` states (XLA's CPU
  transcendental functions, ROADMAP queue 3).
* ``ServingEngine.stream``, in the form of ``tests/test_serving.py::
  test_engine_streaming_hooks``, and held to the JAX engine's ``stream``
  on the same weights; ``EngineConfig.for_workload`` against the
  reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import serve_batch as jax_serve_batch
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import frontends as jax_frontends
from repro.models import init_params as jax_init_params
from repro.models import layers as jax_layers
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch import configs as tconfigs
from repro_torch.api import serve_batch
from repro_torch.models import frontends, layers, params_from_jax
from repro_torch.serving import EngineConfig, ServingEngine

WEIGHT_SCALE = 8.0
# the f32 LayerNorm: f32 ulps of the output's scale
F32_ULPS = 2
# the bf16 GELU / SiLU MLPs: bf16 ulps of the output's scale
BF16_ULPS = 1
# the int8 GELU / SiLU MLPs: share of the output's scale (an activation
# ulp moved across an int8 rounding; see test_mlp_matches_jax)
QUANT_FLIP_TOL = 3e-2
LLAVA = "llava-next-mistral-7b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the host's cores; small ops slow down
    when torch's intra-op threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, quant_mode="bf16"):
    jcfg = jax_reduced(jax_get_config(arch)).with_(remat=False, quant_mode=quant_mode)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch)).with_(quant_mode=quant_mode)
    return jcfg, tcfg


def _bf16(a):
    """numpy f32 -> bf16 torch tensor (the reference rounds the same way)."""
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def _to_np(t):
    return t.float().numpy()


@pytest.mark.parametrize("stub", ["fake_vision_embeds", "fake_audio_frames"])
def test_frontend_stubs_match_the_reference_in_shape_dtype_and_scale(stub):
    """``embed_spec`` is the reference's ``ShapeDtypeStruct`` as a ``meta``
    tensor; a stub gives (B, S, d_model) bf16 at the reference's scale
    (normal x 0.02), the same tensor for the same seed and another for
    another seed."""
    cfg = tconfigs.get_config(LLAVA if stub == "fake_vision_embeds"
                              else "seamless-m4t-large-v2")
    jspec = jax_frontends.embed_spec(jax_get_config(cfg.name), 3, 64)
    spec = frontends.embed_spec(cfg, 3, 64)
    assert spec.device.type == "meta"
    assert tuple(spec.shape) == tuple(jspec.shape) == (3, 64, cfg.d_model)
    assert str(spec.dtype).replace("torch.", "") == str(jspec.dtype) == "bfloat16"
    fn = getattr(frontends, stub)
    x = fn(0, cfg, 3, 64, device="cpu")
    want = getattr(jax_frontends, stub)(jax.random.PRNGKey(0), jax_get_config(cfg.name), 3, 64)
    assert x.shape == spec.shape and x.dtype == spec.dtype
    assert torch.equal(x, fn(0, cfg, 3, 64, device="cpu"))
    assert not torch.equal(x, fn(1, cfg, 3, 64, device="cpu"))
    ratio = float(x.float().std()) / float(jnp.std(want.astype(jnp.float32)))
    assert 0.98 < ratio < 1.02, ratio


@pytest.mark.parametrize("quant_mode", ["int8_spoga", "bf16"])
def test_llava_serve_batch_matches_jax(quant_mode):
    """llava through ``serve_batch`` as the reference's static serving path serves
    a frontend arch (``launch/serve.py`` ``_static_main``: ``{"embeds"}``):
    16 patch embeddings a row, 6 greedy tokens equal to the JAX
    ``serve_batch``'s; the decode steps embed the sampled tokens."""
    jcfg, tcfg = _configs(LLAVA, quant_mode)
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tree = jax.tree_util.tree_map_with_path(
        lambda p, a: (a.astype(np.float32) * WEIGHT_SCALE).astype(a.dtype)
        if "'w" in jax.tree_util.keystr(p) else a, tree)
    embeds = (np.random.default_rng(3).standard_normal((2, 16, tcfg.d_model)) * 0.02
              ).astype(np.float32)
    want, _ = jax_serve_batch(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                              {"embeds": jnp.asarray(embeds)}, cache_len=32, gen_tokens=6)
    got, _ = serve_batch(tcfg, params_from_jax(tree, tcfg, "cpu"),
                         {"embeds": torch.from_numpy(embeds)}, cache_len=32, gen_tokens=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_layernorm_matches_jax(dtype):
    """``layernorm`` (and ``init_layernorm``'s ones / zeros) against the
    jitted reference on (2, 8, 256) rows with random gamma and beta; the
    output keeps the input's dtype: bitwise in bf16, within ``F32_ULPS``
    f32 ulps of its scale in f32."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 8, 256)) * 3 + 1).astype(np.float32)
    p = {"gamma": rng.standard_normal(256).astype(np.float32),
         "beta": rng.standard_normal(256).astype(np.float32)}
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jax.jit(jax_layers.layernorm)(jx, jax.tree_util.tree_map(jnp.asarray, p))
                      .astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = layers.layernorm(tx, {k: torch.from_numpy(v) for k, v in p.items()})
    assert got.dtype == tx.dtype
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_to_np(got), want)
    else:
        np.testing.assert_allclose(_to_np(got), want, rtol=0,
                                   atol=F32_ULPS * np.spacing(np.float32(np.abs(want).max())))
    init = layers.init_layernorm(256)
    jinit = jax_layers.init_layernorm(256)
    for k in ("gamma", "beta"):
        assert init[k].dtype == torch.float32
        np.testing.assert_array_equal(init[k].numpy(), np.asarray(jinit[k]))


@pytest.mark.parametrize("quant_mode", ["int8_spoga", "bf16"])
@pytest.mark.parametrize("act", ["gelu", "relu", "silu"])
def test_mlp_matches_jax(act, quant_mode):
    """``mlp`` (``out(act(in(x)))``, GELU by default) against the jitted
    reference on the reference's ``init_mlp`` weights (scaled by 8) and a
    (2, 8, 128) bf16 input; ``init_mlp`` gives the reference's layout.

    The ReLU MLP is bitwise in both modes.  GELU and SiLU go through XLA's
    CPU ``tanh`` / logistic, which differ from PyTorch's in the last ulps
    (ROADMAP queue 3): with bf16 GEMMs the output stays within
    ``BF16_ULPS`` bf16 ulp of its scale; at ``int8_spoga`` such an ulp
    moves an activation across an int8 rounding now and then (the
    reference's compiled graph quantizes the unrounded f32 activation), so
    the output stays within ``QUANT_FLIP_TOL`` of its scale, and the
    second GEMM alone, fed the reference's own activation, is bitwise."""
    jp = jax.tree_util.tree_map(
        lambda a: (a.astype(jnp.float32) * WEIGHT_SCALE).astype(a.dtype),
        jax_layers.init_mlp(jax.random.PRNGKey(0), 128, 512))
    x = np.random.default_rng(1).standard_normal((2, 8, 128)).astype(np.float32)
    kw = {} if act == "gelu" else {"act": act}
    want = np.asarray(jax.jit(lambda x, p: jax_layers.mlp(x, p, quant_mode=quant_mode, **kw))(
        jnp.asarray(x).astype(jnp.bfloat16), jp).astype(jnp.float32))
    tp = {k: _bf16(np.asarray(v.astype(jnp.float32))) for k, v in jp.items()}
    got = layers.mlp(_bf16(x), tp, quant_mode=quant_mode, **kw)
    assert got.dtype == torch.bfloat16
    scale = np.abs(want).max()
    if act == "relu":
        np.testing.assert_array_equal(_to_np(got), want)
    elif quant_mode == "bf16":
        tol = BF16_ULPS * 2.0 ** (np.floor(np.log2(scale)) - 7)
        np.testing.assert_allclose(_to_np(got), want, rtol=0, atol=tol)
    else:
        np.testing.assert_allclose(_to_np(got), want, rtol=0, atol=QUANT_FLIP_TOL * scale)
        h = jax.jit(lambda x, p: jax_layers._act(act)(
            jax_layers.linear(x, p["w_in"], quant_mode)))(jnp.asarray(x).astype(jnp.bfloat16), jp)
        out = jax.jit(lambda h, p: jax_layers.linear(h, p["w_out"], quant_mode))(h, jp)
        got2 = layers.linear(_bf16(np.asarray(h.astype(jnp.float32))), tp["w_out"], quant_mode)
        np.testing.assert_array_equal(_to_np(got2), np.asarray(out.astype(jnp.float32)))
    shapes = {k: tuple(v.shape) for k, v in
              layers.init_mlp(torch.Generator().manual_seed(0), "cpu", 128, 512).items()}
    assert shapes == {k: tuple(v.shape) for k, v in jp.items()}


def test_engine_streaming_hooks():
    """``tests/test_serving.py::test_engine_streaming_hooks`` on the port:
    ``on_token`` fires for every token in order, and ``stream`` yields the
    stream the request records -- the JAX engine's ``stream`` on the same
    weights and prompt (minicpm3-4b, slot cache)."""
    jcfg, tcfg = _configs("minicpm3-4b")
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tree = jax.tree_util.tree_map_with_path(
        lambda p, a: (a.astype(np.float32) * WEIGHT_SCALE).astype(a.dtype)
        if "'w" in jax.tree_util.keystr(p) else a, tree)
    params = params_from_jax(tree, tcfg, "cpu")
    rng = np.random.default_rng(3)
    engine = ServingEngine(tcfg, params, EngineConfig(n_slots=2, cache_len=32), device="cpu")
    seen = []
    req = engine.add_request(rng.integers(0, tcfg.vocab_size, 6).tolist(), 5,
                             on_token=seen.append)
    while engine.has_work:
        engine.step()
    assert seen == req.output_tokens and len(seen) == 5

    prompt = rng.integers(0, tcfg.vocab_size, 6).tolist()
    engine = ServingEngine(tcfg, params, EngineConfig(n_slots=2, cache_len=32), device="cpu")
    toks = list(engine.stream(prompt, 4))
    assert len(toks) == 4
    assert toks == engine.metrics.finished[0].output_tokens
    jengine = JaxServingEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                               JaxEngineConfig(n_slots=2, cache_len=32))
    assert toks == list(jengine.stream(prompt, 4))


def test_for_workload_matches_the_reference():
    """``EngineConfig.for_workload`` sizes the cache as the reference's does
    (prompt + gen + headroom) and passes the other fields through."""
    for args, kw in (((128, 32), {}), ((16, 4), {"n_slots": 8, "cache_mode": "paged",
                                                 "page_size": 8, "prefill_chunk": 8})):
        got = dataclasses.asdict(EngineConfig.for_workload(*args, **kw))
        want = dataclasses.asdict(JaxEngineConfig.for_workload(*args, **kw))
        assert got == {k: want[k] for k in got}
    assert EngineConfig.for_workload(128, 32).cache_len == 168
