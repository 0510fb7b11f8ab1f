"""The port's collectives and data-parallel training against the JAX
package's.

Two gloo ranks on the CPU, spawned once for the whole file
(``launch.mesh.spawn``):

* ``compressed_psum_mean`` of each rank's gradient tree equals the
  reference's bitwise; the reference runs under
  ``jax.jit(jax.vmap(..., axis_name="data"))`` over the stacked per-rank
  gradients.  The result is deterministic, zeros stay zero, and
  ``psum_mean`` is the f32 sum rounded once, over the axis size;
* a dp=2 train step (``make_train_step(..., mesh=)``) keeps the params
  bitwise equal across ranks, compressed or not; uncompressed it matches
  the one-rank step on the whole batch within ``STEP_TOL``; compressed,
  the loss of the batches it trained on falls.

About 9 s.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime.collectives import compressed_psum_mean as jax_compressed
from repro.runtime.collectives import psum_mean as jax_psum_mean
from repro_torch.launch.mesh import spawn

# a dp=2 step against the one-rank step on the whole batch: the two halves'
# gradients are summed in another order (and bf16 gradients rounded once
# more), so the averaged gradients agree within this share of each leaf's
# largest magnitude.  AdamW's first step moves each param by about
# lr * sign(g), so a gradient near zero may move the other way: the
# updated params agree within 2 lr
STEP_TOL = 2e-2
TRAIN_STEPS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# an absmax whose f32 quotient by 127 differs from its product with the
# f32 reciprocal of 127: the jitted reference multiplies
RECIPROCAL_CASE = 7.322016


def _grads(rank):
    """Rank ``rank``'s gradient tree: f32 and bf16 leaves of several scales,
    an all-zero leaf, and a leaf whose absmax tells the reference's
    reciprocal multiply from a division."""
    rng = np.random.default_rng(100 + rank)
    d = rng.uniform(-1, 1, size=(32,)).astype(np.float32)
    d[rank] = RECIPROCAL_CASE * (1.0 if rank == 0 else -0.37)
    return {"a": torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32)),
            "d": torch.from_numpy(d),
            "b": torch.from_numpy((rng.normal(size=(128,)) * 1e-3).astype(np.float32))
                 .to(torch.bfloat16),
            "z": torch.zeros((8, 8), dtype=torch.float32),
            "c": [torch.from_numpy((rng.standard_t(2, size=(16, 16)) * 5).astype(np.float32))]}


def _train_cfg():
    from repro_torch.configs import get_config, reduced
    return reduced(get_config("llama3.2-1b")).with_(n_layers=2, remat=False,
                                                     quant_mode="int8_spoga")


def _tcfg(**kw):
    from repro_torch.configs.base import TrainConfig
    return TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=20, fsdp=False,
                       zero1=False, **kw)


def _batches(cfg, n, batch=4, seq=32):
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    pipe = SyntheticTokenPipeline(cfg.vocab_size, seq, batch, seed=1, device="cpu")
    return [pipe.global_batch_at(i) for i in range(n)]


def _rank(rank, dev):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import _loss_and_grads, make_train_step
    from repro_torch.models import init_params
    from repro_torch.models.model import lm_loss
    from repro_torch.optim.optimizers import adamw_init
    from repro_torch.runtime import collectives as col

    mesh = make_host_mesh(data=2, backend="gloo", device=dev)
    data = col.axis(mesh, "data")
    out = {}
    g = _grads(rank)
    out["compressed"] = col.compressed_psum_mean(g, data)
    out["compressed_again"] = col.compressed_psum_mean(g, data)
    out["psum_mean"] = col.psum_mean(g, data)
    gen = torch.Generator().manual_seed(rank)
    out["stochastic"] = col.compressed_psum_mean(g, data, generator=gen)

    cfg = _train_cfg()
    batch = _batches(cfg, 1)[0]
    params = init_params(cfg, seed=0, device=dev)
    _, grads = _loss_and_grads(params, cfg, _tcfg(), {"tokens": batch.chunk(2)[rank]})
    out["dp_grads"] = col.psum_mean(grads, data)
    for compress in (False, True):
        params = init_params(cfg, seed=0, device=dev)
        opt = adamw_init(params, device=dev)
        step = make_train_step(cfg, _tcfg(grad_compression=compress), mesh=mesh)
        params, opt, m = step(params, opt, {"tokens": batch})
        out[f"step_params_{compress}"] = params
        out[f"step_loss_{compress}"] = float(m["loss"])
    # compressed training on a few batches: their loss falls
    params = init_params(cfg, seed=0, device=dev)
    opt = adamw_init(params, device=dev)
    step = make_train_step(cfg, _tcfg(grad_compression=True), mesh=mesh)
    seen = _batches(cfg, 2)
    with torch.no_grad():
        before = [float(lm_loss(params, cfg, {"tokens": b})) for b in seen]
    for i in range(TRAIN_STEPS):
        params, opt, _ = step(params, opt, {"tokens": seen[i % 2]})
    with torch.no_grad():
        after = [float(lm_loss(params, cfg, {"tokens": b})) for b in seen]
    out["seen_loss"] = (before, after)
    out["trained_params"] = params
    return out


@functools.lru_cache(maxsize=None)
def _results():
    return spawn(_rank, 2, "gloo", device="cpu")


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _flat(tree):
    from repro_torch.tree import named_leaves
    return dict(named_leaves(tree))


def test_compressed_psum_mean_matches_reference_bitwise():
    res = _results()
    trees = [_grads(r) for r in range(2)]
    flat = [_flat(t) for t in trees]

    def to_jax(t):
        return jnp.asarray(_np(t), dtype=jnp.bfloat16 if t.dtype == torch.bfloat16
                           else jnp.float32)

    stacked = {k: jnp.stack([to_jax(f[k]) for f in flat]) for k in flat[0]}
    want = jax.jit(jax.vmap(lambda g: jax_compressed(g, "data"), axis_name="data"))(stacked)
    want_mean = jax.jit(jax.vmap(lambda g: jax_psum_mean(g, "data"), axis_name="data"))(stacked)
    for r in range(2):
        got = _flat(res[r]["compressed"])
        got_mean = _flat(res[r]["psum_mean"])
        for k in flat[0]:
            w = np.asarray(want[k][r].astype(jnp.float32))
            np.testing.assert_array_equal(_np(got[k]), w, err_msg=k)
            assert got[k].dtype == flat[0][k].dtype
            np.testing.assert_array_equal(_np(got_mean[k]),
                                          np.asarray(want_mean[k][r].astype(jnp.float32)),
                                          err_msg=k)
            assert str(got_mean[k].dtype).split(".")[-1] == str(want_mean[k].dtype), k
    s = np.float32(RECIPROCAL_CASE)
    assert s / np.float32(127) != s * np.float32(1 / 127)


def test_compressed_psum_mean_deterministic_and_zero_preserving():
    res = _results()
    for r in range(2):
        a, b = _flat(res[r]["compressed"]), _flat(res[r]["compressed_again"])
        for k in a:
            assert torch.equal(a[k], b[k])
        assert not torch.any(a["['z']"]) and not torch.any(_flat(res[r]["stochastic"])["['z']"])
    # every rank holds the same mean; stochastic rounding stays within one
    # quantization step of the deterministic result (plus, for a bf16 leaf,
    # one bf16 ulp of the largest value: both results are rounded to bf16)
    a0, a1 = _flat(res[0]["compressed"]), _flat(res[1]["compressed"])
    for k in a0:
        assert torch.equal(a0[k], a1[k])
    s0, s1 = _flat(res[0]["stochastic"]), _flat(res[1]["stochastic"])
    for k in a0:
        assert torch.equal(s0[k], s1[k])
        step = max(float(x.float().abs().max()) for x in (_flat(_grads(0))[k],
                                                          _flat(_grads(1))[k])) / 127.0
        ulp = 2.0 ** -7 * float(a0[k].float().abs().max()) if a0[k].dtype == torch.bfloat16 \
            else 1e-6
        assert float((s0[k].float() - a0[k].float()).abs().max()) <= step + ulp


@pytest.mark.parametrize("compress", [False, True])
def test_dp_step_keeps_params_equal_across_ranks(compress):
    res = _results()
    p0, p1 = _flat(res[0][f"step_params_{compress}"]), _flat(res[1][f"step_params_{compress}"])
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
    assert res[0][f"step_loss_{compress}"] == res[1][f"step_loss_{compress}"]
    t0, t1 = _flat(res[0]["trained_params"]), _flat(res[1]["trained_params"])
    for k in t0:
        assert torch.equal(t0[k], t1[k]), k


def test_dp_step_matches_one_rank_step_on_whole_batch():
    from repro_torch.launch.steps import _loss_and_grads, make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim.optimizers import adamw_init

    cfg = _train_cfg()
    batch = _batches(cfg, 1)[0]
    params = init_params(cfg, seed=0, device="cpu")
    _, want_grads = _loss_and_grads(params, cfg, _tcfg(), {"tokens": batch})
    before = {k: v.clone() for k, v in _flat(params).items()}
    opt = adamw_init(params, device="cpu")
    params, _, m = make_train_step(cfg, _tcfg())(params, opt, {"tokens": batch})
    res = _results()
    assert abs(res[0]["step_loss_False"] - float(m["loss"])) < 1e-5
    got_grads = _flat(res[0]["dp_grads"])
    for k, want in _flat(want_grads).items():
        err = (got_grads[k].float() - want.float()).abs().max()
        assert err <= STEP_TOL * float(want.float().abs().max()), k
    got = _flat(res[0]["step_params_False"])
    lr = float(m["lr"])
    moved = 0
    for k, want in _flat(params).items():
        assert float((got[k].float() - want.float()).abs().max()) <= 2 * lr * 1.01, k
        moved += bool((want.float() - before[k].float()).abs().max() > 0)
    assert moved > len(before) // 2


def test_compressed_dp_training_lowers_seen_loss():
    before, after = _results()[0]["seen_loss"]
    assert np.isfinite(before + after).all()
    assert np.mean(after) < np.mean(before) - 0.2, (before, after)
