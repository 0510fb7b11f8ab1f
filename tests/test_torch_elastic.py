"""Sharded checkpoints and elastic restore of the port (the port's
counterpart of ``tests/test_distribution.py::
test_elastic_restore_across_mesh_shapes``).

Reduced llama3.2-1b with 2 layers, ``TrainConfig()``'s defaults (FSDP and
ZeRO-1).  Four gloo ranks on the CPU, spawned once for the whole file
(``launch.mesh.spawn``):

* one step on a 2x2 ("data", "model") mesh, then a sharded
  ``save_checkpoint`` of ``(params, opt_state)``: the files are byte for
  byte a single-process save of the gathered tree (``shard.gather_tree``),
  and the JAX package's ``restore_checkpoint`` reads them;
* the same step restored onto 4x1 and onto 1x4, and unsharded: every
  restored block is bitwise the slice of the saved tree; one more step on
  each matches the port's unsharded resumed step (the loss within
  ``LOSS_TOL``, every gradient leaf within ``GRAD_TOL`` of its largest
  magnitude, the params within ``PARAM_RTOL`` / ``PARAM_ATOL``, the AdamW
  state as ``test_torch_sharded_train.check_adamw_step`` holds it);
* ``train_loop`` for 2 steps on 2x2 with an asynchronous checkpoint,
  resumed onto 4x1 for 2 more: the 4 losses are an uninterrupted
  unsharded run's within ``LOSS_TOL``.

About 20 s.
"""

import functools
import os
import tempfile
import time
import types

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import restore_checkpoint as jax_restore_checkpoint
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro.optim.optimizers import adamw_init as jax_adamw_init
from repro_torch.launch.mesh import spawn
from test_torch_sharded_train import check_adamw_step

LOSS_TOL = 2e-4                 # the reference test's bounds
PARAM_RTOL = 3e-2
PARAM_ATOL = 3e-3
GRAD_TOL = 2e-2                 # as tests/test_torch_sharded_train.py
TCFG = dict(learning_rate=1e-3, warmup_steps=2, total_steps=4)
TARGETS = ((4, 1), (1, 4))
LOOP = dict(batch=8, seq=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    from repro_torch.configs import get_config, reduced
    return reduced(get_config("llama3.2-1b")).with_(n_layers=2, remat=False,
                                                     quant_mode="int8_spoga")


def _tcfg():
    from repro_torch.configs.base import TrainConfig
    return TrainConfig(**TCFG)


def _batches(cfg):
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    pipe = SyntheticTokenPipeline(cfg.vocab_size, 32, 8, seed=1, device="cpu")
    return [pipe.global_batch_at(i) for i in range(2)]


def _like(cfg):
    from repro_torch.models import param_shapes
    from repro_torch.optim.optimizers import adamw_init
    meta = param_shapes(cfg)
    return (meta, adamw_init(meta, device="meta"))


def _specs(cfg, mesh):
    from repro_torch.runtime.sharding import opt_state_specs, param_specs
    like = _like(cfg)
    p_specs = param_specs(like[0], mesh, cfg, fsdp=True)
    return (p_specs, opt_state_specs(like[1], p_specs, mesh, True))


def _named(tree):
    from repro_torch.tree import named_leaves
    return list(named_leaves(tree))


def _rank(rank, dev, root):
    torch.set_num_threads(1)
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import _sharded_loss_and_grads, make_train_step, \
        sharded_layout
    from repro_torch.launch.train import train_loop
    from repro_torch.models import init_params
    from repro_torch.optim.optimizers import adamw_init
    from repro_torch.shard.core import gather_tree, shard_opt_state, shard_params
    from repro_torch.tree import tree_map

    cfg, tcfg = _cfg(), _tcfg()
    batches = _batches(cfg)
    out = {"restored": {}}
    mesh = make_host_mesh(2, 2, backend="gloo", device=dev)
    specs = _specs(cfg, mesh)
    full = init_params(cfg, seed=0, device="cpu")
    opt = shard_opt_state(adamw_init(full, device="cpu"), specs[0], mesh, True, cfg=cfg)
    params = shard_params(full, mesh, cfg, fsdp=True)
    params, opt, _ = make_train_step(cfg, tcfg, mesh=mesh)(params, opt,
                                                            {"tokens": batches[0]})
    save_checkpoint(os.path.join(root, "sharded"), 1, (params, opt), mesh=mesh, specs=specs,
                    cfg=cfg)
    gathered = gather_tree((params, opt), specs, mesh, cfg)
    if rank == 0:
        save_checkpoint(os.path.join(root, "single"), 1, gathered)
        out["gathered"] = gathered
    for shape in TARGETS:
        mesh = make_host_mesh(*shape, backend="gloo", device=dev)
        specs = _specs(cfg, mesh)
        step, (params, opt), _ = restore_checkpoint(os.path.join(root, "sharded"), None,
                                                    _like(cfg), device="cpu", mesh=mesh,
                                                    specs=specs, cfg=cfg)
        # the step below updates the restored tensors in place
        res = dict(step=step, restored=tree_map(torch.clone, (params, opt)),
                   coords={a: mesh.axis_rank(a) for a in mesh.axis_names})
        layout = sharded_layout(cfg, tcfg, mesh)
        local = batches[1].chunk(layout.dp)[layout.data.rank] if layout.data else batches[1]
        _, grads = _sharded_loss_and_grads(params, layout, tcfg, {"tokens": local})
        res["grads"] = gather_tree(grads, layout.g_specs, mesh, cfg)
        params, opt, m = make_train_step(cfg, tcfg, mesh=mesh)(params, opt,
                                                                {"tokens": batches[1]})
        res["loss"] = float(m["loss"])
        res["stepped"] = gather_tree(params, layout.p_specs, mesh, cfg)
        res["stepped_opt"] = gather_tree(opt, layout.o_specs, mesh, cfg)
        out["restored"][shape] = res
    # train_loop: 2 steps on 2x2, resumed onto 4x1 for 2 more
    loop_dir = os.path.join(root, "loop")
    _, first = train_loop(cfg, tcfg, steps=2, ckpt_dir=loop_dir, device="cpu",
                          mesh=make_host_mesh(2, 2, backend="gloo", device=dev), **LOOP)
    _, rest = train_loop(cfg, tcfg, steps=4, ckpt_dir=loop_dir, device="cpu",
                         mesh=make_host_mesh(4, 1, backend="gloo", device=dev), **LOOP)
    out["loop"] = first + rest
    return out


@functools.lru_cache(maxsize=None)
def _results():
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="repro_torch_elastic_")
    ranks = spawn(_rank, 4, "gloo", device="cpu", args=(root,))
    print(f"[elastic] four ranks {time.perf_counter() - t0:.1f} s")
    return root, ranks


def _stub_mesh(shape):
    return types.SimpleNamespace(shape=dict(zip(("data", "model"), shape)),
                                 axis_names=("data", "model"))


def test_sharded_save_is_the_single_process_save_of_the_gathered_tree():
    root, _ = _results()
    for name in ("arrays.npz", "meta.json"):
        with open(os.path.join(root, "sharded", "step_00000001", name), "rb") as f:
            a = f.read()
        with open(os.path.join(root, "single", "step_00000001", name), "rb") as f:
            b = f.read()
        assert a == b, name
    assert not [d for d in os.listdir(os.path.join(root, "sharded")) if d.startswith("tmp")]


def test_reference_restores_the_sharded_save():
    root, ranks = _results()
    jcfg = jax_reduced(jax_get_config("llama3.2-1b")).with_(n_layers=2, remat=False)
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    like = (params, jax_adamw_init(params))
    step, tree, _ = jax_restore_checkpoint(os.path.join(root, "sharded"), None, like)
    assert step == 1
    got = jax.tree_util.tree_leaves(tree)
    want = _named(ranks[0]["gathered"])
    assert len(got) == len(want)
    for g, (name, w) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g, np.float32), w.float().numpy(),
                                      err_msg=name)


def test_unsharded_restore_is_the_gathered_tree():
    from repro_torch.checkpoint import restore_checkpoint
    root, ranks = _results()
    step, tree, _ = restore_checkpoint(os.path.join(root, "sharded"), None, _like(_cfg()),
                                       device="cpu")
    assert step == 1
    for (name, a), (_, b) in zip(_named(tree), _named(ranks[0]["gathered"])):
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("shape", TARGETS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_restored_blocks_are_slices_of_the_saved_tree(shape):
    from repro_torch.shard.core import shard_tree
    _, ranks = _results()
    cfg = _cfg()
    mesh = _stub_mesh(shape)
    saved = ranks[0]["gathered"]
    for r in ranks:
        res = r["restored"][shape]
        assert res["step"] == 1
        want = shard_tree(saved, _specs(cfg, mesh), mesh, cfg, coords=res["coords"])
        for (name, a), (_, b) in zip(_named(res["restored"]), _named(want)):
            assert a.shape == b.shape and torch.equal(a, b), (shape, name)


@pytest.mark.parametrize("shape", TARGETS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_step_after_restore_matches_unsharded_resumed_step(shape):
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.launch.steps import _loss_and_grads, make_train_step
    root, ranks = _results()
    cfg, tcfg = _cfg(), _tcfg()
    batch = _batches(cfg)[1]
    _, (params, opt), _ = restore_checkpoint(os.path.join(root, "sharded"), None, _like(cfg),
                                             device="cpu")
    _, grads = _loss_and_grads(params, cfg, tcfg, {"tokens": batch})
    params, opt, m = make_train_step(cfg, tcfg)(params, opt, {"tokens": batch})
    res = ranks[0]["restored"][shape]
    np.testing.assert_allclose(res["loss"], float(m["loss"]), rtol=LOSS_TOL, atol=LOSS_TOL)
    got = dict(_named(res["grads"]))
    for name, want in _named(grads):
        err = float((got[name].float() - want.float()).abs().max())
        assert err <= GRAD_TOL * float(want.float().abs().max()), (shape, name, err)
    for (name, a), (_, b) in zip(_named(res["stepped"]), _named(params)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=f"{shape} {name}")
    check_adamw_step(res["stepped_opt"], opt, ranks[0]["gathered"][1]["master"],
                     res["stepped"], tcfg, f"{shape} step after restore")
    for r in ranks[1:]:
        assert r["restored"][shape]["loss"] == res["loss"]


def test_train_loop_resumed_on_another_mesh_matches_uninterrupted_run():
    from repro_torch.launch.train import train_loop
    _, ranks = _results()
    _, want = train_loop(_cfg(), _tcfg(), steps=4, device="cpu", **LOOP)
    got = ranks[0]["loop"]
    assert len(got) == 4
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=LOSS_TOL)
    for r in ranks[1:]:
        assert r["loop"] == got
