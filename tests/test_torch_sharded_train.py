"""The port's sharded train step (FSDP, ZeRO-1, tensor parallelism)
against the JAX package's sharded step and against the port's unsharded
step.

Reduced llama3.2-1b with 2 layers.  Four gloo ranks on the CPU, spawned
once for the whole file (``launch.mesh.spawn``), each building the
2x2, 4x1 and 1x4 ("data", "model") meshes in turn:

* **the reference's sharded step**: a JAX subprocess with four host
  devices runs ``make_train_step(grad_specs=param_specs(fsdp=True))`` on a
  ``repro.launch.mesh.make_host_mesh(2, 2)`` mesh with
  ``opt_state_specs(zero1=True)`` inputs, and the single-device step, from
  the same weights and batch (its own ``init_params``), and saves them
  with the reference's ``save_checkpoint``.  The port's 2x2 step with
  ``TrainConfig()``'s defaults (``fsdp=True``, ``zero1=True``) on those
  weights matches both: the loss within ``LOSS_TOL``, the params within
  ``PARAM_RTOL`` / ``PARAM_ATOL`` (the reference test's own bounds), and
  the AdamW state after the step against the reference's
  (:func:`check_adamw_step`), in ``bf16`` and in ``int8_spoga``;
* **the port's unsharded step**, on 2x2, 4x1 and 1x4 meshes: every
  gradient leaf (gathered with ``shard.gather_tree``) within ``GRAD_TOL``
  of its largest magnitude, the loss within ``LOSS_TOL``, the AdamW state
  after the first step (:func:`check_adamw_step`), the params after two
  steps within the param bounds; also with ``microbatches=2``, with
  ``grad_reduce_dtype="bf16"`` and with the ZeRO-1 layout as
  ``grad_specs`` on 2x2; with remat, each period's FSDP
  leaves are gathered again in the recompute and the gradients do not
  change;
* FSDP and ZeRO-1 on 4x1 for every other arch that trains on one device
  (MoE, MLA, recurrent, encoder-decoder, frontend): the global loss and
  every gradient leaf against the unsharded step's;
* ranks that hold the same block of a param or of the AdamW state hold
  the same bits; each rank's bytes equal ``shard.tree_device_bytes``;
* the sharded step builds on 2x2 for the MoE, MLA and recurrent stacks
  too, each rank on its ``local_config`` (their steps are held in
  ``tests/test_torch_tp_train.py``); ``grad_compression`` with FSDP or
  ZeRO-1 is refused (``ValueError``).

About 45 s (the JAX subprocess about 30 s of it).
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import textwrap
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn

# the reference test's bounds (tests/test_distribution.py)
LOSS_TOL = 2e-4
PARAM_RTOL = 3e-2
PARAM_ATOL = 3e-3
# a sharded step's gradients against the unsharded step's: summed in another
# order (and bf16 gradients rounded once more), as test_torch_collectives.py
# bounds dp=2
GRAD_TOL = 2e-2
# the AdamW update itself, which the param bounds cannot see (two steps at
# lr 1e-3 move an element less than PARAM_ATOL): m, a scaled gradient,
# within GRAD_TOL of each leaf's largest magnitude; v, a scaled square, within
# 2 GRAD_TOL + GRAD_TOL**2 (|a^2 - b^2| <= |a - b| |a + b|); the master moved by
# AdamW's rule from the state's own m and v within UPDATE_TOL of the lr
V_TOL = 2 * GRAD_TOL + GRAD_TOL ** 2
UPDATE_TOL = 1e-3
MODES = ("bf16", "int8_spoga")
# every other arch that trains on one device, FSDP and ZeRO-1 on 4x1
DP_ARCHS = ("deepseek-moe-16b", "granite-moe-3b-a800m", "minicpm3-4b", "xlstm-125m",
            "recurrentgemma-9b", "seamless-m4t-large-v2", "llava-next-mistral-7b")
MESHES = ((2, 2), (4, 1), (1, 4))
# the stacks whose tensor-parallel training the sharded step once refused
TP_ARCHS = ("deepseek-moe-16b", "minicpm3-4b", "xlstm-125m", "recurrentgemma-9b")
STEPS = 2
TCFG = dict(learning_rate=1e-3, warmup_steps=2, total_steps=4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_JAX_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np

    from repro.checkpoint.checkpoint import save_checkpoint
    from repro.configs import get_config, reduced
    from repro.configs.base import TrainConfig
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import make_train_step
    from repro.models import init_params
    from repro.optim.optimizers import adamw_init
    from repro.runtime import sharding as shard_lib

    out = sys.argv[1]
    tcfg = TrainConfig(**json.loads(sys.argv[2]))
    params = None
    losses = {}
    for mode in sys.argv[3:]:
        cfg = reduced(get_config("llama3.2-1b")).with_(n_layers=2, remat=False,
                                                        quant_mode=mode)
        params = init_params(cfg, jax.random.PRNGKey(0))
        opt = adamw_init(params)
        batch = {"tokens": jax.random.randint(jax.random.PRNGKey(1), (8, 32), 0,
                                              cfg.vocab_size)}
        p1, o1, m1 = jax.jit(make_train_step(cfg, tcfg))(params, opt, batch)
        mesh = make_host_mesh(2, 2)
        p_specs = shard_lib.param_specs(jax.eval_shape(lambda: params), mesh, cfg, fsdp=True)
        o_specs = shard_lib.opt_state_specs(jax.eval_shape(lambda: opt), p_specs, mesh,
                                            zero1=True)
        b_specs = shard_lib.batch_specs_tree(jax.eval_shape(lambda: batch), mesh)
        with mesh:
            step = jax.jit(make_train_step(cfg, tcfg, grad_specs=p_specs),
                           in_shardings=(shard_lib.named(p_specs, mesh),
                                         shard_lib.named(o_specs, mesh),
                                         shard_lib.named(b_specs, mesh)))
            p2, o2, m2 = step(params, opt, batch)
        save_checkpoint(os.path.join(out, mode), 1, p1)
        save_checkpoint(os.path.join(out, mode), 2, p2)
        save_checkpoint(os.path.join(out, mode + "-opt"), 1, o1)
        save_checkpoint(os.path.join(out, mode + "-opt"), 2, o2)
        losses[mode] = [float(m1["loss"]), float(m2["loss"])]
        np.save(os.path.join(out, "tokens.npy"), np.asarray(batch["tokens"]))
    save_checkpoint(out, 0, params)
    with open(os.path.join(out, "losses.json"), "w") as f:
        json.dump(losses, f)
""")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mode="int8_spoga"):
    from repro_torch.configs import get_config, reduced
    return reduced(get_config("llama3.2-1b")).with_(n_layers=2, remat=False, quant_mode=mode)


def _tcfg(**kw):
    from repro_torch.configs.base import TrainConfig
    return TrainConfig(**TCFG, **kw)


def _batch(cfg):
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    return SyntheticTokenPipeline(cfg.vocab_size, 32, 8, seed=1, device="cpu")


def _arch_batch(cfg, b=4, s=32):
    """A global batch for ``cfg``: tokens; encoder embeddings and target
    tokens; or frontend embeddings and labels, row r's first 3 + 4r
    positions masked (-1), so the data ranks hold uneven label counts."""
    rng = np.random.default_rng(1)

    def embeds(n):
        return torch.from_numpy(rng.standard_normal((b, n, cfg.d_model)).astype(np.float32)
                                ).to(torch.bfloat16)

    def tokens():
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32))

    if cfg.is_encoder_decoder:
        return {"src_embeds": embeds(16), "tgt_tokens": tokens()}
    if cfg.frontend is not None:
        labels = tokens()
        for r in range(b):
            labels[r, :3 + 4 * r] = -1
        return {"embeds": embeds(s), "labels": labels}
    return {"tokens": tokens()}


def _full(tree):
    return {k: v for k, v in _named(tree)}


def _named(tree):
    from repro_torch.tree import named_leaves
    return list(named_leaves(tree))


def _sharded_state(full, cfg, tcfg, mesh):
    from repro_torch.optim.optimizers import adamw_init
    from repro_torch.runtime.sharding import param_specs
    from repro_torch.shard.core import shard_opt_state, shard_params
    p_specs = param_specs(full, mesh, cfg, fsdp=tcfg.fsdp)
    opt = shard_opt_state(adamw_init(full, device="cpu"), p_specs, mesh, tcfg.zero1, cfg=cfg)
    return shard_params(full, mesh, cfg, fsdp=tcfg.fsdp), opt


def _local_bytes(tree):
    return sum(t.numel() * t.element_size() for _, t in _named(tree))


def _rank(rank, dev, jax_dir):
    torch.set_num_threads(1)
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (
        _sharded_loss_and_grads,
        make_train_step,
        sharded_layout,
    )
    from repro_torch.models import init_params, param_shapes
    from repro_torch.shard.core import gather_tree
    from repro_torch.tree import tree_map

    out = {"jax": {}, "meshes": {}, "variants": {}}
    for shape in MESHES:
        mesh = make_host_mesh(*shape, backend="gloo", device=dev)
        if shape == (2, 2):
            # the reference's weights and batch, TrainConfig()'s defaults
            tokens = torch.from_numpy(np.load(os.path.join(jax_dir, "tokens.npy")))
            for mode in MODES:
                cfg = _cfg(mode)
                _, full, _ = restore_checkpoint(jax_dir, 0, param_shapes(cfg), device="cpu")
                params, opt = _sharded_state(full, cfg, _tcfg(), mesh)
                step = make_train_step(cfg, _tcfg(), mesh=mesh)
                params, opt, m = step(params, opt, {"tokens": tokens})
                layout = sharded_layout(cfg, _tcfg(), mesh)
                out["jax"][mode] = dict(loss=float(m["loss"]),
                                        params=gather_tree(params, layout.p_specs, mesh, cfg),
                                        opt=gather_tree(opt, layout.o_specs, mesh, cfg))
        cfg = _cfg()
        tcfg = _tcfg()
        pipe = _batch(cfg)
        full = init_params(cfg, seed=0, device="cpu")
        params, opt = _sharded_state(full, cfg, tcfg, mesh)
        layout = sharded_layout(cfg, tcfg, mesh)
        data = layout.data
        batch = pipe.global_batch_at(0)
        local = batch.chunk(data.size)[data.rank] if data is not None else batch
        loss, grads = _sharded_loss_and_grads(params, layout, tcfg, {"tokens": local})
        step = make_train_step(cfg, tcfg, mesh=mesh)
        losses = []
        for i in range(STEPS):
            params, opt, m = step(params, opt, {"tokens": pipe.global_batch_at(i)})
            losses.append(float(m["loss"]))
            if i == 0:
                # the next step updates the leaves held whole in place
                first = tree_map(torch.clone, (gather_tree(params, layout.p_specs, mesh, cfg),
                                               gather_tree(opt, layout.o_specs, mesh, cfg)))
        out["meshes"][shape] = dict(
            grads=gather_tree(grads, layout.g_specs, mesh, cfg), losses=losses, first=first,
            params=gather_tree(params, layout.p_specs, mesh, cfg), local_params=params,
            local_opt=opt, coords={a: mesh.axis_rank(a) for a in mesh.axis_names},
            param_bytes=_local_bytes(params), opt_bytes=_local_bytes(opt))
        if shape == (4, 1):
            out["archs"] = {arch: _arch_grads(arch, mesh) for arch in DP_ARCHS}
        if shape == (2, 2):
            out["builds"] = {arch: _builds(arch, mesh) for arch in TP_ARCHS}
            out["remat"] = _remat_gathers(params, layout, tcfg, local)
            zero1_grads = dict(grad_specs=layout.o_specs["m"])
            for name, kw, step_kw in (
                    ("microbatches=2", dict(microbatches=2), {}),
                    ("grad_reduce_dtype=bf16", dict(grad_reduce_dtype="bf16"), {}),
                    ("grad_specs=ZeRO-1 layout", {}, zero1_grads)):
                tv = _tcfg(**kw)
                # the steps above updated the leaves that shard_params kept whole
                full = init_params(cfg, seed=0, device="cpu")
                params, opt = _sharded_state(full, cfg, tv, mesh)
                params, opt, m = make_train_step(cfg, tv, mesh=mesh, **step_kw)(
                    params, opt, {"tokens": batch})
                out["variants"][name] = dict(
                    loss=float(m["loss"]), params=gather_tree(params, layout.p_specs, mesh, cfg),
                    opt=gather_tree(opt, layout.o_specs, mesh, cfg))
    return out


def _arch_grads(arch, mesh):
    """(the global loss, the gathered gradients) of ``arch`` (reduced,
    ``int8_spoga``) under FSDP and ZeRO-1 on ``mesh``."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.steps import _sharded_loss_and_grads, sharded_layout
    from repro_torch.models import init_params
    from repro_torch.runtime import collectives
    from repro_torch.shard.core import gather_tree, shard_params
    cfg = reduced(get_config(arch)).with_(remat=False, quant_mode="int8_spoga")
    tcfg = _tcfg()
    layout = sharded_layout(cfg, tcfg, mesh)
    params = shard_params(init_params(cfg, seed=0, device="cpu"), mesh, cfg, fsdp=True)
    batch = {k: v.chunk(layout.dp)[layout.data.rank] for k, v in _arch_batch(cfg).items()}
    loss, grads = _sharded_loss_and_grads(params, layout, tcfg, batch)
    loss = collectives.all_reduce(loss, layout.data, "sum") / layout.dp
    return float(loss), gather_tree(grads, layout.g_specs, mesh, cfg)


def _builds(arch, mesh):
    """Whether the sharded step builds for ``arch`` (reduced) on ``mesh``
    with each rank's config the one ``shard.local_config`` gives."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.steps import make_train_step, sharded_layout
    from repro_torch.shard.core import local_config
    cfg = reduced(get_config(arch))
    tp = mesh.shape["model"]
    return callable(make_train_step(cfg, _tcfg(), mesh=mesh)) and \
        sharded_layout(cfg, _tcfg(), mesh).cfg == local_config(cfg, tp)


def _remat_gathers(params, layout, tcfg, batch):
    """(FSDP gathers over "data" without remat, with remat, whether the
    gradients with remat are bitwise those without) of one loss and
    backward at the rank's blocks."""
    from repro_torch.launch.steps import _sharded_loss_and_grads
    from repro_torch.runtime import collectives
    orig = collectives.all_gather
    counts, grads = [], []
    for remat in (False, True):
        calls = [0]

        def counting(t, ax, dim, _calls=calls):
            _calls[0] += ax.group is layout.data.group
            return orig(t, ax, dim)

        collectives.all_gather = counting
        try:
            lay = dataclasses.replace(layout, cfg=layout.cfg.with_(remat=remat))
            grads.append(_sharded_loss_and_grads(params, lay, tcfg, {"tokens": batch})[1])
        finally:
            collectives.all_gather = orig
        counts.append(calls[0])
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(*map(_named, grads)))
    return counts[0], counts[1], same


def _jax_reference(out_dir):
    env = dict(os.environ)
    env["PYTHONPATH"] = "src"
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, out_dir, json.dumps(TCFG), *MODES],
                       env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"


@functools.lru_cache(maxsize=None)
def _results():
    t0 = time.perf_counter()
    jax_dir = tempfile.mkdtemp(prefix="repro_torch_sharded_")
    _jax_reference(jax_dir)
    t1 = time.perf_counter()
    ranks = spawn(_rank, 4, "gloo", device="cpu", args=(jax_dir,))
    print(f"[sharded] JAX reference {t1 - t0:.1f} s, four ranks "
          f"{time.perf_counter() - t1:.1f} s")
    return jax_dir, ranks


def _unsharded(cfg, tcfg, batches, full=None):
    """The port's unsharded step: (first gradients, losses, params, the
    AdamW state after the first step)."""
    from repro_torch.launch.steps import _loss_and_grads, make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim.optimizers import adamw_init
    from repro_torch.tree import tree_map
    params = init_params(cfg, seed=0, device="cpu") if full is None else full
    _, grads = _loss_and_grads(params, cfg, tcfg, {"tokens": batches[0]})
    opt = adamw_init(params, device="cpu")
    step = make_train_step(cfg, tcfg)
    losses, first = [], None
    for b in batches:
        params, opt, m = step(params, opt, {"tokens": b})
        losses.append(float(m["loss"]))
        first = tree_map(torch.clone, opt) if first is None else first
    return grads, losses, params, first


def _lr(tcfg, step: int) -> float:
    """The schedule's learning rate at ``step``, in float64 (the
    reference's formulas, ``repro/optim/optimizers.py:make_schedule``)."""
    warm = min(step / max(tcfg.warmup_steps, 1), 1.0)
    if tcfg.schedule == "constant":
        return tcfg.learning_rate * warm
    frac = min(max((step - tcfg.warmup_steps) / max(tcfg.total_steps - tcfg.warmup_steps, 1),
                   0.0), 1.0)
    decay = 1.0 - frac if tcfg.schedule == "linear" else 0.5 * (1.0 + np.cos(np.pi * frac))
    return tcfg.learning_rate * warm * decay


def check_adamw_step(got, want, master0, params, tcfg, label):
    """The AdamW state ``got`` after a step (full leaves) against the
    reference's ``want`` after the same step, from the master ``master0``
    before it: m within ``GRAD_TOL`` and v within ``V_TOL`` of each leaf's
    largest magnitude in ``want``; ``got``'s master is ``master0`` moved by
    AdamW's rule from ``got``'s own m and v, within ``UPDATE_TOL`` of the
    step's learning rate (so a step that did not update, or updated a block
    from another block's moments, fails); and ``params`` are that master
    cast to their dtype, bit for bit."""
    step = int(got["step"])
    assert step == int(want["step"]), (label, step)
    lr = _lr(tcfg, step)
    bc1, bc2 = 1.0 - tcfg.beta1 ** step, 1.0 - tcfg.beta2 ** step
    for key, tol in (("m", GRAD_TOL), ("v", V_TOL)):
        for (name, a), (_, b) in zip(_named(got[key]), _named(want[key])):
            err = float((a.double() - b.double()).abs().max())
            assert err <= tol * float(b.double().abs().max()), (label, key, name, err)
    for (name, w1), (_, w0), (_, m), (_, v), (_, p) in zip(
            *(_named(t) for t in (got["master"], master0, got["m"], got["v"], params))):
        w0 = w0.double()
        rule = w0 - lr * ((m.double() / bc1) / ((v.double() / bc2).sqrt() + 1e-8)
                          + tcfg.weight_decay * w0)
        err = float((w1.double() - rule).abs().max())
        assert err <= UPDATE_TOL * lr, (label, "master", name, err, lr)
        assert torch.equal(p, w1.to(p.dtype)), (label, "param", name)


def _init(cfg):
    from repro_torch.models import init_params
    return init_params(cfg, seed=0, device="cpu")


def _close_params(got, want, label):
    for (k, a), (_, b) in zip(_named(got), _named(want)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=f"{label} {k}")


@pytest.mark.parametrize("mode", MODES)
def test_2x2_step_matches_reference_sharded_and_single_step(mode):
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.models import param_shapes
    from repro_torch.optim.optimizers import adamw_init
    jax_dir, ranks = _results()
    with open(os.path.join(jax_dir, "losses.json")) as f:
        single_loss, sharded_loss = json.load(f)[mode]
    cfg = _cfg(mode)
    meta = param_shapes(cfg)
    _, master0, _ = restore_checkpoint(jax_dir, 0, meta, device="cpu")
    got = ranks[0]["jax"][mode]
    for want_loss, step, label in ((single_loss, 1, "single-device"), (sharded_loss, 2, "2x2")):
        np.testing.assert_allclose(got["loss"], want_loss, rtol=LOSS_TOL, atol=LOSS_TOL,
                                   err_msg=label)
        _, want, _ = restore_checkpoint(os.path.join(jax_dir, mode), step, meta, device="cpu")
        _close_params(got["params"], want, f"{mode} against the reference's {label} step")
        _, want_opt, _ = restore_checkpoint(os.path.join(jax_dir, mode + "-opt"), step,
                                            adamw_init(meta, device="meta"), device="cpu")
        check_adamw_step(got["opt"], want_opt, master0, got["params"], _tcfg(),
                         f"{mode} against the reference's {label} step")
    for r in ranks[1:]:
        assert r["jax"][mode]["loss"] == got["loss"]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_step_matches_unsharded_step(shape):
    cfg = _cfg()
    pipe = _batch(cfg)
    grads, losses, params, first = _unsharded(cfg, _tcfg(), [pipe.global_batch_at(i)
                                                             for i in range(STEPS)])
    _, ranks = _results()
    res = ranks[0]["meshes"][shape]
    check_adamw_step(res["first"][1], first, _init(cfg), res["first"][0], _tcfg(),
                     f"{shape} first step")
    got = _full(res["grads"])
    for k, want in _named(grads):
        err = float((got[k].float() - want.float()).abs().max())
        assert err <= GRAD_TOL * float(want.float().abs().max()), (k, err)
    np.testing.assert_allclose(res["losses"], losses, rtol=LOSS_TOL, atol=LOSS_TOL)
    _close_params(res["params"], params, f"{shape}")
    for r in ranks[1:]:
        assert r["meshes"][shape]["losses"] == res["losses"]


@pytest.mark.parametrize("arch", DP_ARCHS)
def test_fsdp_and_zero1_cover_every_arch(arch):
    """FSDP and ZeRO-1 on 4x1 (one row a rank) against the unsharded
    gradients: the global loss (the MoE load-balance means and the
    labelled-token count over every rank's rows) and every gradient leaf,
    the MoE routers' included."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.steps import _loss_and_grads
    from repro_torch.models import init_params
    cfg = reduced(get_config(arch)).with_(remat=False, quant_mode="int8_spoga")
    loss, grads = _loss_and_grads(init_params(cfg, seed=0, device="cpu"), cfg, _tcfg(),
                                  _arch_batch(cfg))
    got_loss, got = _results()[1][0]["archs"][arch]
    np.testing.assert_allclose(got_loss, float(loss), rtol=LOSS_TOL, atol=LOSS_TOL)
    got = _full(got)
    for k, want in _named(grads):
        err = float((got[k].float() - want.float()).abs().max())
        assert err <= GRAD_TOL * float(want.float().abs().max()), (k, err)


def test_remat_gathers_each_period_again_and_changes_no_bit():
    """With remat the backward recomputes each period from its input: it
    gathers the period's FSDP leaves again (the 7 projections of each of
    the 2 periods) instead of keeping them, and the gradients are bitwise
    those without remat."""
    for r in _results()[1]:
        off, on, same = r["remat"]
        assert off > 0 and on - off == 7 * 2, (off, on)
        assert same


@pytest.mark.parametrize("variant", ["microbatches=2", "grad_reduce_dtype=bf16",
                                     "grad_specs=ZeRO-1 layout"])
def test_step_variants_on_2x2(variant):
    """Each against the unsharded step with the same TrainConfig; the
    ZeRO-1 layout as ``grad_specs`` reduce-scatters the gradients of the
    leaves the params keep whole over "data"."""
    cfg = _cfg()
    kw = {"microbatches=2": dict(microbatches=2),
          "grad_reduce_dtype=bf16": dict(grad_reduce_dtype="bf16")}.get(variant, {})
    _, losses, params, first = _unsharded(cfg, _tcfg(**kw), [_batch(cfg).global_batch_at(0)])
    got = _results()[1][0]["variants"][variant]
    np.testing.assert_allclose(got["loss"], losses[0], rtol=LOSS_TOL, atol=LOSS_TOL)
    check_adamw_step(got["opt"], first, _init(cfg), got["params"], _tcfg(**kw), variant)
    _close_params(got["params"], params, variant)


def _spec_axes(spec):
    return {a for e in spec if e is not None for a in (e if isinstance(e, tuple) else (e,))}


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_replicas_hold_the_same_bits(shape):
    from repro_torch.models import param_shapes
    from repro_torch.optim.optimizers import adamw_init
    from repro_torch.runtime.sharding import opt_state_specs, param_specs, spec_leaves
    cfg = _cfg()
    mesh = _stub_mesh(shape)
    meta = param_shapes(cfg)
    p_specs = param_specs(meta, mesh, cfg, fsdp=True)
    o_specs = opt_state_specs(adamw_init(meta, device="meta"), p_specs, mesh, True)
    ranks = [r["meshes"][shape] for r in _results()[1]]
    pairs = 0
    for key, specs in (("local_params", p_specs), ("local_opt", o_specs)):
        like = ranks[0][key]
        for i, spec in enumerate(spec_leaves(specs, like)):
            used = _spec_axes(spec)
            groups = {}
            for r in ranks:
                held = tuple(r["coords"][a] for a in sorted(used))
                groups.setdefault(held, []).append(_named(r[key])[i])
            for members in groups.values():
                name, first = members[0]
                for _, other in members[1:]:
                    assert torch.equal(first, other), (shape, key, name)
                    pairs += 1
    assert pairs > 0


def _stub_mesh(shape):
    return types.SimpleNamespace(shape=dict(zip(("data", "model"), shape)),
                                 axis_names=("data", "model"))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_rank_bytes_equal_tree_device_bytes(shape):
    from repro_torch.models import param_shapes
    from repro_torch.optim.optimizers import adamw_init
    from repro_torch.runtime.sharding import opt_state_specs, param_specs
    from repro_torch.shard import tree_device_bytes
    cfg = _cfg()
    mesh = _stub_mesh(shape)
    meta = param_shapes(cfg)
    opt = adamw_init(meta, device="meta")
    p_specs = param_specs(meta, mesh, cfg, fsdp=True)
    want_p = tree_device_bytes(meta, p_specs, mesh)
    want_o = tree_device_bytes(opt, opt_state_specs(opt, p_specs, mesh, True), mesh)
    full_p = tree_device_bytes(meta, param_specs(meta, mesh, cfg, fsdp=False), _stub_mesh((1, 1)))
    assert want_p < full_p
    for r in _results()[1]:
        assert r["meshes"][shape]["param_bytes"] == want_p
        assert r["meshes"][shape]["opt_bytes"] == want_o


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_tensor_parallel_training_refuses_other_stacks(arch):
    """The refusal of tensor-parallel training of the MoE, MLA and
    recurrent stacks is lifted: on the 2x2 mesh the sharded step builds
    for each, every rank running the config ``local_config`` gives it
    (``tests/test_torch_tp_train.py`` holds their steps to the reference
    and to the unsharded step)."""
    for r in _results()[1]:
        assert r["builds"][arch]


@pytest.mark.parametrize("fsdp,zero1,shape", [(True, True, (2, 1)), (True, False, (2, 1)),
                                              (False, True, (2, 1)), (False, False, (1, 2))])
def test_grad_compression_refuses_the_sharded_step(fsdp, zero1, shape):
    from repro_torch.launch.steps import make_train_step
    with pytest.raises(ValueError, match="grad_compression"):
        make_train_step(_cfg(), _tcfg(grad_compression=True, fsdp=fsdp, zero1=zero1),
                        mesh=_stub_mesh(shape))
