"""Tensor-parallel training of every arch, and tensor parallelism inside
the experts, against the JAX package's sharded step and the port's
unsharded step.

The seven archs other than llama (MoE, MLA, recurrent, encoder-decoder,
frontend), reduced, ``int8_spoga``, remat off, batch 4 x 32
(``test_torch_sharded_train._arch_batch``).  Gloo ranks on the CPU,
spawned once per world size for the whole file (2 ranks, then 4):

* **the reference's sharded step**: a JAX subprocess with four host
  devices runs ``make_train_step(grad_specs=param_specs(fsdp=True))`` on
  ``repro.launch.mesh.make_host_mesh(2, 2)`` for each arch, and on
  ``make_host_mesh(1, 4)`` for deepseek-moe-16b with ``num_experts=6``
  (tp=4 does not divide the experts: tensor parallelism inside them), and
  saves its weights, params and AdamW state with the reference's
  ``save_checkpoint``.  The port's step on the same mesh shape from those
  weights, ``TrainConfig()``'s defaults (FSDP and ZeRO-1 on "data"),
  matches it: the loss within ``LOSS_TOL``, the params within
  ``PARAM_RTOL`` / ``PARAM_ATOL``, the AdamW state by
  ``check_adamw_step`` (the reference test's bounds);
* **the port's unsharded step**: on 2x2, 1x2 and 1x4 every gradient leaf
  (gathered with ``shard.gather_tree``) within ``GRAD_TOL`` of its largest
  magnitude and the loss within ``LOSS_TOL``; with remat the gradients
  of deepseek-moe-16b on 2x2 are bitwise those without;
* **serving inside the experts** at tp=4 with 6 experts: the ``LLM``'s
  greedy streams in paged and slot mode equal the JAX package's unsharded
  ``LLM``; at ``int8_spoga`` the prefill and decode logits are bitwise the
  unsharded port's; at ``bf16`` the experts' output is within
  ``BF16_ULPS`` of the unsharded one's largest magnitude (the down
  product sums the ranks' f32 partials and rounds once, the unsharded one
  rounds its own f32 sum);
* ranks that hold the same block hold the same bits after the step, and
  each rank's bytes equal ``shard.tree_device_bytes``;
* ``launch.train.main(["--tp", "2", ...])`` in the two ranks gives the
  losses of ``make_train_step(mesh=)`` on the same batches, for
  minicpm3-4b and deepseek-moe-16b; a deepseek-moe-16b checkpoint saved
  at 1x2 restores onto 2x1 and onto 1x4 (expert-parallel), and the next
  step matches the unsharded step from that checkpoint.

The file reports its own time (about 150 s alone: the JAX subprocess
most of it).
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
from test_torch_sharded_train import (
    GRAD_TOL,
    LOSS_TOL,
    REPO,
    _arch_batch,
    _close_params,
    _full,
    _local_bytes,
    _named,
    _sharded_state,
    _spec_axes,
    check_adamw_step,
)

ARCHS = ("deepseek-moe-16b", "granite-moe-3b-a800m", "minicpm3-4b", "xlstm-125m",
         "recurrentgemma-9b", "seamless-m4t-large-v2", "llava-next-mistral-7b")
# deepseek-moe-16b with 6 experts at tp=4: tensor parallelism inside them
INSIDE = "deepseek-moe-16b/E=6"
INSIDE_EXPERTS = 6
MESHES = ((2, 2), (1, 2), (1, 4))
TCFG = dict(learning_rate=1e-3, warmup_steps=2, total_steps=4)
CLI_ARCHS = ("minicpm3-4b", "deepseek-moe-16b")
CLI_STEPS = 2
RESTORE_TARGETS = ((2, 1), (1, 4))
# the experts' bf16 down product inside the experts: the ranks' f32
# partials summed and rounded once, against the unsharded f32 sum rounded
# once -- at most this many bf16 ulps of the largest output apart
BF16_ULPS = 1
# the serving weights: the JAX init with the projections scaled up, so
# greedy decoding does not collapse (as test_torch_tp_archs.py)
WEIGHT_SCALE = 8.0
GEN = 5
_T0 = time.perf_counter()

_JAX_SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, sys
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
    losses = {}
    for name, arch, experts, dp, tp in json.loads(sys.argv[3]):
        cfg = reduced(get_config(arch)).with_(remat=False, quant_mode="int8_spoga")
        if experts:
            cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, num_experts=experts))
        params = init_params(cfg, jax.random.PRNGKey(0))
        opt = adamw_init(params)
        with np.load(os.path.join(out, name.replace("/", "_") + ".npz")) as f:
            batch = {k: jax.numpy.asarray(f[k]) for k in f.files}
        mesh = make_host_mesh(dp, tp)
        p_specs = shard_lib.param_specs(jax.eval_shape(lambda: params), mesh, cfg, fsdp=True)
        o_specs = shard_lib.opt_state_specs(jax.eval_shape(lambda: opt), p_specs, mesh,
                                            zero1=True)
        b_specs = shard_lib.batch_specs_tree(jax.eval_shape(lambda: batch), mesh)
        with mesh:
            step = jax.jit(make_train_step(cfg, tcfg, grad_specs=p_specs),
                           in_shardings=(shard_lib.named(p_specs, mesh),
                                         shard_lib.named(o_specs, mesh),
                                         shard_lib.named(b_specs, mesh)))
            p1, o1, m1 = step(params, opt, batch)
        d = os.path.join(out, name.replace("/", "_"))
        save_checkpoint(d, 0, params)
        save_checkpoint(d, 1, p1)
        save_checkpoint(d + "-opt", 1, o1)
        losses[name] = float(m1["loss"])
    with open(os.path.join(out, "losses.json"), "w") as f:
        json.dump(losses, f)
""")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    print(f"\n[test_torch_tp_train] {time.perf_counter() - _T0:.1f} s")


def _tcfg(**kw):
    from repro_torch.configs.base import TrainConfig
    return TrainConfig(**TCFG, **kw)


def _cfg(name, mode="int8_spoga"):
    """The reduced config of an arch name, or of ``INSIDE``."""
    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config(name.split("/")[0])).with_(remat=False, quant_mode=mode)
    if name == INSIDE:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, num_experts=INSIDE_EXPERTS))
    return cfg


def _cases():
    """(name, arch, experts, data, model) of the reference's sharded steps."""
    return [[a, a, None, 2, 2] for a in ARCHS] + \
        [[INSIDE, "deepseek-moe-16b", INSIDE_EXPERTS, 1, 4]]


def _npz(batch) -> dict:
    """The batch as numpy, embeddings the bf16 values as f32."""
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy() for k, v in batch.items()}


def _weights(jax_dir, name, step=0):
    """A reference checkpoint of ``name`` as the port's full tree."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.models import param_shapes
    return restore_checkpoint(os.path.join(jax_dir, name.replace("/", "_")), step,
                              param_shapes(_cfg(name)), device="cpu")[1]


def _local_batch(batch, layout):
    if layout.data is None:
        return batch
    return {k: v.chunk(layout.dp)[layout.data.rank] for k, v in batch.items()}


def _grads(full, cfg, mesh, tcfg, remat=False):
    """(the global loss, the gathered gradients) of the sharded step's loss
    on ``mesh`` at ``full``'s blocks."""
    from repro_torch.launch.steps import _sharded_loss_and_grads, sharded_layout
    from repro_torch.runtime import collectives
    from repro_torch.shard.core import gather_tree, shard_params
    layout = sharded_layout(cfg, tcfg, mesh)
    if remat:
        layout = dataclasses.replace(layout, cfg=layout.cfg.with_(remat=True))
    params = shard_params(full, mesh, cfg, fsdp=tcfg.fsdp)
    loss, grads = _sharded_loss_and_grads(params, layout, tcfg,
                                          _local_batch(_arch_batch(cfg), layout))
    if layout.data is not None:
        loss = collectives.all_reduce(loss, layout.data, "sum") / layout.dp
    return float(loss), gather_tree(grads, layout.g_specs, mesh, cfg)


def _step(full, cfg, mesh, tcfg, batch):
    """One sharded step from ``full`` on ``batch`` (global): the loss, the
    gathered params and AdamW state, the rank's blocks, its coordinates
    and its bytes."""
    from repro_torch.launch.steps import make_train_step, sharded_layout
    from repro_torch.shard.core import gather_tree
    from repro_torch.tree import tree_map
    layout = sharded_layout(cfg, tcfg, mesh)
    params, opt = _sharded_state(tree_map(torch.clone, full), cfg, tcfg, mesh)
    params, opt, m = make_train_step(cfg, tcfg, mesh=mesh)(params, opt, batch)
    return dict(loss=float(m["loss"]), params=gather_tree(params, layout.p_specs, mesh, cfg),
                opt=gather_tree(opt, layout.o_specs, mesh, cfg),
                local_params=params, local_opt=opt,
                coords={a: mesh.axis_rank(a) for a in mesh.axis_names},
                param_bytes=_local_bytes(params), opt_bytes=_local_bytes(opt))


def _token_batches(cfg, n):
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    pipe = SyntheticTokenPipeline(cfg.vocab_size, 32, 4, seed=1, device="cpu")
    return [{"tokens": pipe.global_batch_at(i)} for i in range(n)]


def _restore_step(root, mesh):
    """The deepseek-moe-16b checkpoint under ``root`` restored onto
    ``mesh``, then one step on the second token batch: the loss, the
    gathered params and AdamW state, and the restored master, gathered
    before the step."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.launch.steps import make_train_step, sharded_layout
    from repro_torch.models import param_shapes
    from repro_torch.optim.optimizers import adamw_init
    from repro_torch.shard.core import gather_tree
    from repro_torch.tree import tree_map
    cfg, tcfg = _cfg("deepseek-moe-16b"), _tcfg()
    layout = sharded_layout(cfg, tcfg, mesh)
    meta = param_shapes(cfg)
    _, (params, opt), _ = restore_checkpoint(
        root, None, (meta, adamw_init(meta, device="meta")), mesh=mesh,
        specs=(layout.p_specs, layout.o_specs), cfg=cfg)
    # a leaf held whole gathers as itself, and the step updates it in place
    master0 = tree_map(torch.clone, gather_tree(opt["master"], layout.o_specs["master"], mesh,
                                                cfg))
    params, opt, m = make_train_step(cfg, tcfg, mesh=mesh)(params, opt,
                                                          _token_batches(cfg, 2)[1])
    return dict(loss=float(m["loss"]), master0=master0,
                params=gather_tree(params, layout.p_specs, mesh, cfg),
                opt=gather_tree(opt, layout.o_specs, mesh, cfg))


def _rank2(rank, dev, jax_dir, root):
    """1x2: the gradients of every arch; the CLI at --tp 2 against
    ``make_train_step(mesh=)``; a deepseek-moe-16b checkpoint saved at 1x2
    after one step, restored onto 2x1."""
    torch.set_num_threads(1)
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step, sharded_layout
    from repro_torch.models import init_params

    mesh = make_host_mesh(1, 2, backend="gloo", device=dev)
    out = {"grads": {(a, (1, 2)): _grads(_weights(jax_dir, a), _cfg(a), mesh, _tcfg())
                     for a in ARCHS}}
    out["cli"] = {}
    for arch in CLI_ARCHS:
        argv = ["--arch", arch, "--reduced", "--tp", "2", "--steps", str(CLI_STEPS),
                "--batch", "4", "--seq", "32", "--quant-mode", "int8_spoga",
                "--device", "cpu", "--backend", "gloo"]
        got = train_cli.main(argv)
        # what main() builds, stepped by hand
        cfg = reduced(get_config(arch)).with_(quant_mode="int8_spoga")
        tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=5, total_steps=CLI_STEPS)
        params, opt = _sharded_state(init_params(cfg, seed=0, device="cpu"), cfg, tcfg, mesh)
        pipe = SyntheticTokenPipeline(cfg.vocab_size, 32, 4, seed=0, device="cpu")
        step = make_train_step(cfg, tcfg, mesh=mesh)
        want = []
        for i in range(CLI_STEPS):
            params, opt, m = step(params, opt, {"tokens": pipe.global_batch_at(i)})
            want.append(float(m["loss"]))
        out["cli"][arch] = (got, want)
    cfg, tcfg = _cfg("deepseek-moe-16b"), _tcfg()
    layout = sharded_layout(cfg, tcfg, mesh)
    params, opt = _sharded_state(init_params(cfg, seed=0, device="cpu"), cfg, tcfg, mesh)
    params, opt, _ = make_train_step(cfg, tcfg, mesh=mesh)(params, opt,
                                                          _token_batches(cfg, 1)[0])
    manager = CheckpointManager(root, keep_n=1, async_save=False, mesh=mesh, cfg=cfg)
    manager.save(1, (params, opt), specs=(layout.p_specs, layout.o_specs))
    manager.wait()
    del mesh
    out["restore"] = {(2, 1): _restore_step(root, make_host_mesh(2, 1, backend="gloo",
                                                                 device=dev))}
    out["root"] = root
    return out


@functools.lru_cache(maxsize=None)
def _serve_tree():
    """The JAX init of the 6-expert config, projections scaled up."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced as jax_reduced
    from repro.models import init_params as jax_init_params
    jcfg = jax_reduced(jax_get_config("deepseek-moe-16b")).with_(remat=False)
    jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe, num_experts=INSIDE_EXPERTS))
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))

    def scale(path, a):
        if "'w" in jax.tree_util.keystr(path) or "experts" in jax.tree_util.keystr(path):
            return (a.astype(np.float32) * WEIGHT_SCALE).astype(a.dtype)
        return a

    return jcfg, jax.tree_util.tree_map_with_path(scale, tree)


def _serve_runtime(kv_mode, tp=1, quant="int8_spoga"):
    from repro_torch.api import KVConfig, MeshConfig, QuantRuntime, RuntimeConfig, SchedulerConfig
    return RuntimeConfig(quant=QuantRuntime(mode=quant),
                         kv=KVConfig(mode=kv_mode, dtype="int8", page_size=8),
                         scheduler=SchedulerConfig(n_slots=2), mesh=MeshConfig(tp=tp))


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, k).tolist() for k in (5, 11, 3)]


def _serve_cfg(quant="int8_spoga"):
    return _serve_runtime("slot", quant=quant).resolve_model(_cfg(INSIDE))


def _serve_inside(tree, dev, mesh):
    """At tp=4 inside the experts: the ``LLM``'s greedy streams in paged and
    slot mode; the logits of a prefill and 3 decode steps over a slot cache
    against the unsharded port at ``int8_spoga`` (largest difference); the
    experts' output at ``bf16``, sharded and unsharded."""
    from repro_torch.api import LLM
    from repro_torch.models import params_from_jax
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.models.moe import moe_ffn
    from repro_torch.models.transformer import period_params
    from repro_torch.runtime.collectives import model_parallel
    from repro_torch.shard import local_config, shard_params

    out = {"streams": {}}
    cfg = _serve_cfg()
    for kv_mode in ("paged", "slot"):
        llm = LLM(config=_cfg(INSIDE), runtime=_serve_runtime(kv_mode, tp=4),
                  params=params_from_jax(tree, cfg, dev), device=dev)
        out["streams"][kv_mode] = [o.token_ids for o in
                                   llm.generate(_prompts(), max_new_tokens=GEN)]
    full = params_from_jax(tree, cfg, "cpu")
    mine = shard_params(full, mesh, cfg)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, 9)).astype(np.int32))
    want, wcache = prefill(full, cfg, {"tokens": tokens}, 32)
    got, gcache = prefill(mine, cfg, {"tokens": tokens}, 32, mesh=mesh)
    diffs = [float((got - want).abs().max())]
    tok = want.argmax(-1).to(torch.int32)
    for _ in range(3):
        want, wcache = decode_step(full, cfg, tok, wcache)
        got, gcache = decode_step(mine, cfg, tok, gcache, mesh=mesh)
        diffs.append(float((got - want).abs().max()))
        tok = want.argmax(-1).to(torch.int32)
    out["logit_diffs"] = diffs
    bcfg = _serve_cfg("bf16")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 9, bcfg.d_model))
                         .astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        want_y, _ = moe_ffn(x, period_params(full["blocks"][0]["moe"], 0), bcfg)
        with model_parallel(mesh):
            got_y, _ = moe_ffn(x, period_params(mine["blocks"][0]["moe"], 0),
                               local_config(bcfg, 4))
    out["bf16_experts"] = (got_y, want_y)
    return out


def _rank4(rank, dev, jax_dir, root, serve_tree):
    """2x2 and 1x4: the reference's sharded steps, the gradients of every
    arch, remat, serving inside the experts and the restore onto 1x4."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_host_mesh

    out = {"jax": {}, "grads": {}}
    mesh = make_host_mesh(2, 2, backend="gloo", device=dev)
    for arch in ARCHS:
        cfg, tcfg = _cfg(arch), _tcfg()
        full = _weights(jax_dir, arch)
        out["grads"][arch, (2, 2)] = _grads(full, cfg, mesh, tcfg)
        out["jax"][arch] = _step(full, cfg, mesh, tcfg, _arch_batch(cfg))
    cfg = _cfg("deepseek-moe-16b")
    full = _weights(jax_dir, "deepseek-moe-16b")
    off = _grads(full, cfg, mesh, _tcfg())[1]
    on = _grads(full, cfg, mesh, _tcfg(), remat=True)[1]
    out["remat"] = all(torch.equal(a, b) for (_, a), (_, b) in zip(_named(off), _named(on)))
    del mesh
    mesh = make_host_mesh(1, 4, backend="gloo", device=dev)
    for arch in ARCHS:
        out["grads"][arch, (1, 4)] = _grads(_weights(jax_dir, arch), _cfg(arch), mesh, _tcfg())
    cfg, full = _cfg(INSIDE), _weights(jax_dir, INSIDE)
    out["grads"][INSIDE, (1, 4)] = _grads(full, cfg, mesh, _tcfg())
    out["jax"][INSIDE] = _step(full, cfg, mesh, _tcfg(), _arch_batch(cfg))
    out["restore"] = {(1, 4): _restore_step(root, mesh)}
    out["serve"] = _serve_inside(serve_tree, dev, mesh)
    return out


def _jax_reference(out_dir):
    for name, *_ in _cases():
        np.savez(os.path.join(out_dir, name.replace("/", "_") + ".npz"),
                 **_npz(_arch_batch(_cfg(name))))
    env = dict(os.environ)
    env["PYTHONPATH"] = "src"
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, out_dir, json.dumps(TCFG),
                        json.dumps(_cases())],
                       env=env, cwd=REPO, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"


@functools.lru_cache(maxsize=None)
def _results():
    t0 = time.perf_counter()
    jax_dir = tempfile.mkdtemp(prefix="repro_torch_tp_train_")
    root = tempfile.mkdtemp(prefix="repro_torch_tp_train_ckpt_")
    _jax_reference(jax_dir)
    t1 = time.perf_counter()
    two = spawn(_rank2, 2, "gloo", device="cpu", args=(jax_dir, root))
    t2 = time.perf_counter()
    four = spawn(_rank4, 4, "gloo", device="cpu", args=(jax_dir, root, _serve_tree()[1]))
    print(f"[tp-train] JAX reference {t1 - t0:.1f} s, two ranks {t2 - t1:.1f} s, four ranks "
          f"{time.perf_counter() - t2:.1f} s")
    return jax_dir, two, four


@functools.lru_cache(maxsize=None)
def _unsharded_grads(name):
    from repro_torch.launch.steps import _loss_and_grads
    jax_dir = _results()[0]
    cfg = _cfg(name)
    loss, grads = _loss_and_grads(_weights(jax_dir, name), cfg, _tcfg(), _arch_batch(cfg))
    return float(loss), grads


def _ranks(shape):
    _, two, four = _results()
    return two if shape == (1, 2) else four


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS + (INSIDE,))
def test_step_matches_reference_sharded_step(name):
    """The port's 2x2 step (1x4 inside the experts) against the JAX
    package's step on the same mesh shape, from its weights and batch."""
    from repro_torch.models import param_shapes
    from repro_torch.optim.optimizers import adamw_init
    from repro_torch.checkpoint import restore_checkpoint
    jax_dir, _, four = _results()
    with open(os.path.join(jax_dir, "losses.json")) as f:
        want_loss = json.load(f)[name]
    d = os.path.join(jax_dir, name.replace("/", "_"))
    meta = param_shapes(_cfg(name))
    _, want, _ = restore_checkpoint(d, 1, meta, device="cpu")
    _, want_opt, _ = restore_checkpoint(d + "-opt", 1, adamw_init(meta, device="meta"),
                                        device="cpu")
    got = four[0]["jax"][name]
    np.testing.assert_allclose(got["loss"], want_loss, rtol=LOSS_TOL, atol=LOSS_TOL)
    _close_params(got["params"], want, f"{name} against the reference's sharded step")
    check_adamw_step(got["opt"], want_opt, _weights(jax_dir, name), got["params"], _tcfg(),
                     f"{name} against the reference's sharded step")
    for r in four[1:]:
        assert r["jax"][name]["loss"] == got["loss"]


def _grad_cases():
    return [(a, s) for s in MESHES for a in ARCHS] + [(INSIDE, (1, 4))]


@pytest.mark.parametrize("name,shape", _grad_cases(),
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s in _grad_cases()])
def test_gradients_match_unsharded_step(name, shape):
    """Every gradient leaf within ``GRAD_TOL`` of its largest magnitude,
    the loss within ``LOSS_TOL``: a collective missing on the gradient
    path (a dropped *f*, a plain narrow where the scatter belongs) leaves
    a replicated leaf's gradient partial."""
    want_loss, want = _unsharded_grads(name)
    for r in _ranks(shape):
        loss, got = r["grads"][name, shape]
        np.testing.assert_allclose(loss, want_loss, rtol=LOSS_TOL, atol=LOSS_TOL)
        got = _full(got)
        for k, w in _named(want):
            err = float((got[k].float() - w.float()).abs().max())
            assert err <= GRAD_TOL * float(w.float().abs().max()), (name, shape, k, err)


def test_remat_changes_no_gradient_bit():
    """deepseek-moe-16b on 2x2 (expert-parallel, its gathers and scatters
    run again in the recompute): the gradients with remat are bitwise
    those without."""
    for r in _results()[2]:
        assert r["remat"]


@pytest.mark.parametrize("kv_mode", ["paged", "slot"])
def test_inside_experts_streams_equal_jax(kv_mode):
    """Tensor parallelism inside the experts serves the JAX package's
    unsharded greedy streams (tp=4, 6 experts, ``int8_spoga``)."""
    want = _jax_inside_streams()
    assert len({t for s in want for t in s}) > 2, "streams collapsed"
    for r in _results()[2]:
        assert r["serve"]["streams"][kv_mode] == want


@functools.lru_cache(maxsize=None)
def _jax_inside_streams():
    import jax

    from repro.api import LLM as JaxLLM
    from repro.api import KVConfig, QuantRuntime, RuntimeConfig, SchedulerConfig
    jcfg, tree = _serve_tree()
    llm = JaxLLM(config=jcfg, params=jax.tree_util.tree_map(jax.numpy.asarray, tree),
                 runtime=RuntimeConfig(quant=QuantRuntime(mode="int8_spoga"),
                                       kv=KVConfig(mode="paged", dtype="int8", page_size=8),
                                       scheduler=SchedulerConfig(n_slots=2)))
    return [o.token_ids for o in llm.generate(_prompts(), max_new_tokens=GEN)]


def test_inside_experts_logits_bitwise_unsharded():
    """At ``int8_spoga`` the down product inside the experts quantizes
    against the whole ``d_expert``'s scales and sums exact integer
    accumulators: prefill and decode logits are the unsharded port's
    bits."""
    for r in _results()[2]:
        assert r["serve"]["logit_diffs"] == [0.0] * 4


def test_inside_experts_bf16_within_one_ulp():
    """At ``bf16`` the ranks' f32 partials of the down product are summed
    and rounded once, where the unsharded product rounds its own f32 sum:
    the experts' output is within ``BF16_ULPS`` bf16 ulps of the largest
    magnitude, not bitwise."""
    for r in _results()[2]:
        got, want = r["serve"]["bf16_experts"]
        ulp = 2.0 ** -7 * float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= BF16_ULPS * ulp


def _stub_mesh(shape):
    return types.SimpleNamespace(shape=dict(zip(("data", "model"), shape)),
                                 axis_names=("data", "model"))


def _state_specs(name, shape):
    from repro_torch.models import param_shapes
    from repro_torch.optim.optimizers import adamw_init
    from repro_torch.runtime.sharding import opt_state_specs, param_specs
    cfg, mesh = _cfg(name), _stub_mesh(shape)
    meta = param_shapes(cfg)
    opt = adamw_init(meta, device="meta")
    p_specs = param_specs(meta, mesh, cfg, fsdp=True)
    return mesh, meta, opt, p_specs, opt_state_specs(opt, p_specs, mesh, True)


def _step_shape(name):
    return (1, 4) if name == INSIDE else (2, 2)


@pytest.mark.parametrize("name", ARCHS + (INSIDE,))
def test_replicas_hold_the_same_bits(name):
    from repro_torch.runtime.sharding import spec_leaves
    _, meta, opt, p_specs, o_specs = _state_specs(name, _step_shape(name))
    ranks = [r["jax"][name] for r in _results()[2]]
    pairs = 0
    for key, specs, like in (("local_params", p_specs, meta), ("local_opt", o_specs, opt)):
        for i, spec in enumerate(spec_leaves(specs, like)):
            groups = {}
            for r in ranks:
                held = tuple(r["coords"][a] for a in sorted(_spec_axes(spec)))
                groups.setdefault(held, []).append(_named(r[key])[i])
            for members in groups.values():
                leaf, first = members[0]
                for _, other in members[1:]:
                    assert torch.equal(first, other), (name, key, leaf)
                    pairs += 1
    assert pairs > 0


@pytest.mark.parametrize("name", ARCHS + (INSIDE,))
def test_rank_bytes_equal_tree_device_bytes(name):
    from repro_torch.shard import tree_device_bytes
    mesh, meta, opt, p_specs, o_specs = _state_specs(name, _step_shape(name))
    for r in _results()[2]:
        assert r["jax"][name]["param_bytes"] == tree_device_bytes(meta, p_specs, mesh)
        assert r["jax"][name]["opt_bytes"] == tree_device_bytes(opt, o_specs, mesh)


@pytest.mark.parametrize("arch", CLI_ARCHS)
def test_train_cli_at_tp2_gives_the_step_losses(arch):
    """``launch.train.main([... "--tp", "2"])`` in two ranks: the losses of
    ``make_train_step(mesh=)`` on the same batches from the same init."""
    for r in _results()[1]:
        got, want = r["cli"][arch]
        assert len(got) == CLI_STEPS and got == want, (got, want)


@functools.lru_cache(maxsize=None)
def _unsharded_resume():
    """The unsharded step from the deepseek-moe-16b checkpoint saved at 1x2,
    restored whole: the loss, params and AdamW state after it."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import param_shapes
    from repro_torch.optim.optimizers import adamw_init
    cfg, tcfg = _cfg("deepseek-moe-16b"), _tcfg()
    meta = param_shapes(cfg)
    _, (params, opt), _ = restore_checkpoint(_results()[1][0]["root"], None,
                                             (meta, adamw_init(meta, device="meta")),
                                             device="cpu")
    params, opt, m = make_train_step(cfg, tcfg)(params, opt, _token_batches(cfg, 2)[1])
    return float(m["loss"]), params, opt


@pytest.mark.parametrize("target", RESTORE_TARGETS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_elastic_restore_from_1x2(target):
    """A deepseek-moe-16b checkpoint saved at 1x2 after one step restores
    onto ``target`` (1x4: 2 experts a rank), and the next step matches the
    unsharded step from the same checkpoint restored whole."""
    want_loss, want, want_opt = _unsharded_resume()
    _, two, four = _results()
    for r in two if target == (2, 1) else four:
        got = r["restore"][target]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=LOSS_TOL, atol=LOSS_TOL)
        _close_params(got["params"], want, f"restored onto {target}")
        check_adamw_step(got["opt"], want_opt, got["master0"], got["params"], _tcfg(),
                         f"restored onto {target}")
