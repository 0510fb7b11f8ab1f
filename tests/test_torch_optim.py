"""The port's optimizers, data pipeline, fault tolerance and training
checkpoints against the JAX package.

* Optimizers: schedules, ``global_norm`` / clipping and one AdamW or SGD
  update fed the same numpy gradients as the reference's jitted update,
  within ``OPT_RTOL`` = 1e-6 (XLA may contract ``b * m + (1 - b) * g`` into
  one FMA and computes ``b ** step`` with its own ``pow``; torch rounds each
  op; the global norm within ``NORM_RTOL`` = 1e-5, a sum of ~10^6 f32
  squares taken in another order), and the state's layout and dtypes the
  reference's.
* The pipeline: ``test_data_pipeline.py``'s properties and
  ``test_fault_tolerance.py::test_pipeline_restart_bit_exact`` (the tokens
  themselves cannot be ``jax.random``'s).
* Fault tolerance: every ``test_fault_tolerance.py`` test that runs no JAX
  training, on the port's copy of the module.
* Checkpoints: ``CheckpointManager`` (gc, async), ``restore_checkpoint``
  into a ``like_tree``, and ``(params, opt_state)`` saved by each package
  and restored by the other, bitwise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import restore_checkpoint as jax_restore_checkpoint
from repro.checkpoint.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models import init_params as jax_init_params
from repro.optim import optimizers as jax_opt
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import CheckpointManager, restore_checkpoint, save_checkpoint
from repro_torch.configs.base import TrainConfig
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.models import init_params, opt_state_from_jax, params_from_jax
from repro_torch.optim import (
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    make_schedule,
    sgd_init,
    sgd_update,
)
from repro_torch.runtime import ElasticPlan, StragglerMonitor, WorkerFailure, run_with_restart
from repro_torch.tree import leaves, named_leaves, tree_map

OPT_RTOL = 1e-6
# a global norm sums ~10^6 squares in f32, and XLA's CPU reduction adds
# them in another order than torch's
NORM_RTOL = 1e-5


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


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _configs():
    jcfg = jax_reduced(jax_get_config("llama3.2-1b")).with_(remat=False)
    tcfg = tconfigs.reduced(tconfigs.get_config("llama3.2-1b"))
    return jcfg, tcfg


def _jax_tree(jcfg, seed=0):
    return jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(seed)))


def _grads_like(tree, seed, scale=1e-2):
    """numpy gradients shaped and typed like ``tree``'s leaves."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * scale).astype(a.dtype), tree)


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_matches_reference(schedule):
    kw = dict(learning_rate=3e-3, warmup_steps=3, total_steps=11, schedule=schedule)
    ref = jax.jit(jax_opt.make_schedule(JaxTrainConfig(**kw)))
    sched = make_schedule(TrainConfig(**kw))
    for step in range(0, 14):
        got = sched(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(ref(jnp.int32(step))), rtol=OPT_RTOL)


def test_global_norm_and_clip_match_reference():
    jcfg, _ = _configs()
    g = _grads_like(_jax_tree(jcfg), 1, scale=0.3)
    tg = tree_map(_t, g)
    np.testing.assert_allclose(float(global_norm(tg)),
                               float(jax.jit(jax_opt.global_norm)(g)), rtol=NORM_RTOL)
    for max_norm in (0.5, 1e9):
        clipped, norm = clip_by_global_norm(tg, max_norm)
        jclipped, jnorm = jax.jit(jax_opt.clip_by_global_norm, static_argnums=1)(g, max_norm)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=NORM_RTOL)
        jflat = [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(jclipped)]
        for a, b in zip(jflat, leaves(clipped)):
            # a clipped bf16 leaf is rounded back to bf16: within one ulp
            np.testing.assert_allclose(_np(b), a, rtol=2 ** -7 if b.dtype == torch.bfloat16
                                       else NORM_RTOL, atol=1e-30)


def test_adamw_init_layout_and_master_is_a_copy():
    """The reference's state layout; every leaf f32 and new (the master of
    an f32 param is a copy, never an alias)."""
    jcfg, tcfg = _configs()
    params = init_params(tcfg, seed=0, device="cpu")
    state = adamw_init(params, device="cpu")
    assert sorted(state) == ["m", "master", "step", "v"]
    assert state["step"].dtype == torch.int32 and state["step"].dim() == 0
    jstate = jax.eval_shape(jax_opt.adamw_init, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    want = [(jax.tree_util.keystr(p), tuple(s.shape), str(s.dtype))
            for p, s in jax.tree_util.tree_flatten_with_path(jstate)[0]]
    got = [(n, tuple(t.shape), str(t.dtype).removeprefix("torch.").replace("float32", "float32"))
           for n, t in named_leaves(state)]
    assert got == want
    for p, w in zip(leaves(params), leaves(state["master"])):
        assert w.dtype == torch.float32 and w.data_ptr() != p.data_ptr()
        assert torch.equal(w, p.float())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if not torch.cuda.is_available():
            adamw_init(params)


@pytest.mark.parametrize("microbatched", [False, True])
def test_adamw_update_matches_reference(microbatched):
    """Three updates from the same params and state, fed the same numpy
    gradients: params (a cast of the master), moments, master and metrics
    within OPT_RTOL of the reference's jitted ``adamw_update`` (of each
    leaf's largest magnitude: a moment can cancel to near 0).  With
    ``microbatched`` the gradients are f32 (the accumulator's dtype).  The
    clip threshold is out of reach, so the update is elementwise: an
    active clip scales by the global norm, whose summation order can flip
    a bf16 gradient's rounding (held within NORM_RTOL by
    ``test_global_norm_and_clip_match_reference``)."""
    jcfg, tcfg = _configs()
    tree = _jax_tree(jcfg)
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=6, weight_decay=0.1,
              grad_clip=1e9)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jax_opt.adamw_init(jparams)
    params = params_from_jax(tree, tcfg, "cpu")
    state = adamw_init(params, device="cpu")
    jupd = jax.jit(jax_opt.adamw_update, static_argnums=3)
    for step in range(3):
        g = _grads_like(tree, 10 + step)
        if microbatched:
            g = jax.tree_util.tree_map(lambda a: a.astype(np.float32), g)
        jparams, jstate, jm = jupd(jparams, jax.tree_util.tree_map(jnp.asarray, g), jstate,
                                   JaxTrainConfig(**kw))
        params, state, m = adamw_update(params, tree_map(_t, g), state, TrainConfig(**kw))
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=OPT_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=NORM_RTOL)
    assert int(state["step"]) == int(jstate["step"]) == 3
    for key in ("m", "v", "master"):
        for a, b in zip(jax.tree_util.tree_leaves(jstate[key]), leaves(state[key])):
            a = np.asarray(a)
            np.testing.assert_allclose(_np(b), a, rtol=0, atol=OPT_RTOL * np.abs(a).max())
    for a, b in zip(jax.tree_util.tree_leaves(jparams), leaves(params)):
        assert b.dtype == (torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)
        # a cast of a master within OPT_RTOL: at most one ulp of the param dtype
        np.testing.assert_allclose(_np(b), np.asarray(a, np.float32), rtol=2 ** -7)


def test_sgd_update_matches_reference():
    """Two momentum-SGD updates against the reference's jitted
    ``sgd_update``, within OPT_RTOL.  The tree has no tuples: the
    reference's ``sgd_update`` unzips its per-leaf pairs with
    ``is_leaf=isinstance(t, tuple)``, which also takes a model tree's
    ``"blocks"`` tuple for a pair and raises (ROADMAP queue 3); the port's
    takes any tree."""
    rng = np.random.default_rng(4)
    tree = {"w": (rng.standard_normal((16, 24)) * 0.1).astype(jnp.bfloat16),
            "norm": np.ones(24, np.float32),
            "sub": {"b": rng.standard_normal(24).astype(np.float32)}}
    cfg = dict(learning_rate=1e-2, warmup_steps=1, total_steps=4, schedule="constant",
               grad_clip=1e9)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jax_opt.sgd_init(jparams)
    params = tree_map(_t, tree)
    state = sgd_init(params, device="cpu")
    for step in range(2):
        g = _grads_like(tree, 20 + step)
        jparams, jstate, jm = jax.jit(jax_opt.sgd_update, static_argnums=3)(
            jparams, jax.tree_util.tree_map(jnp.asarray, g), jstate, JaxTrainConfig(**cfg))
        params, state, m = sgd_update(params, tree_map(_t, g), state, TrainConfig(**cfg))
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=NORM_RTOL)
    assert int(state["step"]) == 2
    for a, b in zip(jax.tree_util.tree_leaves(jstate["mom"]), leaves(state["mom"])):
        a = np.asarray(a)
        np.testing.assert_allclose(_np(b), a, rtol=0, atol=OPT_RTOL * np.abs(a).max())
    for a, b in zip(jax.tree_util.tree_leaves(jparams), leaves(params)):
        np.testing.assert_allclose(_np(b), np.asarray(a, np.float32), rtol=2 ** -7)
    model_tree = {"blocks": (tree,)}
    with pytest.raises(IndexError):
        jax_opt.sgd_update(model_tree, model_tree, jax_opt.sgd_init(model_tree),
                           JaxTrainConfig(**cfg))
    sgd_update(tree_map(_t, model_tree), tree_map(_t, model_tree),
               sgd_init(tree_map(_t, model_tree), device="cpu"), TrainConfig(**cfg))


# ---------------------------------------------------------------------------
# Data pipeline (test_data_pipeline.py)
# ---------------------------------------------------------------------------

def _pipe(**kw):
    return SyntheticTokenPipeline(device="cpu", **kw)


def test_pipeline_deterministic_across_instances():
    a = _pipe(vocab_size=128, seq_len=16, global_batch=8, seed=7)
    b = _pipe(vocab_size=128, seq_len=16, global_batch=8, seed=7)
    for i in range(4):
        assert torch.equal(a.global_batch_at(i), b.global_batch_at(i))
    assert not torch.equal(a.global_batch_at(0),
                           _pipe(vocab_size=128, seq_len=16, global_batch=8,
                                 seed=8).global_batch_at(0))


def test_pipeline_different_steps_differ():
    p = _pipe(vocab_size=128, seq_len=16, global_batch=8, seed=0)
    assert not torch.equal(p.global_batch_at(0), p.global_batch_at(1))


def test_pipeline_tokens_in_vocab():
    t = _pipe(vocab_size=97, seq_len=33, global_batch=5, seed=1).global_batch_at(0)
    assert tuple(t.shape) == (5, 33) and t.dtype == torch.int32
    assert int(t.min()) >= 0 and int(t.max()) < 97


def test_pipeline_host_slices_partition_global_batch():
    full = _pipe(vocab_size=64, seq_len=8, global_batch=12, seed=2).global_batch_at(5)
    parts = [_pipe(vocab_size=64, seq_len=8, global_batch=12, seed=2, n_hosts=4,
                   host_id=h).host_batch_at(5) for h in range(4)]
    assert torch.equal(torch.cat(parts, dim=0), full)
    it = iter(_pipe(vocab_size=64, seq_len=8, global_batch=12, seed=2))
    assert torch.equal(next(it), _pipe(vocab_size=64, seq_len=8, global_batch=12,
                                       seed=2).host_batch_at(0))


def test_pipeline_not_iid_uniform():
    """A bigram model beats the unigram entropy floor by a clear margin."""
    t = _pipe(vocab_size=64, seq_len=256, global_batch=16, seed=3).global_batch_at(0).numpy()
    pairs = {}
    for row in t:
        for a, b in zip(row[:-1], row[1:]):
            pairs.setdefault(int(a), []).append(int(b))
    ents = []
    for nxt in pairs.values():
        _, counts = np.unique(nxt, return_counts=True)
        q = counts / counts.sum()
        ents.append(-(q * np.log2(q)).sum())
    assert np.mean(ents) < 0.8 * np.log2(64)


def test_pipeline_restart_bit_exact():
    p1 = _pipe(vocab_size=512, seq_len=32, global_batch=4, seed=3)
    ref = [p1.global_batch_at(i) for i in range(6)]
    p2 = _pipe(vocab_size=512, seq_len=32, global_batch=4, seed=3)
    for i in (3, 4, 5):
        assert torch.equal(p2.global_batch_at(i), ref[i])


def test_pipeline_defaults_to_the_card():
    p = SyntheticTokenPipeline(vocab_size=64, seq_len=8, global_batch=2)
    if torch.cuda.is_available():
        assert p.global_batch_at(0).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            p.global_batch_at(0)


# ---------------------------------------------------------------------------
# Fault tolerance (test_fault_tolerance.py)
# ---------------------------------------------------------------------------

def test_straggler_flags_slow_host():
    mon = StragglerMonitor(n_hosts=4, threshold=2.0)
    for _ in range(10):
        for h in range(3):
            mon.record(h, 1.0)
        mon.record(3, 5.0)
    assert mon.stragglers() == [3]


def test_straggler_no_false_positives():
    mon = StragglerMonitor(n_hosts=4)
    for _ in range(10):
        for h in range(4):
            mon.record(h, 1.0 + 0.05 * h)
    assert mon.stragglers() == []


def test_straggler_transient_spike_decays():
    mon = StragglerMonitor(n_hosts=2, threshold=2.0, alpha=0.5)
    mon.record(0, 1.0)
    mon.record(1, 1.0)
    mon.record(1, 10.0)
    for _ in range(12):
        mon.record(0, 1.0)
        mon.record(1, 1.0)
    assert mon.stragglers() == []


@pytest.mark.parametrize("healthy,tp,want", [(256, 16, (16, 16)), (240, 16, (15, 16)),
                                             (6, 16, None)])
def test_elastic_plan(healthy, tp, want):
    p = ElasticPlan.plan(healthy, tp)
    if want is None:
        assert p.dp * p.model == healthy
    else:
        assert p == ElasticPlan(dp=want[0], model=want[1])


def test_restart_recovers_and_completes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=3)
    fail_at = {7}

    def step_fn(step, state):
        if step in fail_at:
            fail_at.clear()
            raise WorkerFailure(f"injected at {step}")
        return state + 1.0

    (step, state), restarts = run_with_restart(
        lambda: (0, torch.zeros(4)), step_fn, mgr, n_steps=12, checkpoint_every=3)
    assert restarts == 1 and step == 12
    assert torch.equal(state, torch.full((4,), 12.0))


def test_restart_gives_up_after_max_failures(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=3)

    def always_fail(step, state):
        raise WorkerFailure("permanent")

    with pytest.raises(WorkerFailure):
        run_with_restart(lambda: (0, torch.zeros(4)), always_fail, mgr, n_steps=5,
                         checkpoint_every=2, max_failures=2)


# ---------------------------------------------------------------------------
# Checkpoints of a training state
# ---------------------------------------------------------------------------

def _train_state(tcfg, seed=0):
    params = init_params(tcfg, seed=seed, device="cpu")
    state = adamw_init(params, device="cpu")
    g = tree_map(lambda p: torch.full_like(p, 0.01), params)
    params, state, _ = adamw_update(params, g, state, TrainConfig())
    return params, state


def test_manager_keeps_last_n_and_saves_async(tmp_path):
    """``keep_n`` steps stay on disk; an async save copies to the host
    before its thread starts, so an in-place update right after it never
    reaches the files; ``restore_latest`` waits for the thread."""
    _, tcfg = _configs()
    params, state = _train_state(tcfg)
    mgr = CheckpointManager(str(tmp_path), keep_n=2, async_save=True)
    for step in (1, 2, 3):
        mgr.save(step, (params, state), metadata={"step": step})
    want = tree_map(lambda t: t.clone(), (params, state))
    for t in leaves((params, state)):
        t.add_(1)                      # in place, while the last save may still run
    step, got, meta = mgr.restore_latest(tree_map(lambda t: t.clone(), (params, state)))
    assert step == 3 and meta == {"step": 3}
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]
    for (name, a), b in zip(named_leaves(got), leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_train_state_round_trips_across_packages(tmp_path, writer):
    """``(params, opt_state)`` saved by one package restores in the other,
    every leaf bitwise in dtype and bits, under the same key paths."""
    jcfg, tcfg = _configs()
    tree = _jax_tree(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jax_opt.adamw_update(jparams, jax.tree_util.tree_map(jnp.asarray,
                                                                  _grads_like(tree, 3)),
                                  jax_opt.adamw_init(jparams), JaxTrainConfig())[1]
    np_state = jax.tree_util.tree_map(np.asarray, jstate)
    params = params_from_jax(tree, tcfg, "cpu")
    state = opt_state_from_jax(np_state, tcfg, "cpu")
    if writer == "jax":
        jax_save_checkpoint(str(tmp_path), 4, (jparams, jstate))
        like = (init_params(tcfg, device="meta"), adamw_init(params, device="cpu"))
        step, (p2, s2), _ = restore_checkpoint(str(tmp_path), None, like, device="cpu")
        assert step == 4
        got, want = list(named_leaves((p2, s2))), list(named_leaves((params, state)))
        assert [n for n, _ in got] == [n for n, _ in want]
        for (name, a), (_, b) in zip(got, want):
            assert a.dtype == b.dtype and a.device.type == "cpu", name
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)
    else:
        save_checkpoint(str(tmp_path), 4, (params, state))
        step, (jp2, js2), _ = jax_restore_checkpoint(str(tmp_path), None, (jparams, jstate))
        assert step == 4
        for x, y in zip(jax.tree_util.tree_leaves((jparams, jstate)),
                        jax.tree_util.tree_leaves((jp2, js2))):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(np.asarray(x).reshape(-1).view(np.uint8),
                                          np.asarray(y).reshape(-1).view(np.uint8))


def test_restore_into_like_tree_checks_each_leaf(tmp_path):
    """``restore_checkpoint(dir, step, like_tree)``: the reference's
    argument; a leaf of another name, shape or dtype raises ``ValueError``
    naming it, and a ``"meta"`` tree restores where ``device`` says."""
    _, tcfg = _configs()
    params, state = _train_state(tcfg)
    save_checkpoint(str(tmp_path), 1, (params, state))
    step, (p2, _), _ = restore_checkpoint(
        str(tmp_path), 1, (init_params(tcfg, device="meta"), state), device="cpu")
    assert p2["embed"].device.type == "cpu"
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_checkpoint(str(tmp_path), 1, params, device="cpu")
    bad = tree_map(lambda t: t, state)
    bad["step"] = torch.zeros((), dtype=torch.int64)
    with pytest.raises(ValueError, match=r"\['step'\].*needs"):
        restore_checkpoint(str(tmp_path), 1, (params, bad))
    wide = init_params(tcfg.with_(d_ff=2 * tcfg.d_ff), device="meta")
    with pytest.raises(ValueError, match="needs"):
        restore_checkpoint(str(tmp_path), 1, (wide, state), device="cpu")
