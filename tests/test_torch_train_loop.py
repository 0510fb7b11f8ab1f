"""The port's train step, ``train_loop`` and training CLI (mirrors
``test_training_integration.py`` and ``test_fault_tolerance.py``'s
training tests).

* Three ``make_train_step`` steps from the reference's weights and AdamW
  state (carried across with ``params_from_jax`` / ``opt_state_from_jax``)
  on the reference's own batches, against its jitted step: the losses
  within ``STEP_LOSS_RTOL`` = 1e-3 (the first bitwise at ``int8_spoga``;
  later ones read params that Adam moved by up to ``lr`` a step from
  gradients equal within ``test_torch_train.py``'s GRAD_TOL), the params
  within ``2 * lr * steps`` absolute (Adam's first steps are sign-like, so
  a gradient of the other sign moves a weight by up to 2 lr a step).
* Microbatches 4 against 1 within the reference test's ``rtol``s; the
  loss falling (dense and ``int8_spoga``); the three integer dataflows'
  loss curves bitwise equal; 3 steps + restore + 3 bitwise equal to 6.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data.pipeline import SyntheticTokenPipeline as JaxPipeline
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import init_params as jax_init_params
from repro.optim.optimizers import adamw_init as jax_adamw_init
from repro_torch import configs as tconfigs
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import train as train_mod
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import train_loop
from repro_torch.models import init_params, opt_state_from_jax, params_from_jax
from repro_torch.optim import adamw_init
from repro_torch.tree import leaves, tree_map

STEP_LOSS_RTOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the host's cores; small ops slow down
    when torch's intra-op threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    return tconfigs.reduced(tconfigs.get_config("llama3.2-1b")).with_(n_layers=2, remat=False,
                                                                       **kw)


@pytest.mark.parametrize("mode", ["bf16", "int8_spoga"])
def test_train_steps_match_jax(mode):
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=6)
    jcfg = jax_reduced(jax_get_config("llama3.2-1b")).with_(n_layers=2, remat=False,
                                                             quant_mode=mode)
    tcfg = _cfg(quant_mode=mode)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jstate = jax_adamw_init(jparams)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    state = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), tcfg, "cpu")
    jstep = jax.jit(jax_make_train_step(jcfg, JaxTrainConfig(**kw)))
    step = make_train_step(tcfg, TrainConfig(**kw))
    pipe = JaxPipeline(jcfg.vocab_size, 32, 4, seed=0)
    for i in range(3):
        tokens = pipe.global_batch_at(i)
        jparams, jstate, jm = jstep(jparams, jstate, {"tokens": tokens})
        params, state, m = step(params, state, {"tokens": torch.from_numpy(np.array(tokens))})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=STEP_LOSS_RTOL)
        if i == 0 and mode == "int8_spoga":
            assert float(m["loss"]) == float(jm["loss"])
    assert int(state["step"]) == 3
    bound = 2 * kw["learning_rate"] * 3
    for a, b in zip(jax.tree_util.tree_leaves(jparams), leaves(params)):
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32), rtol=0,
                                   atol=bound)
    start = jax.tree_util.tree_leaves(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    moved = sum(int((b.float().numpy() != np.asarray(a, np.float32)).sum())
                for a, b in zip(start, leaves(params)))
    assert moved > 0.9 * sum(t.numel() for t in leaves(params))


def test_microbatched_grad_accum_matches_full_batch():
    """k microbatches with mean-accumulated f32 gradients against one full
    batch step (test_training_integration.py's ``rtol``s)."""
    cfg = _cfg()
    params = init_params(cfg, seed=0, device="cpu")
    state = adamw_init(params, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (8, 32), generator=torch.Generator().manual_seed(1))
    clone = lambda tree: tree_map(lambda t: t.clone(), tree)  # noqa: E731
    p1, _, m1 = make_train_step(cfg, TrainConfig())(clone(params), clone(state),
                                                    {"tokens": tokens})
    p2, _, m2 = make_train_step(cfg, TrainConfig(microbatches=4))(clone(params), clone(state),
                                                                  {"tokens": tokens})
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5, atol=1e-5)
    for a, b in zip(leaves(p1), leaves(p2)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=1e-3, atol=1e-5)


def test_grad_reduce_dtype_bf16_trains():
    """``grad_reduce_dtype="bf16"`` casts every gradient to bf16 (the f32
    norm scales' too) and the f32 master absorbs the rounding."""
    cfg = _cfg()
    params = init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (4, 32), generator=torch.Generator().manual_seed(2))
    step = make_train_step(cfg, TrainConfig(grad_reduce_dtype="bf16"))
    _, state, m = step(params, adamw_init(params, device="cpu"), {"tokens": tokens})
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    assert state["master"]["final_norm"].dtype == torch.float32


@pytest.mark.parametrize("mode,margin", [("bf16", 0.25), ("int8_spoga", 0.2)])
def test_loss_decreases(mode, margin):
    """test_training_integration.py: 25 steps of a 2-layer reduced llama
    lower the mean of the last 3 losses by ``margin`` from the first 3; at
    ``int8_spoga`` (the paper's W8A8 SPOGA dataflow) too."""
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=3, total_steps=25)
    _, losses = train_loop(_cfg(quant_mode=mode), tcfg, steps=25, batch=4, seq=64,
                           log_every=100, device="cpu")
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) - margin, losses


def test_quant_modes_agree_exactly():
    """spoga / deas / direct are the same integer arithmetic: the training
    curves match bit for bit."""
    curves = {}
    for mode in ("int8_spoga", "int8_deas", "int8_direct"):
        tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=6)
        _, curves[mode] = train_loop(_cfg(quant_mode=mode), tcfg, steps=6, batch=2, seq=32,
                                     log_every=100, device="cpu")
    assert curves["int8_spoga"] == curves["int8_deas"] == curves["int8_direct"]


def test_training_resume_bit_exact(tmp_path):
    """6 steps straight against 3 + checkpoint + restore + 3: the final
    params bitwise equal (stateless pipeline, async checkpoint of host
    copies)."""
    cfg = _cfg(quant_mode="int8_spoga")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=6)
    params_a, losses_a = train_loop(cfg, tcfg, steps=6, batch=2, seq=32, log_every=100,
                                    device="cpu")
    ckpt = str(tmp_path / "ckpt")
    train_loop(cfg, tcfg, steps=3, batch=2, seq=32, ckpt_dir=ckpt, checkpoint_every=3,
               log_every=100, device="cpu")
    params_b, losses_b = train_loop(cfg, tcfg, steps=6, batch=2, seq=32, ckpt_dir=ckpt,
                                    checkpoint_every=100, log_every=100, device="cpu")
    assert losses_b == losses_a[3:]
    for a, b in zip(leaves(params_a), leaves(params_b)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_train_cli_on_cpu(capsys, tmp_path):
    """``python -m repro_torch.launch.train --reduced --device cpu`` logs the
    reference's lines, checkpoints and resumes."""
    argv = ["--arch", "llama3.2-1b", "--reduced", "--steps", "3", "--batch", "2", "--seq",
            "16", "--quant-mode", "int8_spoga", "--device", "cpu", "--ckpt-dir",
            str(tmp_path)]
    train_mod.main(argv)
    out = capsys.readouterr().out
    assert out.count("[train] step") == 3 and "first loss" in out
    assert "gnorm" in out and "lr" in out
    train_mod.main(argv[:4] + ["4"] + argv[5:])
    assert "[train] resumed from step 3" in capsys.readouterr().out


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_train_needs_a_card_unless_told_otherwise():
    """No fallback: without a card, ``train_loop`` and the CLI without
    ``--device cpu`` raise."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop(_cfg(), TrainConfig(), steps=1, batch=1, seq=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.main(["--reduced", "--steps", "1"])
