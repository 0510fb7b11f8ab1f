"""The dry run (``repro_torch.launch.dryrun``): its collective sums against
the JAX package's HLO parser, one rank's program on ``"meta"`` tensors
against the same program on four gloo CPU ranks, calibration, the
kernels' meta branches and ``main``.

* ``collective_stats`` over recorded calls equals the reference's
  ``collective_stats`` over the same collectives written as HLO lines;
* reduced llama3.2-1b (dense), deepseek-moe-16b (MoE, its dense lead
  layer) and seamless-m4t-large-v2 (encoder-decoder), ``int8_spoga`` on
  the ``cuda_spoga_dequant`` backend, at a small train, prefill and decode
  shape on a 2x2 mesh: each rank's program on a dry mesh and on meta
  tensors counts exactly what the same rank counts on four gloo CPU
  ranks with real collectives -- collectives (count and bytes per kind,
  and each call), operations, bytes, kernel calls (``META_CALLS`` there,
  ``PLAIN_CALLS`` here) -- and rank 0's record equals rank 3's;
* ``calibrated_costs`` equals the full-depth counts exactly (4 periods;
  the encoder-decoder's 4 encoder layers scale with them linearly), but
  for a train step's bytes, whose term quadratic in depth (the stacked
  leaves' slice backward) it misses by exactly that term;
* a (2, 2, 1) multi-pod mesh (the batch over ("pod", "data") as one data
  axis, FSDP on "data") takes the reference's step on the same host mesh
  (a JAX subprocess, run beside the gloo ranks), and the port's (4, 1)
  step: its AdamW moments, the gradient scaled and squared, within 1e-5;
* ``optim.global_norm`` of a rank's blocks is the whole tree's, inf and
  not NaN where a replicated leaf holds an inf;
* the kernels' meta branches count ``META_CALLS`` and the kernel's work,
  and touch neither ``LAUNCHES`` nor ``PLAIN_CALLS``;
* ``main`` on one full-size cell writes one record with the reference's
  keys and exits 0; a ``--device cuda`` record's counts are a meta run's.

About 55 s in one process (the four spawned ranks about 20 s of it).
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch
from test_torch_sharded_train import LOSS_TOL, REPO, TCFG, check_adamw_step

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.launch.dryrun import calibrated_costs, collective_stats, kernel_counts, main
from repro_torch.launch.mesh import make_dry_mesh, spawn
from repro_torch.launch.steps import lower_cell
from repro_torch.runtime import counters

ARCHS = ("llama3.2-1b", "deepseek-moe-16b", "seamless-m4t-large-v2")
SMALL = {"train": ShapeConfig("train_small", "train", 16, 8),
         "prefill": ShapeConfig("prefill_small", "prefill", 16, 4),
         "decode": ShapeConfig("decode_small", "decode", 32, 4)}
MESH = (2, 2)
# the multi-pod layout's data axis, ("pod", "data") as one, against "data"
POD_MESHES = (((2, 2, 1), ("pod", "data", "model")), ((4, 1), ("data", "model")))

# the keys of the reference's run_cell record (repro/launch/dryrun.py)
REF_KEYS = {"arch", "shape", "kind", "mesh", "devices", "quant_mode", "gemm_backend", "zero1",
            "fsdp", "microbatches", "remat_policy", "kv_cache_dtype", "grad_reduce_dtype",
            "lower_s", "compile_s", "memory", "hbm_per_device_gib", "cost", "collectives", "ok"}
REF_MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "code_bytes"}
REF_COST = {"flops_per_device", "bytes_accessed_per_device"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    return reduced(get_config(arch)).with_(quant_mode="int8_spoga",
                                           gemm_backend="cuda_spoga_dequant")


def _record(lowered) -> dict:
    """What one run of a rank's program counts, and its kernels' calls by
    branch."""
    before = kernel_counts()
    compiled = lowered.compile()
    after = kernel_counts()
    c = compiled.counts
    return {"ops": c.ops, "bytes": c.bytes, "collectives": collective_stats(c.collectives),
            "calls": sorted((k, str(d), s) for k, d, s in c.collectives),
            "kernels": dict(c.kernels),
            "argument_bytes": compiled.memory_analysis().argument_size_in_bytes,
            "branch": {name: tuple(a - b for a, b in zip(after[name], before[name]))
                       for name in after}}


# the reference's step on the (pod, data, model) = (2, 2, 1) host mesh, from
# the port's seed-0 weights and the same tokens, at the learning rate of the
# sharded-training tests (TCFG: the step moves an element far beyond f32's
# rounding of the master)
_JAX_POD_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np

    from repro.checkpoint.checkpoint import restore_checkpoint, save_checkpoint
    from repro.configs import get_config, reduced
    from repro.configs.base import TrainConfig
    from repro.launch.mesh import _make_mesh
    from repro.launch.steps import make_train_step
    from repro.models import init_params
    from repro.optim.optimizers import adamw_init
    from repro.runtime import sharding as shard_lib

    out = sys.argv[1]
    cfg = reduced(get_config("llama3.2-1b")).with_(quant_mode="int8_spoga")
    like = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
    _, params, _ = restore_checkpoint(out, 0, like)
    opt = adamw_init(params)
    batch = {"tokens": jax.numpy.asarray(np.load(os.path.join(out, "tokens.npy")))}
    mesh = _make_mesh((2, 2, 1), ("pod", "data", "model"))
    p_specs = shard_lib.param_specs(like, mesh, cfg, fsdp=True)
    o_specs = shard_lib.opt_state_specs(jax.eval_shape(lambda: opt), p_specs, mesh, zero1=True)
    b_specs = shard_lib.batch_specs_tree(jax.eval_shape(lambda: batch), mesh)
    with mesh:
        step = jax.jit(make_train_step(cfg, TrainConfig(**json.loads(sys.argv[2])),
                                       grad_specs=p_specs),
                       in_shardings=(shard_lib.named(p_specs, mesh),
                                     shard_lib.named(o_specs, mesh),
                                     shard_lib.named(b_specs, mesh)))
        _, opt, metrics = step(params, opt, batch)
    save_checkpoint(os.path.join(out, "opt"), 1, opt)
    with open(os.path.join(out, "loss.json"), "w") as f:
        json.dump(float(metrics["loss"]), f)
""")


def _pod_tokens(cfg):
    gen = torch.Generator().manual_seed(0)
    return torch.randint(0, cfg.vocab_size, (8, 16), generator=gen, dtype=torch.int32)


def _start_jax_pod_step():
    """Start the reference's multi-pod step in a subprocess: (its
    directory, the process)."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.models import init_params

    out = tempfile.mkdtemp(prefix="repro_torch_pod_")
    cfg = _cfg("llama3.2-1b")
    save_checkpoint(out, 0, init_params(cfg, seed=0, device="cpu"))
    np.save(os.path.join(out, "tokens.npy"), _pod_tokens(cfg).numpy())
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    with open(os.path.join(out, "log.txt"), "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", _JAX_POD_SCRIPT, out, json.dumps(TCFG)],
                                env=env,
                                cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    return out, proc


def _jax_pod_step():
    """The reference's multi-pod step: (loss, AdamW state after it)."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.models import param_shapes
    from repro_torch.optim.optimizers import adamw_init

    out, proc = _spawned()[1]
    try:
        rc = proc.wait(timeout=600)
        with open(os.path.join(out, "log.txt")) as f:
            assert rc == 0, f.read()
        with open(os.path.join(out, "loss.json")) as f:
            loss = json.load(f)
        meta = adamw_init(param_shapes(_cfg("llama3.2-1b")), device="meta")
        return loss, restore_checkpoint(os.path.join(out, "opt"), 1, meta, device="cpu")[1]
    finally:
        shutil.rmtree(out, ignore_errors=True)


def _norms(mesh):
    """``global_norm`` of a tree with a leaf split over "data", one over
    "model" and one replicated, at this rank's blocks on ``mesh`` and
    whole: finite, then with an inf in the replicated leaf."""
    from repro_torch.optim.optimizers import global_norm

    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn((4, 6), generator=gen), "b": torch.randn((3,), generator=gen),
            "c": torch.randn((2, 4), generator=gen)}
    specs = {"a": ("data", None), "b": (None,), "c": (None, "model")}
    out = []
    for inf in (False, True):
        if inf:
            tree["b"][1] = float("inf")
        block = {"a": tree["a"].chunk(2)[mesh.axis_rank("data")], "b": tree["b"],
                 "c": tree["c"].chunk(2, dim=1)[mesh.axis_rank("model")]}
        out.append((float(global_norm(block, specs, mesh)), float(global_norm(tree))))
    return out


def _pod_step(shape, axes, dev):
    """One sharded train step of reduced llama3.2-1b from seed-0 weights on
    a real mesh of ``shape``: (loss, the whole params and AdamW state
    after it)."""
    from repro_torch.launch.mesh import _make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim.optimizers import adamw_init
    from repro_torch.runtime.sharding import opt_state_specs, param_specs
    from repro_torch.shard import gather_tree, shard_opt_state, shard_params

    cfg = _cfg("llama3.2-1b")
    mesh = _make_mesh(shape, axes, backend="gloo", device=dev)
    params = init_params(cfg, seed=0, device="cpu")
    p_specs = param_specs(params, mesh, cfg, fsdp=True)
    opt = adamw_init(params, device="cpu")
    o_specs = opt_state_specs(opt, p_specs, mesh, True)
    step = make_train_step(cfg, TrainConfig(**TCFG), mesh=mesh)
    params, opt, metrics = step(shard_params(params, mesh, cfg, fsdp=True),
                                shard_opt_state(opt, p_specs, mesh, True, cfg=cfg),
                                {"tokens": _pod_tokens(cfg)})
    return (float(metrics["loss"]), gather_tree(params, p_specs, mesh, cfg),
            gather_tree(opt, o_specs, mesh, cfg))


def _rank_records(rank, dev):
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(*MESH, backend="gloo", device=dev)
    records = {(arch, kind): _record(lower_cell(_cfg(arch), shape, mesh, TrainConfig(),
                                                device="cpu"))
               for arch in ARCHS for kind, shape in SMALL.items()}
    pods = {shape: _pod_step(shape, axes, dev) for shape, axes in POD_MESHES}
    return records, pods, _norms(mesh)


_SPAWNED = []


def _spawned():
    """(The four gloo ranks' results, the reference's multi-pod step
    started beside them), once for the file."""
    if not _SPAWNED:
        jax_pod = _start_jax_pod_step()
        _SPAWNED.append((spawn(_rank_records, MESH[0] * MESH[1], "gloo", device="cpu"),
                         jax_pod))
    return _SPAWNED[0]


# ---------------------------------------------------------------------------
# collective_stats
# ---------------------------------------------------------------------------

def test_collective_stats_equals_the_reference_parser():
    from repro.launch.dryrun import collective_stats as ref_stats

    calls = [("all-gather", torch.bfloat16, (128, 1024)), ("all-reduce", torch.float32, (256,)),
             ("reduce-scatter", torch.float32, (64, 32)), ("collective-permute", torch.int32, (16,)),
             ("all-to-all", torch.int8, (8, 4, 2)), ("all-reduce", torch.float32, ()),
             ("all-gather", torch.int32, (2, 3))]
    hlo_type = {torch.bfloat16: "bf16", torch.float32: "f32", torch.int32: "s32",
                torch.int8: "s8"}
    hlo = "\n".join(
        f"  %c{i} = {hlo_type[d]}[{','.join(map(str, s))}]{{0}} {k}(%x{i})"
        for i, (k, d, s) in enumerate(calls)) + "\n  %n = f32[9999]{0} add(%a, %b)\n"
    assert collective_stats(calls) == ref_stats(hlo)
    assert collective_stats([]) == ref_stats("")


# ---------------------------------------------------------------------------
# One rank's program on meta against the same program on gloo ranks
# ---------------------------------------------------------------------------

def test_dry_run_counts_what_the_ranks_run():
    """Rank 0's program on meta (what the dry run reports) against rank 0 on
    the gloo ranks; every gloo rank's record equals rank 0's, the last
    rank's included."""
    real = [records for records, _, _ in _spawned()[0]]
    dry = make_dry_mesh(MESH, ("data", "model"))
    for arch in ARCHS:
        for kind, shape in SMALL.items():
            want = real[0][(arch, kind)]
            got = _record(lower_cell(_cfg(arch), shape, dry, TrainConfig()))
            label = (arch, kind)
            assert got["collectives"] == want["collectives"], label
            assert got["calls"] == want["calls"], label
            assert (got["ops"], got["bytes"]) == (want["ops"], want["bytes"]), label
            assert got["kernels"] == want["kernels"] and got["kernels"], label
            assert got["argument_bytes"] == want["argument_bytes"], label
            # meta calls here, plain calls there, no launch in either
            for name, (launched, plain, meta) in got["branch"].items():
                assert (launched, plain) == (0, 0), label
                assert want["branch"][name] == (0, meta, 0), label
                assert meta == got["kernels"].get(name, 0), label
    for rank in range(1, MESH[0] * MESH[1]):
        assert real[rank] == real[0], rank


def test_multi_pod_data_axis_trains_as_one_data_axis():
    """A (pod, data, model) = (2, 2, 1) mesh -- FSDP and ZeRO-1 on "data",
    the batch over ("pod", "data"), the FSDP gradient summed over "pod" too
    -- takes the reference's step on the same host mesh: the loss within
    ``LOSS_TOL`` and the AdamW state by ``check_adamw_step`` (m, the
    clipped gradient scaled, within 2% of each leaf's largest magnitude).
    It also takes the port's (4, 1) step: m and v, the gradient and its
    square, within 1e-5 of each leaf's largest magnitude, so a missing pod
    sum, a wrong divisor or half a batch's gradient fails; the loss within
    1e-6 relative."""
    from repro_torch.models import init_params
    from repro_torch.tree import named_leaves

    pods = [p for _, p, _ in _spawned()[0]]
    (loss_pod, params_pod, opt_pod), (loss_4, _, opt_4) = (pods[0][shape]
                                                          for shape, _ in POD_MESHES)
    jax_loss, jax_opt = _jax_pod_step()
    np.testing.assert_allclose(loss_pod, jax_loss, rtol=LOSS_TOL, atol=LOSS_TOL)
    check_adamw_step(opt_pod, jax_opt, init_params(_cfg("llama3.2-1b"), seed=0, device="cpu"),
                     params_pod, TrainConfig(**TCFG), "(2, 2, 1) against the reference's step")
    assert loss_pod == pytest.approx(loss_4, rel=1e-6)
    for key in ("m", "v"):
        for (name, a), (_, b) in zip(named_leaves(opt_pod[key]), named_leaves(opt_4[key])):
            err = float((a.double() - b.double()).abs().max())
            assert err <= 1e-5 * float(b.double().abs().max()), (key, name, err)
    for rank in pods[1:]:
        for shape, _ in POD_MESHES:
            assert rank[shape][0] == pods[0][shape][0]


def test_global_norm_of_sharded_leaves_is_the_whole_trees():
    """Each rank's ``global_norm`` of its blocks (a replicated leaf counted
    on its first rank only) equals the whole tree's: within 1e-6 relative,
    and inf, not NaN, when the replicated leaf holds an inf."""
    for rank in _spawned()[0]:
        (finite, finite_whole), (inf, inf_whole) = rank[2]
        assert finite == pytest.approx(finite_whole, rel=1e-6)
        assert inf == inf_whole == float("inf")


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

def _full_counts(cfg, shape, mesh, periods: int):
    lead = cfg.moe.first_k_dense if cfg.moe else 0
    c = cfg.with_(n_layers=lead + periods * cfg.pattern_period,
                  n_encoder_layers=periods if cfg.is_encoder_decoder else 0)
    return lower_cell(c, shape, mesh, TrainConfig()).compile()


@pytest.mark.parametrize("arch", ARCHS)
def test_calibration_equals_the_full_depth_counts(arch):
    """Four periods, extrapolated from one and two (the encoder-decoder's 4
    encoder layers scale with the periods, 1 and 2 of them at 1 and 2
    periods).  Eager counts are linear in depth, so for prefill and decode
    the extrapolation is exact, and so are a train step's operations and
    collectives.  A train step's bytes are not: the backward of each
    period's slice of a stacked leaf (``select_backward``) writes the whole
    stack, and the gradients' sum reads it, once a period, so its bytes
    grow as c * n**2; for the dense and MoE stacks the extrapolation falls
    short of the full count by exactly c * (4 - 1) * (4 - 2), with c from
    the full counts at 1, 2 and 3 periods (the encoder-decoder's, which
    also scales its encoder, is not pinned: it is no bound, only short)."""
    cfg = _cfg(arch)
    mesh = make_dry_mesh(MESH, ("data", "model"))
    for shape in SMALL.values():
        big = cfg.with_(n_layers=(cfg.moe.first_k_dense if cfg.moe else 0)
                        + 4 * cfg.pattern_period,
                        n_encoder_layers=4 if cfg.is_encoder_decoder else 0)
        cal = calibrated_costs(big, shape, mesh, TrainConfig())
        full = _full_counts(cfg, shape, mesh, 4)
        assert cal["periods"] == 4
        assert cal["flops_per_device"] == full.counts.ops, shape.kind
        assert cal["collectives"] == collective_stats(full.collectives), shape.kind
        if shape.kind != "train":
            assert cal["bytes_accessed_per_device"] == full.counts.bytes, shape.kind
            continue
        assert cal["bytes_accessed_per_device"] < full.counts.bytes, shape.kind
        if cfg.is_encoder_decoder:
            continue
        b1, b2, b3 = (_full_counts(cfg, shape, mesh, k).counts.bytes for k in (1, 2, 3))
        c2 = b3 - 2 * b2 + b1                       # 2 * c
        assert c2 > 0 and full.counts.bytes - 3 * b3 + 3 * b2 - b1 == 0, shape.kind
        assert full.counts.bytes - cal["bytes_accessed_per_device"] == 3 * c2, shape.kind


# ---------------------------------------------------------------------------
# The kernels' meta branches
# ---------------------------------------------------------------------------

def test_meta_branches_count_work_and_launch_nothing():
    from repro_torch.kernels import deas_gemm, spoga_gemm, spoga_gemm_dequant

    m, k, n = 6, 40, 24
    x = torch.empty((m, k), dtype=torch.int8, device="meta")
    w = torch.empty((k, n), dtype=torch.int8, device="meta")
    xs = torch.empty((m, 1), dtype=torch.float32, device="meta")
    ws = torch.empty((1, n), dtype=torch.float32, device="meta")
    before = kernel_counts()
    with counters.counting() as c:
        outs = [spoga_gemm_dequant.spoga_gemm_dequant(x, w, xs, ws),
                spoga_gemm.spoga_gemm(x, w), deas_gemm.deas_gemm(x, w)]
    after = kernel_counts()
    assert [(o.device.type, tuple(o.shape), o.dtype) for o in outs] == [
        ("meta", (m, n), torch.float32), ("meta", (m, n), torch.int32),
        ("meta", (m, n), torch.int32)]
    assert {name: tuple(a - b for a, b in zip(after[name], before[name])) for name in after} \
        == {name: (0, 0, 1) for name in after}
    assert c.kernels == {"spoga_gemm_dequant": 1, "spoga_gemm": 1, "deas_gemm": 1}
    assert c.ops == 3 * 2 * m * n * k
    assert c.bytes == (m * k + k * n + 4 * m + 4 * n + 4 * m * n) + 2 * (m * k + k * n + 4 * m * n)
    with pytest.raises(ValueError, match="different devices"):
        spoga_gemm.spoga_gemm(x, torch.zeros((k, n), dtype=torch.int8))
    with pytest.raises(TypeError):
        spoga_gemm.spoga_gemm(x.float(), w)


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def test_main_writes_one_record_and_exits_0(tmp_path):
    out = tmp_path / "dryrun.jsonl"
    with pytest.raises(SystemExit) as done:
        main(["--arch", "recurrentgemma-9b", "--shape", "decode_32k", "--no-calibrate",
              "--out", str(out)])
    assert done.value.code == 0
    (line,) = out.read_text().splitlines()
    rec = json.loads(line)
    assert REF_KEYS <= set(rec) and rec["ok"] is True
    assert set(rec["memory"]) == REF_MEMORY and set(rec["cost"]) == REF_COST
    assert (rec["mesh"], rec["devices"], rec["device"]) == ("16x16", 256, "meta")
    mem = rec["memory"]
    assert rec["hbm_per_device_gib"] == round(
        (mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
         - mem["alias_bytes"]) / 2**30, 3)
    assert mem["code_bytes"] == 0 and mem["alias_bytes"] > 0
    # bf16, the reference's default quant mode: no quantized GEMM kernel
    assert rec["quant_mode"] == "bf16" and rec["kernels"] == {}
    assert rec["collectives"]["total_bytes"] > 0


def test_main_exits_1_when_a_cell_fails(tmp_path):
    out = tmp_path / "dryrun.jsonl"
    with pytest.raises(SystemExit) as done:
        main(["--arch", "llama3.2-1b", "--shape", "decode_32k", "--mesh", "both",
              "--out", str(out)])
    assert done.value.code == 1
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["mesh"], r["ok"]) for r in recs] == [("16x16", False), ("2x16x16", False)]
    assert all("tp=16" in r["error"] for r in recs)


def test_a_card_record_counts_on_meta(monkeypatch):
    """A ``device="cuda"`` record takes its ``memory``, ``cost``,
    ``collectives`` and ``kernels`` from a meta run of the cell
    (``counted_on``), never from the card run, whose counters see no
    kernel launch.  Here the card run is ``_card_run`` on meta tensors,
    its kernels counting nothing (as a launch counts nothing) and the
    card's clocks and memory stats stand-ins; its own collectives and
    argument bytes equal the meta run's."""
    from repro_torch.launch import dryrun

    card_run = dryrun._card_run

    def kernel_less_card_run(lowered, start):
        with monkeypatch.context() as m:
            m.setattr(counters, "gemm", lambda *a: contextlib.nullcontext())
            return card_run(lowered, start)

    class Event:
        def __init__(self, **kw):
            pass

        def record(self):
            pass

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return 0.0

    # a reduced cell on the small dry mesh, both runs
    monkeypatch.setattr(dryrun, "get_config", lambda arch: reduced(get_config(arch)))
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda **kw: make_dry_mesh(MESH, ("data", "model")))
    cell = ("recurrentgemma-9b", "decode_32k", False, "int8_spoga")
    meta = dryrun.run_cell(*cell, calibrate=False)
    for name, stand_in in (("is_available", lambda: True), ("reset_peak_memory_stats", None),
                           ("memory_allocated", 0), ("max_memory_allocated", 0),
                           ("synchronize", None), ("get_device_name", "stand-in")):
        monkeypatch.setattr(torch.cuda, name,
                            stand_in if callable(stand_in) else lambda *a, v=stand_in: v)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(dryrun, "_card_run", kernel_less_card_run)
    card = dryrun.run_cell(*cell, calibrate=False, device="cuda")
    assert meta["kernels"] and meta["counted_on"] == "meta"
    assert (card["device"], card["card"]["collectives"], card["card"]["argument_bytes"]) == \
        ("cuda", meta["collectives"], meta["memory"]["argument_bytes"])
    for key in ("memory", "hbm_per_device_gib", "cost", "collectives", "kernels", "counted_on"):
        assert card[key] == meta[key], key
