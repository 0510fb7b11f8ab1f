"""The port's serving CLI (``repro_torch.launch.serve``) and process-wide
default GEMM backend against the reference's.

* Flags -> ``RuntimeConfig``: argvs that together set every flag give the
  reference CLI's ``to_dict()`` (the reference's read off its ``main`` with
  ``LLM`` stubbed); ``--paged-attn`` maps the reference's gather twin
  ``jnp`` to the port's ``gather``.  The ``--runtime`` overlay, by preset
  name and JSON file, through both ``main``s.
* ``synthetic_workload``: the same arrivals over several seeds and
  ``shared_prefix`` values.
* Both ``_engine_main``s on reduced llama3.2-1b at ``int8_spoga``, paged,
  int8 KV, on the same weights (the JAX ``init_params`` tree with its
  projections scaled up, carried across by ``params_from_jax``): every
  request's greedy tokens, and the sample and pool report lines.
* ``main([... "--device", "cpu"])`` in engine mode with the trace, event,
  profile and recorder sinks; ``--static``; an encoder-decoder arch takes
  the static path.
* ``--tp 2`` in two gloo CPU ranks (``launch.mesh.spawn``) gives the
  ``--tp 1`` streams.
* ``set_default_backend`` / ``get_default_backend`` held to
  ``tests/test_backends.py``'s cases; a CPU twin as the default raises for
  CUDA tensors.

About 26 s in one process (the 2-rank spawn and the reference's jitted
engine most of it).
"""

import contextlib
import functools
import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as ref_serve
from repro.api import LLM as JaxLLM
from repro.backends import registry as ref_registry
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro_torch.api import LLM
from repro_torch.backends import (
    get_default_backend,
    quantized_linear,
    resolve_backend,
    set_default_backend,
)
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import spoga_gemm as spoga_gemm_mod
from repro_torch.launch import serve
from repro_torch.launch.mesh import spawn
from repro_torch.models import params_from_jax

WEIGHT_SCALE = 8.0

# argv pairs (reference, port) that together set every flag of the CLI
RUNTIME_ARGVS = {
    "paged": (["--reduced", "--quant-mode", "int8_spoga", "--cache-mode", "paged",
               "--kv-cache-dtype", "int8", "--page-size", "8", "--pages", "64",
               "--prefill-chunk", "16", "--prefix-cache", "--shared-prefix", "8",
               "--defrag-threshold", "0.3", "--slots", "3", "--max-prefills", "2",
               "--no-buckets", "--admission", "prefix-aware", "--eviction",
               "deadline-preempt", "--prompt-len", "24", "--gen", "6", "--paged-attn"],
              "jnp", "gather"),
    "direct": (["--quant-mode", "int8_direct", "--gemm-backend", "direct",
                "--defrag-threshold", "-1", "--batched-admission", "--temperature", "0.7",
                "--top-k", "5", "--seed", "3", "--requests", "5", "--stagger", "1",
                "--batch", "2", "--static", "--stream", "--deadline", "1.5"], None, None),
    "spec_obs": (["--spec", "3", "--draft", "model", "--draft-arch", "xlstm-125m",
                  "--trace", "t.json", "--events", "e.jsonl", "--fence-spans",
                  "--profile", "prof", "--profile-steps", "5", "--debug-invariants",
                  "--metrics-port", "0", "--events-max-mb", "2", "--watchdog",
                  "--record", "rec", "--admission", "deadline", "--tp", "2",
                  "--arch", "xlstm-125m"], None, None),
    "priority": (["--admission", "priority", "--cache-mode", "paged", "--spec", "2"],
                 None, None),
}

ENGINE_ARGV = ["--reduced", "--quant-mode", "int8_spoga", "--cache-mode", "paged",
               "--kv-cache-dtype", "int8", "--page-size", "8", "--requests", "4",
               "--slots", "2", "--prompt-len", "16", "--gen", "6", "--stagger", "2",
               "--device", "cpu"]
TP_ARGV = ["--reduced", "--quant-mode", "int8_spoga", "--cache-mode", "paged",
           "--kv-cache-dtype", "int8", "--page-size", "8", "--requests", "3", "--slots", "2",
           "--prompt-len", "12", "--gen", "5", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Built(Exception):
    """Raised by a stub ``LLM`` to stop a ``main`` once its runtime is built."""

    def __init__(self, runtime):
        super().__init__()
        self.runtime = runtime


def _stub_llm(arch=None, *, runtime=None, **_):
    raise _Built(runtime)


def _ref_main_runtime(argv, monkeypatch):
    monkeypatch.setattr(ref_serve, "LLM", _stub_llm)
    monkeypatch.setattr(sys, "argv", ["serve.py", *argv])
    with pytest.raises(_Built) as built:
        ref_serve.main()
    return built.value.runtime


def _port_main_runtime(argv, monkeypatch):
    monkeypatch.setattr(serve, "LLM", _stub_llm)
    with pytest.raises(_Built) as built:
        serve.main(argv)
    return built.value.runtime


# ---------------------------------------------------------------------------
# Flags -> RuntimeConfig
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(RUNTIME_ARGVS))
def test_runtime_from_args_matches_reference(case, monkeypatch):
    argv, ref_attn, port_attn = RUNTIME_ARGVS[case]
    ref_rt = _ref_main_runtime(argv + ([ref_attn] if ref_attn else []), monkeypatch)
    ns = serve._parser().parse_args(argv + ([port_attn] if port_attn else []))
    ours = serve._runtime_from_args(ns).to_dict()
    want = ref_rt.to_dict()
    if ref_attn:
        assert want["kv"]["paged_attn_impl"] == ref_attn
        assert ours["kv"]["paged_attn_impl"] == port_attn
        want["kv"]["paged_attn_impl"] = port_attn
    assert ours == want


def test_every_flag_is_covered():
    """The argvs above set every option of both parsers (``--device`` and
    ``--runtime`` have tests of their own)."""
    used = {a for argv, _, _ in RUNTIME_ARGVS.values() for a in argv if a.startswith("--")}
    ours = {o for a in serve._parser()._actions for o in a.option_strings
            if o.startswith("--")} - {"--help", "--device", "--runtime"}
    assert ours <= used, sorted(ours - used)


@pytest.mark.parametrize("source", ["preset", "json"])
def test_runtime_overlay_matches_reference(source, monkeypatch, tmp_path):
    spec = "int8-byte-serving"
    if source == "json":
        from repro_torch.api import load_runtime

        path = tmp_path / "rt.json"
        path.write_text(json.dumps(load_runtime(spec).to_dict()))
        spec = str(path)
    argv = ["--runtime", spec, "--reduced", "--trace", "t.json", "--watchdog",
            "--quant-mode", "bf16", "--slots", "7"]     # the last two are ignored
    ref_rt = _ref_main_runtime(argv, monkeypatch)
    ours = _port_main_runtime(argv, monkeypatch)
    assert ours.to_dict() == ref_rt.to_dict()
    assert ours.reduced and ours.obs.trace == "t.json" and ours.scheduler.n_slots != 7


# ---------------------------------------------------------------------------
# The workload
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("shared_prefix", [0, 5, 64])
def test_synthetic_workload_matches_reference(seed, shared_prefix):
    cfg, jcfg = get_config("llama3.2-1b"), jax_get_config("llama3.2-1b")
    for n, plen, gen, stagger in ((8, 32, 16, 2), (3, 1, 1, 0), (5, 128, 32, 3)):
        ours = serve.synthetic_workload(cfg, n, plen, gen, stagger, seed, shared_prefix)
        want = ref_serve.synthetic_workload(jcfg, n, plen, gen, stagger, seed, shared_prefix)
        assert ours == want


# ---------------------------------------------------------------------------
# The engine path against the reference's
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tree():
    jcfg = jax_reduced(jax_get_config("llama3.2-1b")).with_(remat=False)
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))

    def scale(path, a):
        if "'w" in jax.tree_util.keystr(path):
            return (a.astype(np.float32) * WEIGHT_SCALE).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(scale, tree)


def _run(fn, llm, args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(llm, args)
    lines = out.getvalue().splitlines()
    return ({r.req_id: r.output_tokens for r in llm.metrics.finished},
            [ln for ln in lines if ln.startswith(("[engine] sample", "[engine] paged"))])


def test_engine_main_streams_match_reference():
    args = serve._parser().parse_args(ENGINE_ARGV)
    tree = _tree()
    jllm = JaxLLM(arch="llama3.2-1b", runtime=ref_serve._runtime_from_args(args),
                  params=jax.tree_util.tree_map(jnp.asarray, tree))
    runtime = serve._runtime_from_args(args)
    tllm = LLM(arch="llama3.2-1b", runtime=runtime,
               params=params_from_jax(tree, runtime.resolve_model(
                   reduced(get_config("llama3.2-1b"))), "cpu"), device="cpu")
    want, want_lines = _run(ref_serve._engine_main, jllm, args)
    got, got_lines = _run(serve._engine_main, tllm, args)
    assert len(got) == args.requests
    assert got == want
    assert len(set(map(tuple, got.values()))) > 1         # not one collapsed stream
    assert got_lines == want_lines and len(got_lines) == 2


def test_main_serves_on_cpu_with_obs_sinks(tmp_path, capsys):
    d = tmp_path
    llm = serve.main(ENGINE_ARGV + ["--trace", str(d / "t.json"), "--events",
                                    str(d / "e.jsonl"), "--profile", str(d / "prof"),
                                    "--profile-steps", "2", "--record", str(d / "rec")])
    out = capsys.readouterr().out
    assert len(llm.metrics.finished) == 4
    assert "[engine] 4 requests" in out and "[engine] sample (req 0):" in out
    assert (d / "t.json").exists() and (d / "e.jsonl").exists()
    assert any((d / "prof").rglob("*.json"))
    assert f"python -m repro_torch.launch.replay {d / 'rec'}" in out


def test_main_static_and_encoder_decoder(capsys):
    serve.main(["--reduced", "--static", "--batch", "2", "--prompt-len", "8", "--gen", "3",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] generated (2, 3) tokens" in out and "[serve] sample:" in out
    serve.main(["--arch", "seamless-m4t-large-v2", "--reduced", "--batch", "2",
                "--prompt-len", "8", "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "enc-dec/frontend arch — static path" in out
    assert "[serve] generated (2, 3) tokens" in out


def _tp_rank(rank, dev):
    llm = serve.main(TP_ARGV + ["--tp", "2"])
    return {r.req_id: r.output_tokens for r in llm.metrics.finished}


def test_tp2_main_gives_tp1_streams():
    want = {r.req_id: r.output_tokens for r in serve.main(TP_ARGV).metrics.finished}
    ranks = spawn(_tp_rank, 2, "gloo", device="cpu")
    assert len(want) == 3
    assert ranks == [want, want]


# ---------------------------------------------------------------------------
# The process-wide default backend
# ---------------------------------------------------------------------------

@pytest.fixture
def restore_default():
    yield
    set_default_backend(None)
    ref_registry.set_default_backend(None)


def test_resolve_respects_override_and_default(restore_default):
    """``test_backends.py``'s case, in both packages: an override beats
    the default, the default beats auto-selection, ``None`` restores it."""
    assert get_default_backend() is None
    assert resolve_backend("int8_spoga", "cpu", "cuda_spoga")[0].name == "cuda_spoga"
    ref_registry.set_default_backend("direct")
    set_default_backend("direct")
    assert ref_registry.resolve_backend("int8_spoga")[0].name == "direct"
    assert resolve_backend("int8_spoga", "cpu")[0].name == "direct"
    assert get_default_backend() == ref_registry.get_default_backend() == "direct"
    assert resolve_backend("int8_spoga", "cpu", "torch_deas")[0].name == "torch_deas"
    set_default_backend(None)
    assert get_default_backend() is None
    assert resolve_backend("int8_spoga", "cpu")[0].name == "torch_spoga"
    assert resolve_backend("int8_deas", "cuda")[0].name == "cuda_deas"


def test_unknown_default_raises_eagerly(restore_default):
    set_default_backend("cuda_spoga")
    with pytest.raises(KeyError):
        ref_registry.set_default_backend("no_such_backend")
    with pytest.raises(KeyError, match="unknown GEMM backend"):
        set_default_backend("no_such_backend")
    assert get_default_backend() == "cuda_spoga"


@pytest.mark.parametrize("twin", ["torch_spoga", "torch_deas", "direct"])
def test_cpu_twin_default_raises_on_cuda(twin, restore_default):
    set_default_backend(twin)
    with pytest.raises(ValueError, match="serves cpu tensors, not cuda"):
        resolve_backend("int8_spoga", "cuda")
    assert resolve_backend("int8_spoga", "cpu")[0].name == twin


def test_cuda_default_runs_its_plain_version_on_cpu(restore_default):
    """A ``cuda_*`` default serves CPU tensors through its kernel's plain
    version, bitwise the auto-selected twin."""
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn((3, 7, 64), generator=g), torch.randn((64, 24), generator=g)
    want = quantized_linear(x, w, "int8_spoga", out_dtype=torch.float32)
    set_default_backend("cuda_spoga")
    calls = spoga_gemm_mod.PLAIN_CALLS
    got = quantized_linear(x, w, "int8_spoga", out_dtype=torch.float32)
    assert spoga_gemm_mod.PLAIN_CALLS == calls + 1
    assert torch.equal(got, want)
    # an explicit override still wins over the default
    assert resolve_backend("int8_deas", "cpu", "torch_deas")[0].name == "torch_deas"
