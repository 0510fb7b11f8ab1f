"""The port's telemetry layer against the JAX package's: Prometheus
exposition and the live ``/metrics`` server, SLO deadline / goodput /
per-request cost accounting, the numerics watchdog, per-lane trace tracks
and the streaming event sink.

Each test of ``tests/test_telemetry.py`` has its counterpart here, except
the ``bench_check`` ones (the port has no benches yet, ROADMAP queue 1,
item 11).  The watchdog is held to the reference's numbers: on the
crafted near-clamp ``w4a4`` GEMM and over reduced engine runs of four
architectures (dense, MoE, recurrent, encoder-decoder through
``forward``) the port's registry has the reference's keys, its integer
counters are equal and ``amax`` is exact; the quantization error and
accumulator bits agree within 1e-6 relative on the one GEMM and 1e-5 over
the engine runs (means over thousands of elements, reduced in another
order).  Off, the watchdog computes nothing; on, outputs stay bitwise.
"""

import json
import pathlib
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.api import LLM as JaxLLM
from repro.api import KVConfig as JaxKVConfig
from repro.api import ObsConfig as JaxObsConfig
from repro.api import RuntimeConfig as JaxRuntimeConfig
from repro.api import SchedulerConfig as JaxSchedulerConfig
from repro.api import SpecConfig as JaxSpecConfig
from repro.api.config import QuantRuntime as JaxQuantRuntime
from repro.backends.pipeline import quantized_linear as jax_quantized_linear
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.obs import watchdog as jax_watchdog
from repro_torch import configs as tconfigs
from repro_torch.api import (
    LLM,
    KVConfig,
    ObsConfig,
    QuantRuntime,
    RuntimeConfig,
    SchedulerConfig,
    SpecConfig,
)
from repro_torch.backends import pipeline
from repro_torch.backends.pipeline import quantized_linear
from repro_torch.models import forward, params_from_jax
from repro_torch.obs import watchdog
from repro_torch.obs.events import EventLog
from repro_torch.obs.metrics import MetricsRegistry, labeled, split_labels
from repro_torch.obs.server import (
    CONTENT_TYPE,
    MetricsServer,
    render_exposition,
    validate_exposition,
)
from repro_torch.obs.trace import Tracer
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.request import Request, RequestCost
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Scheduler

WEIGHT_SCALE = 8.0
REL = 1e-6
# the engine runs' means reduce up to a few thousand f32 elements, in
# XLA's order there and torch's here
ENGINE_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the host's cores; small ops slow down
    when torch's intra-op threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_watchdogs():
    watchdog.reset()
    jax_watchdog.reset()
    yield
    watchdog.reset()
    jax_watchdog.reset()


# ---------------------------------------------------------------------------
# labeled registry keys, exposition, validator
# ---------------------------------------------------------------------------

def test_labeled_keys_roundtrip_and_sort():
    key = labeled("watchdog_amax", mode="w4a4", layer="decode.00")
    assert key == 'watchdog_amax{layer="decode.00",mode="w4a4"}'
    base, labels = split_labels(key)
    assert base == "watchdog_amax"
    assert labels == {"layer": "decode.00", "mode": "w4a4"}
    assert labeled("plain") == "plain"
    assert split_labels("plain") == ("plain", {})


def _populated_registry():
    reg = MetricsRegistry()
    reg.inc("steps", 3)
    reg.inc(labeled("watchdog_act_sat", layer="decode.00", mode="w4a4"), 7)
    reg.set("pages_total", 16)
    for v in (0.001, 0.01, 0.02, 0.5):
        reg.observe("ttft_s", v)
    reg.observe(labeled("watchdog_amax", layer="decode.00", mode="w4a4"), 2.5)
    return reg


def test_render_exposition_is_valid_and_complete():
    text = render_exposition([_populated_registry()], {"tokens_per_second": 12.5})
    assert validate_exposition(text) == []
    assert "# TYPE repro_steps_total counter" in text
    assert "repro_steps_total 3" in text
    assert 'repro_watchdog_act_sat_total{layer="decode.00",mode="w4a4"} 7' in text
    assert "# TYPE repro_pages_total gauge" in text
    assert "repro_tokens_per_second 12.5" in text
    assert "# TYPE repro_ttft_s histogram" in text
    assert 'repro_ttft_s_bucket{le="+Inf"} 4' in text
    assert "repro_ttft_s_count 4" in text and "repro_ttft_s_sum" in text
    assert 'repro_watchdog_amax_bucket{layer="decode.00",le=' in text


def test_render_exposition_merges_registries_and_prefix():
    a, b = MetricsRegistry(), MetricsRegistry()
    a.inc("from_a")
    b.inc("from_b")
    text = render_exposition([a, b], prefix="x")
    assert "x_from_a_total 1" in text and "x_from_b_total 1" in text
    assert validate_exposition(text) == []


BAD_EXPOSITIONS = [
    ("name with spaces 1\n", "malformed sample"),
    ("x_total 1\n", "no TYPE"),
    ("# TYPE c counter\nc_total -1\n", "negative counter"),
    ('# TYPE h histogram\nh_bucket{le="1"} 5\nh_bucket{le="0.5"} 6\n'
     'h_bucket{le="+Inf"} 6\nh_sum 1\nh_count 6\n', "le not increasing"),
    ('# TYPE h histogram\nh_bucket{le="1"} 5\nh_bucket{le="2"} 3\n'
     'h_bucket{le="+Inf"} 5\nh_sum 1\nh_count 5\n', "not cumulative"),
    ('# TYPE h histogram\nh_bucket{le="1"} 5\nh_sum 1\nh_count 5\n', "missing +Inf"),
    ('# TYPE h histogram\nh_bucket{le="+Inf"} 4\nh_sum 1\nh_count 5\n', "!= _count"),
    ('# TYPE h histogram\nh_bucket{le="+Inf"} 5\nh_count 5\n', "missing _sum"),
    ("# TYPE a counter\n# TYPE a counter\n", "duplicate TYPE"),
    ("# comment that is not HELP or TYPE\n", "malformed comment"),
]


@pytest.mark.parametrize("text,problem", BAD_EXPOSITIONS,
                         ids=[p for _, p in BAD_EXPOSITIONS])
def test_validator_rejects_malformed_exposition(text, problem):
    """Every malformed exposition of the reference's test (and two more)
    is named, with the reference validator's own messages."""
    from repro.obs.server import validate_exposition as jax_validate

    errors = validate_exposition(text)
    assert any(problem in e for e in errors), errors
    assert errors == jax_validate(text)


# ---------------------------------------------------------------------------
# the HTTP frontend
# ---------------------------------------------------------------------------

def test_metrics_server_endpoints():
    reg = _populated_registry()
    log = EventLog()
    for i in range(5):
        log.emit("tick", i)
    srv = MetricsServer(lambda: ([reg], {"up": 1.0}), port=0, events=lambda: log).start()
    try:
        assert srv.port and srv.url == f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(srv.url + "/metrics") as resp:
            assert resp.headers["Content-Type"] == CONTENT_TYPE
            body = resp.read().decode()
        assert validate_exposition(body) == []
        assert "repro_up 1" in body and "repro_steps_total 3" in body
        with urllib.request.urlopen(srv.url + "/healthz") as resp:
            assert resp.read() == b"ok\n"
        with urllib.request.urlopen(srv.url + "/snapshot") as resp:
            doc = json.loads(resp.read())
        assert doc["derived"] == {"up": 1.0}
        assert doc["registries"][0]["counters"]["steps"] == 3
        doc = json.loads(urllib.request.urlopen(srv.url + "/events?n=2").read())
        assert doc["returned"] == 2 and doc["window"] == 5
        assert [e["seq"] for e in doc["events"]] == [3, 4]
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.url + "/nope")
        assert ei.value.code == 404
    finally:
        srv.close()
    srv.close()   # idempotent


def test_metrics_server_collector_failure_is_500_not_crash():
    def broken():
        raise RuntimeError("collector exploded")

    srv = MetricsServer(broken, port=0).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.url + "/metrics")
        assert ei.value.code == 500
        assert b"collector exploded" in ei.value.read()
        with urllib.request.urlopen(srv.url + "/healthz") as resp:
            assert resp.read() == b"ok\n"
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# SLO deadline / goodput / cost accounting (host-side units)
# ---------------------------------------------------------------------------

def test_sampling_params_deadline_validation():
    assert SamplingParams(deadline_s=1.5).deadline_s == 1.5
    assert SamplingParams().deadline_s is None
    with pytest.raises(ValueError):
        SamplingParams(deadline_s=0.0)


def test_deadline_goodput_and_cost_accounting():
    m = EngineMetrics()
    m.begin()
    now = time.perf_counter()
    hit = Request(req_id=0, prompt=[1], max_new_tokens=2, deadline_s=1000.0)
    hit.submit_time = now
    hit.output_tokens = [5, 6]
    hit.cost = RequestCost(prefill_s=0.2, decode_s=0.1, dispatches=3, page_steps=4)
    m.record_finished(hit)
    miss = Request(req_id=1, prompt=[1], max_new_tokens=1, deadline_s=1e-9)
    miss.submit_time = now - 1.0
    miss.late_at_admission = True
    miss.output_tokens = [7]
    m.record_finished(miss)
    free = Request(req_id=2, prompt=[1], max_new_tokens=3)
    free.submit_time = now
    free.output_tokens = [1, 2, 3]
    m.record_finished(free)
    assert (hit.deadline_hit, miss.deadline_hit, free.deadline_hit) == (True, False, None)
    assert m.deadline_hits == 1 and m.deadline_misses == 1
    assert m.deadline_late_admissions == 1
    assert m.goodput_tokens == 2 + 3
    rep = m.report()
    assert rep["deadline_hit_rate"] == 0.5 and rep["goodput_tokens"] == 5
    assert rep["goodput_tokens_per_s"] <= rep["tokens_per_s"]
    assert rep["cost_prefill_p99_s"] == pytest.approx(0.2)
    assert rep["cost_decode_p99_s"] == pytest.approx(0.1)
    m2 = EngineMetrics()
    m2.begin()
    free2 = Request(req_id=0, prompt=[1], max_new_tokens=1)
    free2.submit_time = time.perf_counter()
    free2.output_tokens = [9]
    m2.record_finished(free2)
    r2 = m2.report()
    assert r2["deadline_hit_rate"] is None
    assert r2["goodput_tokens"] == r2["generated_tokens"] == 1


def test_scheduler_stamps_late_at_admission():
    sched = Scheduler(n_slots=2)
    doomed = Request(req_id=0, prompt=[1], max_new_tokens=1, deadline_s=1e-6)
    doomed.submit_time = time.perf_counter() - 1.0
    fine = Request(req_id=1, prompt=[1], max_new_tokens=1, deadline_s=100.0)
    fine.submit_time = time.perf_counter()
    sched.submit(doomed)
    sched.submit(fine)
    admitted = sched.schedule_group() + sched.schedule_group()
    assert [r.req_id for r, _ in admitted] == [0, 1]
    assert doomed.late_at_admission is True and fine.late_at_admission is False
    assert sched.request_in(admitted[0][1]) is doomed and sched.request_in(5) is None


# ---------------------------------------------------------------------------
# numerics watchdog: the pipeline surface
# ---------------------------------------------------------------------------

def _crafted_near_clamp():
    """test_telemetry.py's input: half the activation entries sit AT the
    dynamic-quant rail."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((8, 32)) * 0.01).astype(np.float32)
    x[:, ::2] = np.where(np.arange(8)[:, None] % 2 == 0, 1.0, -1.0)
    w = rng.standard_normal((32, 16)).astype(np.float32) * 0.1
    return x, w


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _ops(fn):
    with _Ops() as rec:
        fn()
    return rec.ops


def test_watchdog_off_computes_nothing(monkeypatch):
    """Off, no stats function runs and no op is added: the GEMM's op
    sequence is the same with or without a watchdog context around a
    ``watch=False`` call; on, the stats' reductions join it.  Over a whole
    ``generate`` with the watchdog off the stats function is never
    called and nothing is recorded."""
    x, w = (torch.from_numpy(a) for a in _crafted_near_clamp())
    off = _ops(lambda: quantized_linear(x, w, "w4a4"))
    with watchdog.watching("decode"):
        unwatched = _ops(lambda: quantized_linear(x, w, "w4a4", watch=False))
    assert watchdog.peek_registry() is None
    watched = _ops(lambda: quantized_linear(x, w, "w4a4", watch=True, layer="crafted"))
    assert off == unwatched
    assert len(watched) > len(off) and "aten.log2.default" in watched
    assert "aten.log2.default" not in off
    watchdog.reset()

    calls = []
    real = pipeline._stage_watchdog_stats
    monkeypatch.setattr(pipeline, "_stage_watchdog_stats",
                        lambda *a, **k: calls.append(a[1]) or real(*a, **k))
    rt = RuntimeConfig(reduced=True, quant=QuantRuntime(mode="w4a4"),
                       kv=KVConfig(mode="paged", page_size=8), scheduler=SchedulerConfig(n_slots=2))
    llm = LLM(arch="llama3.2-1b", runtime=rt, device="cpu")
    assert not llm.config.numerics_watchdog
    llm.generate([[1, 2, 3, 4, 5]], max_new_tokens=3)
    assert calls == [] and watchdog.peek_registry() is None
    armed = LLM(arch="llama3.2-1b", device="cpu", runtime=RuntimeConfig(
        reduced=True, quant=QuantRuntime(mode="w4a4"), kv=KVConfig(mode="paged", page_size=8),
        scheduler=SchedulerConfig(n_slots=2), obs=ObsConfig(watchdog=True)))
    armed.generate([[1, 2, 3, 4, 5]], max_new_tokens=3)
    assert calls and {c.split(".")[0] for c in calls} == {"prefill", "decode"}


def test_watchdog_saturation_counter_fires_and_is_output_invisible():
    """The crafted case: outputs bitwise with the watchdog on; integer
    counters equal to the reference's, ``amax`` exact, the quantization
    error and accumulator bits within 1e-6 relative."""
    x, w = _crafted_near_clamp()
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    y_plain = quantized_linear(tx, tw, "w4a4")
    y_watch = quantized_linear(tx, tw, "w4a4", watch=True, layer="crafted")
    assert torch.equal(y_plain, y_watch)
    jax.jit(lambda a, b: jax_quantized_linear(a, b, "w4a4", watch=True, layer="crafted"))(x, w)
    jax.effects_barrier()

    reg, jreg = watchdog.peek_registry(), jax_watchdog.peek_registry()
    assert reg is not None and jreg is not None
    assert {k: c.value for k, c in reg.counters.items()} == \
        {k: c.value for k, c in jreg.counters.items()}
    key = labeled("watchdog_act_sat", layer="crafted", mode="w4a4")
    n_key = labeled("watchdog_act_elems", layer="crafted", mode="w4a4")
    sat, n = reg.counters[key].value, reg.counters[n_key].value
    assert n == x.size and sat / n == pytest.approx(0.5, abs=0.1)
    assert watchdog.saturation_report()['layer="crafted",mode="w4a4"'] == pytest.approx(sat / n)
    assert watchdog.saturation_report() == jax_watchdog.saturation_report()
    _hists_match(reg, jreg)
    amax_key = labeled("watchdog_amax", layer="crafted", mode="w4a4")
    assert reg.histograms[amax_key].max == pytest.approx(1.0)
    acc_key = labeled("watchdog_acc_bits", layer="crafted", mode="w4a4")
    assert 0 < reg.histograms[acc_key].max <= 33
    peak = labeled("watchdog_acc_bits_peak", layer="crafted", mode="w4a4")
    assert reg.gauges[peak].value == pytest.approx(jreg.gauges[peak].value, rel=REL)
    watchdog.reset()
    assert watchdog.peek_registry() is None


def _hists_match(reg, jreg, rel=REL):
    """amax exact; quant error and accumulator bits within ``rel``.  The
    reference's debug callbacks are unordered, so a label's samples
    compare as sorted lists."""
    assert set(reg.histograms) == set(jreg.histograms)
    for k, h in reg.histograms.items():
        jh = jreg.histograms[k]
        assert h.total == jh.total and h.counts == jh.counts, k
        got, want = sorted(h.samples), sorted(jh.samples)
        if k.startswith("watchdog_amax"):
            assert got == want, k
        else:
            np.testing.assert_allclose(got, want, rtol=rel, err_msg=k)


def test_runtime_config_arms_model_watchdog_flag():
    base = tconfigs.get_config("llama3.2-1b")
    assert not RuntimeConfig().resolve_model(base).numerics_watchdog
    armed = RuntimeConfig(obs=ObsConfig(watchdog=True)).resolve_model(base)
    assert armed.numerics_watchdog
    assert hash(armed) != hash(RuntimeConfig().resolve_model(base))
    jbase = jax_get_config("llama3.2-1b")
    assert JaxRuntimeConfig(obs=JaxObsConfig(watchdog=True)).resolve_model(
        jbase).numerics_watchdog == armed.numerics_watchdog


# ---------------------------------------------------------------------------
# the watchdog over engine runs: the reference's keys and counts
# ---------------------------------------------------------------------------

def _scaled(arch):
    jcfg = jax_reduced(jax_get_config(arch)).with_(remat=False)
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))

    def scale(path, a):
        key = jax.tree_util.keystr(path)
        if "'w" in key or "'experts" in key:
            return (a.astype(np.float32) * WEIGHT_SCALE).astype(a.dtype)
        return a

    return jcfg, jax.tree_util.tree_map_with_path(scale, tree)


def _engine_run(arch):
    """(kv, scheduler, spec settings, prompt lengths).  llama: paged, prefix
    cache, 8-token chunks, n-gram speculation, three prompts over two
    lanes; the other stacks refuse those and serve paged with exact-length
    prefill.  recurrentgemma admits its two prompts together, so no lane
    idles in a decode step: an idle lane's recurrent state is where the
    packages differ by design (the reference advances it, the port does
    not; ROADMAP queue 3), and the stats cover every lane's rows."""
    if arch == "llama3.2-1b":
        return (dict(mode="paged", page_size=8, prefix_cache=True),
                dict(n_slots=2, prefill_chunk=8), dict(enabled=True, k=2, drafter="ngram"),
                (5, 9, 3))
    kv = dict(mode="paged", page_size=8, cache_len=32)
    if arch == "recurrentgemma-9b":
        return kv, dict(n_slots=2, max_prefills_per_step=2), dict(), (5, 9)
    return kv, dict(n_slots=2), dict(), (5, 9, 3)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-moe-16b", "recurrentgemma-9b",
                                  "seamless-m4t-large-v2"])
def test_watchdog_registry_matches_reference(arch):
    """The same run through both packages, ``w4a4`` with the watchdog on:
    the same registry keys (labels ``<entry>.<site>.k<K>n<N>``, every
    period sharing its first period's labels as the reference's scanned
    body does), equal integer counters, ``amax`` exact, the rest within
    1e-6 relative.  The encoder-decoder runs through ``forward``."""
    jcfg, tree = _scaled(arch)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    if arch.startswith("seamless"):
        jc = jcfg.with_(quant_mode="w4a4", numerics_watchdog=True)
        tc = tcfg.with_(quant_mode="w4a4", numerics_watchdog=True)
        rng = np.random.default_rng(0)
        src = rng.standard_normal((2, 6, jc.d_model)).astype(np.float32)
        tgt = rng.integers(0, jc.vocab_size, (2, 5)).astype(np.int32)
        fwd = jax.jit(jax_forward, static_argnums=1)
        jparams = jax.tree_util.tree_map(jnp.asarray, tree)
        tparams = params_from_jax(tree, tc, "cpu")
        for _ in range(2):     # the second call reuses the trace: labels stay
            want = fwd(jparams, jc, {"src_embeds": jnp.asarray(src, jnp.bfloat16),
                                     "tgt_tokens": jnp.asarray(tgt)})
            got = forward(tparams, tc, {"src_embeds": torch.from_numpy(src).bfloat16(),
                                        "tgt_tokens": torch.from_numpy(tgt)})
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    else:
        kv, sched, spec, lens = _engine_run(arch)
        jllm = JaxLLM(arch=arch, params=jax.tree_util.tree_map(jnp.asarray, tree),
                      runtime=JaxRuntimeConfig(
                          reduced=True, quant=JaxQuantRuntime(mode="w4a4"),
                          kv=JaxKVConfig(**kv), scheduler=JaxSchedulerConfig(**sched),
                          spec=JaxSpecConfig(**spec), obs=JaxObsConfig(watchdog=True)))
        rt = RuntimeConfig(reduced=True, quant=QuantRuntime(mode="w4a4"), kv=KVConfig(**kv),
                           scheduler=SchedulerConfig(**sched), spec=SpecConfig(**spec),
                           obs=ObsConfig(watchdog=True))
        tllm = LLM(arch=arch, runtime=rt, params=params_from_jax(tree, rt.resolve_model(tcfg),
                                                                  "cpu"), device="cpu")
        rng = np.random.default_rng(0)
        shared = rng.integers(0, jcfg.vocab_size, 16).tolist()
        prompts = [shared + rng.integers(0, jcfg.vocab_size, n).tolist() for n in lens]
        want = jllm.generate(prompts, max_new_tokens=4)
        got = tllm.generate(prompts, max_new_tokens=4)
        assert [o.token_ids for o in got] == [o.token_ids for o in want]
    jax.effects_barrier()
    reg, jreg = watchdog.peek_registry(), jax_watchdog.peek_registry()
    assert sorted(reg.counters) == sorted(jreg.counters)
    assert {k: c.value for k, c in reg.counters.items()} == \
        {k: c.value for k, c in jreg.counters.items()}
    _hists_match(reg, jreg, ENGINE_REL)
    layers = {split_labels(k)[1]["layer"] for k in reg.counters}
    tags = {lab.split(".")[0] for lab in layers}
    assert tags == ({"forward"} if arch.startswith("seamless") else
                    {"verify"} if arch == "llama3.2-1b" else {"prefill", "decode"})


# ---------------------------------------------------------------------------
# live end-to-end: paged + prefix + spec run, scraped mid-flight
# ---------------------------------------------------------------------------

def _telemetry_runtime(watchdog_on: bool, port=None) -> RuntimeConfig:
    return RuntimeConfig(
        reduced=True, quant=QuantRuntime(mode="w4a4"),
        kv=KVConfig(mode="paged", page_size=8, prefix_cache=True),
        scheduler=SchedulerConfig(n_slots=2, prefill_chunk=8),
        spec=SpecConfig(enabled=True, k=2, drafter="ngram"),
        obs=ObsConfig(watchdog=watchdog_on, metrics_port=port))


def _prompts(cfg):
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 16).tolist()
    return [shared + rng.integers(0, cfg.vocab_size, n).tolist() for n in (5, 9, 3)]


def test_live_scrape_watchdog_parity_and_cost():
    llm_off = LLM(arch="llama3.2-1b", runtime=_telemetry_runtime(False), device="cpu")
    outs_off = llm_off.generate(_prompts(llm_off.config), max_new_tokens=6)
    assert llm_off.metrics_server is None
    assert watchdog.peek_registry() is None

    llm = LLM(arch="llama3.2-1b", runtime=_telemetry_runtime(True, port=0), device="cpu")
    assert llm.config.numerics_watchdog
    engine = llm.build_engine(25, 6)
    sp = SamplingParams(deadline_s=120.0)
    reqs = [engine.add_request(p, 6, sampling=sp) for p in _prompts(llm.config)]
    assert all(r.deadline_s == 120.0 for r in reqs)
    url = llm.metrics_server.url
    mid = None
    while engine.has_work:
        engine.step()
        if mid is None:
            mid = urllib.request.urlopen(url + "/metrics").read().decode()
    assert mid is not None and validate_exposition(mid) == []
    assert "repro_steps_total" in mid
    final = urllib.request.urlopen(url + "/metrics").read().decode()
    assert validate_exposition(final) == []
    assert "# TYPE repro_ttft_s histogram" in final
    assert 'repro_ttft_s_bucket{le="+Inf"} 3' in final
    assert "# TYPE repro_per_token_s histogram" in final
    assert "repro_goodput_tokens_total" in final
    assert "repro_deadline_hits_total 3" in final
    assert "repro_watchdog_act_sat_total" in final and 'mode="w4a4"' in final
    assert "repro_goodput_tokens_per_second" in final and "repro_tokens_per_second" in final
    assert [r.output_tokens for r in reqs] == [o.token_ids for o in outs_off]
    sat = watchdog.saturation_report()
    assert sat and all(0.0 <= v <= 1.0 for v in sat.values())
    assert any(k.startswith(('layer="prefill.', 'layer="verify.', 'layer="decode.'))
               for k in sat)
    for r in reqs:
        assert r.deadline_hit is True and r.cost.dispatches >= 1
        assert r.cost.prefill_s > 0 and r.cost.page_steps > 0
    m = engine.metrics
    assert m.deadline_hits == 3 and m.deadline_misses == 0
    assert m.goodput_tokens == sum(len(r.output_tokens) for r in reqs)
    llm.close()
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(url + "/healthz", timeout=1)
    llm.close()   # idempotent


def test_generate_outputs_carry_deadline_and_cost():
    rt = RuntimeConfig(reduced=True, kv=KVConfig(mode="slot", cache_len=32),
                       scheduler=SchedulerConfig(n_slots=2))
    llm = LLM(arch="llama3.2-1b", runtime=rt, device="cpu")
    outs = llm.generate([[1, 2, 3, 4]], sampling=SamplingParams(deadline_s=300.0),
                        max_new_tokens=4)
    assert outs[0].deadline_hit is True and outs[0].cost is not None
    assert outs[0].cost["dispatches"] >= 1 and outs[0].cost["prefill_s"] > 0
    outs2 = llm.generate([[1, 2, 3, 4]], max_new_tokens=4)
    assert outs2[0].deadline_hit is None and outs2[0].cost["dispatches"] >= 1


# ---------------------------------------------------------------------------
# per-lane trace tracks; streaming event sink with rotation
# ---------------------------------------------------------------------------

def test_tracer_mirrors_spans_onto_lane_tracks():
    tr = Tracer()
    with tr.span("decode", lanes=[0, 2], batch=2):
        pass
    with tr.span("prefill", lane=1):
        pass
    with tr.span("step"):
        pass
    engine_evs = [e for e in tr.events if e["tid"] == 1]
    lane_evs = [e for e in tr.events if e["tid"] != 1]
    assert [e["name"] for e in engine_evs] == ["decode", "prefill", "step"]
    assert sorted((e["tid"], e["name"], e["args"]["lane"]) for e in lane_evs) == [
        (2, "decode", 0), (3, "prefill", 1), (4, "decode", 2)]
    assert all(e["cat"] == "lane" for e in lane_evs)
    dec = engine_evs[0]
    for lane_ev in (e for e in lane_evs if e["name"] == "decode"):
        assert lane_ev["ts"] == dec["ts"] and lane_ev["dur"] == dec["dur"]
        assert lane_ev["args"]["batch"] == 2
    metas = [e for e in tr.to_chrome()["traceEvents"] if e["ph"] == "M"]
    names = {e["tid"]: e["args"]["name"] for e in metas if e["name"] == "thread_name"}
    assert names == {1: "engine", 2: "lane 0", 3: "lane 1", 4: "lane 2"}


def test_event_log_streams_and_rotates(tmp_path):
    path = tmp_path / "events.jsonl"
    log = EventLog(stream_path=str(path), max_bytes=2048, keep=16)
    for i in range(200):
        log.emit("tick", req_id=i, payload="x" * 32)
    assert log.rotations >= 1
    rotated = pathlib.Path(str(path) + ".1")
    assert rotated.exists() and len(log) == 16
    log.close()
    for p in (path, rotated):
        assert p.stat().st_size <= 2 * log.max_bytes
        for line in p.read_text().splitlines():
            ev = json.loads(line)
            assert ev["kind"] == "tick" and "seq" in ev
    current = path.read_text().splitlines()
    if current:
        last_rotated = json.loads(rotated.read_text().splitlines()[-1])["seq"]
        assert json.loads(current[0])["seq"] == last_rotated + 1
    assert log.timeline(199)[0]["req_id"] == 199
    log2 = EventLog(stream_path=str(tmp_path / "s.jsonl"))
    log2.emit("a")
    assert log2.to_jsonl(str(tmp_path / "s.jsonl")) == str(tmp_path / "s.jsonl")
    assert (tmp_path / "s.jsonl").read_text().count("\n") == 1
    log2.close()
    with pytest.raises(ValueError):
        EventLog(stream_path=str(tmp_path / "bad.jsonl"), max_bytes=0)


def test_obs_config_builds_streaming_sink(tmp_path):
    path = tmp_path / "ev.jsonl"
    obs = ObsConfig(events=str(path), events_max_mb=1.0).build()
    assert isinstance(obs.events, EventLog)
    assert obs.events.stream_path == str(path) and obs.events.max_bytes == 2 ** 20
    obs.events.emit("hello", req_id=0)
    obs.close()
    assert json.loads(path.read_text().splitlines()[0])["kind"] == "hello"
    with pytest.raises(ValueError):
        ObsConfig(events_max_mb=0)
    with pytest.raises(ValueError):
        ObsConfig(metrics_port=70000)
