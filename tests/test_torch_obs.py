"""The port's observability layer (``repro_torch/obs/``) against the JAX
package's.

Each test of ``tests/test_obs.py`` has its counterpart here (same name,
``_torch`` where the port differs: ``Span.fence`` synchronizes CUDA
tensors instead of ``jax.block_until_ready``, the step profiler is
``torch.profiler``).  Beyond those, on the same inputs: the metrics
registry's ``snapshot()`` equals the reference's and the Prometheus
exposition equals it byte for byte; the port engine's event journal
equals the JAX engine's event by event once ``diff_journals``' volatile
fields (timestamps, waits, latencies) are set aside, and so do the
per-request timelines; greedy streams with observability off, on and
fenced equal each other and the JAX engine's.  The engines serve the
reduced llama3.2-1b with the JAX ``init_params`` tree, projection weights
scaled by 8 so greedy decoding does not collapse (as ``test_torch_api.py``
does), carried across with ``params_from_jax``.
"""

import dataclasses
import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.api import LLM as JaxLLM
from repro.api import KVConfig as JaxKVConfig
from repro.api import ObsConfig as JaxObsConfig
from repro.api import RuntimeConfig as JaxRuntimeConfig
from repro.api import SchedulerConfig as JaxSchedulerConfig
from repro.api import SpecConfig as JaxSpecConfig
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro.obs import MetricsRegistry as JaxMetricsRegistry
from repro.obs import render_exposition as jax_render_exposition
from repro.obs.replay import VOLATILE_FIELDS, canonical_event
from repro_torch import configs as tconfigs
from repro_torch.api import (
    LLM,
    KVConfig,
    ObsConfig,
    RequestOutput,
    RuntimeConfig,
    SchedulerConfig,
    SpecConfig,
)
from repro_torch.models import params_from_jax
from repro_torch.obs import (
    DISABLED,
    EventLog,
    Histogram,
    MetricsRegistry,
    NULL_EVENTS,
    NULL_TRACER,
    StepProfiler,
    Tracer,
    render_exposition,
)
from repro_torch.paging.manager import PageManager
from repro_torch.serving.metrics import EngineMetrics

WEIGHT_SCALE = 8.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the host's cores; small ops slow down
    when torch's intra-op threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# tracer: span nesting, monotonicity, Chrome export
# ---------------------------------------------------------------------------

def test_span_nesting_depth_and_monotonic_timestamps():
    tr = Tracer()
    with tr.span("outer", step=1):
        with tr.span("inner_a"):
            pass
        with tr.span("inner_b"):
            pass
    names = [e["name"] for e in tr.events]
    assert names == ["inner_a", "inner_b", "outer"]
    a, b, outer = tr.events
    assert a["args"]["depth"] == b["args"]["depth"] == 1
    assert outer["args"]["depth"] == 0 and outer["args"]["step"] == 1
    assert outer["ts"] <= a["ts"] <= a["ts"] + a["dur"]
    assert a["ts"] + a["dur"] <= b["ts"] + 1e-9 or a["ts"] <= b["ts"]
    assert b["ts"] + b["dur"] <= outer["ts"] + outer["dur"] + 1e-9
    assert all(e["dur"] >= 0 for e in tr.events)


def test_span_set_attaches_args_after_entry():
    tr = Tracer()
    with tr.span("defrag") as sp:
        sp.set(pages_moved=3)
    assert tr.events[-1]["args"]["pages_moved"] == 3


def test_tracer_chrome_document_shape(tmp_path):
    tr = Tracer()
    tr.instant("marker", reason="test")
    with tr.span("work"):
        pass
    doc = tr.to_chrome()
    assert doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    assert [e["ph"] for e in evs[:2]] == ["M", "M"]
    assert {e["ph"] for e in evs[2:]} == {"i", "X"}
    assert all(e["pid"] == 1 and e["tid"] == 1 for e in evs)
    out = tmp_path / "trace.json"
    assert tr.save(str(out)) == str(out)
    assert json.loads(out.read_text())["traceEvents"] == json.loads(json.dumps(evs))


def test_span_fence_is_free_unless_enabled_torch(monkeypatch):
    """A fence is kept only by a fencing tracer; at exit it synchronizes the
    devices of its CUDA tensors (each once) and nothing for CPU tensors."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: synced.append(dev))
    x = torch.ones(4)
    with Tracer(fence_spans=False).span("decode") as sp:
        sp.fence(x)
        assert sp._fences == []
    tr_f = Tracer(fence_spans=True)
    with tr_f.span("decode") as sp:
        sp.fence(x, x)
        assert sp._fences == [x, x]
    assert tr_f.events[-1]["dur"] >= 0
    assert synced == []                        # CPU tensors need no fence

    class OnCard(torch.Tensor):           # stands in for a CUDA tensor
        @property
        def device(self):
            return torch.device("cuda", 0)

    cuda = torch.empty(2).as_subclass(OnCard)
    with tr_f.span("decode") as sp:
        sp.fence(cuda, cuda, 3)
    assert synced == [torch.device("cuda", 0)]


def test_null_tracer_is_inert():
    sp1 = NULL_TRACER.span("a", x=1)
    sp2 = NULL_TRACER.span("b")
    assert sp1 is sp2
    with sp1 as sp:
        sp.fence(torch.ones(()))
        sp.set(y=2)
    NULL_TRACER.instant("never")
    assert NULL_TRACER.events == ()
    assert NULL_TRACER.to_chrome()["traceEvents"] == []
    assert NULL_TRACER.save("/nonexistent/should-not-be-written") is None


def test_tracer_document_matches_reference_shape():
    """The same spans give the reference's event records, key for key
    (timestamps aside)."""
    from repro.obs import Tracer as JaxTracer

    docs = []
    for tr in (Tracer(), JaxTracer()):
        with tr.span("step", idx=1):
            with tr.span("decode", lanes=[0, 2], batch=2):
                pass
        tr.instant("mark", why="x")
        docs.append([{k: v for k, v in e.items() if k not in ("ts", "dur")}
                     for e in tr.to_chrome()["traceEvents"]])
    assert docs[0] == docs[1]


# ---------------------------------------------------------------------------
# histograms and the registry
# ---------------------------------------------------------------------------

def test_histogram_bucket_edges():
    h = Histogram("lat", base=1e-6, growth=2.0, n_buckets=8)
    assert h.bucket_index(0.0) == 0 and h.bucket_index(1e-6) == 0
    for i in range(1, 7):
        assert h.bucket_index(h.edge(i)) == i
        assert h.bucket_index(h.edge(i) * 1.0001) == i + 1
    assert h.bucket_index(1e9) == h.n_buckets - 1
    for v in (0.0, 1e-6, 3e-6, 0.5, 1e9):
        h.observe(v)
    assert sum(h.counts) == h.total == 5
    assert h.min == 0.0 and h.max == 1e9


def test_histogram_exact_percentiles_match_numpy():
    from repro.obs import Histogram as JaxHistogram

    h, jh = Histogram("lat"), JaxHistogram("lat")
    xs = np.random.default_rng(0).exponential(0.05, size=200)
    for x in xs:
        h.observe(x)
        jh.observe(x)
    for q in (50, 95, 99):
        assert h.percentile(q) == pytest.approx(np.percentile(xs, q))
        assert h.bucket_percentile(q) == jh.bucket_percentile(q)
    assert h.mean == pytest.approx(float(np.mean(xs)))
    p95, est = h.percentile(95), h.bucket_percentile(95)
    i = h.bucket_index(p95)
    lo = 0.0 if i == 0 else h.edge(i - 1)
    assert lo <= est <= h.edge(i)


def test_histogram_empty_and_single_sample():
    h = Histogram("lat")
    assert h.percentile(99) == 0.0 and h.bucket_percentile(50) == 0.0
    assert h.mean == 0.0
    h.observe(0.25)
    assert h.percentile(1) == h.percentile(99) == 0.25


def test_registry_creates_on_first_touch_and_snapshots():
    reg = MetricsRegistry()
    reg.inc("steps")
    reg.inc("steps", 2)
    reg.set("pages", 7)
    reg.set_max("peak", 3)
    reg.set_max("peak", 2)
    reg.observe("ttft", 0.5)
    snap = reg.snapshot()
    assert snap["counters"]["steps"] == 3
    assert snap["gauges"] == {"pages": 7, "peak": 3}
    assert snap["histograms"]["ttft"]["count"] == 1
    assert snap["histograms"]["ttft"]["p99"] == 0.5


def _fill(reg, seed):
    """The same random observations into either package's registry,
    labelled series included."""
    from repro_torch.obs import labeled

    rng = np.random.default_rng(seed)
    for _ in range(300):
        name = f"m{int(rng.integers(0, 3))}"
        lab = labeled(name, layer=f"decode.{int(rng.integers(0, 3)):02d}", mode="w4a4")
        op, v = int(rng.integers(0, 5)), float(10.0 ** rng.uniform(-6, 2))
        if op == 0:
            reg.inc("c_" + name, int(v) + 1)
        elif op == 1:
            reg.inc("t_" + lab, v)
        elif op == 2:
            reg.set_max("g_" + name, v)
        elif op == 3:
            reg.set("s_" + lab, v)
        else:
            reg.observe("h_" + (lab if v > 1 else name), v)


@pytest.mark.parametrize("seed", [0, 1])
def test_snapshot_and_exposition_match_reference(seed):
    """For the same observations ``snapshot()`` equals the reference's and
    the Prometheus text is the reference's byte for byte (series names,
    labels, bucket edges, cumulative counts, derived gauges)."""
    reg, jreg = MetricsRegistry(), JaxMetricsRegistry()
    _fill(reg, seed)
    _fill(jreg, seed)
    assert reg.snapshot() == jreg.snapshot()
    derived = {"tokens_per_second": 12.5, "wall_seconds": 0.125}
    assert render_exposition([reg], derived) == jax_render_exposition([jreg], derived)
    two = MetricsRegistry()
    two.inc("other", 3)
    jtwo = JaxMetricsRegistry()
    jtwo.inc("other", 3)
    assert render_exposition([reg, two], prefix="x") == \
        jax_render_exposition([jreg, jtwo], prefix="x")


# ---------------------------------------------------------------------------
# event log
# ---------------------------------------------------------------------------

def test_event_log_timeline_and_jsonl(tmp_path):
    log = EventLog()
    log.emit("queued", req_id=1)
    log.emit("queued", req_id=2)
    log.emit("admitted", req_id=1, mode="chunked", queue_wait_s=0.01)
    log.emit("rejected", reason="page_capacity", need_pages=4, available=1)
    log.emit("finished", req_id=1, reason="length")
    assert len(log) == 5
    tl = log.timeline(1)
    assert [e["kind"] for e in tl] == ["queued", "admitted", "finished"]
    assert tl[1]["mode"] == "chunked"
    assert log.kinds() == {"queued": 2, "admitted": 1, "rejected": 1, "finished": 1}
    out = tmp_path / "events.jsonl"
    assert log.to_jsonl(str(out)) == str(out)
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(lines) == 5
    assert all("kind" in ev and "t" in ev for ev in lines)
    assert [e["kind"] for e in log.timeline(2)] == ["queued"]


def test_null_event_log_is_inert():
    assert NULL_EVENTS.emit("queued", req_id=1) is None
    assert len(NULL_EVENTS) == 0
    assert NULL_EVENTS.timeline(1) == []
    assert NULL_EVENTS.kinds() == {}
    assert NULL_EVENTS.to_jsonl("/nonexistent/nope") is None


# ---------------------------------------------------------------------------
# ObsConfig resolution + RuntimeConfig round-trip
# ---------------------------------------------------------------------------

def test_obs_config_auto_enable_and_build():
    assert not ObsConfig().resolved_enabled
    for kw in ({"trace": "t.json"}, {"events": "e.jsonl"}, {"fence_spans": True},
               {"debug_invariants": True}, {"enabled": True}):
        assert ObsConfig(**kw).resolved_enabled
        assert ObsConfig(**kw).resolved_enabled == JaxObsConfig(**kw).resolved_enabled
    assert not ObsConfig(enabled=False, trace="t.json").resolved_enabled
    off = ObsConfig().build()
    assert not off.enabled
    assert off.tracer is NULL_TRACER and off.events is NULL_EVENTS
    assert off.save() == []
    on = ObsConfig(enabled=True).build()
    assert on.enabled and isinstance(on.events, EventLog)
    with pytest.raises(ValueError):
        ObsConfig(profile_steps=0)
    assert dataclasses.asdict(ObsConfig()) == dataclasses.asdict(JaxObsConfig())


def test_runtime_config_obs_roundtrip():
    """Round-trips through JSON, and the reference's ``to_dict`` with
    ``obs`` set loads into the port (and the port's into the reference)."""
    obs = dict(trace="t.json", events="e.jsonl", fence_spans=True, profile_steps=5,
               debug_invariants=True, metrics_port=0, watchdog=True, record_path="b")
    rc = RuntimeConfig(obs=ObsConfig(**obs))
    assert RuntimeConfig.from_dict(json.loads(json.dumps(rc.to_dict()))) == rc
    assert RuntimeConfig.from_dict({"max_new_tokens": 4}).obs == ObsConfig()
    jrc = JaxRuntimeConfig(obs=JaxObsConfig(**obs))
    assert RuntimeConfig.from_dict(jrc.to_dict()) == rc
    assert rc.to_dict() == jrc.to_dict()
    assert JaxRuntimeConfig.from_dict(rc.to_dict()) == jrc


# ---------------------------------------------------------------------------
# torch.profiler hook
# ---------------------------------------------------------------------------

def test_step_profiler_wraps_n_steps_torch(tmp_path):
    """The first step warms the profiler up and is discarded; the next
    ``n_steps`` are written as a Chrome trace when the last one ends."""
    prof = StepProfiler(str(tmp_path), n_steps=2)
    for i in range(3):
        prof.step_begin("cpu")
        torch.ones(64).mul(i + 1).sum()
        assert prof.active                  # one profile armed across the steps
        prof.step_end()
    assert prof.done and not prof.active    # warm-up + 2 steps: written here
    prof.close()
    prof.close()                            # idempotent
    doc = json.loads(open(prof.trace_path).read())
    assert any("aten::" in e.get("name", "") for e in doc["traceEvents"])
    prof.step_begin("cpu")                  # inert once done
    assert not prof.active
    short = StepProfiler(str(tmp_path / "short"), n_steps=5)
    short.step_begin("cpu")
    short.step_end()
    short.step_begin("cpu")
    torch.ones(8).sum()
    short.step_end()
    short.close()                           # a short run flushes what it recorded
    assert short.done and os.path.exists(short.trace_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no card"):
            StepProfiler(str(tmp_path)).step_begin("cuda")


# ---------------------------------------------------------------------------
# EngineMetrics: empty-run wall clock, deprecation shim
# ---------------------------------------------------------------------------

def test_engine_metrics_empty_run_reports_cleanly():
    m = EngineMetrics()
    assert m.wall_s == 0.0
    r = m.report()
    assert r["requests"] == 0 and r["tokens_per_s"] == 0.0
    assert r["ttft_p99_s"] == 0.0 and r["accept_len_p50"] == 0.0
    m.begin()
    start = m.start_time
    m.begin()
    assert m.start_time == start
    m.touch()
    assert 0 < m.wall_s < 10.0
    assert m.end_time >= start


def test_engine_metrics_deprecation_shim():
    m = EngineMetrics()
    with pytest.warns(DeprecationWarning):
        m.prefills = 5
    assert m.prefills == 5
    m.inc("prefills")
    assert m.prefills == 6
    with pytest.warns(DeprecationWarning):
        m.pages_total = 9
    assert m.registry.gauge("pages_total").value == 9
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        _ = m.prefills
        m.inc("decode_steps")
        m.set_gauge("pages_total", 9)
        m.max_gauge("peak_running", 2)
        m.observe("accept_len", 3)
        m.extra = 1                          # not a metric: a plain attribute
    assert m.report()["accept_len_p50"] == 3.0
    with pytest.raises(AttributeError):
        _ = m.not_a_metric


def test_page_manager_invariant_violations_collects_all():
    pm = PageManager(n_pages=8, page_size=4, n_lanes=2, max_pages_per_lane=4)
    assert pm.invariant_violations() == []
    pm.check_invariants()
    pm.refcount[1] = 1
    bad = pm.invariant_violations()
    assert any("refcount mismatch" in msg for msg in bad)
    assert any("both free and referenced" in msg for msg in bad)
    with pytest.raises(AssertionError):
        pm.check_invariants()


# ---------------------------------------------------------------------------
# engine-level: the same run through the JAX and the port engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree():
    jcfg = jax_reduced(jax_get_config("llama3.2-1b")).with_(remat=False)
    t = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    return jax.tree_util.tree_map_with_path(
        lambda path, a: ((a.astype(np.float32) * WEIGHT_SCALE).astype(a.dtype)
                         if "'w" in jax.tree_util.keystr(path) else a), t)


def _runtime(pkg, obs_kw):
    """test_obs.py's serve: paged + chunked + prefix + spec (every event
    source hot)."""
    if pkg == "jax":
        return JaxRuntimeConfig(
            reduced=True, kv=JaxKVConfig(mode="paged", page_size=8, prefix_cache=True),
            scheduler=JaxSchedulerConfig(n_slots=2, prefill_chunk=8),
            spec=JaxSpecConfig(enabled=True, k=2, drafter="ngram"),
            obs=JaxObsConfig(**obs_kw))
    return RuntimeConfig(
        reduced=True, kv=KVConfig(mode="paged", page_size=8, prefix_cache=True),
        scheduler=SchedulerConfig(n_slots=2, prefill_chunk=8),
        spec=SpecConfig(enabled=True, k=2, drafter="ngram"), obs=ObsConfig(**obs_kw))


def _prompts():
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 512, 16).tolist()
    return [shared + rng.integers(0, 512, n).tolist() for n in (5, 9, 3)]


def _serve(tree, obs_kw, pkg="torch"):
    rt = _runtime(pkg, obs_kw)
    if pkg == "jax":
        llm = JaxLLM(arch="llama3.2-1b", runtime=rt,
                     params=jax.tree_util.tree_map(jax.numpy.asarray, tree))
    else:
        cfg = rt.resolve_model(tconfigs.reduced(tconfigs.get_config("llama3.2-1b")))
        llm = LLM(arch="llama3.2-1b", runtime=rt, params=params_from_jax(tree, cfg, "cpu"),
                  device="cpu")
    return llm, llm.generate(_prompts(), max_new_tokens=6)


@pytest.fixture(scope="module")
def jax_run(tree):
    return _serve(tree, {"enabled": True}, pkg="jax")


def test_disabled_obs_is_noop_and_enabled_is_output_invisible(tree, jax_run):
    """Off: null sinks, no timeline, no queue wait.  On (fenced spans,
    per-step invariant checks) and plain on: greedy streams bitwise equal
    to off and to the JAX engine's; spans of the dispatch kinds exercised;
    complete timelines."""
    llm_off, outs_off = _serve(tree, {})
    assert not llm_off.obs.enabled and llm_off.obs is not DISABLED
    assert llm_off.obs.tracer is NULL_TRACER and len(llm_off.obs.events) == 0
    assert all(o.timeline is None and o.queue_wait_s is None for o in outs_off)
    assert llm_off.engine.obs is llm_off.obs

    llm_on, outs_on = _serve(tree, {"fence_spans": True, "debug_invariants": True})
    _, outs_plain = _serve(tree, {"enabled": True})
    want = [o.token_ids for o in jax_run[1]]
    assert [o.token_ids for o in outs_off] == want
    assert [o.token_ids for o in outs_on] == want
    assert [o.token_ids for o in outs_plain] == want

    names = {e["name"] for e in llm_on.obs.tracer.events}
    assert {"step", "chunk"} <= names and names & {"decode", "verify"}
    for e in llm_on.obs.tracer.events:
        assert e["ph"] == "X" and e["dur"] >= 0 and "depth" in e["args"]
    ids = {o.request_id for o in outs_on}
    for out in outs_on:
        kinds = [e["kind"] for e in out.timeline]
        assert kinds[0] == "queued" and kinds[-1] == "finished"
        assert kinds.index("queued") < kinds.index("admitted") < kinds.index("first_token")
        admitted = next(e for e in out.timeline if e["kind"] == "admitted")
        assert admitted["mode"] in ("chunked", "prefix")
        assert admitted["queue_wait_s"] >= 0
        assert out.queue_wait_s == admitted["queue_wait_s"]
        assert all(e["req_id"] in ids for e in out.timeline)
    modes = {next(e for e in o.timeline if e["kind"] == "admitted")["mode"] for o in outs_on}
    assert "prefix" in modes
    assert any(e["kind"] == "chunk" for o in outs_on for e in o.timeline)
    rep = llm_on.metrics.report()
    assert rep["verify_dispatches"] >= 1
    assert rep["ttft_p99_s"] >= rep["ttft_p50_s"] >= 0
    assert "accept_len_p99" in rep and "queue_wait_p99_s" in rep


def test_event_journal_matches_jax_engine(tree, jax_run):
    """Event by event, the port's journal is the JAX engine's: the same
    kinds in the same order with the same fields and values, the volatile
    ones (``t``, ``wall``, waits, latencies) aside; per-request timelines
    too.  Every field the reference writes is present, volatile or not."""
    jllm, jouts = jax_run
    tllm, touts = _serve(tree, {"enabled": True})
    jev, tev = list(jllm.obs.events.events), list(tllm.obs.events.events)
    assert [canonical_event(e) for e in tev] == [canonical_event(e) for e in jev]
    assert [sorted(e) for e in tev] == [sorted(e) for e in jev]
    assert [e["seq"] for e in tev] == list(range(len(tev)))
    kinds = {e["kind"] for e in tev}
    assert {"queued", "admitted", "chunk", "first_token", "spec_verify",
            "finished"} <= kinds, kinds
    for to, jo in zip(touts, jouts):
        assert [canonical_event(e) for e in to.timeline] == \
            [canonical_event(e) for e in jo.timeline]
        assert (to.queue_wait_s is None) == (jo.queue_wait_s is None)
    assert {"t", "wall"} <= VOLATILE_FIELDS


def test_event_journal_matches_jax_engine_under_pool_pressure(tree):
    """A 9-page pool with the prefix cache, 8-token chunks and defrag at
    0.05: page-capacity rejections, a prefix-tree eviction, copy-on-write
    forks of full-prompt hits and defrags, journaled as the JAX engine
    journals them."""
    kv = dict(mode="paged", page_size=8, prefix_cache=True, n_pages=9, cache_len=48)
    sched = dict(n_slots=3, prefill_chunk=8, defrag_threshold=0.05)
    jllm = JaxLLM(arch="llama3.2-1b", params=jax.tree_util.tree_map(jax.numpy.asarray, tree),
                  runtime=JaxRuntimeConfig(reduced=True, kv=JaxKVConfig(**kv),
                                           scheduler=JaxSchedulerConfig(**sched),
                                           obs=JaxObsConfig(enabled=True)))
    rt = RuntimeConfig(reduced=True, kv=KVConfig(**kv), scheduler=SchedulerConfig(**sched),
                       obs=ObsConfig(enabled=True))
    cfg = rt.resolve_model(tconfigs.reduced(tconfigs.get_config("llama3.2-1b")))
    tllm = LLM(arch="llama3.2-1b", runtime=rt, params=params_from_jax(tree, cfg, "cpu"),
               device="cpu")
    rng = np.random.default_rng(1)
    a = rng.integers(0, 512, 16).tolist()
    prompts = [a, a, rng.integers(0, 512, 21).tolist(), a + [5, 6],
               rng.integers(0, 512, 30).tolist(), a]
    for llm in (jllm, tllm):
        eng = llm.engine
        for i, (p, g) in enumerate(zip(prompts, (4, 6, 9, 3, 5, 7))):
            eng.add_request(p, g)
            if i % 2:
                eng.step()
        while eng.has_work:
            eng.step()
    jev, tev = list(jllm.obs.events.events), list(tllm.obs.events.events)
    assert [canonical_event(e) for e in tev] == [canonical_event(e) for e in jev]
    kinds = tllm.obs.events.kinds()
    assert kinds == jllm.obs.events.kinds()
    for kind in ("rejected", "prefix_evict", "cow_fork", "defrag"):
        assert kinds.get(kind, 0) >= 1, kinds
    assert {r.req_id: r.output_tokens for r in tllm.metrics.finished} == \
        {r.req_id: r.output_tokens for r in jllm.metrics.finished}


def test_obs_save_writes_configured_sinks(tmp_path, tree):
    trace = tmp_path / "trace.json"
    events = tmp_path / "events.jsonl"
    llm, outs = _serve(tree, {"trace": str(trace), "events": str(events)})
    assert len(outs) == 3
    written = llm.obs.save()
    assert set(written) == {str(trace), str(events)}
    doc = json.loads(trace.read_text())
    assert doc["traceEvents"] and doc["traceEvents"][0]["ph"] == "M"
    lines = [json.loads(line) for line in events.read_text().splitlines()]
    assert {"queued", "admitted", "first_token", "finished"} <= {ev["kind"] for ev in lines}
    llm.close()
    llm.close()                              # idempotent


def test_request_output_queue_wait_reads_timeline():
    """The reference's contract: the queue wait is read off the timeline's
    ``admitted`` event, and is None without a timeline."""
    out = RequestOutput(request_id=0, prompt_token_ids=[1], token_ids=[2], text=None,
                        finish_reason="length", ttft_s=0.1, latency_s=0.2,
                        timeline=[{"kind": "queued", "req_id": 0},
                                  {"kind": "admitted", "req_id": 0, "queue_wait_s": 0.05}])
    assert out.queue_wait_s == 0.05
    assert RequestOutput(request_id=1, prompt_token_ids=[], token_ids=[], text=None,
                         finish_reason="length", ttft_s=None,
                         latency_s=None).queue_wait_s is None
    from repro.api import RequestOutput as JaxRequestOutput

    fields = [f.name for f in dataclasses.fields(RequestOutput)]
    assert fields == [f.name for f in dataclasses.fields(JaxRequestOutput)]


def test_debug_invariants_raise_and_journal_a_violation(tree):
    """``debug_invariants`` checks the page pool after every step: a broken
    pool emits an ``invariant_violation`` event, then raises."""
    llm, _ = _serve(tree, {"debug_invariants": True})
    eng = llm.engine
    eng.add_request([1, 2, 3, 4], 3)
    mgr = eng.store.manager
    mgr.refcount[mgr._free[-1]] = 1           # a free page that claims a holder
    with pytest.raises(AssertionError, match="page-pool invariants violated"):
        eng.step()
    assert llm.obs.events.kinds().get("invariant_violation") == 1
