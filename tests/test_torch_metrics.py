"""The port's metrics against the JAX package.

``repro_torch/obs/metrics.py`` (counters, gauges, the log-bucketed
histogram with exact percentiles) and ``repro_torch/serving/metrics.py``
(``EngineMetrics``) are held against ``repro/obs/metrics.py`` and
``repro/serving/metrics.py`` on the same samples, and the engine's counts
against the JAX engine's on the same run (the reduced llama3.2-1b, 4 KV
heads, the JAX ``init_params`` tree with its projection weights scaled by
8).  Each test names the reference test whose contract it carries over.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro.obs.metrics import Histogram as JaxHistogram
from repro.obs.metrics import MetricsRegistry as JaxMetricsRegistry
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving.metrics import EngineMetrics as JaxEngineMetrics
from repro.serving.policies import BucketBatchedAdmission as JaxBucketBatchedAdmission
from repro.serving.policies import EnginePolicies as JaxEnginePolicies
from repro.serving.policies import ThresholdDefrag as JaxThresholdDefrag
from repro.serving.request import Request as JaxRequest
from repro.serving.request import RequestState as JaxRequestState
from repro_torch import configs as tconfigs
from repro_torch.models import params_from_jax
from repro_torch.obs import Histogram, MetricsRegistry
from repro_torch.serving import (
    BucketBatchedAdmission,
    EngineConfig,
    EngineMetrics,
    EnginePolicies,
    Request,
    RequestState,
    ServingEngine,
    ThresholdDefrag,
)

WEIGHT_SCALE = 8.0
# report keys of the reference that belong to the prefix cache and to
# speculative decoding (ROADMAP queue 1, item 6); the port adds one key
ITEM_6_KEYS = {"prefix_hits", "prefix_misses", "prefix_hit_tokens", "prefix_cow_forks",
               "prefix_evicted_pages", "prefix_tree_pages", "spec_proposed", "spec_accepted",
               "verify_dispatches", "acceptance_rate", "accept_len_p50", "accept_len_p95",
               "accept_len_p99", "cost_verify_p99_s"}
PORT_KEYS = {"decode_step_mean_s"}


def _samples(seed, n=257):
    """Latency-like samples over six decades, edge values included."""
    rng = np.random.default_rng(seed)
    xs = 10.0 ** rng.uniform(-7, -1, n)
    return list(xs) + [1e-6, 2e-6, 4e-6, 0.0, 1e-6 * 2 ** 43, 1e6]


@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_matches_reference(seed):
    """test_obs.py's histogram contract: the same samples give the same
    bucket counts, exact percentiles, mean, min and max."""
    h, jh = Histogram("x"), JaxHistogram("x")
    for x in _samples(seed):
        h.observe(x)
        jh.observe(x)
    assert h.counts == jh.counts and h.total == jh.total
    assert (h.sum, h.min, h.max, h.mean) == (jh.sum, jh.min, jh.max, jh.mean)
    for q in (0, 1, 50, 90, 95, 99, 99.9, 100):
        assert h.percentile(q) == jh.percentile(q), q
    assert Histogram("empty").percentile(99) == JaxHistogram("empty").percentile(99) == 0.0
    coarse, jcoarse = Histogram("c", base=1e-3, growth=10.0, n_buckets=4), \
        JaxHistogram("c", base=1e-3, growth=10.0, n_buckets=4)
    for x in (1e-3, 1e-2, 0.5, 1.0, 7.0, 1e4):
        assert coarse.bucket_index(x) == jcoarse.bucket_index(x), x
    with pytest.raises(ValueError):
        Histogram("bad", growth=1.0)


def test_registry_matches_reference():
    """Counters (int and float), gauges (set, running max) and histograms
    created on first touch, read back as the reference's registry does."""
    reg, jreg = MetricsRegistry(), JaxMetricsRegistry()
    rng = np.random.default_rng(2)
    for _ in range(200):
        name = f"m{int(rng.integers(0, 4))}"
        op, v = int(rng.integers(0, 4)), float(rng.uniform(0, 10))
        for r in (reg, jreg):
            if op == 0:
                r.inc("c_" + name, int(v))
            elif op == 1:
                r.inc("t_" + name, v)
            elif op == 2:
                r.set_max("g_" + name, v)
            else:
                r.observe("h_" + name, v)
    assert {k: c.value for k, c in reg.counters.items()} == \
        {k: c.value for k, c in jreg.counters.items()}
    assert {k: g.value for k, g in reg.gauges.items()} == \
        {k: g.value for k, g in jreg.gauges.items()}
    for k, h in reg.histograms.items():
        assert h.percentile(95) == jreg.histograms[k].percentile(95)
    reg.set("g", 3)
    reg.set_max("g", 2)
    assert reg.gauge("g").value == 3


def _finished_pair(i):
    """The same finished request in both packages, its clock stamps fixed
    (only ``finish_time`` comes from ``record_finished``)."""
    kw = dict(req_id=i, prompt=[1] * (3 + i), max_new_tokens=4, submit_time=10.0 * i,
              admit_time=10.0 * i + 0.01 * (i % 5), first_token_time=10.0 * i + 0.02 * i,
              deadline_s=(None if i % 3 else 1e9), output_tokens=[1, 2, 3, 4])
    req = Request(**kw)
    jreq = JaxRequest(**kw)
    req.state, jreq.state = RequestState.FINISHED, JaxRequestState.FINISHED
    return req, jreq


def test_engine_metrics_report_matches_reference():
    """``EngineMetrics.report()`` has the reference's keys less item 6's
    (``ITEM_6_KEYS``) plus ``decode_step_mean_s``; on the same finished
    requests and events, the counts, TTFT and queue-wait percentiles and
    deadline and goodput numbers equal the reference's."""
    m, jm = EngineMetrics(), JaxEngineMetrics()
    assert set(m.report()) == (set(jm.report()) - ITEM_6_KEYS) | PORT_KEYS
    for metrics in (m, jm):
        metrics.begin()
        for name, n in (("steps", 9), ("prefills", 7), ("prefill_dispatches", 5),
                        ("stacked_prefills", 4), ("chunk_steps", 2), ("decode_steps", 8),
                        ("defrag_count", 1), ("defrag_pages_moved", 3), ("decode_s", 0.25)):
            metrics.inc(name, n)
        metrics.max_gauge("peak_running", 3)
        metrics.max_gauge("peak_running", 2)
    for i in range(12):
        req, jreq = _finished_pair(i)
        m.record_finished(req)
        jm.record_finished(jreq)
    rep, jrep = m.report(), jm.report()
    for key in ("requests", "generated_tokens", "prompt_tokens", "steps", "prefills",
                "prefill_dispatches", "stacked_prefills", "decode_steps", "chunk_steps",
                "defrag_count", "defrag_pages_moved", "peak_running", "decode_s",
                "ttft_mean_s", "ttft_max_s", "ttft_p50_s", "ttft_p95_s", "ttft_p99_s",
                "queue_wait_p50_s", "queue_wait_p95_s", "queue_wait_p99_s",
                "deadline_hits", "deadline_misses", "deadline_hit_rate", "goodput_tokens"):
        assert rep[key] == jrep[key], key
    assert rep["deadline_hits"] == 4 and rep["decode_step_mean_s"] == 0.25 / 8
    assert m.prefills == 7 and m.peak_running == 3
    with pytest.raises(AttributeError):
        m.no_such_metric


def test_engine_counts_match_jax_engine():
    """On the same run (paged, 8-token chunks, stacked same-bucket
    admissions, threshold-0.05 defrag, generous deadlines) the port's
    counts equal the JAX engine's."""
    jcfg = jax_reduced(jax_get_config("llama3.2-1b")).with_(remat=False, n_kv_heads=4)
    tcfg = tconfigs.reduced(tconfigs.get_config("llama3.2-1b")).with_(n_kv_heads=4)
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: ((a.astype(np.float32) * WEIGHT_SCALE).astype(a.dtype)
                         if "'w" in jax.tree_util.keystr(path) else a), tree)
    ecfg = dict(n_slots=3, cache_len=40, cache_mode="paged", page_size=8, prefill_chunk=8,
                prefill_buckets=(8,), max_prefills_per_step=2)
    jeng = JaxServingEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                            JaxEngineConfig(**ecfg), policies=JaxEnginePolicies(
                                admission=JaxBucketBatchedAdmission(),
                                defrag=JaxThresholdDefrag(0.05)))
    teng = ServingEngine(tcfg, params_from_jax(tree, tcfg, "cpu"), EngineConfig(**ecfg),
                         device="cpu", policies=EnginePolicies(
                             admission=BucketBatchedAdmission(), defrag=ThresholdDefrag(0.05)))
    lens, gens = (5, 19, 6, 7, 3, 14), (2, 6, 9, 3, 5, 4)
    for eng in (jeng, teng):
        for i, (n, g) in enumerate(zip(lens, gens)):
            eng.add_request(np.random.default_rng(i).integers(0, 512, n).tolist(), g,
                            deadline_s=300.0 if i % 2 else None)
        while eng.has_work:
            eng.step()
    rep, jrep = teng.metrics.report(), jeng.metrics.report()
    for key in ("steps", "prefills", "prefill_dispatches", "stacked_prefills", "chunk_steps",
                "decode_steps", "defrag_count", "defrag_pages_moved", "deadline_hits",
                "deadline_misses", "goodput_tokens", "peak_running", "peak_pages_used",
                "requests", "generated_tokens", "pages_total", "page_size"):
        assert rep[key] == jrep[key], key
    assert rep["stacked_prefills"] >= 2 and rep["chunk_steps"] >= 2
    assert rep["defrag_count"] >= 1
    assert rep["deadline_hits"] == 3
    assert {r.req_id: r.output_tokens for r in teng.metrics.finished} == \
        {r.req_id: r.output_tokens for r in jeng.metrics.finished}
