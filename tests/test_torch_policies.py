"""Engine policies of the port against the JAX package: stacked admission,
priority and deadline admission, deadline preemption and defrag.

The port's ``serving/policies.py``, ``serving/scheduler.py``, the engine's
admission loop, ``paging/manager.PageManager.defrag``,
``paging/cache.PagedCache.defrag`` and ``api/config.build_policies`` are
held against the reference modules at the same relative paths, on the same
weights (the JAX ``init_params`` tree of the reduced llama3.2-1b, 4 KV
heads, projection weights scaled by 8).  Decisions (admission order, shed
requests, page moves) and greedy streams are compared exactly; time
dependent decisions run on one scripted clock in both packages.  Each test
names the reference test whose contract it carries over.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import LLM as JaxLLM
from repro.api import KVConfig as JaxKVConfig
from repro.api import RuntimeConfig as JaxRuntimeConfig
from repro.api import SchedulerConfig as JaxSchedulerConfig
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro.paging import PageManager as JaxPageManager
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving.policies import DeadlineAdmission as JaxDeadlineAdmission
from repro.serving.policies import DeadlinePreemption as JaxDeadlinePreemption
from repro.serving.policies import EnginePolicies as JaxEnginePolicies
from repro.serving.policies import PriorityAdmission as JaxPriorityAdmission
from repro.serving.request import Request as JaxRequest
from repro_torch import configs as tconfigs
from repro_torch.api import LLM, KVConfig, RuntimeConfig, SchedulerConfig, serve_batch
from repro_torch.models import params_from_jax, prefill
from repro_torch.paging import PageManager, PagedCache
from repro_torch.serving import (
    BucketBatchedAdmission,
    BudgetOrEOSEviction,
    DeadlineAdmission,
    DeadlinePreemption,
    EngineConfig,
    EnginePolicies,
    FIFOAdmission,
    NeverDefrag,
    PrefixAwareAdmission,
    PriorityAdmission,
    Request,
    SamplingParams,
    Scheduler,
    ServingEngine,
    ThresholdDefrag,
)

WEIGHT_SCALE = 8.0
KV_MODES = {"slot": {}, "paged": dict(mode="paged", page_size=8)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the host's cores; small ops slow down
    when torch's intra-op threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs():
    jcfg = jax_reduced(jax_get_config("llama3.2-1b")).with_(remat=False, n_kv_heads=4)
    tcfg = tconfigs.reduced(tconfigs.get_config("llama3.2-1b")).with_(n_kv_heads=4)
    return jcfg, tcfg


def _scaled_tree(jcfg, seed=0):
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(seed)))

    def scale(path, a):
        if "'w" in jax.tree_util.keystr(path):
            return (a.astype(np.float32) * WEIGHT_SCALE).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(scale, tree)


def _llms(kv, **sched):
    """The port's ``LLM`` and the JAX ``LLM`` on the same weights and runtime."""
    jcfg, tcfg = _configs()
    tree = _scaled_tree(jcfg)
    jllm = JaxLLM(config=jcfg, params=jax.tree_util.tree_map(jnp.asarray, tree),
                  runtime=JaxRuntimeConfig(kv=JaxKVConfig(**kv),
                                           scheduler=JaxSchedulerConfig(**sched)))
    llm = LLM(config=tcfg, params=params_from_jax(tree, tcfg, "cpu"), device="cpu",
              runtime=RuntimeConfig(kv=KVConfig(**kv), scheduler=SchedulerConfig(**sched)))
    return jllm, llm


def _solo(llm, prompt, gen):
    out, _ = serve_batch(llm.config, llm.params,
                         {"tokens": torch.tensor([prompt], dtype=torch.int32)},
                         cache_len=llm.engine.engine_cfg.cache_len, gen_tokens=gen)
    return out[0].tolist()


def _streams(metrics):
    return {r.req_id: r.output_tokens for r in metrics.finished}


COUNTS = ("prefills", "prefill_dispatches", "stacked_prefills", "decode_steps", "steps")


# ---------------------------------------------------------------------------
# stacked admission
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", list(KV_MODES), ids=list(KV_MODES))
def test_batched_admission_stacks_and_matches_solo(kv):
    """test_api.py::test_batched_admission_stacks_and_matches_solo, in slot
    and paged mode: the bucket-8 prompts admit as one stacked dispatch,
    with the reference's counts; every stream equals the JAX ``LLM``'s and
    its solo ``serve_batch``."""
    jllm, llm = _llms(KV_MODES[kv], n_slots=4, batched_admission=True,
                      prefill_buckets=(8, 16))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, llm.config.vocab_size, n).tolist() for n in (5, 7, 12, 6)]
    got = [o.token_ids for o in llm.generate(prompts, max_new_tokens=6)]
    assert got == [o.token_ids for o in jllm.generate(prompts, max_new_tokens=6)]
    m, jm = llm.metrics, jllm.metrics
    assert m.prefills == 4 and m.prefill_dispatches < m.prefills
    assert m.stacked_prefills >= 2
    for name in COUNTS:
        assert getattr(m, name) == getattr(jm, name), name
    for toks, prompt in zip(got, prompts):
        assert toks == _solo(llm, prompt, 6)
    if kv == "paged":
        assert llm.engine.store.manager.pages_in_use == 0
        llm.engine.store.manager.check_invariants()


@pytest.mark.parametrize("kv", list(KV_MODES), ids=list(KV_MODES))
def test_batched_admission_respects_slot_limit(kv):
    """test_api.py::test_batched_admission_respects_slot_limit: 2 lanes, 3
    same-bucket prompts, so the stack is capped by the free lanes."""
    jllm, llm = _llms(KV_MODES[kv], n_slots=2, batched_admission=True, prefill_buckets=(8,))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, llm.config.vocab_size, 5).tolist() for _ in range(3)]
    got = [o.token_ids for o in llm.generate(prompts, max_new_tokens=3)]
    assert got == [o.token_ids for o in jllm.generate(prompts, max_new_tokens=3)]
    assert llm.metrics.stacked_prefills == jllm.metrics.stacked_prefills == 2
    for name in COUNTS:
        assert getattr(llm.metrics, name) == getattr(jllm.metrics, name), name
    for toks, prompt in zip(got, prompts):
        assert toks == _solo(llm, prompt, 3)


# ---------------------------------------------------------------------------
# priority and deadline admission, deadline preemption (scripted clock)
# ---------------------------------------------------------------------------

def _engine_pair(policies, jax_policies, **ecfg):
    jcfg, tcfg = _configs()
    tree = _scaled_tree(jcfg)
    ecfg = {"n_slots": 1, "cache_len": 32, **ecfg}
    jeng = JaxServingEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                            JaxEngineConfig(**ecfg), policies=jax_policies)
    teng = ServingEngine(tcfg, params_from_jax(tree, tcfg, "cpu"), EngineConfig(**ecfg),
                         device="cpu", policies=policies)
    return jeng, teng


def _scripted(engines, requests, times):
    """Submit ``requests`` ((prompt, gen, kwargs)) at t=0 to every engine,
    then step them together with the decision clock at ``times[i]`` for
    step i (the last time holds once the list runs out)."""
    now = [0.0]
    for eng in engines:
        eng.set_clock(lambda: now[0])
        for prompt, gen, kw in requests:
            eng.add_request(prompt, gen, **kw)
    i = 0
    while any(eng.has_work for eng in engines):
        now[0] = times[min(i, len(times) - 1)]
        for eng in engines:
            if eng.has_work:
                eng.step()
        i += 1


def _outcome(metrics):
    """(finish order, streams, finish reasons) of a run."""
    fin = metrics.finished
    return ([r.req_id for r in fin], {r.req_id: r.output_tokens for r in fin},
            {r.req_id: r.finish_reason for r in fin})


def test_priority_admission_through_engine_matches_jax():
    """test_prefix.py::test_priority_admission_through_engine, with five
    requests of mixed priority on one lane: the admission order (by first
    token) and every stream equal the JAX engine's, higher priority first
    with aging."""
    jeng, teng = _engine_pair(EnginePolicies(admission=PriorityAdmission(aging_steps=2)),
                              JaxEnginePolicies(admission=JaxPriorityAdmission(aging_steps=2)))
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, 512, 6).tolist(), 3, {"priority": p}) for p in (0, 2, 1, 0, 3)]
    _scripted([jeng, teng], reqs, [0.0])
    got, want = _outcome(teng.metrics), _outcome(jeng.metrics)
    assert got == want
    assert got[0][:2] == [4, 1]           # priority 3, then 2, ahead of FIFO order


def test_priority_admission_orders_and_ages():
    """test_prefix.py::test_priority_admission_orders_and_ages and
    ..._aging_prevents_starvation on the port's scheduler and policy."""
    sched = Scheduler(n_slots=1, admission=PriorityAdmission(aging_steps=3))
    lo = Request(req_id=0, prompt=[1], max_new_tokens=1, priority=0)
    hi = Request(req_id=1, prompt=[1], max_new_tokens=1, priority=5)
    sched.submit(lo)
    sched.submit(hi)
    assert [r.req_id for r, _ in sched.schedule_group()] == [1]
    sched.release(0)
    sched.submit(Request(req_id=2, prompt=[1], max_new_tokens=1, priority=9))
    assert sched.schedule_group(admit_ok=lambda r: r.req_id != 2) == []
    assert [r.req_id for r, _ in sched.schedule_group()] == [2]
    sched.release(0)
    assert [r.req_id for r, _ in sched.schedule_group()] == [0]
    pol, jpol = PriorityAdmission(aging_steps=2), JaxPriorityAdmission(aging_steps=2)
    old, jold = (cls(req_id=0, prompt=[1], max_new_tokens=1, priority=0)
                 for cls in (Request, JaxRequest))
    picks = []
    for i in range(12):
        queue = [old, Request(req_id=100 + i, prompt=[1], max_new_tokens=1, priority=2)]
        jqueue = [jold, JaxRequest(req_id=100 + i, prompt=[1], max_new_tokens=1, priority=2)]
        got = pol.next_group(queue, 1, lambda r: True, lambda r: 1)
        assert got == jpol.next_group(jqueue, 1, lambda r: True, lambda r: 1)
        picks.append(queue[got[0]].req_id)
    assert 0 in picks, "aging never lifted the starved request"


def test_deadline_admission_sheds_late():
    """test_serving.py::test_deadline_admission_sheds_late on one scripted
    clock: one lane, requests with deadlines of 0.5 s, 2.5 s, none and
    9 s, one step a second.  The shed requests, the finish order and
    reasons, the streams and the deadline counts equal the JAX engine's;
    shed requests hold no lane and produce no token."""
    jeng, teng = _engine_pair(EnginePolicies(admission=DeadlineAdmission()),
                              JaxEnginePolicies(admission=JaxDeadlineAdmission()))
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 512, 8).tolist(), 4, {"deadline_s": d})
            for d in (0.5, 2.5, None, 9.0)]
    _scripted([jeng, teng], reqs, [float(t) for t in range(40)])
    got, want = _outcome(teng.metrics), _outcome(jeng.metrics)
    assert got == want
    shed = [rid for rid, reason in got[2].items() if reason == "deadline"]
    assert shed and all(not got[1][rid] for rid in shed)
    rep, jrep = teng.metrics.report(), jeng.metrics.report()
    for key in ("deadline_shed", "deadline_hits", "deadline_misses", "requests",
                "goodput_tokens"):
        assert rep[key] == jrep[key], key
    assert rep["deadline_shed"] >= 1


def test_deadline_admission_slack_and_validation():
    """test_serving.py::test_deadline_admission_slack_and_validation, with
    the reference policy's decisions beside the port's on the same queue."""
    with pytest.raises(ValueError):
        DeadlineAdmission(slack_s=-1.0)
    with pytest.raises(ValueError, match="deadline_s"):
        SamplingParams(deadline_s=0.0)
    pol, jpol = DeadlineAdmission(slack_s=0.5), JaxDeadlineAdmission(slack_s=0.5)
    cases = [(99.0, 1.2), (99.0, 2.0), (99.0, None), (98.0, 2.4), (99.9, 0.5)]
    queue = [Request(req_id=i, prompt=[1], max_new_tokens=1, submit_time=s, deadline_s=d)
             for i, (s, d) in enumerate(cases)]
    jqueue = [JaxRequest(req_id=i, prompt=[1], max_new_tokens=1, submit_time=s, deadline_s=d)
              for i, (s, d) in enumerate(cases)]
    assert pol.shed(queue, 100.0) == jpol.shed(jqueue, 100.0) == [0, 3, 4]
    assert pol.shed([queue[2]], 1e9) == []        # no deadline: never shed


def test_deadline_preemption_matches_jax():
    """``DeadlinePreemption`` on one scripted clock: a long request with a
    2.5 s deadline holds the only lane while a no-deadline request waits;
    once its deadline passes it is preempted (reason ``"deadline"``,
    partial stream) and the waiting request takes the lane.  Decisions,
    streams and counts equal the JAX engine's."""
    jeng, teng = _engine_pair(EnginePolicies(eviction=DeadlinePreemption()),
                              JaxEnginePolicies(eviction=JaxDeadlinePreemption()))
    rng = np.random.default_rng(2)
    long, short = (rng.integers(0, 512, 6).tolist() for _ in range(2))
    _scripted([jeng, teng], [(long, 12, {"deadline_s": 2.5}), (short, 4, {})],
              [float(t) for t in range(40)])
    got, want = _outcome(teng.metrics), _outcome(jeng.metrics)
    assert got == want
    assert got[2][0] == "deadline" and 0 < len(got[1][0]) < 12
    assert len(got[1][1]) == 4
    assert teng.metrics.deadline_preempt == jeng.metrics.deadline_preempt == 1


# ---------------------------------------------------------------------------
# defrag
# ---------------------------------------------------------------------------

def test_threshold_defrag_unit():
    """test_api.py::test_threshold_defrag_unit on the port's manager."""
    mgr = PageManager(n_pages=9, page_size=4, n_lanes=2, max_pages_per_lane=4)
    mgr.admit(0, 8), mgr.alloc(0, 2)       # pages 1, 2
    mgr.admit(1, 8), mgr.alloc(1, 2)       # pages 3, 4
    pol = ThresholdDefrag(threshold=0.3)
    assert not pol.should_defrag(mgr)      # contiguous: frag = 0
    mgr.free_lane(0)                       # holes at 1, 2; span 4, used 2
    assert pol.should_defrag(mgr)          # frag = 0.5 > 0.3
    assert not ThresholdDefrag(threshold=0.6).should_defrag(mgr)
    assert not NeverDefrag().should_defrag(mgr)
    mgr.defrag()
    assert not pol.should_defrag(mgr)      # compacted back to frag = 0
    with pytest.raises(ValueError):
        ThresholdDefrag(threshold=1.0)


def test_manager_defrag_compacts():
    """test_paging.py::test_manager_defrag_compacts, with the moves, tables
    and free pages equal to the reference manager's after the same
    history (three lanes, the middle one freed, then a new admission)."""
    mgrs = [cls(n_pages=12, page_size=4, n_lanes=3, max_pages_per_lane=3)
            for cls in (PageManager, JaxPageManager)]
    for mgr in mgrs:
        for lane in range(3):
            mgr.admit(lane, reserve_tokens=12)
            mgr.alloc(lane, 3)
        mgr.free_lane(1)
    moves = [mgr.defrag() for mgr in mgrs]
    assert moves[0] == moves[1]
    assert sorted(m[0] for m in moves[0]) == [7, 8, 9]
    assert sorted(m[1] for m in moves[0]) == [4, 5, 6]
    for mgr in mgrs:
        assert {p for pages in mgr.lane_pages for p in pages} == set(range(1, 7))
        assert mgr.defrag() == []
        mgr.admit(1, reserve_tokens=8)
        mgr.alloc(1, 2)
    port, ref = mgrs
    assert port.block_tables.tolist() == ref.block_tables.tolist()
    assert port.lane_pages == ref.lane_pages and port.span == ref.span == 8
    port.check_invariants()


def test_paged_cache_defrag_preserves_lane_contents():
    """test_paging.py::test_paged_cache_defrag_preserves_lane_contents: a
    lane's rows read the same through its remapped table after defrag."""
    _, tcfg = _configs()
    params = params_from_jax(_scaled_tree(_configs()[0]), tcfg, "cpu")
    pool = PagedCache(tcfg, n_lanes=3, cache_len=32, page_size=8, device="cpu")
    mgr = pool.manager
    rng = np.random.default_rng(1)
    for lane in range(3):
        tokens = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (1, 16)).astype(np.int32))
        _, single = prefill(params, tcfg, {"tokens": tokens}, cache_len=16)
        mgr.admit(lane, reserve_tokens=16)
        ids = mgr.alloc(lane, 2)
        mgr.set_length(lane, 16)
        pool.insert(single, lane, ids, new_len=16)

    def lane_rows(lane):
        tbl = pool.cache["block_tables"][lane, :2].long()
        return [leaf[:, tbl].clone() for leaf in pool.cache["blocks"][0].values()]

    before = lane_rows(2)
    pool.free(1)
    assert pool.defrag() == [(6, 3), (5, 4)]
    assert all(torch.equal(a, b) for a, b in zip(lane_rows(2), before))
    assert {p for pages in mgr.lane_pages for p in pages} == set(range(1, 5))
    mgr.check_invariants()


def _defrag_run(make, threshold, runtime_cls, kv_cls, sched_cls, **kw):
    rc = runtime_cls(kv=kv_cls(mode="paged", page_size=8, cache_len=32),
                     scheduler=sched_cls(n_slots=3, defrag_threshold=threshold))
    llm = make(rc)
    rng = np.random.default_rng(0)
    # a short request finishes early, freeing LOW pages while later lanes
    # still hold HIGH ones: holes, so fragmentation
    arrivals = [(0, rng.integers(0, 512, 14).tolist(), 2),
                (0, rng.integers(0, 512, 12).tolist(), 10),
                (1, rng.integers(0, 512, 9).tolist(), 8)]
    llm.engine.run(arrivals)
    return llm


def test_defrag_policy_triggers_and_is_output_invisible():
    """test_api.py::test_defrag_policy_triggers_and_is_output_invisible: at
    threshold 0.05 the engine compacts (as often, and moving as many
    pages, as the JAX engine) and the streams equal those with defrag off
    and the JAX engine's."""
    jcfg, tcfg = _configs()
    tree = _scaled_tree(jcfg)
    tparams = params_from_jax(tree, tcfg, "cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    runs = {}
    for threshold in (0.05, None):
        port = _defrag_run(lambda rc: LLM(config=tcfg, params=tparams, runtime=rc,
                                          device="cpu"),
                           threshold, RuntimeConfig, KVConfig, SchedulerConfig)
        ref = _defrag_run(lambda rc: JaxLLM(config=jcfg, params=jparams, runtime=rc),
                          threshold, JaxRuntimeConfig, JaxKVConfig, JaxSchedulerConfig)
        runs[threshold] = port, ref
    (on, ref_on), (off, ref_off) = runs[0.05], runs[None]
    assert on.metrics.defrag_count >= 1 and on.metrics.defrag_pages_moved >= 1
    assert off.metrics.defrag_count == 0
    for name in ("defrag_count", "defrag_pages_moved"):
        assert getattr(on.metrics, name) == getattr(ref_on.metrics, name), name
    assert _streams(on.metrics) == _streams(off.metrics) == _streams(ref_on.metrics)
    on.engine.store.manager.check_invariants()


# ---------------------------------------------------------------------------
# api/config.py: build_policies
# ---------------------------------------------------------------------------

def test_build_policies_mapping():
    """test_api.py::test_build_policies_mapping: each config maps to the
    policy classes the reference's maps to, the prefix-aware case and the
    shared-prefix policy included."""
    cases = [
        (dict(), FIFOAdmission, BudgetOrEOSEviction, ThresholdDefrag),
        (dict(batched_admission=True, defrag_threshold=None), BucketBatchedAdmission,
         BudgetOrEOSEviction, NeverDefrag),
        (dict(admission="priority"), PriorityAdmission, BudgetOrEOSEviction, ThresholdDefrag),
        (dict(admission="deadline", eviction="deadline-preempt", defrag_threshold=0.2),
         DeadlineAdmission, DeadlinePreemption, ThresholdDefrag),
        (dict(admission="prefix-aware"), PrefixAwareAdmission, BudgetOrEOSEviction,
         ThresholdDefrag),
    ]
    for sched, adm, ev, dfr in cases:
        p = RuntimeConfig(scheduler=SchedulerConfig(**sched)).build_policies()
        jp = JaxRuntimeConfig(scheduler=JaxSchedulerConfig(**sched)).build_policies()
        assert (type(p.admission), type(p.eviction), type(p.defrag)) == (adm, ev, dfr)
        assert [type(x).__name__ for x in (p.admission, p.eviction, p.defrag)] == \
            [type(x).__name__ for x in (jp.admission, jp.eviction, jp.defrag)]
        if dfr is ThresholdDefrag:
            assert p.defrag.threshold == jp.defrag.threshold
        assert type(p.prefix).__name__ == type(jp.prefix).__name__ == "SharedPrefix"
        assert p.prefix.min_pages == jp.prefix.min_pages
    assert dataclasses.fields(EnginePolicies)[3].name == "prefix"
