"""The port's shared-prefix KV cache against the JAX package.

``prefix/tree.py``, ``prefix/cache.py`` and the refcount / copy-on-write
half of ``paging/manager.py`` are plain Python in both packages: each case
of ``tests/test_prefix.py`` runs the same operations on the port's and the
reference's objects and asserts the same results.  The engine cases serve
the reduced llama3.2-1b (4 KV heads, ``int8_spoga`` GEMMs, bf16 and int8
pools) with the JAX ``init_params`` tree scaled by 8 (so greedy decoding
does not collapse onto one token), carried across with
``params_from_jax``: streams with the prefix cache on equal those with it
off and the JAX engine's, bitwise, and the page bookkeeping is checked
after every engine step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro.paging import PageManager as JaxPageManager
from repro.prefix import PrefixCache as JaxPrefixCache
from repro.prefix import PrefixTree as JaxPrefixTree
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import EnginePolicies as JaxEnginePolicies
from repro.serving import PrefixAwareAdmission as JaxPrefixAwareAdmission
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import ThresholdDefrag as JaxThresholdDefrag
from repro_torch import configs as tconfigs
from repro_torch.api import serve_batch
from repro_torch.models import params_from_jax
from repro_torch.paging import PageManager
from repro_torch.prefix import PrefixCache, PrefixTree
from repro_torch.serving import (
    EngineConfig,
    EnginePolicies,
    PrefixAwareAdmission,
    ServingEngine,
    ThresholdDefrag,
)

PS = 4          # tree-test page size
WEIGHT_SCALE = 8.0
MANAGERS = [PageManager, JaxPageManager]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes that share the host's
    cores; torch's intra-op threads then spin against each other and small
    ops slow down a hundredfold.  This file's tensors are small: one thread
    each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# PrefixTree, port and reference side by side
# ---------------------------------------------------------------------------

def _tree_match(cls):
    t = cls(PS)
    toks = list(range(100, 112))                   # 3 pages
    out = [t.insert(toks, [1, 2, 3])]
    pages, path = t.match(toks)
    out += [pages, len(path)]
    out.append(t.match(toks[:8] + [999] * 4)[0])   # 2 pages + a partial third
    out.append(t.match(toks[:3] + [999] * 9)[0])   # below page granularity
    out.append(t.match(toks[:3])[0])               # shorter than a page
    return out


def _tree_split(cls):
    t = cls(PS)
    a, b = [1, 2, 3, 4, 5, 6, 7, 8], [1, 2, 3, 4, 9, 9, 9, 9]
    return [t.insert(a, [10, 11]), t.insert(b, [20, 21]), t.match(a)[0], t.match(b)[0],
            t.total_pages, t.n_nodes]


def _tree_duplicate(cls):
    t = cls(PS)
    return [t.insert([5, 6, 7, 8], [3]), t.insert([5, 6, 7, 8], [7]),
            t.match([5, 6, 7, 8])[0]]


def _tree_lru(cls):
    t = cls(PS)
    trunk = [1, 2, 3, 4]
    t.insert(trunk + [5] * 4, [1, 2])
    t.insert(trunk + [6] * 4, [1, 3])
    t.match(trunk + [5] * 4)
    out = [t.evict(1, evictable=lambda n: True)]
    out.append(t.evict(10, evictable=lambda n: True,
                       protect=list(t.match(trunk + [5] * 4)[1])))
    out.append(sorted(t.evict(10, evictable=lambda n: True)))
    return out + [t.n_nodes]


def _tree_remap(cls):
    t = cls(PS)
    t.insert([1, 2, 3, 4, 5, 6, 7, 8], [9, 4])
    t.remap({9: 1, 4: 2})
    return [t.match([1, 2, 3, 4, 5, 6, 7, 8])[0]]


TREE_CASES = {
    "match_is_page_aligned": (_tree_match, [[1, 2, 3], [1, 2, 3], 1, [1, 2], [], []]),
    "split_and_divergent_insert": (_tree_split, [[10, 11], [21], [10, 11], [10, 21], 3, 3]),
    "duplicate_insert_keeps_original_pages": (_tree_duplicate, [[3], [], [3]]),
    "lru_evicts_leaves_first_with_protection": (_tree_lru, [[3], [], [1, 2], 0]),
    "remap_rewrites_pages": (_tree_remap, [[1, 2]]),
}


@pytest.mark.parametrize("case", sorted(TREE_CASES))
def test_tree_matches_reference(case):
    fn, want = TREE_CASES[case]
    assert fn(PrefixTree) == fn(JaxPrefixTree) == want


def test_prefix_cache_plan_publish_evict_match_reference():
    """``PrefixCache.plan`` (partial and full-prompt hits, with and
    without forking), ``publish``, ``evict_for``, ``epoch`` and ``stats``
    give the reference's answers on the same pool."""
    out = []
    for mgr_cls, cache_cls in ((PageManager, PrefixCache), (JaxPageManager, JaxPrefixCache)):
        res = []
        for fork in (True, False):
            mgr = mgr_cls(n_pages=12, page_size=PS, n_lanes=2, max_pages_per_lane=4)
            cache = cache_cls(mgr, PS, allow_fork=fork)
            mgr.admit(0, 12)
            pages = mgr.alloc(0, 3)
            prompt = list(range(12))
            res.append(cache.publish(prompt + [7], pages))
            for p in (prompt, prompt[:8] + [50, 51, 52, 53, 54], [9] * 12):
                plan = cache.plan(p)
                res.append(None if plan is None else
                           (plan.pages, plan.match_tokens, plan.resume, plan.fork_index))
            res.append(cache.stats())
            mgr.free_lane(0)
            res.append((cache.evict_for(2), cache.epoch, cache.cached_pages))
            mgr.check_invariants()
        out.append(res)
    assert out[0] == out[1]
    assert out[0][1] == ([1, 2, 3], 12, 11, 2)          # full hit, fork the last page
    assert out[0][7] == ([1, 2], 8, 8, None)             # no fork: drop the last page


# ---------------------------------------------------------------------------
# PageManager refcounts / CoW, port and reference side by side
# ---------------------------------------------------------------------------

def _mgr_adopt(cls):
    mgr = cls(n_pages=10, page_size=4, n_lanes=3, max_pages_per_lane=4)
    mgr.admit(0, reserve_tokens=16)
    pages = mgr.alloc(0, 2)
    mgr.tree_ref(pages)
    mgr.admit(1, reserve_tokens=16, adopt_pages=pages)
    out = [list(mgr.lane_pages[1]), mgr.block_tables[1, :2].tolist(),
           mgr.refcount[pages].tolist(), mgr.available]
    mgr.check_invariants()
    out += [mgr.free_lane(0), mgr.refcount[pages].tolist(), mgr.free_lane(1),
            mgr.tree_unref(pages)]
    mgr.check_invariants()
    return out


def _mgr_cow(cls):
    mgr = cls(n_pages=10, page_size=4, n_lanes=2, max_pages_per_lane=4)
    mgr.admit(0, reserve_tokens=8)
    pages = mgr.alloc(0, 2)
    mgr.tree_ref(pages)
    mgr.admit(1, reserve_tokens=12, adopt_pages=pages, forks=1)
    src, dst = mgr.cow_fork(1, 1)
    out = [src, dst, list(mgr.lane_pages[1]), int(mgr.refcount[src]), int(mgr.refcount[dst]),
           mgr.ensure_writable(1, 7), mgr.ensure_writable(1, 2)]
    mgr.check_invariants()
    out.append(mgr.ensure_writable_range(0, 0, 8))
    with pytest.raises(RuntimeError, match="not shared"):
        mgr.cow_fork(1, 0)
    mgr.check_invariants()
    return out


def _mgr_gate(cls):
    mgr = cls(n_pages=6, page_size=4, n_lanes=2, max_pages_per_lane=5)
    mgr.admit(0, reserve_tokens=12)
    pages = mgr.alloc(0, 3)
    mgr.tree_ref(pages)
    mgr.free_lane(0)
    mgr.admit(1, reserve_tokens=20, adopt_pages=pages)
    out = [mgr.available]
    mgr.free_lane(1)
    with pytest.raises(RuntimeError, match="overcommit"):
        mgr.admit(1, reserve_tokens=20, adopt_pages=pages, forks=2)
    mgr.check_invariants()
    return out


def _mgr_defrag(cls):
    mgr = cls(n_pages=12, page_size=4, n_lanes=3, max_pages_per_lane=4)
    mgr.admit(0, reserve_tokens=8)
    mgr.alloc(0, 2)
    mgr.admit(1, reserve_tokens=8)
    mid = mgr.alloc(1, 2)
    mgr.tree_ref(mid)
    mgr.admit(2, reserve_tokens=8, adopt_pages=mid)
    mgr.free_lane(0)
    seen = {}
    mgr.remap_listeners.append(seen.update)
    moves = mgr.defrag()
    assert moves and seen == dict(moves)
    assert mgr.lane_pages[1] == mgr.lane_pages[2]
    assert (mgr.refcount[mgr.lane_pages[1]] == 3).all()
    mgr.check_invariants()
    return [moves, list(mgr.lane_pages[1]), mgr.block_tables.tolist()]


MANAGER_CASES = {"adopt_and_shared_free": _mgr_adopt, "cow_fork_swaps_private_page": _mgr_cow,
                 "admit_gate_counts_adoption_and_forks": _mgr_gate,
                 "defrag_preserves_shared_aliasing": _mgr_defrag}


@pytest.mark.parametrize("case", sorted(MANAGER_CASES))
def test_manager_matches_reference(case):
    assert MANAGER_CASES[case](PageManager) == MANAGER_CASES[case](JaxPageManager)


def _state(mgr):
    return (mgr.block_tables.tolist(), [list(p) for p in mgr.lane_pages],
            mgr.refcount.tolist(), mgr.tree_held.tolist(), sorted(mgr._free),
            mgr.lengths.tolist(), mgr.reserved.tolist())


@pytest.mark.parametrize("seed", [0, 1])
def test_manager_invariants_under_random_ops(seed):
    """A random alloc / publish / fork / free / defrag storm on the port's
    and the reference's manager in lockstep: the invariants hold after
    every operation and the two stay in the same state (the same errors,
    the same tables, refcounts and free lists)."""
    rng = np.random.default_rng(seed)
    mgrs = [cls(n_pages=24, page_size=4, n_lanes=4, max_pages_per_lane=5) for cls in MANAGERS]
    published = [[], []]
    for _ in range(300):
        lane, op, arg = int(rng.integers(0, 4)), int(rng.integers(0, 6)), int(rng.integers(1, 20))
        errors = []
        for mgr, pub in zip(mgrs, published):
            try:
                if op == 0 and not mgr.lane_pages[lane] and not mgr.reserved[lane]:
                    mgr.admit(lane, arg)
                elif op == 1:
                    mgr.ensure(lane, arg)
                elif op == 2 and mgr.lane_pages[lane]:
                    assert mgr.free_lane(lane) >= 0
                elif op == 3 and mgr.lane_pages[lane]:
                    for p in mgr.lane_pages[lane]:
                        if not mgr.tree_held[p]:
                            mgr.tree_ref([p])
                            pub.append(p)
                            break
                elif op == 4:
                    for i, p in enumerate(mgr.lane_pages[lane]):
                        if mgr.refcount[p] > 1 and mgr.free_pages > 0:
                            mgr.cow_fork(lane, i)
                            break
                elif op == 5:
                    remap = dict(mgr.defrag())
                    pub[:] = [remap.get(p, p) for p in pub]
                errors.append(None)
            except RuntimeError as e:
                errors.append(str(e))
            mgr.check_invariants()
        assert errors[0] == errors[1]
        assert _state(mgrs[0]) == _state(mgrs[1])
    for mgr, pub in zip(mgrs, published):
        while pub:
            mgr.tree_unref([pub.pop()])
            mgr.check_invariants()
    assert _state(mgrs[0]) == _state(mgrs[1])


# ---------------------------------------------------------------------------
# Engine: prefix cache on == off == the JAX engine, bitwise
# ---------------------------------------------------------------------------

def _configs(kv_dtype, arch="llama3.2-1b"):
    kw = dict(quant_mode="int8_spoga", kv_cache_dtype=kv_dtype, n_kv_heads=4)
    jcfg = jax_reduced(jax_get_config(arch)).with_(remat=False, **kw)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch)).with_(**kw)
    return jcfg, tcfg


def _scaled_tree(jcfg):
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))

    def scale(path, a):
        key = jax.tree_util.keystr(path)
        if "'w" in key or "'experts" in key:
            return (a.astype(np.float32) * WEIGHT_SCALE).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(scale, tree)


ENGINE = dict(n_slots=2, cache_len=48, cache_mode="paged", page_size=8, prefill_chunk=8)


def _streams(metrics):
    return {r.req_id: r.output_tokens for r in metrics.finished}


def _run_checked(engine, arrivals):
    """``engine.run(arrivals)``, with the page bookkeeping checked after
    every step."""
    pending = sorted(arrivals, key=lambda a: a[0])
    i = 0
    while i < len(pending) or engine.has_work:
        while i < len(pending) and pending[i][0] <= engine._step_idx:
            engine.add_request(*pending[i][1:])
            i += 1
        if not engine.has_work:
            engine._step_idx = pending[i][0]
            continue
        engine.step()
        engine.store.manager.check_invariants()
    return engine.metrics


def _pair(kv_dtype, jax_policies=None, policies=None, arch="llama3.2-1b", **ecfg_kw):
    """(JAX engine, port engine) on the same weights and settings."""
    jcfg, tcfg = _configs(kv_dtype, arch)
    tree = _scaled_tree(jcfg)
    ecfg = {**ENGINE, **ecfg_kw}
    jeng = JaxServingEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                            JaxEngineConfig(**ecfg), policies=jax_policies)
    teng = ServingEngine(tcfg, params_from_jax(tree, tcfg, "cpu"), EngineConfig(**ecfg),
                         device="cpu", policies=policies)
    return jeng, teng


def _solo(engine, prompt, gen, cache_len=48):
    """The prompt's solo slot-cache decode on the port (``serve_batch``)."""
    out, _ = serve_batch(engine.cfg, engine.params,
                         {"tokens": torch.tensor([prompt], dtype=torch.int32)},
                         cache_len=cache_len, gen_tokens=gen)
    return out[0].tolist()


def _shared_traffic(seed, tails, gens):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 512, 16).tolist()        # 2 pages
    prompts = [shared + rng.integers(0, 512, n).tolist() for n in tails]
    return [(2 * i, p, g) for i, (p, g) in enumerate(zip(prompts, gens))]


@pytest.mark.parametrize("arch,kv", [
    pytest.param("llama3.2-1b", "bf16", id="bf16"),          # GQA pages
    pytest.param("llama3.2-1b", "int8", id="int8"),          # byte-size pages + scales
    pytest.param("minicpm3-4b", "bf16", id="minicpm3-4b"),   # MLA latent pages
])
def test_engine_prefix_cache_is_bitwise_invisible(arch, kv):
    """``test_prefix.py::test_engine_prefix_cache_is_bitwise_invisible``:
    staggered requests sharing a 2-page prefix give the same greedy tokens
    with the prefix cache on as off, both equal the JAX engine's (cache on)
    and the cache actually hits, with the same counts as the reference."""
    arrivals = _shared_traffic(0, (5, 9, 3), (6, 5, 4))
    outs = {}
    for on in (False, True):
        jeng, teng = _pair(kv, arch=arch, prefix_cache=on)
        m, jm = _run_checked(teng, arrivals), jeng.run(arrivals)
        outs[on] = _streams(m)
        assert outs[on] == _streams(jm)
        if on:
            assert m.prefix_hits >= 2 and m.prefix_hit_tokens >= 32
            for key in ("prefix_hits", "prefix_misses", "prefix_hit_tokens",
                        "prefix_cow_forks", "prefix_tree_pages", "chunk_steps",
                        "prefill_dispatches", "decode_steps"):
                assert getattr(m, key) == getattr(jm, key), key
    assert outs[True] == outs[False]


def test_engine_prefix_cow_fork_under_concurrent_decode():
    """A full-prompt hit CoW-forks the boundary page while the publishing
    request still decodes through it: both streams equal the solo decode
    and the JAX engine's."""
    _cow_fork_case("llama3.2-1b")


def test_engine_prefix_cow_fork_copies_mla_latent_pages():
    """The CoW fork of :func:`test_engine_prefix_cow_fork_under_concurrent_decode`
    on minicpm3-4b: the forked page's latents (``ckvp``/``krp``) are copied."""
    _cow_fork_case("minicpm3-4b")


def _cow_fork_case(arch):
    prompt = np.random.default_rng(1).integers(0, 512, 16).tolist()   # 2 pages
    arrivals = [(0, prompt, 10), (2, prompt, 10)]
    jeng, teng = _pair("bf16", arch=arch, prefix_cache=True)
    m, jm = _run_checked(teng, arrivals), jeng.run(arrivals)
    assert m.prefix_cow_forks >= 1 and m.prefix_hits == 1
    assert m.prefix_cow_forks == jm.prefix_cow_forks
    ref = _solo(teng, prompt, 10)
    assert all(r.output_tokens == ref for r in m.finished)
    assert _streams(m) == _streams(jm)


def test_engine_prefix_no_sharing_below_page_granularity():
    rng = np.random.default_rng(2)
    shared = rng.integers(0, 512, 5).tolist()         # < one page
    prompts = [shared + rng.integers(0, 512, 6).tolist() for _ in range(2)]
    _, teng = _pair("bf16", prefix_cache=True)
    m = _run_checked(teng, [(0, prompts[0], 4), (2, prompts[1], 4)])
    assert m.prefix_hits == 0 and m.prefix_misses == 2
    for i, p in enumerate(prompts):
        assert _streams(m)[i] == _solo(teng, p, 4)


def test_engine_prefix_eviction_then_rematch():
    """Pool pressure LRU-evicts tree-only pages to admit new work; an
    evicted prefix misses, republishes and matches again, all exact and
    with the reference's counts."""
    rng = np.random.default_rng(3)
    pa, pb = (rng.integers(0, 512, 16).tolist() for _ in range(2))
    arrivals = [(0, pa, 8), (5, pb, 8), (10, pa, 8), (15, pa, 8)]
    jeng, teng = _pair("bf16", n_slots=1, cache_len=32, n_pages=5, prefill_chunk=None,
                       prefix_cache=True)
    m, jm = _run_checked(teng, arrivals), jeng.run(arrivals)
    assert m.prefix_evicted_pages > 0 and m.prefix_hits >= 1
    for key in ("prefix_hits", "prefix_misses", "prefix_evicted_pages", "prefix_cow_forks"):
        assert getattr(m, key) == getattr(jm, key), key
    outs = _streams(m)
    assert outs == _streams(jm)
    assert outs[0] == outs[2] == outs[3] == _solo(teng, pa, 8, 32)
    assert outs[1] == _solo(teng, pb, 8, 32)


def test_engine_prefix_defrag_moves_shared_pages_exactly():
    """Aggressive defrag compacts mid-run while the tree and several lanes
    alias the same pages: outputs stay solo-exact and equal to the JAX
    engine's, the tree follows the moves, the invariants hold every step."""
    arrivals = [(t, p, g) for t, (_, p, g) in zip((0, 2, 6, 9), _shared_traffic(
        4, (5, 9, 3, 7), (6, 4, 7, 5)))]
    jeng, teng = _pair("bf16", prefix_cache=True,
                       jax_policies=JaxEnginePolicies(defrag=JaxThresholdDefrag(0.1, min_pages=2)),
                       policies=EnginePolicies(defrag=ThresholdDefrag(0.1, min_pages=2)))
    m, jm = _run_checked(teng, arrivals), jeng.run(arrivals)
    assert m.defrag_count > 0 and m.prefix_hits >= 2
    assert (m.defrag_count, m.defrag_pages_moved) == (jm.defrag_count, jm.defrag_pages_moved)
    tree_pages = sorted(p for node in teng.prefix.tree.nodes() for p in node.pages)
    assert all(teng.store.manager.tree_held[p] for p in tree_pages)
    outs = _streams(m)
    assert outs == _streams(jm)
    for i, (_, p, g) in enumerate(arrivals):
        assert outs[i] == _solo(teng, p, g), i


def test_engine_prefix_aware_admission_is_exact():
    """``test_spec.py::test_prefix_aware_admission_through_engine_is_exact``:
    prefix-aware ordering changes no output, shared-prefix requests hit,
    and the admission order is the reference's."""
    rng = np.random.default_rng(7)
    shared = rng.integers(0, 512, 16).tolist()
    prompts = ([shared + rng.integers(0, 512, n).tolist() for n in (5, 9, 3)]
               + [rng.integers(0, 512, 11).tolist()])
    arrivals = [(0, p, g) for p, g in zip(prompts, (6, 5, 4, 5))]
    jeng, teng = _pair("bf16", prefix_cache=True,
                       jax_policies=JaxEnginePolicies(admission=JaxPrefixAwareAdmission()),
                       policies=EnginePolicies(admission=PrefixAwareAdmission()))
    m, jm = _run_checked(teng, arrivals), jeng.run(arrivals)
    assert m.prefix_hits >= 2
    assert [r.req_id for r in m.finished] == [r.req_id for r in jm.finished]
    outs = _streams(m)
    assert outs == _streams(jm)
    for i, (_, p, g) in enumerate(arrivals):
        assert outs[i] == _solo(teng, p, g), i


def test_int8_full_prompt_prefix_hit_is_exact():
    """int8 pools CoW-fork the boundary page on a full-prompt hit and
    resume at the final token (every admission goes through the chunk
    step): the hit reuses all but one token and matches the cold run."""
    prompt = np.random.default_rng(8).integers(0, 512, 16).tolist()
    arrivals = [(0, prompt, 8), (3, prompt, 8)]
    jeng, teng = _pair("int8", prefix_cache=True)
    m, jm = _run_checked(teng, arrivals), jeng.run(arrivals)
    assert m.prefix_hits == 1 and m.prefix_cow_forks >= 1
    assert m.prefix_hit_tokens == len(prompt) - 1
    assert m.chunk_steps == jm.chunk_steps
    outs = _streams(m)
    assert outs == _streams(jm) and outs[0] == outs[1]


def test_engine_rejects_bad_prefix_configs():
    _, tcfg = _configs("bf16")
    jcfg, _ = _configs("bf16")
    params = params_from_jax(_scaled_tree(jcfg), tcfg, "cpu")
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(tcfg, params, EngineConfig(cache_mode="slot", prefix_cache=True),
                      device="cpu")
    eng = ServingEngine(tcfg, params, EngineConfig(cache_mode="paged", page_size=8,
                                                   prefix_cache=True), device="cpu")
    assert eng._chunk_len == 8          # one page a chunk without prefill_chunk
