"""The port's flight recorder and deterministic replay
(``repro_torch/obs/recorder.py``, ``repro_torch/obs/replay.py``,
``python -m repro_torch.launch.replay``) against the JAX package's.

Each test of ``tests/test_replay.py`` has its counterpart here: a run
recorded with ``ObsConfig(record_path=...)`` replays **bitwise** (every
greedy token stream and every scheduler decision in the journal) from
nothing but the bundle; a perturbed replay names the first divergent
decision; ``DeadlinePreemption``'s time-dependent decisions replay from
the decision-clock tape; the event log's ``seq`` stays contiguous across
rotation; a disarmed recorder changes nothing.  Beyond those: a bundle
the *reference* records on the CPU replays in the port with no divergent
decision and equal tokens (the port's ``init_params`` then returns
``params_from_jax`` of the reference's seed-0 weights), and the CLI exits
0 with the reference's ``--json`` keys.  Every replay here runs on the
CPU (``device="cpu"``).
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from repro_torch.api import LLM, KVConfig, ObsConfig, RuntimeConfig, SchedulerConfig, SpecConfig
from repro_torch.obs.events import EventLog, NullEventLog
from repro_torch.obs.recorder import BUNDLE_VERSION
from repro_torch.obs.replay import (
    ReplayClock,
    canonical_event,
    diff_journals,
    load_bundle,
    replay_bundle,
)
from repro_torch.serving.policies import DeadlinePreemption
from repro_torch.serving.sampling import SamplingParams

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the host's cores; small ops slow down
    when torch's intra-op threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# event log: wall clock + contiguous seq across rotation
# ---------------------------------------------------------------------------

def test_event_log_emits_wall_and_monotonic_seq():
    log = EventLog()
    before = time.time()
    evs = [log.emit("k", i, x=i) for i in range(5)]
    after = time.time()
    assert [e["seq"] for e in evs] == [0, 1, 2, 3, 4]
    for e in evs:
        assert before <= e["wall"] <= after and "t" in e
    assert NullEventLog().tail(3) == []
    assert log.tail(2) == evs[-2:] and log.tail(0) == [] and log.tail(99) == evs


def test_event_seq_stays_contiguous_across_rotation(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    log = EventLog(stream_path=path, max_bytes=400)
    for i in range(40):
        log.emit("tick", i, payload="x" * 20)
    log.close()
    assert log.rotations >= 1
    lines = []
    for p in (path + ".1", path):
        with open(p) as f:
            lines += [json.loads(line) for line in f]
    seqs = [e["seq"] for e in lines]
    assert seqs == list(range(seqs[0], seqs[0] + len(seqs)))
    assert all("wall" in e for e in lines)


# ---------------------------------------------------------------------------
# journal differ + replay clock units
# ---------------------------------------------------------------------------

def test_diff_journals_finds_first_divergence_and_ignores_volatiles():
    from repro.obs.replay import VOLATILE_FIELDS as JAX_VOLATILE
    from repro_torch.obs.replay import VOLATILE_FIELDS

    assert VOLATILE_FIELDS == JAX_VOLATILE
    a = [{"seq": 0, "t": 1.0, "wall": 9.0, "kind": "queued", "req_id": 0},
         {"seq": 1, "t": 2.0, "wall": 9.1, "kind": "admitted", "req_id": 0,
          "pages": [1, 2], "queue_wait_s": 0.5}]
    b = [{"seq": 0, "t": 5.0, "wall": 99.0, "kind": "queued", "req_id": 0},
         {"seq": 1, "t": 6.0, "wall": 99.1, "kind": "admitted", "req_id": 0,
          "pages": [1, 2], "queue_wait_s": 0.9}]
    assert diff_journals(a, b) is None
    b[1]["pages"] = [1, 3]
    div = diff_journals(a, b)
    assert div is not None and div.index == 1
    msg = div.format()
    assert "diverged at event 1" in msg
    assert "pages=[1, 2]" in msg and "pages=[1, 3]" in msg
    div = diff_journals(a, a[:1])
    assert div.index == 1 and div.replayed is None
    assert "<journal ended>" in div.format()
    assert canonical_event({"kind": "defrag", "moves": [(5, 1)]}) == \
        {"kind": "defrag", "moves": [[5, 1]]}


def test_replay_clock_scripts_tape_then_holds():
    clk = ReplayClock([1.0, 2.5, 7.0])
    assert [clk(), clk(), clk()] == [1.0, 2.5, 7.0]
    assert clk() == 7.0 and clk() == 7.0
    assert clk.exhausted_reads == 2
    assert ReplayClock([])() == 0.0


# ---------------------------------------------------------------------------
# record -> replay: bitwise fidelity
# ---------------------------------------------------------------------------

def _mixed_runtime(record_path=None, spec=True, eviction="budget", admission="fifo"):
    """The everything-on paged engine: prefix cache + chunked prefill +
    (optionally) speculative decoding."""
    return RuntimeConfig(
        reduced=True,
        kv=KVConfig(mode="paged", page_size=8, prefix_cache=True),
        scheduler=SchedulerConfig(n_slots=2, prefill_chunk=8, admission=admission,
                                  eviction=eviction),
        spec=SpecConfig(enabled=spec, k=2, drafter="ngram"),
        obs=ObsConfig(record_path=record_path))


def _arrivals(vocab, seed=0, deadlines=(None, 120.0, None, 120.0)):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 16).tolist()
    return [(s * 2, shared + rng.integers(0, vocab, n).tolist(), 6, deadlines[s])
            for s, n in enumerate((5, 9, 3, 7))]


def _record_mixed_run(path, seed=0):
    """Record one staggered paged+prefix+spec run; returns the recorded
    per-request token streams keyed by req_id."""
    llm = LLM(arch="llama3.2-1b", runtime=_mixed_runtime(record_path=path), device="cpu")
    eng = llm.build_engine(25, 6)
    eng.run(arrivals=[(s, p, g, SamplingParams(deadline_s=d))
                      for s, p, g, d in _arrivals(llm.config.vocab_size, seed)])
    tokens = {r.req_id: list(r.output_tokens) for r in eng.metrics.finished}
    llm.close()
    return tokens


def test_record_replay_mixed_paged_prefix_spec_bitwise(tmp_path):
    bundle = str(tmp_path / "bundle")
    recorded = _record_mixed_run(bundle)
    b = load_bundle(bundle)
    assert b.manifest["version"] == BUNDLE_VERSION == 1
    assert b.manifest["arch"] == "llama3.2-1b"
    assert b.manifest["engine"]["cache_mode"] == "paged"
    fp = b.manifest["fingerprint"]
    assert fp["torch"] == torch.__version__ and fp["device"]
    assert sorted(os.listdir(bundle)) == ["arrivals.jsonl", "clock.jsonl", "journal.jsonl",
                                          "manifest.json", "outputs.jsonl"]
    assert len(b.arrivals) == 4 and len(b.outputs) == 4
    assert {e["kind"] for e in b.journal} >= {"queued", "admitted", "spec_verify", "finished"}
    admits = [e for e in b.journal if e["kind"] == "admitted"]
    assert all("pages" in e or e["mode"] in ("chunked", "cold") for e in admits)
    assert any(e.get("mode") == "prefix" and e.get("pages") for e in admits)
    assert len(b.clock) > 0

    res = LLM.replay(bundle, device="cpu")
    assert res.ok, res.summary()
    assert res.token_mismatches == [] and res.divergence is None and res.warnings == []
    assert res.n_recorded_events == res.n_replayed_events > 0
    assert {o["req_id"]: o["tokens"] for o in b.outputs} == recorded


def test_perturbed_replay_names_first_divergent_decision(tmp_path):
    bundle = str(tmp_path / "bundle")
    _record_mixed_run(bundle)

    def shrink(rt):
        return dataclasses.replace(rt, kv=dataclasses.replace(rt.kv, n_pages=6))

    res = replay_bundle(bundle, runtime_transform=shrink, max_steps=2000, device="cpu")
    assert not res.ok and res.divergence is not None
    msg = res.divergence.format()
    assert "diverged at event" in msg and "recorded " in msg and "replayed " in msg
    rec, rep = res.divergence.recorded, res.divergence.replayed
    assert canonical_event(rec) != canonical_event(rep)


@pytest.mark.parametrize("case,fuzz_seed", [(0, 7), (1, 23), (2, 101)])
def test_fuzz_random_workloads_record_replay_bitwise(tmp_path, case, fuzz_seed):
    """Random stagger / priorities / deadlines (none, generous, already
    blown) / prefix-shared prompts / spec on-off -> record -> replay ->
    bitwise."""
    rng = np.random.default_rng(fuzz_seed)
    spec = case % 2 == 0
    admission = ["fifo", "priority", "deadline"][case % 3]
    bundle = str(tmp_path / f"fuzz{case}")
    llm = LLM(arch="llama3.2-1b", device="cpu",
              runtime=_mixed_runtime(record_path=bundle, spec=spec, admission=admission))
    eng = llm.build_engine(25, 6)
    shared = rng.integers(0, llm.config.vocab_size, 16).tolist()
    for _ in range(int(rng.integers(3, 6))):
        use_prefix = rng.random() < 0.6
        n = int(rng.integers(2, 9))
        prompt = ((shared if use_prefix else [])
                  + rng.integers(0, llm.config.vocab_size, n).tolist())
        gen = int(rng.integers(2, 7))
        deadline = [None, 120.0, 1e-6][int(rng.integers(0, 3))]
        eng.add_request(prompt, gen, sampling=SamplingParams(deadline_s=deadline),
                        priority=int(rng.integers(0, 3)))
        for _ in range(int(rng.integers(0, 3))):
            if eng.has_work:
                eng.step()
    eng.run()
    llm.close()
    res = replay_bundle(bundle, device="cpu")
    assert res.ok, (f"fuzz case {case} (seed {fuzz_seed}, spec={spec}, "
                    f"admission={admission}):\n" + res.summary())


def test_recorder_disarmed_zero_overhead_and_output_invisible(tmp_path):
    llm_off = LLM(arch="llama3.2-1b", runtime=_mixed_runtime(), device="cpu")
    eng_off = llm_off.build_engine(25, 6)
    # disarmed: no recorder object, and the decision clock IS
    # time.perf_counter (no wrapper on any host path)
    assert llm_off.obs.recorder is None and eng_off._recorder is None
    assert eng_off._clock is time.perf_counter
    assert eng_off.scheduler.clock is time.perf_counter
    llm_on = LLM(arch="llama3.2-1b", runtime=_mixed_runtime(record_path=str(tmp_path / "b")),
                 device="cpu")
    eng_on = llm_on.build_engine(25, 6)
    assert eng_on._recorder is llm_on.obs.recorder
    assert eng_on._clock is not time.perf_counter
    rng = np.random.default_rng(3)
    shared = rng.integers(0, llm_off.config.vocab_size, 16).tolist()
    arrivals = [(s * 2, shared + rng.integers(0, llm_off.config.vocab_size, n).tolist(), 5)
                for s, n in enumerate((4, 8, 6))]
    eng_off.run(arrivals=list(arrivals))
    eng_on.run(arrivals=list(arrivals))
    off = {r.req_id: r.output_tokens for r in eng_off.metrics.finished}
    on = {r.req_id: r.output_tokens for r in eng_on.metrics.finished}
    assert off == on
    llm_on.close()
    llm_off.close()


# ---------------------------------------------------------------------------
# DeadlinePreemption: SLO eviction, recorded + replayable
# ---------------------------------------------------------------------------

def test_deadline_preemption_frees_lane_for_ontime_work(tmp_path):
    bundle = str(tmp_path / "preempt")
    rt = RuntimeConfig(reduced=True, kv=KVConfig(cache_len=64),
                       scheduler=SchedulerConfig(n_slots=1, eviction="deadline-preempt"),
                       obs=ObsConfig(record_path=bundle))
    llm = LLM(arch="llama3.2-1b", runtime=rt, device="cpu")
    eng = llm.engine
    assert isinstance(llm._policies.eviction, DeadlinePreemption)
    rng = np.random.default_rng(0)
    doomed = eng.add_request(rng.integers(0, llm.config.vocab_size, 8).tolist(), 32,
                             sampling=SamplingParams(deadline_s=1e-6))
    ontime = eng.add_request(rng.integers(0, llm.config.vocab_size, 8).tolist(), 4)
    eng.run()
    assert doomed.finish_reason == "deadline" and len(doomed.output_tokens) < 32
    assert len(ontime.output_tokens) == 4
    assert eng.metrics.deadline_preempt == 1
    evicted = [e for e in llm.obs.events.events if e["kind"] == "evicted"]
    assert len(evicted) == 1
    assert evicted[0]["req_id"] == doomed.req_id and evicted[0]["reason"] == "deadline"
    assert eng.metrics.report()["deadline_preempt"] == 1
    llm.close()
    res = replay_bundle(bundle, device="cpu")
    assert res.ok, res.summary()
    replays = [e for e in load_bundle(bundle).journal if e["kind"] == "evicted"]
    assert len(replays) == 1 and replays[0]["reason"] == "deadline"


def test_deadline_preemption_keeps_lane_when_nothing_waiting():
    rt = RuntimeConfig(reduced=True, kv=KVConfig(cache_len=64),
                       scheduler=SchedulerConfig(n_slots=1, eviction="deadline-preempt"))
    llm = LLM(arch="llama3.2-1b", runtime=rt, device="cpu")
    eng = llm.engine
    late = eng.add_request(np.random.default_rng(1).integers(
        0, llm.config.vocab_size, 8).tolist(), 4, sampling=SamplingParams(deadline_s=1e-6))
    eng.run()
    assert len(late.output_tokens) == 4 and late.finish_reason == "length"
    assert eng.metrics.deadline_preempt == 0
    llm.close()


def test_scheduler_config_rejects_unknown_eviction():
    with pytest.raises(ValueError, match="eviction"):
        SchedulerConfig(eviction="lru")


def test_metrics_server_serves_event_tail():
    rt = RuntimeConfig(reduced=True, kv=KVConfig(cache_len=64),
                       scheduler=SchedulerConfig(n_slots=2),
                       obs=ObsConfig(enabled=True, metrics_port=0))
    llm = LLM(arch="llama3.2-1b", runtime=rt, device="cpu")
    llm.generate([np.random.default_rng(0).integers(0, llm.config.vocab_size, 8).tolist()],
                 max_new_tokens=3)
    base = llm.metrics_server.url
    doc = json.loads(urllib.request.urlopen(base + "/events?n=2").read())
    assert doc["returned"] == 2 and doc["window"] == len(llm.obs.events)
    assert doc["events"] == list(llm.obs.events.events)[-2:]
    assert all({"seq", "t", "wall", "kind"} <= set(e) for e in doc["events"])
    doc = json.loads(urllib.request.urlopen(base + "/events").read())
    assert doc["returned"] == min(100, doc["window"]) > 0
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(base + "/events?n=bogus")
    assert err.value.code == 400
    json.loads(urllib.request.urlopen(base + "/snapshot").read())
    llm.close()


# ---------------------------------------------------------------------------
# across packages, and the command line
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_bundle(tmp_path_factory):
    """The mixed staggered run recorded by the reference on the CPU (its
    own seed-0 weights), and its ``launch.replay --json`` verdict."""
    from repro.api import LLM as JaxLLM
    from repro.api import KVConfig as JaxKVConfig
    from repro.api import ObsConfig as JaxObsConfig
    from repro.api import RuntimeConfig as JaxRuntimeConfig
    from repro.api import SchedulerConfig as JaxSchedulerConfig
    from repro.api import SpecConfig as JaxSpecConfig
    from repro.launch import replay as jax_replay_cli
    from repro.serving.sampling import SamplingParams as JaxSamplingParams

    bundle = str(tmp_path_factory.mktemp("jax") / "bundle")
    llm = JaxLLM(arch="llama3.2-1b", runtime=JaxRuntimeConfig(
        reduced=True, kv=JaxKVConfig(mode="paged", page_size=8, prefix_cache=True),
        scheduler=JaxSchedulerConfig(n_slots=2, prefill_chunk=8),
        spec=JaxSpecConfig(enabled=True, k=2, drafter="ngram"),
        obs=JaxObsConfig(record_path=bundle)))
    eng = llm.build_engine(25, 6)
    eng.run(arrivals=[(s, p, g, JaxSamplingParams(deadline_s=d))
                      for s, p, g, d in _arrivals(llm.config.vocab_size)])
    llm.close()
    argv = sys.argv
    sys.argv = ["replay", bundle, "--json"]
    try:
        import contextlib
        import io

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = jax_replay_cli.main()
    finally:
        sys.argv = argv
    assert rc == 0
    return bundle, json.loads(out.getvalue())


def test_reference_bundle_replays_in_the_port(jax_bundle, monkeypatch):
    """A bundle the JAX package recorded replays in the port: no divergent
    decision, equal tokens; provenance mismatches would be warnings."""
    import repro_torch.api.llm as llm_mod
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced as jax_reduced
    from repro.models import init_params as jax_init_params
    from repro_torch.models import params_from_jax

    bundle, _ = jax_bundle
    jcfg = jax_reduced(jax_get_config("llama3.2-1b")).with_(remat=False)
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    monkeypatch.setattr(llm_mod, "init_params",
                        lambda cfg, seed=0, device=None: params_from_jax(tree, cfg, device))
    b = load_bundle(bundle)
    assert "jax" in b.manifest["fingerprint"] and b.manifest["seed"] == 0
    res = replay_bundle(bundle, device="cpu")
    assert res.error is None and res.divergence is None, res.summary()
    assert res.token_mismatches == [] and res.ok
    assert res.n_recorded_events == res.n_replayed_events > 0
    assert {e["kind"] for e in b.journal} >= {"queued", "admitted", "spec_verify", "finished"}


def test_replay_cli_exits_zero_with_the_reference_json_keys(tmp_path, jax_bundle):
    bundle = str(tmp_path / "bundle")
    _record_mixed_run(bundle)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.replay", bundle, "--json",
                          "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout
    doc = json.loads(out.stdout)
    assert set(doc) == set(jax_bundle[1])
    assert doc["ok"] is True and doc["divergence"] is None and doc["n_requests"] == 4
    text = subprocess.run([sys.executable, "-m", "repro_torch.launch.replay", bundle,
                           "--device", "cpu", "--max-steps", "3"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert text.returncode == 1 and "replay stopped at max_steps=3" in text.stdout
