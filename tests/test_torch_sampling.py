"""Stochastic sampling of the port (``serving/sampling.py`` and the engine).

The reference draws from ``jax.random`` streams, which the port cannot
reproduce, so the port is held to four properties instead: a lane's token
depends only on its key and its own logits row (never on its neighbours);
the same seed gives the same stream; ``top_k=1`` gives the greedy token;
and the draws follow the temperature-scaled, top-k-truncated softmax (a
chi-square test at a fixed seed).  Greedy lanes are bitwise the argmax
whatever shares the batch, and the engine's streams do not depend on the
batch they ride in, in slot and paged modes.  ``SamplingParams`` validates
as the reference's does.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.serving.sampling import SamplingParams as JaxSamplingParams
from repro_torch import configs as tconfigs
from repro_torch.api import LLM, KVConfig, RuntimeConfig, SamplingDefaults
from repro_torch.models import init_params
from repro_torch.serving import EngineConfig, SamplingParams, ServingEngine
from repro_torch.serving.sampling import request_key, sample_tokens

V = 64
# chi-square critical value, 7 degrees of freedom, p = 0.001
CHI2_7_999 = 24.322


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


def _logits(rows, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(rows, V)) * 2.0).float()


def test_sampling_params_validate_as_the_reference():
    for kw in (dict(greedy=False, temperature=0.0), dict(greedy=False, temperature=-1.0),
               dict(deadline_s=0.0)):
        with pytest.raises(ValueError) as got:
            SamplingParams(**kw)
        with pytest.raises(ValueError) as want:
            JaxSamplingParams(**kw)
        assert str(got.value) == str(want.value)
    assert dataclasses.asdict(SamplingParams()) == dataclasses.asdict(JaxSamplingParams())
    SamplingParams(greedy=True, temperature=0.0)     # greedy ignores the temperature


def test_request_key_is_counter_based():
    keys = {request_key(s, r, t) for s in range(3) for r in range(3) for t in range(50)}
    assert len(keys) == 450 and all(0 <= k < 2 ** 63 for k in keys)
    assert request_key(5, 1, 7) == request_key(5, 1, 7)
    assert request_key(5, 1, 7) != request_key(6, 1, 7)


def test_greedy_lanes_are_the_argmax_whatever_their_neighbours():
    logits = _logits(6)
    greedy = [True, False, True, False, True, True]
    temps, topk = [0.5, 0.7, 1.3, 2.0, 0.9, 1.0], [0, 5, 1, 0, 3, 0]
    keys = [request_key(1, i, 0) for i in range(6)]
    got = sample_tokens(logits, temps, topk, greedy, keys)
    want = torch.argmax(logits, dim=-1).to(torch.int32)
    assert got.dtype == torch.int32
    for b in (0, 2, 4, 5):
        assert got[b] == want[b]
    assert torch.equal(sample_tokens(logits, temps, topk, [True] * 6, keys), want)


def test_lane_depends_only_on_its_key_and_row():
    """A lane's token is the same alone, in any batch, at any lane index."""
    logits = _logits(5, seed=1)
    temps, topk, greedy = [0.8] * 5, [0, 10, 3, 0, 20], [False] * 5
    for t in range(20):
        keys = [request_key(9, i, t) for i in range(5)]
        batch = sample_tokens(logits, temps, topk, greedy, keys)
        for b in range(5):
            alone = sample_tokens(logits[b:b + 1], temps[b:b + 1], topk[b:b + 1], [False],
                                  keys[b:b + 1])
            assert alone[0] == batch[b]
        perm = [3, 0, 4, 1, 2]
        shuffled = sample_tokens(logits[perm], [temps[i] for i in perm],
                                 [topk[i] for i in perm], greedy, [keys[i] for i in perm])
        assert shuffled.tolist() == [batch[i].item() for i in perm]


def test_top_k_one_is_greedy_and_top_k_bounds_the_support():
    logits = _logits(4, seed=2)
    want = torch.argmax(logits, dim=-1)
    seen = [set() for _ in range(4)]
    for t in range(200):
        keys = [request_key(3, i, t) for i in range(4)]
        one = sample_tokens(logits, [1.5] * 4, [1] * 4, [False] * 4, keys)
        assert torch.equal(one.long(), want)
        five = sample_tokens(logits, [5.0] * 4, [5] * 4, [False] * 4, keys)
        for b in range(4):
            seen[b].add(int(five[b]))
    for b in range(4):
        top5 = set(torch.topk(logits[b], 5).indices.tolist())
        assert seen[b] <= top5 and len(seen[b]) >= 4


@pytest.mark.parametrize("temperature,top_k", [(1.0, 0), (0.7, 8)])
def test_frequencies_follow_the_softmax(temperature, top_k):
    """4,000 draws of one row (keys of one request's first 4,000 tokens):
    the counts over the 8 likeliest tokens (the rest pooled) against the
    truncated softmax, chi-square below its p = 0.001 critical value."""
    row = torch.from_numpy(np.random.default_rng(4).normal(size=(1, 16)) * 1.5).float()
    n = 4000
    counts = np.zeros(16, np.int64)
    for t in range(n):
        tok = sample_tokens(row, [temperature], [top_k], [False], [request_key(11, 0, t)])
        counts[int(tok[0])] += 1
    probs = torch.softmax(row[0] / temperature, dim=-1).numpy().astype(np.float64)
    if top_k:
        keep = np.argsort(-probs)[:top_k]
        mask = np.zeros(16, bool)
        mask[keep] = True
        assert counts[~mask].sum() == 0
        probs = np.where(mask, probs, 0.0)
        probs /= probs.sum()
    order = np.argsort(-probs)
    cells = list(order[:7]) + [order[7:]]
    obs = np.array([counts[c].sum() for c in cells], np.float64)
    exp = np.array([probs[c].sum() * n for c in cells])
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    assert chi2 < CHI2_7_999, (chi2, obs, exp)


# ---------------------------------------------------------------------------
# The engine: streams independent of the batch, greedy lanes untouched
# ---------------------------------------------------------------------------

CFG = tconfigs.reduced(tconfigs.get_config("llama3.2-1b")).with_(
    quant_mode="int8_spoga", kv_cache_dtype="int8", n_kv_heads=4)
STO = SamplingParams(greedy=False, temperature=0.8, top_k=20, seed=5)


@pytest.fixture(scope="module")
def params():
    p = init_params(CFG, seed=0, device="cpu")
    for blk in p["blocks"]:          # larger projections: streams that do not collapse
        for sub in blk.values():
            if isinstance(sub, dict):
                for k in sub:
                    sub[k] = (sub[k].float() * 8).to(sub[k].dtype)
    return p


def _serve(params, mode, reqs):
    kw = dict(cache_mode="paged", page_size=8, prefill_chunk=8) if mode == "paged" else {}
    eng = ServingEngine(CFG, params, EngineConfig(n_slots=4, cache_len=64, **kw), device="cpu")
    out = [eng.add_request(p, g, sampling=s) for p, g, s in reqs]
    while eng.has_work:
        eng.step()
    return [r.output_tokens for r in out]


@pytest.mark.parametrize("mode", ["slot", "paged"])
def test_engine_stream_is_independent_of_the_batch(params, mode):
    """A stochastic request (temperature 0.8, top_k 20, seed 5) gives the
    same stream alone and beside three neighbours (two greedy, one
    stochastic with another seed) that share its prefills and decode
    steps; the same seed gives the same stream twice; ``top_k=1`` gives
    the greedy stream; a greedy neighbour's stream is its own greedy
    stream.  The key folds in the request id (as the reference's does), so
    the request is submitted first in every run."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n).tolist() for n in (13, 9, 17, 11)]
    alone, = _serve(params, mode, [(prompts[0], 12, STO)])
    other = SamplingParams(greedy=False, temperature=1.1, seed=9)
    mixed = _serve(params, mode, [(prompts[0], 12, STO), (prompts[1], 10, None),
                                  (prompts[2], 6, other), (prompts[3], 12, None)])
    assert mixed[0] == alone
    assert _serve(params, mode, [(prompts[0], 12, STO)])[0] == alone
    greedy, = _serve(params, mode, [(prompts[0], 12, None)])
    assert _serve(params, mode, [(prompts[0], 12, dataclasses.replace(STO, top_k=1))])[0] \
        == greedy
    assert alone != greedy, "the stochastic stream is the greedy one"
    assert mixed[1] == _serve(params, mode, [(prompts[1], 10, None)])[0]
    assert mixed[3] == _serve(params, mode, [(prompts[3], 12, None)])[0]


def test_llm_serves_stochastic_sampling_and_defaults(params):
    """``LLM.generate(sampling=)`` and ``SamplingDefaults`` pass the policy
    through: the defaults' stream is the explicit one's."""
    rc = RuntimeConfig(kv=KVConfig(mode="paged", page_size=8, dtype="int8"),
                       sampling=SamplingDefaults(greedy=False, temperature=0.8, top_k=20,
                                                 seed=5))
    prompt = np.random.default_rng(0).integers(0, 512, 13).tolist()
    llm = LLM(config=CFG, runtime=rc, params=params, device="cpu")
    by_default, = llm.generate(prompt, max_new_tokens=6)
    llm2 = LLM(config=CFG, runtime=dataclasses.replace(rc, sampling=SamplingDefaults()),
               params=params, device="cpu")
    explicit, = llm2.generate(prompt, sampling=STO, max_new_tokens=6)
    greedy, = llm2.generate(prompt, max_new_tokens=6)
    assert by_default.token_ids == explicit.token_ids != greedy.token_ids
    assert rc.sampling.to_params() == STO
