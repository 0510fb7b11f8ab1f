"""The port's serving engine against the JAX engine on the recurrent
archs (``xlstm-125m``: mLSTM and sLSTM cells; ``recurrentgemma-9b``:
RG-LRU cells and local attention over window rings), in slot and paged
mode, at bf16 and ``int8_spoga``.

Both engines serve the same weights (the JAX ``init_params`` tree with its
projection weights scaled up, so that greedy decoding does not collapse)
with the arrivals of ``test_serving.py::test_engine_matches_solo_staggered``
and exact-length prefill.  Greedy streams must be equal.  (Kept apart from
``test_torch_engine.py``, whose shared helpers it uses, so that the two
files' runs spread over two test workers.)
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.models import params_from_jax
from repro_torch.serving import EngineConfig, ServingEngine

from test_torch_engine import ENGINE, RECURRENT, _arrivals, _recurrent_setup, _streams


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the host's cores; small ops slow down
    when torch's intra-op threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("quant_mode", ["int8_spoga", "bf16"])
@pytest.mark.parametrize("cache_mode", ["slot", "paged"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_engine_recurrent_matches_jax_engine(arch, cache_mode, quant_mode):
    """``test_serving.py::test_engine_matches_solo_staggered`` for the
    recurrent stacks (exact-length prefill): staggered requests, more than
    lanes, so a freed lane is reused and its admission overwrites every
    leaf of the last occupant's state and ring.  The greedy streams equal
    the JAX engine's (which ``test_serving.py`` holds to each request's solo
    run); a stack that keeps all its state per lane draws no pages in paged
    mode."""
    jcfg, tcfg, tree = _recurrent_setup(arch, quant_mode)
    arrivals = _arrivals(jcfg.vocab_size)
    kw = {**ENGINE, "prefill_buckets": None, "cache_mode": cache_mode}
    jeng = JaxServingEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                            JaxEngineConfig(**kw))
    want = _streams(jeng.run(arrivals))
    tparams = params_from_jax(tree, tcfg, "cpu")
    teng = ServingEngine(tcfg, tparams, EngineConfig(**kw), device="cpu")
    metrics = teng.run(arrivals)
    got = _streams(metrics)
    assert got == want
    assert len({t for s in got.values() for t in s}) > 2, "streams collapsed"
    assert metrics.report()["peak_running"] == 2
    if cache_mode == "paged":
        assert teng.store.manager.pages_in_use == 0
        assert metrics.report()["peak_pages_used"] == 0
