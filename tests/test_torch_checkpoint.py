"""The port's checkpoint loader against the JAX package.

``repro_torch/checkpoint/checkpoint.py`` reads and writes the reference's
format (``step_XXXXXXXX/arrays.npz`` keyed by ``keystr`` paths, bf16 as
``uint16`` bit views, ``meta.json``).  Checkpoints are written inside each
test, by either package, from the JAX ``init_params`` tree of the reduced
llama3.2-1b (4 KV heads) with its projection weights scaled by 8.  Every
comparison is bitwise, in dtype and bits.  Each test names the reference
test whose contract it carries over.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import LLM as JaxLLM
from repro.api import KVConfig as JaxKVConfig
from repro.api import QuantRuntime as JaxQuantRuntime
from repro.api import RuntimeConfig as JaxRuntimeConfig
from repro.checkpoint.checkpoint import latest_step as jax_latest_step
from repro.checkpoint.checkpoint import restore_checkpoint as jax_restore_checkpoint
from repro.checkpoint.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro_torch import configs as tconfigs
from repro_torch.api import LLM, KVConfig, QuantRuntime, RuntimeConfig
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.checkpoint.checkpoint import _named_leaves
from repro_torch.models import init_params, params_from_jax

WEIGHT_SCALE = 8.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the host's cores; small ops slow down
    when torch's intra-op threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch="llama3.2-1b"):
    jcfg = jax_reduced(jax_get_config(arch)).with_(remat=False, n_kv_heads=4)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch)).with_(n_kv_heads=4)
    return jcfg, tcfg


def _scaled_tree(jcfg, seed=0):
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(seed)))

    def scale(path, a):
        if "'w" in jax.tree_util.keystr(path):
            return (a.astype(np.float32) * WEIGHT_SCALE).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(scale, tree)


def _restore(directory, step, tcfg):
    """The port's ``restore_checkpoint`` into ``tcfg``'s layout on the CPU
    (a ``like_tree`` of ``"meta"`` tensors, as ``LLM(checkpoint_dir=)``
    passes it)."""
    return restore_checkpoint(directory, step, init_params(tcfg, device="meta"), device="cpu")


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _assert_port_trees_equal(got, want):
    got, want = list(_named_leaves(got)), list(_named_leaves(want))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)


def test_reference_checkpoint_loads_into_port(tmp_path):
    """The reference's ``save_checkpoint`` of the JAX tree, then the port's
    ``restore_checkpoint``: every leaf equals ``params_from_jax`` of the
    same tree, the step and the metadata come back."""
    jcfg, tcfg = _configs()
    tree = _scaled_tree(jcfg)
    jax_save_checkpoint(str(tmp_path), 3, jax.tree_util.tree_map(jnp.asarray, tree),
                        metadata={"arch": "llama3.2-1b"})
    step, params, meta = _restore(str(tmp_path), None, tcfg)
    assert step == 3 and meta == {"arch": "llama3.2-1b"}
    _assert_port_trees_equal(params, params_from_jax(tree, tcfg, "cpu"))
    assert params["blocks"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert params["final_norm"].dtype == torch.float32


def test_save_restore_bit_identical(tmp_path):
    """test_checkpoint.py::test_save_restore_bit_identical across the two
    packages: the port's ``save_checkpoint``, then the reference's
    ``restore_checkpoint(like_tree=<JAX tree>)``, gives the JAX tree's
    arrays bitwise; the port reads its own checkpoint back bitwise too."""
    jcfg, tcfg = _configs()
    tree = _scaled_tree(jcfg)
    params = params_from_jax(tree, tcfg, "cpu")
    path = save_checkpoint(str(tmp_path), 7, params)
    assert os.path.basename(path) == "step_00000007"
    like = jax.tree_util.tree_map(jnp.asarray, tree)
    step, restored, meta = jax_restore_checkpoint(str(tmp_path), None, like)
    assert step == 7 and meta == {}
    for x, y in zip(jax.tree_util.tree_leaves(like), jax.tree_util.tree_leaves(restored)):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(np.asarray(x).view(np.uint8),
                                      np.asarray(y).view(np.uint8))
    _assert_port_trees_equal(_restore(str(tmp_path), 7, tcfg)[1], params)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "granite-moe-3b-a800m",
                                  "deepseek-moe-16b"])
def test_new_arch_checkpoints_round_trip(tmp_path, arch):
    """The MLA and MoE trees in the reference's format, both ways: key
    paths through ``head_blocks``, 3-D expert stacks, the f32 router and
    the MLA leaves.  The reference's save loads into the port as
    ``params_from_jax`` of the same tree; the port's save of its own init
    loads into the reference bitwise, and back into the port."""
    from repro_torch.models import init_params

    jcfg, tcfg = _configs(arch)
    tree = _scaled_tree(jcfg)
    jax_save_checkpoint(str(tmp_path / "ref"), 1, jax.tree_util.tree_map(jnp.asarray, tree))
    _, params, _ = _restore(str(tmp_path / "ref"), None, tcfg)
    _assert_port_trees_equal(params, params_from_jax(tree, tcfg, "cpu"))
    own = init_params(tcfg, seed=3, device="cpu")
    save_checkpoint(str(tmp_path / "port"), 2, own)
    _, restored, _ = jax_restore_checkpoint(str(tmp_path / "port"), None,
                                            jax.tree_util.tree_map(jnp.asarray, tree))
    flat = jax.tree_util.tree_flatten_with_path(restored)[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat] == [n for n, _ in _named_leaves(own)]
    for (_, x), (name, t) in zip(flat, _named_leaves(own)):
        np.testing.assert_array_equal(np.asarray(x).view(np.uint8),
                                      _bits(t).view(np.uint8), err_msg=name)
    _assert_port_trees_equal(_restore(str(tmp_path / "port"), 2, tcfg)[1],
                             own)
    if tcfg.moe is not None:
        assert own["blocks"][0]["moe"]["router"].dtype == torch.float32
        assert own["blocks"][0]["moe"]["experts_up"].dim() == 4   # (periods, E, d, de)


def test_latest_step_and_overwrite(tmp_path):
    """test_checkpoint.py::test_latest_step_and_overwrite: the latest step
    wins in both packages, and saving a step again replaces it."""
    jcfg, tcfg = _configs()
    first = params_from_jax(_scaled_tree(jcfg, 0), tcfg, "cpu")
    second = params_from_jax(_scaled_tree(jcfg, 1), tcfg, "cpu")
    assert latest_step(str(tmp_path / "none")) is None
    save_checkpoint(str(tmp_path), 1, first)
    save_checkpoint(str(tmp_path), 5, first)
    assert latest_step(str(tmp_path)) == jax_latest_step(str(tmp_path)) == 5
    save_checkpoint(str(tmp_path), 5, second)
    step, got, _ = _restore(str(tmp_path), None, tcfg)
    assert step == 5
    _assert_port_trees_equal(got, second)
    _assert_port_trees_equal(_restore(str(tmp_path), 1, tcfg)[1], first)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        _restore(str(tmp_path / "none"), None, tcfg)


def test_structure_mismatch_rejected(tmp_path):
    """test_checkpoint.py::test_structure_mismatch_rejected: a checkpoint
    whose leaves are not the layout the config implies is refused, by
    name (an untied head, a missing leaf) or by shape (other depth, other
    width)."""
    jcfg, tcfg = _configs()
    save_checkpoint(str(tmp_path / "ok"), 1, params_from_jax(_scaled_tree(jcfg), tcfg, "cpu"))
    with pytest.raises(ValueError, match="needs"):
        _restore(str(tmp_path / "ok"), 1, tcfg.with_(n_layers=3))
    with pytest.raises(ValueError, match="structure mismatch"):
        _restore(str(tmp_path / "ok"), 1, tcfg.with_(tie_embeddings=False))
    with pytest.raises(ValueError, match="needs"):
        _restore(str(tmp_path / "ok"), 1, tcfg.with_(d_ff=2 * tcfg.d_ff))
    tree = _scaled_tree(jcfg)
    del tree["blocks"][0]["attn"]["wq"]
    jax_save_checkpoint(str(tmp_path / "bad"), 1, jax.tree_util.tree_map(jnp.asarray, tree))
    with pytest.raises(ValueError, match="missing"):
        _restore(str(tmp_path / "bad"), 1, tcfg)


def test_no_partial_checkpoint_on_disk(tmp_path):
    """test_checkpoint.py::test_no_partial_checkpoint_on_disk: the save is
    a rename into place, so only final ``step_*`` directories remain."""
    jcfg, tcfg = _configs()
    params = params_from_jax(_scaled_tree(jcfg), tcfg, "cpu")
    save_checkpoint(str(tmp_path), 2, params)
    save_checkpoint(str(tmp_path), 2, params)
    assert os.listdir(tmp_path) == ["step_00000002"]
    assert sorted(os.listdir(tmp_path / "step_00000002")) == ["arrays.npz", "meta.json"]


def test_llm_checkpoint_dir_matches_jax_engine(tmp_path):
    """``LLM(checkpoint_dir=)`` serves the reference's checkpoint: its greedy
    streams equal the JAX ``LLM`` built on ``restore_checkpoint(...)[1]``
    (the reference's own ``LLM(checkpoint_dir=)`` keeps the whole
    ``(step, tree, metadata)`` tuple as its params; ROADMAP queue 3)."""
    jcfg, tcfg = _configs()
    tree = jax.tree_util.tree_map(jnp.asarray, _scaled_tree(jcfg))
    jax_save_checkpoint(str(tmp_path), 4, tree)
    kv = dict(mode="paged", dtype="int8", page_size=8)
    jllm = JaxLLM(config=jcfg, params=jax_restore_checkpoint(str(tmp_path), None, tree)[1],
                  runtime=JaxRuntimeConfig(quant=JaxQuantRuntime(mode="int8_spoga"),
                                           kv=JaxKVConfig(**kv)))
    llm = LLM(config=tcfg, checkpoint_dir=str(tmp_path), device="cpu",
              runtime=RuntimeConfig(quant=QuantRuntime(mode="int8_spoga"), kv=KVConfig(**kv)))
    _assert_port_trees_equal(llm.params, params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                                                         tcfg, "cpu"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, n).tolist() for n in (5, 13, 3)]
    got = [o.token_ids for o in llm.generate(prompts, max_new_tokens=5)]
    assert got == [o.token_ids for o in jllm.generate(prompts, max_new_tokens=5)]
    assert len({t for s in got for t in s}) > 2, "streams collapsed"
    with pytest.raises(ValueError, match="at most one"):
        LLM(config=tcfg, checkpoint_dir=str(tmp_path), params=llm.params, device="cpu")
