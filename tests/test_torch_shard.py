"""The port's sharding rules and ``shard/`` against the JAX package's.

``MeshConfig`` validates and round-trips as the reference's does;
``build_mesh`` is ``None`` when sharding is off and a genuine one-rank
mesh with ``enable=True``.  For every arch at ``model`` in {1, 2, 4} the
port's ``param_specs`` (FSDP on and off), ``opt_state_specs``,
``cache_specs`` and ``pool_specs`` equal the reference's, leaf for leaf
(the reference's rules read only ``mesh.shape`` and ``mesh.axis_names``,
so both take the same stub mesh and no devices are forced).  The
invariants of ``tests/test_sharding_rules.py`` hold for the port's specs,
and ``tree_device_bytes`` of mistral-large-123b at tp=4 equals the
reference's and comes to under half of the unsharded footprint.  Shapes
come from ``init_params(cfg, device="meta")`` and ``jax.eval_shape``: no
full-size weights are allocated.  About 8 s in one process.
"""

import dataclasses
import functools
import types

import jax
import numpy as np
import pytest
import torch

from repro.api import MeshConfig as JaxMeshConfig
from repro.api import RuntimeConfig as JaxRuntimeConfig
from repro.configs import get_config as jax_get_config
from repro.models import model as jax_model
from repro.optim.optimizers import adamw_init as jax_adamw_init
from repro.runtime import sharding as jax_sharding
from repro.shard.memory import tree_device_bytes as jax_tree_device_bytes
from repro_torch import configs as tconfigs
from repro_torch.api import MeshConfig, RuntimeConfig
from repro_torch.models import init_params
from repro_torch.models.model import init_cache, paged_cache_shapes
from repro_torch.optim.optimizers import adamw_init
from repro_torch.runtime import sharding
from repro_torch.shard import build_mesh, describe_mesh, pool_shardings, shard_params
from repro_torch.shard import tree_device_bytes
from repro_torch.shard.core import as_shapes, local_config
from repro_torch.tree import named_leaves

ARCHS = sorted(tconfigs.ARCHS)
MODEL_SIZES = (1, 2, 4)
CACHE = dict(batch=4, cache_len=64)
POOL = dict(n_lanes=4, cache_len=64, page_size=16, n_pages=17)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(model: int, data: int = 1):
    return types.SimpleNamespace(shape={"data": data, "model": model},
                                 axis_names=("data", "model"))


@functools.lru_cache(maxsize=None)
def _params(arch):
    """(port meta tree, reference eval_shape tree) of the full config."""
    tcfg = tconfigs.get_config(arch)
    jcfg = jax_get_config(arch)
    return tcfg, init_params(tcfg, device="meta"), jcfg, jax_model.param_shapes(jcfg)


def _ref_flat(specs, shapes):
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    ps = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(flat) == len(ps)
    return {jax.tree_util.keystr(p): tuple(s) for (p, _), s in zip(flat, ps)}


def _port_flat(specs, shapes):
    return {path: tuple(s) for (path, _), s in zip(named_leaves(shapes),
                                                   sharding.spec_leaves(specs, shapes))}


def _norm(spec):
    """A spec without its trailing ``None`` entries (a ``PartitionSpec``
    may keep or drop them; both mean replicated)."""
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _assert_equal_specs(port, ref):
    assert sorted(port) == sorted(ref)
    bad = {k: (port[k], ref[k]) for k in ref if _norm(port[k]) != _norm(ref[k])}
    assert not bad, bad


def _check_valid(specs_flat, shapes, mesh):
    """The invariants of test_sharding_rules.py: no axis twice, only
    divisible dims sharded, rank at most the leaf's."""
    leaves = dict(named_leaves(shapes))
    for path, spec in specs_flat.items():
        shape = tuple(leaves[path].shape)
        assert len(spec) <= len(shape), (path, spec, shape)
        seen = []
        for dim, ax in zip(shape, spec):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            for a in axes:
                assert a not in seen, (path, spec)
                seen.append(a)
            assert dim % int(np.prod([mesh.shape[a] for a in axes])) == 0, (path, spec)


# ---------------------------------------------------------------------------
# MeshConfig
# ---------------------------------------------------------------------------

MESH_CASES = [dict(), dict(tp=2), dict(dp=2, tp=2), dict(enable=True), dict(enable=False, tp=4),
              dict(tp=0), dict(dp=0), dict(axes=("data",)), dict(axes=("model", "model")),
              dict(axes=["data", "model"])]


@pytest.mark.parametrize("kw", MESH_CASES, ids=[str(k) for k in MESH_CASES])
def test_mesh_config_matches_reference(kw):
    def build(cls):
        try:
            return cls(**kw)
        except ValueError as e:
            return e

    got, want = build(MeshConfig), build(JaxMeshConfig)
    if isinstance(want, Exception):
        assert type(got) is type(want) and str(got) == str(want)
        return
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.enabled == want.enabled
    rc = RuntimeConfig(mesh=got)
    d = rc.to_dict()
    assert d["mesh"] == JaxRuntimeConfig(mesh=want).to_dict()["mesh"]
    assert RuntimeConfig.from_dict(d) == rc
    assert JaxRuntimeConfig.from_dict(d).mesh == want


def test_build_mesh_off_and_one_rank():
    assert build_mesh(MeshConfig()) is None
    assert build_mesh(MeshConfig(enable=False, tp=2)) is None
    assert describe_mesh(None) == "unsharded (no mesh)"
    mesh = build_mesh(MeshConfig(enable=True), backend="gloo", device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.axis_names == ("data", "model")
    assert mesh.size == 1 and mesh.axis_rank("model") == 0 and mesh.backend == "gloo"
    assert describe_mesh(mesh) == "mesh {'data': 1, 'model': 1} over 1 rank(s): data=1, model=1"
    with pytest.raises(ValueError, match="needs 2 ranks but the process group has 1"):
        build_mesh(MeshConfig(tp=2))
    with pytest.raises(ValueError, match="two distinct"):
        MeshConfig(axes=("model", "model"))


# ---------------------------------------------------------------------------
# The rules against the reference's, every arch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_match_reference(arch):
    tcfg, tshapes, jcfg, jshapes = _params(arch)
    topt = adamw_init(tshapes, device="meta")
    jopt = jax.eval_shape(jax_adamw_init, jshapes)
    for model in MODEL_SIZES:
        mesh = _mesh(model, data=2)
        for fsdp in (False, True):
            tp = sharding.param_specs(tshapes, mesh, tcfg, fsdp=fsdp)
            jp = jax_sharding.param_specs(jshapes, mesh, jcfg, fsdp=fsdp)
            _assert_equal_specs(_port_flat(tp, tshapes), _ref_flat(jp, jshapes))
        for zero1 in (False, True):
            to = sharding.opt_state_specs(topt, tp, mesh, zero1=zero1)
            jo = jax_sharding.opt_state_specs(jopt, jp, mesh, zero1=zero1)
            for key in ("m", "v", "master"):
                _assert_equal_specs(_port_flat(to[key], topt[key]),
                                    _ref_flat(jo[key], jopt[key]))
            assert _norm(to["step"]) == _norm(tuple(jo["step"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_pool_specs_match_reference(arch):
    tcfg, _, jcfg, _ = _params(arch)
    tcache = init_cache(tcfg, CACHE["batch"], CACHE["cache_len"], "meta")
    jcache = jax_model.cache_shapes(jcfg, CACHE["batch"], CACHE["cache_len"])
    paged = not tcfg.is_encoder_decoder
    if paged:
        tpool = as_shapes(paged_cache_shapes(tcfg, **POOL))
        jpool = jax_model.paged_cache_shapes(jcfg, **POOL)
    for model in MODEL_SIZES:
        mesh = _mesh(model, data=2)
        _assert_equal_specs(_port_flat(sharding.cache_specs(tcache, mesh), tcache),
                            _ref_flat(jax_sharding.cache_specs(jcache, mesh), jcache))
        if paged:
            _assert_equal_specs(_port_flat(sharding.pool_specs(tpool, mesh), tpool),
                                _ref_flat(jax_sharding.pool_specs(jpool, mesh), jpool))


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_valid_on_production_mesh(arch):
    """test_sharding_rules.py's invariants on the (16, 16) production mesh,
    for the params, the ZeRO-1 moments and the master copy."""
    tcfg, tshapes, _, _ = _params(arch)
    mesh = _mesh(16, data=16)
    ps = sharding.param_specs(tshapes, mesh, tcfg, fsdp=True)
    _check_valid(_port_flat(ps, tshapes), tshapes, mesh)
    topt = adamw_init(tshapes, device="meta")
    os_ = sharding.opt_state_specs(topt, ps, mesh, zero1=True)
    for key in ("m", "master"):
        _check_valid(_port_flat(os_[key], topt[key]), topt[key], mesh)


def test_batch_and_cache_specs():
    """``batch_pspec`` as the reference's; mistral-large's cache specs are
    valid at batch 128 and 32,768 rows (test_sharding_rules.py)."""
    for mesh in (_mesh(1), _mesh(2, 2), _mesh(4, 8)):
        for shape in ((8, 128), (3, 128), (8, 64, 2048), (16, 7, 1000)):
            assert _norm(sharding.batch_pspec(shape, mesh)) == \
                _norm(tuple(jax_sharding.batch_pspec(shape, mesh)))
        batch = {"tokens": torch.empty((8, 128), device="meta")}
        assert sharding.batch_specs_tree(batch, mesh)["tokens"] == \
            sharding.batch_pspec((8, 128), mesh)
    cfg = tconfigs.get_config("mistral-large-123b")
    mesh = _mesh(16, data=16)
    shapes = init_cache(cfg, 128, 32768, "meta")
    _check_valid(_port_flat(sharding.cache_specs(shapes, mesh), shapes), shapes, mesh)


# ---------------------------------------------------------------------------
# Footprint, slicing, local pools
# ---------------------------------------------------------------------------

def test_mistral_large_tp4_footprint_matches_reference():
    """tree_device_bytes at tp=4 equals the reference's, for the params
    (no FSDP, as serving shards) and for a paged pool; params + pool per
    rank come to under half (and a third) of the unsharded footprint."""
    tcfg, tshapes, jcfg, jshapes = _params("mistral-large-123b")
    mesh = _mesh(4)
    pool = dict(n_lanes=8, cache_len=4096, page_size=16, n_pages=2048)
    tpool = as_shapes(paged_cache_shapes(tcfg, **pool))
    jpool = jax_model.paged_cache_shapes(jcfg, **pool)
    tp_bytes = tree_device_bytes(tshapes, sharding.param_specs(tshapes, mesh, tcfg, fsdp=False),
                                 mesh)
    jp_bytes = jax_tree_device_bytes(
        jshapes, jax_sharding.param_specs(jshapes, mesh, jcfg, fsdp=False), mesh)
    assert tp_bytes == jp_bytes
    tk = tree_device_bytes(tpool, sharding.pool_specs(tpool, mesh), mesh)
    assert tk == jax_tree_device_bytes(jpool, jax_sharding.pool_specs(jpool, mesh), mesh)

    def total(tree):
        return sum(int(np.prod(leaf.shape)) * leaf.dtype.itemsize
                   for _, leaf in named_leaves(tree))

    unsharded = total(tshapes) + total(tpool)
    assert tp_bytes + tk < unsharded / 3
    # the figure PERF.md predicts: about 57.1 GiB of params a rank
    assert abs(tp_bytes / 2**30 - 57.1) < 0.1


def test_shard_params_slices_by_spec_and_kv_group():
    """Each rank's part of a reduced llama tree: sharded leaves are the
    spec's blocks (the query heads of wq/wo grouped by the KV head they
    read), the ranks' parts tile the full leaf, replicated leaves are the
    full tensor; the local config has the rank's heads."""
    cfg = tconfigs.reduced(tconfigs.get_config("llama3.2-1b"))
    params = init_params(cfg, device="cpu")
    mesh = _mesh(2)
    parts = [shard_params(params, mesh, cfg, coords={"data": 0, "model": r}) for r in range(2)]
    assert torch.equal(torch.cat([p["embed"] for p in parts]), params["embed"])
    assert parts[0]["final_norm"] is params["final_norm"]
    blk = [p["blocks"][0] for p in parts]
    full = params["blocks"][0]
    assert torch.equal(torch.cat([b["attn"]["wk"] for b in blk], -1), full["attn"]["wk"])
    assert torch.equal(torch.cat([b["mlp"]["w_down"] for b in blk], 1), full["mlp"]["w_down"])
    g, hkv, hd = cfg.n_heads // cfg.n_kv_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    wq = full["attn"]["wq"].unflatten(-1, (g, hkv, hd))
    for r, b in enumerate(blk):
        want = wq[..., r * hkv // 2:(r + 1) * hkv // 2, :].flatten(-3)
        assert torch.equal(b["attn"]["wq"], want)
        assert b["attn"]["wq"].shape[-1] == b["attn"]["wo"].shape[-2]
    local = local_config(cfg, 2)
    assert (local.n_heads, local.n_kv_heads, local.resolved_head_dim) == (2, 2, hd)
    shapes = pool_shardings(paged_cache_shapes(cfg, **POOL), mesh)
    assert shapes["blocks"][0]["kp"][0][-2] == cfg.n_kv_heads // 2
    assert shapes["block_tables"][0] == paged_cache_shapes(cfg, **POOL)["block_tables"][0]
    # MLA and the xLSTM cells run at tp=2 on the rank's heads; the MLA
    # latents and the xLSTM width split two ways (models/kvcache.py)
    for arch in ("minicpm3-4b", "xlstm-125m"):
        full = tconfigs.reduced(tconfigs.get_config(arch))
        local = local_config(full, 2)
        assert (local.n_heads, local.n_kv_heads, local.tp, local.kv_split) == \
            (full.n_heads // 2, full.n_kv_heads // 2, 2, False)
        assert local.resolved_head_dim == full.resolved_head_dim
        assert local.mla == full.mla and local.d_model == full.d_model
    # tp=4 does not divide 6 experts: tensor parallelism inside them, every
    # rank holding every expert's d_expert / 4 block (gate / up columns,
    # down rows) by the reference's specs
    moe = tconfigs.reduced(tconfigs.get_config("deepseek-moe-16b"))
    moe = moe.with_(moe=dataclasses.replace(moe.moe, num_experts=6))
    local = local_config(moe, 4)
    assert (local.n_heads, local.n_kv_heads, local.tp) == (moe.n_heads // 4, moe.n_kv_heads // 4, 4)
    assert local.moe == moe.moe
    mesh4 = _mesh(4)
    blk = shard_params(init_params(moe, device="cpu"), mesh4, moe,
                       coords={"data": 0, "model": 1})["blocks"][0]["moe"]
    de = moe.moe.d_expert
    assert tuple(blk["experts_gate"].shape[-3:]) == (6, moe.d_model, de // 4)
    assert tuple(blk["experts_up"].shape[-3:]) == (6, moe.d_model, de // 4)
    assert tuple(blk["experts_down"].shape[-3:]) == (6, de // 4, moe.d_model)


@pytest.mark.parametrize("arch,field", [("llama3.2-1b", "d_ff"),
                                        ("deepseek-moe-16b", "dense FFN"),
                                        ("deepseek-moe-16b", "shared experts"),
                                        ("deepseek-moe-16b", "d_expert")])
def test_local_config_refuses_an_ffn_width_tp_does_not_divide(arch, field):
    """The rules leave such an FFN replicated, and its row-parallel sum
    would add tp copies of the product: refused, not served tp times too
    large.  The routed experts' ``d_expert`` is such a width where tp does
    not divide the experts (tensor parallelism inside them)."""
    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    local_config(cfg, 2)
    if field == "d_ff":
        cfg = cfg.with_(d_ff=cfg.d_ff + 1)
    elif field == "dense FFN":
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, d_ff_dense=cfg.moe.d_ff_dense + 1))
    elif field == "shared experts":
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, d_expert=cfg.moe.d_expert + 1,
                                                num_shared_experts=1))
    else:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, num_experts=7,
                                                d_expert=cfg.moe.d_expert + 1,
                                                num_shared_experts=2))
    with pytest.raises(ValueError, match=f"tp=2 must divide .*{field}"):
        local_config(cfg, 2)
