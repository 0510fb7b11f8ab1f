"""The dry run's cells against the JAX package: the shapes, the cells and
their constants, ``batch_specs``, ``cell_program``'s input trees and
donated names (on ``make_host_mesh(1, 1)``), and its spec trees at a
16x16 and a 2x16x16 mesh -- for every (arch x shape) cell.  The bytes
one rank holds (``lower_cell``'s meta inputs) equal the reference's
``tree_device_bytes`` of the same trees and specs for the cells the port
shards at model=16, and the other cells fail with the ``ValueError`` of
their tp=16.  About 35 s in one process (the reference's
``cell_program`` on 32 cells most of it).
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, SUBQUADRATIC, cells, get_config
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.data.pipeline import batch_specs
from repro_torch.launch.mesh import make_dry_mesh, make_production_mesh
from repro_torch.launch.steps import CROSS_LEN_FOR_DECODE, _cache_len_for, cell_program, \
    lower_cell
from repro_torch.runtime import counters, sharding
from repro_torch.shard.core import as_shapes
from repro_torch.tree import leaves

# the cells whose tp=16 the port lays out (shard.local_config): the rest
# wait for tp beyond the heads
SHARDED_ARCHS = ("deepseek-moe-16b", "seamless-m4t-large-v2", "recurrentgemma-9b")
N_SHARDED, N_REFUSED = 10, 22
MESHES = {"16x16": False, "2x16x16": True}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Fake16:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class _Fake2x16:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


FAKE = {"16x16": _Fake16, "2x16x16": _Fake2x16}


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _shapes(tree, ref: bool) -> list:
    flat = jax.tree_util.tree_leaves(tree) if ref else leaves(tree)
    return [(tuple(t.shape), _dtype_name(t.dtype)) for t in flat]


def _ref_specs(tree):
    from jax.sharding import PartitionSpec

    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))]


@functools.lru_cache(maxsize=None)
def _ref_program(arch: str, shape: str):
    """The reference's cell_program on make_host_mesh(1, 1): (kwargs, donate)."""
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_config
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import cell_program as ref_cell_program

    _, kwargs, _, _, donate = ref_cell_program(ref_config(arch), REF_SHAPES[shape],
                                               make_host_mesh(1, 1))
    return kwargs, donate


def _ref_in_specs(arch: str, shape: str, mesh_name: str) -> dict:
    """The reference's in-specs of the cell at a fake mesh (its
    cell_program's rules, without NamedSharding)."""
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_config
    from repro.runtime import sharding as ref

    cfg, sh, mesh = ref_config(arch), REF_SHAPES[shape], FAKE[mesh_name]
    kwargs, _ = _ref_program(arch, shape)
    p_specs = ref.param_specs(kwargs["params"], mesh, cfg, fsdp=True)
    out = {"params": p_specs}
    if sh.kind == "train":
        out["opt_state"] = ref.opt_state_specs(kwargs["opt_state"], p_specs, mesh, True)
    if "batch" in kwargs:
        out["batch"] = ref.batch_specs_tree(kwargs["batch"], mesh)
    if sh.kind == "decode":
        out["tokens"] = ref.batch_pspec(kwargs["tokens"].shape, mesh)
        out["cache"] = ref.cache_specs(kwargs["cache"], mesh)
    return out


def _port_in_specs(arch: str, shape: str, mesh) -> dict:
    """The port's in-specs of the cell (``runtime.sharding`` on the port's
    trees: the rules ``cell_program`` applies, also where it refuses)."""
    cfg, sh = get_config(arch), SHAPES[shape]
    _, kwargs, _, _, _ = cell_program(cfg, sh, make_dry_mesh((1, 1), ("data", "model")))
    p_specs = sharding.param_specs(kwargs["params"], mesh, cfg, fsdp=True)
    out = {"params": p_specs}
    if sh.kind == "train":
        out["opt_state"] = sharding.opt_state_specs(kwargs["opt_state"], p_specs, mesh, True)
    if "batch" in kwargs:
        out["batch"] = sharding.batch_specs_tree(kwargs["batch"], mesh)
    if sh.kind == "decode":
        out["tokens"] = sharding.batch_pspec(tuple(kwargs["tokens"].shape), mesh)
        out["cache"] = sharding.cache_specs(kwargs["cache"], mesh)
    return out, kwargs


def _import_ref_dryrun():
    """``repro.launch.dryrun`` sets XLA_FLAGS when imported: import it after
    JAX has its devices, and put the environment back."""
    jax.devices()
    saved = dict(os.environ)
    try:
        import repro.launch.dryrun as ref_dryrun
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return ref_dryrun


# ---------------------------------------------------------------------------
# Shapes, cells and their constants
# ---------------------------------------------------------------------------

def test_shapes_cells_and_constants_equal_the_reference():
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import SUBQUADRATIC as REF_SUBQUADRATIC
    from repro.configs import cells as ref_cells
    from repro.configs import get_config as ref_config
    from repro.configs.base import ShapeConfig as RefShapeConfig
    from repro.launch import steps as ref_steps

    ref_dryrun = _import_ref_dryrun()
    assert list(SHAPES) == list(REF_SHAPES)
    for name, shape in SHAPES.items():
        assert isinstance(shape, ShapeConfig)
        assert vars(shape) == vars(REF_SHAPES[name])
    assert [f for f in ShapeConfig.__dataclass_fields__] == \
        [f for f in RefShapeConfig.__dataclass_fields__]
    assert cells() == ref_cells() and cells(True) == ref_cells(True)
    assert (len(cells(True)), len(cells())) == (40, 32)
    assert SUBQUADRATIC == REF_SUBQUADRATIC
    from repro_torch.launch.dryrun import TRAIN_MICROBATCHES
    assert TRAIN_MICROBATCHES == ref_dryrun.TRAIN_MICROBATCHES
    assert CROSS_LEN_FOR_DECODE == ref_steps.CROSS_LEN_FOR_DECODE
    for arch, shape, _ in cells(True):
        assert _cache_len_for(get_config(arch), SHAPES[shape]) == \
            ref_steps._cache_len_for(ref_config(arch), REF_SHAPES[shape]), (arch, shape)


def test_batch_specs_equal_the_reference_for_every_cell():
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_config
    from repro.data.pipeline import batch_specs as ref_batch_specs

    for arch, shape, _ in cells(True):
        port = batch_specs(get_config(arch), SHAPES[shape])
        ref = ref_batch_specs(ref_config(arch), REF_SHAPES[shape])
        assert sorted(port) == sorted(ref), (arch, shape)
        assert _shapes(as_shapes(port), False) == _shapes(ref, True), (arch, shape)


# ---------------------------------------------------------------------------
# cell_program: input trees, donated names, spec trees
# ---------------------------------------------------------------------------

def test_cell_program_inputs_and_donation_equal_the_reference():
    host = make_dry_mesh((1, 1), ("data", "model"))
    for arch, shape, _ in cells():
        fn, kwargs, in_specs, _, donate = cell_program(get_config(arch), SHAPES[shape], host)
        ref_kwargs, ref_donate = _ref_program(arch, shape)
        assert callable(fn) and tuple(donate) == tuple(ref_donate), (arch, shape)
        assert list(kwargs) == list(ref_kwargs), (arch, shape)
        for name in kwargs:
            assert _shapes(kwargs[name], False) == _shapes(ref_kwargs[name], True), \
                (arch, shape, name)
        assert sorted(in_specs) == sorted(kwargs)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_spec_trees_equal_the_reference(mesh_name):
    dry = make_production_mesh(multi_pod=MESHES[mesh_name], dry=True)
    n_program = 0
    for arch, shape, _ in cells():
        port, kwargs = _port_in_specs(arch, shape, dry)
        ref = _ref_in_specs(arch, shape, mesh_name)
        assert sorted(port) == sorted(ref), (arch, shape)
        for name in port:
            assert sharding.spec_leaves(port[name], kwargs[name]) == _ref_specs(ref[name]), \
                (arch, shape, name)
        if arch in SHARDED_ARCHS:
            _, _, in_specs, _, _ = cell_program(get_config(arch), SHAPES[shape], dry)
            for name in port:
                assert sharding.spec_leaves(in_specs[name], kwargs[name]) == \
                    sharding.spec_leaves(port[name], kwargs[name]), (arch, shape, name)
            n_program += 1
    assert n_program == N_SHARDED


# ---------------------------------------------------------------------------
# One rank's bytes, and the cells the port cannot lay out yet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_rank_bytes_equal_the_reference_tree_device_bytes(mesh_name):
    """``lower_cell``'s meta inputs (the rank's program is not run) hold
    the bytes ``run_cell`` reports as ``argument_bytes``; they equal the
    reference's ``tree_device_bytes`` of the same trees and specs."""
    from repro.shard.memory import tree_device_bytes

    dry = make_production_mesh(multi_pod=MESHES[mesh_name], dry=True)
    seen = 0
    for arch, shape, _ in cells():
        if arch not in SHARDED_ARCHS:
            continue
        mb = {"deepseek-moe-16b": 4, "recurrentgemma-9b": 2}.get(arch, 1)
        lowered = lower_cell(get_config(arch), SHAPES[shape], dry, TrainConfig(microbatches=mb))
        assert all(t.device.type == "meta" for t in leaves(lowered.inputs))
        ref_kwargs, _ = _ref_program(arch, shape)
        want = tree_device_bytes(ref_kwargs, _ref_in_specs(arch, shape, mesh_name),
                                 FAKE[mesh_name])
        assert counters.tree_bytes(list(lowered.inputs.values())) == want, (arch, shape)
        seen += 1
    assert seen == N_SHARDED


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_cells_beyond_the_heads_fail_with_their_tp(mesh_name):
    """The cells whose heads tp=16 cannot split (ROADMAP 10.2 (e)) come
    back ``ok: false`` with the ``ValueError`` of ``shard.local_config``;
    pinned so that the next slice lowers the count."""
    from repro_torch.launch.dryrun import run_cell

    refused = []
    for arch, shape, _ in cells():
        if arch in SHARDED_ARCHS:
            continue
        rec = run_cell(arch, shape, MESHES[mesh_name], "int8_spoga", calibrate=False)
        assert rec["ok"] is False and rec["mesh"] == mesh_name
        assert rec["error"].startswith("ValueError: ") and "tp=16 must divide" in rec["error"]
        refused.append((arch, shape))
    assert len(refused) == N_REFUSED
    assert len(cells()) == N_SHARDED + N_REFUSED
