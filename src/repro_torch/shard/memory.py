"""Per-rank footprint of sharded trees (the port of
``repro/shard/memory.py``).

Analytic, not measured: given a tree of shapes (``"meta"`` tensors from
``init_params(cfg, device="meta")``) and its specs, what one rank holds.  This is how a
``mistral-large-123b``-scale config is checked to fit a tp=4 mesh without
allocating 123B params.
"""

from __future__ import annotations

import math

from repro_torch.runtime.sharding import spec_leaves
from repro_torch.tree import leaves


def _axis_product(mesh, entry) -> int:
    names = entry if isinstance(entry, tuple) else (entry,)
    size = 1
    for n in names:
        size *= mesh.shape.get(n, 1)
    return size


def shard_denominator(spec, shape, mesh) -> int:
    """How many ways this leaf is split across the mesh (1 = replicated)."""
    denom = 1
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            continue
        size = _axis_product(mesh, entry)
        if size > 1 and shape[i] % size == 0:
            denom *= size
    return denom


def leaf_device_bytes(leaf, spec, mesh) -> int:
    total = math.prod(leaf.shape) * leaf.dtype.itemsize
    return total // shard_denominator(spec, tuple(leaf.shape), mesh)


def tree_device_bytes(shapes_tree, specs_tree, mesh) -> int:
    """Bytes ONE rank holds for the tree under the given specs."""
    flat = leaves(shapes_tree)
    specs = spec_leaves(specs_tree, shapes_tree)
    if len(flat) != len(specs):
        raise ValueError(f"shape/spec trees disagree: {len(flat)} leaves "
                         f"vs {len(specs)} specs")
    return sum(leaf_device_bytes(l, s, mesh) for l, s in zip(flat, specs))


def describe_mesh(mesh) -> str:
    if mesh is None:
        return "unsharded (no mesh)"
    shape = dict(mesh.shape)
    return (f"mesh {shape} over {math.prod(shape.values())} rank(s): "
            + ", ".join(f"{a}={n}" for a, n in shape.items()))
