"""Mesh construction and param/pool sharding for the serving path (the
port of ``repro/shard/core.py``).

The reference commits each leaf to a ``NamedSharding`` with
``jax.device_put``; here each rank slices the full leaf to its own part
(:func:`shard_params`) and allocates only its part of the page pools
(:func:`pool_shardings` gives the local shapes).  The layers find the
model axis through ``runtime.collectives.model_parallel`` and run on the
rank's local heads, columns, rows and experts (:func:`local_config`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.launch.mesh import _make_mesh
from repro_torch.runtime.sharding import param_specs, pool_specs, zip_map

# what tensor-parallel serving runs at tp > 1 (the rest: ROADMAP queue 1,
# item 10.2)
_TP_KINDS = {"attn", "moe", "dense_ffn_layer"}


def validate_mesh_config(mesh_cfg) -> None:
    """The reference's static check, under its name.  A ``MeshConfig``
    checks its axes when it is made (``__post_init__``); this makes it
    again from its fields, which runs the same check."""
    dataclasses.replace(mesh_cfg)


def build_mesh(mesh_cfg, *, backend: Optional[str] = None, device=None):
    """``MeshConfig`` -> a ``launch.mesh.Mesh``, or None when sharding is off.

    ``dp * tp > 1`` needs an initialised process group of exactly that many
    ranks (``torchrun`` or ``launch.mesh.spawn``).  ``enable=True`` at
    ``tp=1`` builds a genuine one-rank mesh (and its one-rank process group
    when none exists): the configuration held bitwise to the unsharded
    engine."""
    if mesh_cfg is None or not mesh_cfg.enabled:
        return None
    return _make_mesh((mesh_cfg.dp, mesh_cfg.tp), tuple(mesh_cfg.axes), backend=backend,
                      device=device)


def mesh_axis_size(mesh, axis: str) -> int:
    return mesh.shape.get(axis, 1) if mesh is not None else 1


def _coords(mesh) -> dict:
    return {a: mesh.axis_rank(a) for a in mesh.axis_names}


def _slice(t: torch.Tensor, spec, mesh, coords: dict, heads=None) -> torch.Tensor:
    """``t``'s block along each sharded dim of ``spec``.  ``heads`` =
    (G, Hkv, D): the sharded dim holds query heads in the attention's
    (G, Hkv) order (query head ``g * Hkv + j`` reads KV head ``j``), and
    the block is every group's slice of this rank's KV heads -- so the
    rank's query heads read exactly the KV heads it holds."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        size, idx = 1, 0
        for n in names:
            size *= mesh.shape[n]
            idx = idx * mesh.shape[n] + coords[n]
        if size == 1 or t.shape[dim] % size:
            continue
        if heads is not None:
            g, hkv, d = heads
            grouped = t.unflatten(dim, (g, hkv, d))
            part = hkv // size
            t = grouped.narrow(dim + 1, idx * part, part).flatten(dim, dim + 2)
        else:
            part = t.shape[dim] // size
            t = t.narrow(dim, idx * part, part)
    return t


def _query_heads(path, cfg):
    """(G, Hkv, D) for a GQA query projection or output projection (whose
    sharded dim holds the query heads), else None."""
    if cfg.use_mla or not path or path[-1] not in ("wq", "wo") or "attn" not in path:
        return None
    return (cfg.n_heads // cfg.n_kv_heads, cfg.n_kv_heads, cfg.resolved_head_dim)


def shard_params(params, mesh, cfg, coords: Optional[dict] = None):
    """This rank's part of the full params tree, by the Megatron rules with
    no FSDP (``param_specs(fsdp=False)``, as the reference serves): each
    sharded leaf is sliced along its spec's axes and copied, so the full
    tree can be freed.  The query heads of ``wq`` / ``wo`` go to the rank
    that holds their KV head (see :func:`_slice`).  ``coords`` (axis name
    -> coordinate) names another rank's part (tests); by default this
    rank's."""
    coords = _coords(mesh) if coords is None else coords

    def walk(tree, spec, path):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k], path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, sp, path + (i,))
                              for i, (v, sp) in enumerate(zip(tree, spec)))
        if spec.count(None) == len(spec):
            return tree
        return _slice(tree, spec, mesh, coords, _query_heads(path, cfg)).contiguous()

    return walk(params, param_specs(params, mesh, cfg, fsdp=False), ())


def as_shapes(tree):
    """A ``(shape, dtype)``-leaf tree (``models.paged_cache_shapes``) as
    ``"meta"`` tensors, which the spec rules read."""
    if isinstance(tree, dict):
        return {k: as_shapes(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and len(tree) == 2 and isinstance(tree[1], torch.dtype):
        return torch.empty(tree[0], dtype=tree[1], device="meta")
    if isinstance(tree, (list, tuple)):
        return type(tree)(as_shapes(v) for v in tree)
    return tree


def pool_shardings(cache_shapes_tree, mesh):
    """The rank's local ``(shape, dtype)`` tree of a paged pool tree
    (``models.paged_cache_shapes``) under ``sharding.pool_specs``: each
    sharded dim divided by its axes' size."""
    metas = as_shapes(cache_shapes_tree)
    specs = pool_specs(metas, mesh)

    def local(leaf, spec):
        shape = list(leaf.shape)
        for dim, entry in enumerate(spec):
            if entry is not None:
                names = entry if isinstance(entry, tuple) else (entry,)
                size = 1
                for n in names:
                    size *= mesh.shape[n]
                shape[dim] //= size
        return (tuple(shape), leaf.dtype)

    return zip_map(local, metas, specs)


def _ffn_widths(cfg, kinds) -> dict:
    """The hidden width of every FFN whose ``w_down`` is row-parallel, by
    name: the dense MLP of attention layers, the dense FFN layers, the
    shared experts (routed experts are split whole, by expert)."""
    m = cfg.moe
    widths = {}
    if "attn" in kinds:
        widths["d_ff"] = cfg.d_ff
    if "dense_ffn_layer" in kinds:
        widths["the dense FFN layers' d_ff"] = m.d_ff_dense or cfg.d_ff
    if "moe" in kinds and m.num_shared_experts:
        widths["the shared experts' width"] = m.num_shared_experts * m.d_expert
    return widths


def local_config(cfg, tp: int):
    """The config a rank of a ``tp``-way model axis runs: its own query and
    KV heads (``head_dim`` made explicit).  Widths the weights carry
    (``d_ff``, experts) need no change.  Refuses what tensor-parallel
    serving does not run yet, and a ``tp`` that does not divide the heads,
    the experts or an FFN's width."""
    if tp == 1:
        return cfg
    kinds = {cfg.layer_type(i) for i in range(cfg.n_layers)}
    if cfg.use_mla or cfg.is_encoder_decoder or cfg.frontend is not None or \
            not kinds <= _TP_KINDS:
        raise NotImplementedError(
            f"{cfg.name}: tensor-parallel execution of MLA, the recurrent cells, the "
            "local-attention ring and the encoder-decoder and frontend archs is not "
            "ported yet (ROADMAP queue 1, item 10.2)")
    if cfg.numerics_watchdog:
        raise NotImplementedError("the numerics watchdog at tp>1 is not ported yet "
                                  "(ROADMAP queue 1, item 10.2)")
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(f"{cfg.name}: tp={tp} must divide n_heads ({cfg.n_heads}) and "
                         f"n_kv_heads ({cfg.n_kv_heads})")
    if cfg.moe is not None and cfg.moe.num_experts % tp:
        raise NotImplementedError(
            f"{cfg.name}: tp={tp} does not divide {cfg.moe.num_experts} experts; tensor "
            "parallelism inside the experts is not ported yet (ROADMAP queue 1, item 10.2)")
    # the rules leave an FFN replicated where tp does not divide its width,
    # and a row-parallel sum of replicated halves would count it tp times
    for name, width in _ffn_widths(cfg, kinds).items():
        if width % tp:
            raise ValueError(f"{cfg.name}: tp={tp} must divide {name} ({width})")
    return cfg.with_(n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp,
                     head_dim=cfg.resolved_head_dim)

