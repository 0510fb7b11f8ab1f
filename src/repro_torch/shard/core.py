"""Mesh construction and param/pool sharding (the port of
``repro/shard/core.py``), and the sharded trees of training.

The reference commits each leaf to a ``NamedSharding`` with
``jax.device_put``; here each rank slices the full leaf to its own part
(:func:`shard_params`, :func:`shard_opt_state`, or any tree and its specs
with :func:`shard_tree`) and allocates only its part of the page pools
(:func:`pool_shardings` gives the local shapes).  :func:`gather_tree` is
the exact inverse: every rank takes part, and each gets the full leaves.
The layers find the model axis through
``runtime.collectives.model_parallel`` and run on the rank's local heads,
columns, rows and experts (:func:`local_config`): whole experts where tp
divides their count, every expert's ``d_expert`` block where it does not
(tensor parallelism inside the experts), in serving and training alike.

Query heads sit on the model axis in the attention's (G, Hkv) order
(:func:`_slice`), in every tree that holds ``wq`` / ``wo`` -- params,
optimizer moments, a checkpoint restored onto a mesh -- so training,
serving and restore lay heads out alike.  sLSTM's ``r_zifo`` is cut by
head where its spec cuts columns (:func:`_by_head`).  An MQA stack (one KV head)
splits its query heads in order and its KV head by columns; MLA's
``w_uq`` / ``w_uk`` / ``w_uv`` hold whole heads in order, as the
column-parallel rule cuts them.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, RankConfig
from repro_torch.launch.mesh import _make_mesh
from repro_torch.runtime.collectives import gather_blocks, world
from repro_torch.runtime.sharding import opt_state_specs, param_specs, pool_specs, zip_map

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


def _names(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def _slice(t: torch.Tensor, spec, mesh, coords: dict, heads=None,
           by_head=None) -> torch.Tensor:
    """``t``'s block along each sharded dim of ``spec``.  ``heads`` =
    (G, Hkv, D): the dim sharded over "model" holds query heads in the
    attention's (G, Hkv) order (query head ``g * Hkv + j`` reads KV head
    ``j``), and the block is every group's slice of this rank's KV heads --
    so the rank's query heads read exactly the KV heads it holds.
    ``by_head``: the dim the "model" split cuts instead of the spec's
    (:func:`_by_head`)."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = _names(entry)
        size, idx = 1, 0
        for n in names:
            size *= mesh.shape[n]
            idx = idx * mesh.shape[n] + coords[n]
        cut = by_head if by_head is not None and "model" in names else dim
        if size == 1 or t.shape[cut] % size:
            continue
        if heads is not None and "model" in names:
            g, hkv, d = heads
            grouped = t.unflatten(dim, (g, hkv, d))
            part = hkv // size
            t = grouped.narrow(dim + 1, idx * part, part).flatten(dim, dim + 2)
        else:
            part = t.shape[cut] // size
            t = t.narrow(cut, idx * part, part)
    return t


def _query_heads(path, cfg):
    """(G, Hkv, D) for a GQA query projection or output projection (whose
    sharded dim holds the query heads), else None."""
    if cfg.use_mla or cfg.n_kv_heads == 1 or not path or path[-1] not in ("wq", "wo") or \
            not {"attn", "xattn"} & set(path):
        return None
    return (cfg.n_heads // cfg.n_kv_heads, cfg.n_kv_heads, cfg.resolved_head_dim)


def _by_head(path, ndim: int):
    """The head dim of sLSTM's ``r_zifo`` (4, H, dh, dh), else None.  Its
    spec splits every head's output columns over "model"; a rank holds
    whole heads instead (the same bytes), so its recurrence runs on its own
    heads with no weight gathered (ROADMAP queue 3)."""
    return ndim - 3 if path and path[-1] == "r_zifo" else None


def _map_leaves(fn, tree, specs, path=()):
    """``fn(path, leaf, spec)`` over ``tree`` and its spec tree."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, specs[k], path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, sp, path + (i,))
                          for i, (v, sp) in enumerate(zip(tree, specs)))
    return fn(path, tree, specs)


def shard_leaf(t: torch.Tensor, spec, mesh, cfg, path=(), coords: Optional[dict] = None):
    """This rank's block of the full leaf ``t`` (at ``path`` in its tree),
    copied; a leaf the rank holds whole is ``t`` itself."""
    if spec.count(None) == len(spec):
        return t
    coords = _coords(mesh) if coords is None else coords
    return _slice(t, spec, mesh, coords, _query_heads(path, cfg),
                  _by_head(path, t.dim())).contiguous()


def shard_tree(tree, specs, mesh, cfg, coords: Optional[dict] = None):
    """This rank's part of the full ``tree`` under ``specs`` (a spec tree
    shaped like it): each sharded leaf sliced along its spec's axes and
    copied, so the full tree can be freed; a leaf the rank holds whole is
    the same tensor (an in-place update of one reaches the other).  The
    query heads of ``wq`` / ``wo`` go to the rank that holds their KV head
    (see :func:`_slice`).  ``coords`` (axis name -> coordinate) names
    another rank's part (tests); by default this rank's."""
    coords = _coords(mesh) if coords is None else coords
    return _map_leaves(lambda path, t, spec: shard_leaf(t, spec, mesh, cfg, path, coords),
                       tree, specs)


def shard_params(params, mesh, cfg, coords: Optional[dict] = None, fsdp: bool = False):
    """This rank's part of the full params tree by ``param_specs(fsdp=)``:
    the Megatron rules, pure TP by default (as the reference serves), and
    with ``fsdp=True`` each weight's other dim over "data" too (the
    training layout).  See :func:`shard_tree`."""
    return shard_tree(params, param_specs(params, mesh, cfg, fsdp=fsdp), mesh, cfg, coords)


def shard_opt_state(opt, p_specs, mesh, zero1: bool, *, cfg, coords: Optional[dict] = None):
    """This rank's part of the full AdamW state ``opt`` (``adamw_init`` of
    the full params) by ``opt_state_specs(opt, p_specs, mesh, zero1)``:
    the moments and the f32 master inherit each param's spec, and ZeRO-1
    shards the largest dim the param leaves replicated over "data".  The
    query heads of the moments of ``wq`` / ``wo`` sit as the params' do."""
    return shard_tree(opt, opt_state_specs(opt, p_specs, mesh, zero1), mesh, cfg, coords)


def _sharded(spec, mesh) -> bool:
    """Whether a leaf under ``spec`` is split over any axis of size > 1."""
    return any(mesh.shape[n] > 1 for entry in spec if entry is not None
               for n in _names(entry))


def _assemble(parts, spec, mesh, cfg, path):
    """The full leaf from every world rank's block (``parts``, in rank
    order; the inverse of :func:`shard_leaf`): the blocks keyed by their
    mesh coordinates, concatenated along each sharded dim over its axes
    (inner axis first), the (G, Hkv) grouping of query heads undone.
    Replicas are equal, so an axis the spec does not shard over keeps
    coordinate 0."""
    ranks = mesh.device_mesh.mesh
    coords = {int(r): idx for idx, r in zip(itertools.product(*map(range, ranks.shape)),
                                           ranks.flatten().tolist())}
    blocks = {coords[r]: p for r, p in enumerate(parts)}
    axes = list(mesh.axis_names)
    heads = _query_heads(path, cfg)
    by_head = _by_head(path, parts[0].dim())
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = _names(entry)
        size = math.prod(mesh.shape[n] for n in names)
        cut = by_head if by_head is not None and "model" in names else dim
        for n in reversed(names):
            i = axes.index(n)
            merged = {}
            for key in sorted(blocks):
                merged.setdefault(key[:i] + key[i + 1:], []).append(blocks[key])
            blocks = {k: torch.cat(v, cut) for k, v in merged.items()}
            axes.pop(i)
        if heads is not None and "model" in names and size > 1:
            # blocks of query heads in rank order, each (G, Hkv/size, D),
            # back to the (G, Hkv, D) order
            g, hkv, d = heads
            blocks = {k: v.unflatten(dim, (size, g, hkv // size, d)).transpose(dim, dim + 1)
                      .flatten(dim, dim + 3) for k, v in blocks.items()}
    return blocks[min(blocks)].contiguous()


def gather_leaf(t: torch.Tensor, spec, mesh, cfg, path=()) -> torch.Tensor:
    """The full leaf of which ``t`` is this rank's block: every rank's
    block all-gathered over the world and assembled (:func:`_assemble`).
    Every rank of the mesh takes part; each gets the full leaf on ``t``'s
    device."""
    if not _sharded(spec, mesh):
        return t.contiguous()
    return _assemble(gather_blocks(t, world(mesh)), spec, mesh, cfg, path)


def gather_leaf_to(t: torch.Tensor, spec, mesh, cfg, path=(), dst: int = 0):
    """:func:`gather_leaf` into world rank ``dst`` alone: every rank sends
    its block once (one gather over the world) and ``dst`` assembles the
    full leaf, on ``t``'s device; the other ranks get ``None``."""
    if not _sharded(spec, mesh):
        return t.contiguous() if dist.get_rank() == dst else None
    parts = gather_blocks(t, world(mesh), dst)
    return None if parts is None else _assemble(parts, spec, mesh, cfg, path)


def gather_tree(tree, specs, mesh, cfg):
    """The full tree of which ``tree`` is this rank's part under ``specs``
    (the exact inverse of :func:`shard_tree`); every rank takes part."""
    return _map_leaves(lambda path, t, spec: gather_leaf(t, spec, mesh, cfg, path), tree, specs)


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


def _ffn_widths(cfg, kinds, tp: int) -> dict:
    """The hidden width of every FFN whose ``w_down`` is row-parallel, by
    name: the dense MLP of attention and RG-LRU layers, the dense FFN
    layers, the shared experts, and the routed experts' ``d_expert`` where
    ``tp`` does not divide the experts (tensor parallelism inside them;
    otherwise they are split whole, by expert)."""
    m = cfg.moe
    widths = {}
    if kinds & {"attn", "local_attn", "rglru"}:
        widths["d_ff"] = cfg.d_ff
    if "dense_ffn_layer" in kinds:
        widths["the dense FFN layers' d_ff"] = m.d_ff_dense or cfg.d_ff
    if "moe" in kinds and m.num_shared_experts:
        widths["the shared experts' width"] = m.num_shared_experts * m.d_expert
    if "moe" in kinds and m.num_experts % tp:
        widths["d_expert"] = m.d_expert
    return widths


def _split_widths(cfg, kinds) -> dict:
    """Every other width a rank holds a 1/tp block of, by name: the MLA
    latent rank, the RG-LRU width, the xLSTM model width (``w_ogate`` /
    ``w_out`` / ``w_zifo`` columns)."""
    widths = {}
    if cfg.use_mla:
        widths["kv_lora_rank"] = cfg.mla.kv_lora_rank
    if "rglru" in kinds:
        widths["lru_width"] = cfg.lru_width or cfg.d_model
    if kinds & {"mlstm", "slstm"}:
        widths["d_model"] = cfg.d_model
    return widths


def local_config(cfg, tp: int):
    """The config a rank of a ``tp``-way model axis runs (a
    ``configs.base.RankConfig``): its own query heads, its own KV heads
    (an MQA stack's one KV head stays whole in the config and is split
    by its ``head_dim`` columns, ``kv_split``), ``head_dim`` made
    explicit, and ``tp``.  Widths the weights carry (``d_ff``, experts,
    the latent and recurrent widths) need no change.  Refuses a ``tp``
    that does not divide the query heads, the KV heads (more than one),
    an FFN's width (``d_expert`` too where it does not divide the experts)
    or a split width."""
    if tp == 1:
        return cfg
    kinds = {cfg.layer_type(i) for i in range(cfg.n_layers)}
    mqa = cfg.n_kv_heads == 1
    if cfg.n_heads % tp or (cfg.n_kv_heads % tp and not mqa):
        raise ValueError(f"{cfg.name}: tp={tp} must divide n_heads ({cfg.n_heads}) and "
                         f"n_kv_heads ({cfg.n_kv_heads})")
    if mqa and cfg.resolved_head_dim % tp:
        raise ValueError(f"{cfg.name}: tp={tp} must divide the one KV head's head_dim "
                         f"({cfg.resolved_head_dim})")
    # the rules leave an FFN replicated where tp does not divide its width,
    # and a row-parallel sum of replicated halves would count it tp times
    for name, width in {**_ffn_widths(cfg, kinds, tp), **_split_widths(cfg, kinds)}.items():
        if width % tp:
            raise ValueError(f"{cfg.name}: tp={tp} must divide {name} ({width})")
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(ModelConfig)}
    fields.update(n_heads=cfg.n_heads // tp,
                  n_kv_heads=1 if mqa else cfg.n_kv_heads // tp,
                  head_dim=cfg.resolved_head_dim)
    return RankConfig(**fields, tp=tp, kv_split=mqa)
