"""Sharding rules: DP / TP / EP / ZeRO-1 specs for every tree (the port of
``repro/runtime/sharding.py``, rule for rule).

A spec is a tuple with one entry per dimension: ``None`` (replicated), an
axis name, or a tuple of axis names -- the entries of the reference's
``PartitionSpec``, which compares equal to it.  A mesh is anything with
``shape`` (axis name -> size) and ``axis_names``: a ``launch.mesh.Mesh``
or a stub.  Trees are the port's nested dicts, lists and tuples; the
rules read each leaf's ``shape`` (tensors, ``"meta"`` tensors included)
and its path, as the reference reads ``jax.tree_util`` key paths.

Megatron-style tensor parallelism over the "model" axis:

* embeddings / unembedding     -> vocab-sharded
* attention q/k/v projections  -> output (head) dim sharded; wo row-sharded
* MLP in projections           -> column-sharded; down/out row-sharded
* MoE experts                  -> expert-parallel over "model" when the
  expert count divides the axis, otherwise TP inside each expert
* recurrent cells              -> state width sharded

Data parallelism over ("pod", "data").  Divisibility is checked leaf by
leaf; anything unshardable is replicated.  ZeRO-1 (``opt_state_specs``):
optimizer moments additionally shard their largest replicated dim over
"data".

**What has no counterpart.**  The reference's activation constraints
(``_sp_constrain``, ``sp_enter`` / ``sp_exit``, ``constrain_activations``,
``constrain_decode_carry``) are instructions to XLA's SPMD partitioner.
The port has no partitioner: its layers call the collectives themselves
(``runtime.collectives``), and the activations between layers stay
replicated over "model" on every rank.  What each constraint asked XLA
for is explicit here:

* ``sp_enter`` (gather the sequence into a TP region): nothing to gather,
  the activation is already whole on every rank;
* ``sp_exit`` (reduce-scatter a row-parallel output): a SUM all-reduce of
  the row-parallel GEMM's int32 accumulator (``layers.linear(row=True)``);
* ``constrain_activations`` / ``constrain_decode_carry`` (pin the layer
  carry's layout): the carry is replicated by construction; the
  vocab-parallel embedding ends in a SUM all-reduce and the unembedding in
  an all-gather of the logits.
"""

from __future__ import annotations


def data_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _axis_size(mesh, names) -> int:
    size = 1
    for n in names if isinstance(names, tuple) else (names,):
        size *= mesh.shape[n]
    return size


def _div(dim: int, mesh, axis) -> bool:
    return dim % _axis_size(mesh, axis) == 0


def _entry(axes: tuple):
    """A spec entry for a tuple of axis names (one name stands alone, as a
    ``PartitionSpec`` normalizes it)."""
    return axes[0] if len(axes) == 1 else axes


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree; ``path`` holds dict keys (str) and
    sequence indices (int), outermost first."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree`` and the spec tree shaped like it
    (specs are tuples, so ``tree`` decides where the leaves are)."""
    if isinstance(tree, dict):
        return {k: zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(zip_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def spec_leaves(specs, like) -> list:
    """The specs of ``like``'s leaves, in ``tree.named_leaves`` order."""
    if isinstance(like, dict):
        return [s for k in sorted(like) for s in spec_leaves(specs[k], like[k])]
    if isinstance(like, (list, tuple)):
        return [s for v, sp in zip(like, specs) for s in spec_leaves(sp, v)]
    return [specs]


# ---------------------------------------------------------------------------
# Parameter specs (name-based Megatron rules)
# ---------------------------------------------------------------------------

_COL = ("wq", "wk", "wv", "w_gate", "w_up", "w_in", "w_uq", "w_uk", "w_uv",
        "w_gate_branch", "w_x_branch", "w_rec_gate", "w_in_gate", "w_ogate",
        "w_zifo")
_ROW = ("wo", "w_down", "w_out")
_VOCAB = ("embed", "head")
_REPL = ("norm1", "norm2", "final_norm", "enc_final_norm", "norm_x", "q_norm",
         "kv_norm", "gamma", "beta", "router", "w_dq", "w_dkv", "w_kr",
         "w_igate", "w_fgate")


def _leaf_name(path) -> str:
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def _path_names(path) -> tuple:
    return tuple(e if isinstance(e, str) else "" for e in path)


def _param_rule(path, shape, mesh, cfg, fsdp: bool) -> tuple:
    name = _leaf_name(path)
    names = _path_names(path)
    nd = len(shape)
    stacked = 1 if ("blocks" in names or "cross_blocks" in names or
                    "enc_blocks" in names) and name not in _VOCAB else 0
    eff = tuple(shape[stacked:])
    pre = (None,) * stacked
    has_data = "data" in mesh.axis_names

    def spec(*axes):
        return pre + axes

    def maybe_fsdp(dim: int):
        return "data" if (fsdp and has_data and _div(dim, mesh, "data")) else None

    if name in ("experts_gate", "experts_up", "experts_down"):
        e, d_in, d_out = eff
        if _div(e, mesh, "model"):                     # expert parallelism
            return spec("model", maybe_fsdp(d_in), None)
        if name == "experts_down" and _div(d_in, mesh, "model"):
            return spec(maybe_fsdp(e), "model", None)  # TP inside experts
        if name != "experts_down" and _div(d_out, mesh, "model"):
            return spec(maybe_fsdp(e), None, "model")
        return spec(None, None, None)
    if name == "r_zifo":                               # (4, H, dh, dh)
        return (spec(None, None, None, "model") if _div(eff[-1], mesh, "model")
                else spec(None, None, None, None))
    if name == "lam":
        return spec("model") if _div(eff[0], mesh, "model") else spec(None)
    if name == "conv_w":
        return spec(None, "model") if _div(eff[-1], mesh, "model") else spec(None, None)
    if name in _VOCAB and nd - stacked == 2:
        v, d = eff
        if _div(v, mesh, "model"):
            return spec("model", maybe_fsdp(d))
        if _div(d, mesh, "model"):
            return spec(maybe_fsdp(v), "model")
        return spec(None, None)
    if name in _COL and nd - stacked == 2:
        if _div(eff[1], mesh, "model"):
            return spec(maybe_fsdp(eff[0]), "model")
        return spec(None, None)
    if name in _ROW and nd - stacked == 2:
        if _div(eff[0], mesh, "model"):
            return spec("model", maybe_fsdp(eff[1]))
        return spec(None, None)
    return (None,) * nd


def param_specs(params_or_shapes, mesh, cfg, fsdp: bool = True):
    """Spec tree mirroring the params tree.  ``fsdp=True`` (the default, as
    in the reference) also shards weights over "data" (ZeRO-3); serving
    shards pure TP (``fsdp=False``)."""
    return map_with_path(
        lambda path, leaf: _param_rule(path, tuple(leaf.shape), mesh, cfg, fsdp),
        params_or_shapes)


# ---------------------------------------------------------------------------
# Batch / cache / optimizer specs
# ---------------------------------------------------------------------------

def batch_pspec(shape, mesh) -> tuple:
    """Shard dim0 (global batch) over the DP axes when divisible, else
    replicate; shard the trailing (feature) dim over "model" when large and
    divisible."""
    dp = data_axes(mesh)
    first = _entry(dp) if dp and shape[0] % _axis_size(mesh, dp) == 0 else None
    rest = [None] * (len(shape) - 1)
    if len(shape) >= 3 and shape[-1] % _axis_size(mesh, "model") == 0 and shape[-1] >= 1024:
        rest[-1] = "model"
    return (first, *rest)


def batch_specs_tree(batch_shapes, mesh):
    return map_with_path(lambda _, s: batch_pspec(tuple(s.shape), mesh), batch_shapes)


def cache_specs(cache_shapes_tree, mesh):
    """Contiguous KV/state caches: batch over DP if divisible, last dim
    over "model"."""
    dp = data_axes(mesh)
    dp_size = _axis_size(mesh, dp)
    model_size = _axis_size(mesh, "model")

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        name = _leaf_name(path)
        names = _path_names(path)
        stacked = 1 if ("blocks" in names or "cross_kv" in names) else 0
        if name == "pos":
            return (None,)
        axes = [None] * len(shape)
        bdim = stacked
        if len(shape) > bdim and shape[bdim] % dp_size == 0 and shape[bdim] > 1:
            axes[bdim] = _entry(dp)
        if len(shape) - stacked >= 2 and shape[-1] % model_size == 0:
            axes[-1] = "model"
        return tuple(axes)

    return map_with_path(rule, cache_shapes_tree)


def opt_state_specs(opt_shapes, p_specs, mesh, zero1: bool = True):
    """Adam moments inherit the param spec; ZeRO-1 adds "data" sharding on
    the largest still-replicated dim."""
    dp_size = mesh.shape.get("data", 1)

    def moment_spec(leaf, pspec):
        spec = list(pspec) + [None] * (len(leaf.shape) - len(pspec))
        if zero1 and "data" not in spec:
            best, best_dim = -1, -1
            for i, (ax, d) in enumerate(zip(spec, leaf.shape)):
                if ax is None and d % dp_size == 0 and d > best:
                    best, best_dim = d, i
            if best_dim >= 0 and best >= dp_size:
                spec[best_dim] = "data"
        return tuple(spec)

    out = {"step": (),
           "m": zip_map(moment_spec, opt_shapes["m"], p_specs),
           "v": zip_map(moment_spec, opt_shapes["v"], p_specs)}
    if "master" in opt_shapes:
        out["master"] = zip_map(moment_spec, opt_shapes["master"], p_specs)
    return out


# ---------------------------------------------------------------------------
# Paged-pool specs
# ---------------------------------------------------------------------------

# pool leaves carrying a KV-head axis: kp/vp are (n_pages, page_size, Hkv,
# head_dim) (stacked variants prepend n_periods), their int8 scales drop
# the trailing head_dim
_POOL_HEAD_AXIS = {"kp": -2, "vp": -2, "kp_scale": -1, "vp_scale": -1}


def pool_specs(cache_shapes_tree, mesh):
    """Specs for a paged serving cache (``models.paged_cache_shapes``).

    Page pools shard their KV-head axis over "model", the axis the
    attention shards its heads over, so each rank's pool slice feeds its
    own heads.  MLA latent pools (``ckvp``) shard the latent rank; the
    rope pool (``krp``) is replicated.  ``pos`` and ``block_tables``
    replicate: the host-side ``PageManager`` is the one source of truth
    and every rank holds the same tables.  Per-lane leaves (recurrent
    state, local-attention rings) shard their trailing width.  A
    non-divisible dim replicates."""
    model = _axis_size(mesh, "model")

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        name = _leaf_name(path)
        nd = len(shape)
        axes = [None] * nd
        if name in ("pos", "block_tables") or nd < 2:
            return tuple(axes)
        if name in _POOL_HEAD_AXIS:
            dim = nd + _POOL_HEAD_AXIS[name]
            if shape[dim] % model == 0:
                axes[dim] = "model"
            return tuple(axes)
        if name == "krp":
            return tuple(axes)
        if shape[-1] % model == 0:
            axes[-1] = "model"
        return tuple(axes)

    return map_with_path(rule, cache_shapes_tree)
