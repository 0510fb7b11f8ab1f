"""Step builders shared by the trainer and the servers (the port of
``repro/launch/steps.py``).

``make_train_step`` gives ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)``: the loss and its gradients (optionally
accumulated over microbatches) and one AdamW update.  Gradients come from
``torch.autograd.grad`` on the param leaves, so each has its leaf's dtype
(bf16 weights get bf16 gradients, the f32 norm scales f32 ones), as
``jax.value_and_grad`` gives them.  The update runs in place
(``optim.adamw_update``).

**On a mesh** (``make_train_step(..., mesh=)``, a ``launch.mesh.Mesh``
over ("data", "model")) the step is the reference's sharded step, run
SPMD: every rank takes the same global batch and keeps its data rank's
slice of it.

* ``TrainConfig(fsdp=False, zero1=False)`` at tp=1 is the replicated
  data-parallel step (the reference's ``shard_map`` step of
  ``tests/test_training_integration.py::test_grad_compression_trains``):
  every rank holds the whole params and optimizer state, and the
  gradients are averaged over "data" by ``collectives.psum_mean`` -- or
  ``compressed_psum_mean`` (the int8 all-reduce) under
  ``TrainConfig.grad_compression`` -- so the params stay bitwise equal
  across ranks.
* Otherwise each rank holds its block of the params under
  ``param_specs(fsdp=TrainConfig.fsdp)`` (``shard.shard_params``) and of
  the AdamW state under ``opt_state_specs(zero1=TrainConfig.zero1)``
  (``shard.shard_opt_state``).  The forward gathers each layer's FSDP
  leaves over "data" just before use (``collectives.gather_params``); the
  gather's backward reduce-scatters the gradient back to the rank's block.
  Leaves the param specs leave whole over "data" are all-reduced (or
  reduce-scattered, where ``grad_specs`` shards them).  The wire carries
  f32, or bf16 under ``grad_reduce_dtype="bf16"``.  At tp>1 the layers
  run on the rank's heads and columns (``shard.local_config``) inside
  ``collectives.model_parallel``.  ``optim.adamw_update`` clips by the
  global norm over the mesh, updates the rank's blocks and all-gathers a
  ZeRO-1 param over "data".

The sharded step's loss is the global batch's: a statistic of the whole
batch (the count of labelled tokens, the MoE load-balance means) is taken
over every data rank's rows (``collectives.batch_total`` /
``batch_mean``), and the metrics' loss is the mean of the ranks' shares
(the replicated step, as the reference's ``shard_map`` step, averages
each rank's own loss).  Tensor-parallel
training runs every arch: GQA, MLA, the MoE stacks (expert-parallel where
tp divides the experts, tensor parallelism inside the experts where it
does not), the recurrent cells, the encoder-decoder and the frontend
stacks, each layer on the rank's heads, columns and experts with
Megatron's *f*, *g* and scatter on the gradient path
(``runtime.collectives``).

**Cells** (the dry run's, ``launch.dryrun``).  :func:`cell_program` gives
one (arch x shape) cell's program on a mesh -- the train step, the
prefill step or the decode step -- with the global input trees and their
spec trees, as the reference's does; :func:`lower_cell` builds one rank's
inputs at its local shapes (``"meta"`` tensors by default, nothing
allocated) and gives a :class:`LoweredCell`, whose ``compile()`` runs the
rank's program once under the dry run's counters (``runtime.counters``).
On a dry mesh (``launch.mesh.DryMesh``) the collectives return
placeholders, so one rank's program runs alone.  The prefill and decode
cells take the params as ``param_specs(fsdp=TrainConfig.fsdp)`` shards
them, as the reference's do: each layer gathers its FSDP leaves over
"data" (``collectives.data_sharded``) and the batch statistics stay the
rank's own.  A batch leaf whose spec shards its feature dim over "model"
(an encoder-decoder's source embeddings) is all-gathered over "model"
first.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.data.pipeline import batch_specs
from repro_torch.models import model as model_lib
from repro_torch.optim.optimizers import adamw_init, adamw_update, zero1_dims
from repro_torch.runtime import collectives, counters
from repro_torch.runtime.sharding import (
    batch_pspec,
    batch_specs_tree,
    cache_specs,
    data_axes,
    opt_state_specs,
    param_specs,
    spec_leaves,
)
from repro_torch.shard.core import as_shapes, local_config, shard_tree
from repro_torch.tree import leaves, rebuild, tree_map

# enc-dec decode cells cross-attend to a fixed-length encoded source
CROSS_LEN_FOR_DECODE = 4_096


def _loss_and_grads(params, cfg: ModelConfig, tcfg: TrainConfig, batch):
    """(loss, gradient tree) of ``lm_loss`` at ``params``.  A leaf the loss
    does not reach (a frontend arch's token embedding) gets zeros, as in
    JAX; ``grad_reduce_dtype="bf16"`` casts every gradient to bf16."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    flat = leaves(live)
    loss = model_lib.lm_loss(live, cfg, batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    if tcfg.grad_reduce_dtype == "bf16":
        grads = [g.to(torch.bfloat16) for g in grads]
    return loss.detach(), rebuild(params, iter(grads))


@dataclasses.dataclass(frozen=True)
class ShardedLayout:
    """A sharded step's mesh, its axes and the spec trees of its params,
    gradients and AdamW state (full-shape specs, ``runtime.sharding``)."""

    mesh: object
    cfg: ModelConfig               # the rank's config (its heads at tp>1)
    p_specs: object
    g_specs: object
    o_specs: object
    data: object                   # the "data" axis (FSDP), or None at data=1
    batch: object = None           # the data-parallel axis (("pod", "data") as one)
    pod: object = None             # a multi-pod mesh's "pod" axis, where data > 1

    @property
    def dp(self) -> int:
        return self.batch.size if self.batch is not None else 1


def _data_dim(spec):
    for i, entry in enumerate(spec):
        if entry is not None and "data" in (entry if isinstance(entry, tuple) else (entry,)):
            return i
    return None


def sharded_layout(cfg: ModelConfig, tcfg: TrainConfig, mesh, grad_specs=None) -> ShardedLayout:
    """The layout of the sharded step on ``mesh`` (see the module
    docstring); refuses ``grad_specs`` that do not fit the param specs, and
    a tp that ``shard.local_config`` refuses."""
    tp = mesh.shape.get("model", 1)
    shapes = model_lib.param_shapes(cfg)
    p_specs = param_specs(shapes, mesh, cfg, fsdp=tcfg.fsdp)
    g_specs = p_specs if grad_specs is None else grad_specs
    o_specs = opt_state_specs(adamw_init(shapes, device="meta"), p_specs, mesh, tcfg.zero1)
    for p, g, o in zip(spec_leaves(p_specs, shapes), spec_leaves(g_specs, shapes),
                       spec_leaves(o_specs["m"], shapes)):
        extra = zero1_dims(p, g)
        if len(g) != len(p) or any(a != b for i, (a, b) in enumerate(zip(p, g))
                                   if i not in extra) or \
                (extra and _data_dim(p) is not None) or not set(extra) <= set(zero1_dims(p, o)):
            raise ValueError(
                f"grad_specs {tuple(g)} for a param with spec {tuple(p)}: a gradient spec "
                f"may only add a 'data' entry that the optimizer spec {tuple(o)} has")
    data = collectives.axis(mesh, "data") if mesh.shape.get("data", 1) > 1 else None
    pod = collectives.axis(mesh, "pod") if data is not None and mesh.shape.get("pod", 1) > 1 \
        else None
    return ShardedLayout(mesh, local_config(cfg, tp), p_specs, g_specs, o_specs, data,
                         collectives.data_axis(mesh), pod)


def _sharded_loss_and_grads(params, layout: ShardedLayout, tcfg: TrainConfig, batch):
    """(this data rank's loss, gradient tree in the ``g_specs`` layout) of
    ``lm_loss`` at the rank's blocks ``params`` on its slice ``batch``:
    the gradients averaged over "data" (see the module docstring)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    flat = leaves(live)
    dims = fsdp_dims(live, layout.p_specs) if layout.data is not None else {}
    wire = torch.bfloat16 if tcfg.grad_reduce_dtype == "bf16" else None
    with collectives.model_parallel(layout.mesh), \
            collectives.data_sharded(layout.data, dims, wire, layout.batch, layout.pod):
        loss = model_lib.lm_loss(live, layout.cfg, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    out = []
    for p, g, g_spec in zip(flat, grads, spec_leaves(layout.g_specs, live)):
        g = torch.zeros_like(p) if g is None else g
        if layout.batch is not None and id(p) not in dims:
            dim = _data_dim(g_spec) if layout.data is not None else None
            ax, pod = (layout.batch, None) if dim is None else (layout.data, layout.pod)
            g = collectives.mean_over(g, ax, dim, wire, pod).to(g.dtype)
        out.append(g.to(torch.bfloat16) if wire is not None else g)
    return loss.detach(), rebuild(params, iter(out))


def fsdp_dims(params, p_specs) -> dict:
    """``id(leaf)`` -> the dim its spec shards over "data", for the leaves
    of ``params`` that ``collectives.gather_params`` gathers (FSDP)."""
    return {id(t): d for t, d in ((t, _data_dim(s)) for t, s in
                                  zip(leaves(params), spec_leaves(p_specs, params)))
            if d is not None}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, grad_specs=None, mesh=None,
                    local_batch: bool = False):
    """fwd + bwd (+ gradient accumulation over ``tcfg.microbatches``) +
    AdamW.

    Microbatching splits the batch's leading axis into k equal slices and
    accumulates their gradients in f32 (on a mesh, each data rank takes
    its rows of each slice, and each slice's gradients are already reduced
    to the rank's blocks), then takes the mean (the mean of per-microbatch
    gradients equals the full-batch gradient for a mean loss over equal
    slices); the loss is the mean of the slices' losses.

    ``mesh``: the sharded step (see the module docstring); the step takes
    the global batch and slices it.  ``grad_specs`` (a spec tree like the
    params'): the layout the gradients are reduced to, by default the
    param specs; it may add a "data" entry that the optimizer specs have.
    Without a mesh it names no axis and changes nothing.  ``local_batch``:
    the step takes this data rank's rows instead (a dry-run cell, whose
    rank holds its block of the batch).  On a multi-pod mesh the
    ("pod", "data") pair is the data-parallel axis
    (``collectives.data_axis``)."""
    dp = _dp_size(mesh) if mesh is not None else 1
    tp = mesh.shape.get("model", 1) if mesh is not None else 1
    sharded = tp > 1 or (dp > 1 and (tcfg.fsdp or tcfg.zero1))
    if tcfg.grad_compression and dp * tp > 1 and sharded:
        raise ValueError(
            "grad_compression runs on the replicated data-parallel step only "
            "(TrainConfig(fsdp=False, zero1=False) on a mesh with model=1): the "
            "reference's sharded make_train_step never compresses")
    layout = sharded_layout(cfg, tcfg, mesh, grad_specs) if sharded else None
    data = collectives.data_axis(mesh) if dp > 1 else None

    def loss_and_grads(params, batch):
        if layout is not None:
            return _sharded_loss_and_grads(params, layout, tcfg, batch)
        return _loss_and_grads(params, cfg, tcfg, batch)

    def local(batch):
        """This data rank's rows of a global (micro)batch."""
        if data is None or local_batch:
            return batch
        return {name: v.chunk(data.size)[data.rank] for name, v in batch.items()}

    def train_step(params, opt_state, batch):
        k = tcfg.microbatches
        if k > 1:
            dev = next(iter(batch.values())).device
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            acc = None
            for i in range(k):
                mb = {name: v.reshape((k, v.shape[0] // k) + tuple(v.shape[1:]))[i]
                      for name, v in batch.items()}
                loss, g = loss_and_grads(params, local(mb))
                loss_sum = loss_sum + loss
                if acc is None:
                    acc = [t.float() for t in leaves(g)]
                else:
                    for a, t in zip(acc, leaves(g)):
                        a.add_(t.float())
            loss = loss_sum / k
            grads = rebuild(params, iter([a / k for a in acc]))
        else:
            loss, grads = loss_and_grads(params, local(batch))
        if layout is None and data is not None:
            grads = (collectives.compressed_psum_mean(grads, data)
                     if tcfg.grad_compression else collectives.psum_mean(grads, data))
        if data is not None:
            loss = collectives.all_reduce(loss, data, "sum") / data.size
        if layout is None:
            params, opt_state, metrics = adamw_update(params, grads, opt_state, tcfg)
        else:
            params, opt_state, metrics = adamw_update(
                params, grads, opt_state, tcfg, mesh=mesh, p_specs=layout.p_specs,
                g_specs=layout.g_specs, o_specs=layout.o_specs)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, cache_len: int, with_lengths: bool = False):
    """``with_lengths``: the serving engine's variant -- takes a per-sequence
    (B,) true-lengths tensor so right-padded prompt buckets prefill
    exactly."""
    if with_lengths:
        def prefill_step(params, batch, lengths):
            return model_lib.prefill(params, cfg, batch, cache_len, lengths=lengths)
    else:
        def prefill_step(params, batch):
            return model_lib.prefill(params, cfg, batch, cache_len)
    return prefill_step


def make_serve_step(cfg: ModelConfig, with_active: bool = False):
    """``with_active``: the serving engine's variant -- takes a (B,)
    live-lane mask (see ``model.decode_step``)."""
    if with_active:
        def serve_step(params, tokens, cache, active):
            return model_lib.decode_step(params, cfg, tokens, cache, active)
    else:
        def serve_step(params, tokens, cache):
            return model_lib.decode_step(params, cfg, tokens, cache)
    return serve_step


# ---------------------------------------------------------------------------
# Cells: one (arch x shape) program on a mesh (the dry run's)
# ---------------------------------------------------------------------------

def _cache_len_for(cfg: ModelConfig, shape: ShapeConfig) -> int:
    if cfg.sliding_window is not None and not any(
        k in ("attn", "moe") for k in cfg.block_pattern
    ):
        # hybrid/local-only stacks never need more than the window
        return min(shape.seq_len, cfg.sliding_window)
    return shape.seq_len


def _model_dims_gathered(batch: dict, b_specs: dict, mesh) -> dict:
    """``batch`` with every dim its spec shards over "model" all-gathered."""
    if mesh.shape.get("model", 1) == 1:
        return batch
    ax = collectives.axis(mesh, "model")
    out = {}
    for name, t in batch.items():
        for dim, entry in enumerate(b_specs[name]):
            if entry is not None and "model" in (entry if isinstance(entry, tuple) else (entry,)):
                t = collectives.all_gather(t, ax, dim)
        out[name] = t
    return out


@contextlib.contextmanager
def _serving(mesh, params, p_specs, fsdp: bool):
    """A prefill or decode cell's context: the model axis, and each layer's
    FSDP leaves gathered over "data" (batch statistics the rank's own)."""
    data = collectives.axis(mesh, "data") if fsdp and mesh.shape.get("data", 1) > 1 else None
    dims = fsdp_dims(params, p_specs) if data is not None else {}
    with collectives.model_parallel(mesh), collectives.data_sharded(data, dims, batch=None):
        yield


def cell_program(cfg: ModelConfig, shape: ShapeConfig, mesh, tcfg: TrainConfig | None = None):
    """-> (fn, kwargs_specs, in_specs, out_specs, donate_argnames).

    ``kwargs_specs``: the global input trees as ``"meta"`` tensors (params,
    optimizer state and batch; params and batch; params, tokens and
    cache); ``in_specs`` / ``out_specs``: their spec trees
    (``runtime.sharding``) where the reference has ``NamedSharding`` s.
    ``fn(**inputs)`` is one rank's program: it takes the rank's blocks of
    the inputs (:func:`lower_cell` builds them) on ``mesh``.  Refuses (a
    ``ValueError`` from ``shard.local_config``) a tp the port cannot lay
    out."""
    tcfg = tcfg or TrainConfig()
    tp = mesh.shape.get("model", 1)
    lcfg = local_config(cfg, tp)
    p_shapes = model_lib.param_shapes(cfg)
    p_specs = param_specs(p_shapes, mesh, cfg, fsdp=tcfg.fsdp)

    if shape.kind == "train":
        step = make_train_step(cfg, tcfg, grad_specs=p_specs, mesh=mesh, local_batch=True)
        opt_shapes = adamw_init(p_shapes, device="meta")
        o_specs = opt_state_specs(opt_shapes, p_specs, mesh, tcfg.zero1)
        b_shapes = as_shapes(batch_specs(cfg, shape))
        b_specs = batch_specs_tree(b_shapes, mesh)

        def train_cell(params, opt_state, batch):
            return step(params, opt_state, _model_dims_gathered(batch, b_specs, mesh))

        kwargs = {"params": p_shapes, "opt_state": opt_shapes, "batch": b_shapes}
        in_specs = {"params": p_specs, "opt_state": o_specs, "batch": b_specs}
        return train_cell, kwargs, in_specs, (p_specs, o_specs, None), ("params", "opt_state")

    cache_len = _cache_len_for(cfg, shape)
    b = shape.global_batch
    if shape.kind == "prefill":
        b_shapes = as_shapes(batch_specs(cfg, shape))
        b_specs = batch_specs_tree(b_shapes, mesh)
        cross = b_shapes["src_embeds"].shape[1] if cfg.is_encoder_decoder else 0
        c_shapes = as_shapes(model_lib.cache_shapes(cfg, b, cache_len, cross))
        c_specs = cache_specs(c_shapes, mesh)

        def prefill_cell(params, batch):
            batch = _model_dims_gathered(batch, b_specs, mesh)
            with _serving(mesh, params, p_specs, tcfg.fsdp):
                logits, cache = model_lib.prefill(params, lcfg, batch, cache_len)
            # the cache's positions are replicated (cache_specs): every lane's
            s = (batch["tgt_tokens"] if cfg.is_encoder_decoder
                 else next(iter(batch.values()))).shape[1]
            cache["pos"] = torch.full((b,), s, dtype=torch.int32, device=logits.device)
            return logits, cache

        kwargs = {"params": p_shapes, "batch": b_shapes}
        in_specs = {"params": p_specs, "batch": b_specs}
        return prefill_cell, kwargs, in_specs, (None, c_specs), ()

    # decode: one token against a cache of shape.seq_len
    cross = CROSS_LEN_FOR_DECODE if cfg.is_encoder_decoder else 0
    c_shapes = as_shapes(model_lib.cache_shapes(cfg, b, cache_len, cross))
    c_specs = cache_specs(c_shapes, mesh)
    tok = torch.empty((b,), dtype=torch.int32, device="meta")

    def decode_cell(params, tokens, cache):
        pos = cache["pos"]
        lanes = tokens.shape[0]
        with _serving(mesh, params, p_specs, tcfg.fsdp):
            if lanes == pos.shape[0]:
                return model_lib.decode_step(params, lcfg, tokens, cache)
            # the rank's lanes of the replicated positions; every lane advances
            data = collectives.data_axis(mesh)
            mine = dict(cache, pos=pos.narrow(0, data.rank * lanes, lanes))
            logits, mine = model_lib.decode_step(params, lcfg, tokens, mine)
        return logits, dict(mine, pos=pos + 1)

    kwargs = {"params": p_shapes, "tokens": tok, "cache": c_shapes}
    in_specs = {"params": p_specs, "tokens": batch_pspec(tuple(tok.shape), mesh),
                "cache": c_specs}
    return decode_cell, kwargs, in_specs, (None, c_specs), ("cache",)


def _fresh(tree, make, key=None):
    """Every tensor leaf of ``tree`` replaced by ``make(leaf, key)``, ``key``
    the leaf's innermost dict key."""
    if isinstance(tree, dict):
        return {k: _fresh(v, make, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fresh(v, make, key) for v in tree)
    return make(tree, key) if isinstance(tree, torch.Tensor) else tree


def _dp_size(mesh) -> int:
    size = 1
    for a in data_axes(mesh):
        size *= mesh.shape[a]
    return size


def _rank_shapes(cfg: ModelConfig, shape: ShapeConfig, mesh, tcfg: TrainConfig, kwargs,
                in_specs) -> dict:
    """The rank's blocks of ``cell_program``'s global inputs, as ``"meta"``
    tensors (each leaf its own storage): params, optimizer state and batch
    cut by their specs at the rank's coordinates (``shard.shard_tree``); a
    decode cache in the rank's own layout (``model.cache_shapes`` of its
    config and lanes: the same bytes as the spec's block, its heads whole),
    with the replicated positions of every lane."""
    out = {}
    for name, tree in kwargs.items():
        if name == "cache":
            b = shape.global_batch
            dp = _dp_size(mesh)
            lanes = b // dp if b % dp == 0 and b > 1 else b
            cross = CROSS_LEN_FOR_DECODE if cfg.is_encoder_decoder else 0
            lcfg = local_config(cfg, mesh.shape.get("model", 1))
            local = as_shapes(model_lib.cache_shapes(lcfg, lanes, _cache_len_for(cfg, shape),
                                                     cross))
            local["pos"] = tree["pos"]
        elif isinstance(tree, torch.Tensor):
            local = shard_tree({name: tree}, {name: in_specs[name]}, mesh, cfg)[name]
        else:
            local = shard_tree(tree, in_specs[name], mesh, cfg)
        out[name] = _fresh(local, lambda t, _: torch.empty(t.shape, dtype=t.dtype,
                                                           device="meta"), name)
    return out


_TOKENS = ("tokens", "tgt_tokens", "labels")


def _materialize(inputs: dict, device, gen, vocab: int) -> dict:
    """Real tensors on ``device`` of the meta inputs: floats normal(0,
    0.02) and token ids uniform in [0, vocab), from ``gen``; every other
    integer (a cache's positions, the optimizer's step) 0."""
    def make(t, key):
        if t.dtype.is_floating_point:
            return torch.empty(t.shape, dtype=t.dtype, device=device).normal_(0.0, 0.02,
                                                                           generator=gen)
        if key in _TOKENS:
            return torch.randint(0, vocab, t.shape, dtype=t.dtype, device=device,
                                 generator=gen)
        return torch.zeros(t.shape, dtype=t.dtype, device=device)
    return {name: _fresh(tree, make, name) for name, tree in inputs.items()}


@dataclasses.dataclass
class MemoryAnalysis:
    """One rank's buffers, in the names of XLA's ``memory_analysis()``."""

    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int
    alias_size_in_bytes: int
    generated_code_size_in_bytes: int = 0


@dataclasses.dataclass
class CompiledCell:
    """What one run of a rank's program did (``LoweredCell.compile``)."""

    counts: counters.Counts
    memory: MemoryAnalysis
    outputs: object

    def memory_analysis(self) -> MemoryAnalysis:
        """Argument bytes: the rank's inputs; output bytes: its outputs
        (those updated in place included); alias bytes: the donated inputs;
        temp bytes: the peak of the storages the run made beyond its
        inputs, less the new outputs -- so ``argument + output + temp -
        alias`` is the rank's peak.  Code bytes are 0: the kernels are one
        shared library, loaded once per process, not a per-program
        buffer."""
        return self.memory

    def cost_analysis(self) -> dict:
        """``{"flops": operations, "bytes accessed": bytes}`` of the run
        (``runtime.counters``: unfused, per aten op, plus the kernels')."""
        return {"flops": float(self.counts.ops), "bytes accessed": float(self.counts.bytes)}

    @property
    def collectives(self) -> list:
        """``(kind, dtype, shape)`` of each collective the run called."""
        return self.counts.collectives


@dataclasses.dataclass
class LoweredCell:
    """One rank's program of a cell and its inputs at the rank's shapes."""

    fn: Callable
    inputs: dict
    donate: tuple
    cfg: ModelConfig               # the rank's config (shard.local_config)
    mesh: object

    def compile(self) -> CompiledCell:
        """Run the rank's program once under the dry run's counters
        (``runtime.counters``) and take its buffers' sizes."""
        given = list(self.inputs.values())
        with counters.counting(given) as counts:
            out = self.fn(**self.inputs)
        given_ids = {id(st) for st in counters.storages(given)}
        new_out = counters.tree_bytes([t for t in leaves(out) if isinstance(t, torch.Tensor)
                                       and id(t.untyped_storage()) not in given_ids])
        memory = MemoryAnalysis(
            argument_size_in_bytes=counters.tree_bytes(given),
            output_size_in_bytes=counters.tree_bytes(out),
            temp_size_in_bytes=max(0, counts.peak_bytes - new_out),
            alias_size_in_bytes=counters.tree_bytes([self.inputs[n] for n in self.donate]))
        return CompiledCell(counts, memory, out)


def lower_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, tcfg: TrainConfig | None = None,
               *, device=None) -> LoweredCell:
    """One rank's program of the cell (its coordinates: ``mesh``'s, a
    ``DryMesh``'s by default rank 0's) with its inputs at the rank's local
    shapes: ``"meta"`` tensors (``device`` ``"meta"``, the default for a
    dry mesh) or real ones made from a generator seeded with 0 on
    ``device``.  Nothing of the whole tree is built."""
    tcfg = tcfg or TrainConfig()
    fn, kwargs, in_specs, _, donate = cell_program(cfg, shape, mesh, tcfg)
    inputs = _rank_shapes(cfg, shape, mesh, tcfg, kwargs, in_specs)
    device = torch.device(device if device is not None else mesh.device)
    if device.type != "meta":
        gen = torch.Generator(device=device).manual_seed(0)
        inputs = _materialize(inputs, device, gen, cfg.vocab_size)
    return LoweredCell(fn, inputs, donate, local_config(cfg, mesh.shape.get("model", 1)), mesh)
