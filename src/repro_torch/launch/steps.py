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
(``runtime.collectives``).  ``ShapeConfig`` and ``cell_program`` /
``lower_cell`` belong to the dry run (ROADMAP queue 1, item 10.2 (d)).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import model as model_lib
from repro_torch.optim.optimizers import adamw_init, adamw_update, zero1_dims
from repro_torch.runtime import collectives
from repro_torch.runtime.sharding import opt_state_specs, param_specs, spec_leaves
from repro_torch.shard.core import local_config
from repro_torch.tree import leaves, rebuild, tree_map


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
    data: object                   # the "data" axis, or None at dp=1

    @property
    def dp(self) -> int:
        return self.data.size if self.data is not None else 1


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
    return ShardedLayout(mesh, local_config(cfg, tp), p_specs, g_specs, o_specs, data)


def _sharded_loss_and_grads(params, layout: ShardedLayout, tcfg: TrainConfig, batch):
    """(this data rank's loss, gradient tree in the ``g_specs`` layout) of
    ``lm_loss`` at the rank's blocks ``params`` on its slice ``batch``:
    the gradients averaged over "data" (see the module docstring)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    flat = leaves(live)
    p_flat = spec_leaves(layout.p_specs, live)
    dims = {id(t): d for t, d in ((t, _data_dim(s)) for t, s in zip(flat, p_flat))
            if d is not None}
    wire = torch.bfloat16 if tcfg.grad_reduce_dtype == "bf16" else None
    with collectives.model_parallel(layout.mesh), \
            collectives.data_sharded(layout.data, dims, wire):
        loss = model_lib.lm_loss(live, layout.cfg, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    out = []
    for p, g, p_spec, g_spec in zip(flat, grads, p_flat, spec_leaves(layout.g_specs, live)):
        g = torch.zeros_like(p) if g is None else g
        if layout.data is not None and id(p) not in dims:
            g = collectives.mean_over(g, layout.data, _data_dim(g_spec), wire).to(g.dtype)
        out.append(g.to(torch.bfloat16) if wire is not None else g)
    return loss.detach(), rebuild(params, iter(out))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, grad_specs=None, mesh=None):
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
    Without a mesh it names no axis and changes nothing."""
    dp = mesh.shape.get("data", 1) if mesh is not None else 1
    tp = mesh.shape.get("model", 1) if mesh is not None else 1
    sharded = tp > 1 or (dp > 1 and (tcfg.fsdp or tcfg.zero1))
    if tcfg.grad_compression and dp * tp > 1 and sharded:
        raise ValueError(
            "grad_compression runs on the replicated data-parallel step only "
            "(TrainConfig(fsdp=False, zero1=False) on a mesh with model=1): the "
            "reference's sharded make_train_step never compresses")
    layout = sharded_layout(cfg, tcfg, mesh, grad_specs) if sharded else None
    data = collectives.axis(mesh, "data") if dp > 1 else None

    def loss_and_grads(params, batch):
        if layout is not None:
            return _sharded_loss_and_grads(params, layout, tcfg, batch)
        return _loss_and_grads(params, cfg, tcfg, batch)

    def local(batch):
        """This data rank's rows of a global (micro)batch."""
        if data is None:
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
