"""Step builders shared by the trainer and the servers (the port of the
single-device parts of ``repro/launch/steps.py``).

``make_train_step`` gives ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)``: the loss and its gradients (optionally
accumulated over microbatches) and one AdamW update.  Gradients come from
``torch.autograd.grad`` on the param leaves, so each has its leaf's dtype
(bf16 weights get bf16 gradients, the f32 norm scales f32 ones), as
``jax.value_and_grad`` gives them.  The update runs in place
(``optim.adamw_update``).

On a mesh (``make_train_step(..., mesh=)``) whose "data" axis has more
than one rank, the step is the reference's ``shard_map`` data-parallel
step (``tests/test_training_integration.py::test_grad_compression_trains``):
every rank holds the whole params and optimizer state, takes its slice of
the global batch, and the gradients are averaged over "data" by
``collectives.psum_mean`` -- or ``compressed_psum_mean`` (the int8
all-reduce) when ``TrainConfig.grad_compression`` is set -- before AdamW,
so the params stay bitwise equal across ranks; the loss is averaged too.
FSDP / ZeRO-1 execution (``TrainConfig.fsdp`` / ``zero1`` on a mesh),
tensor-parallel training, ``grad_specs``, ``ShapeConfig`` and
``cell_program`` / ``lower_cell`` are not ported yet (ROADMAP queue 1,
item 10.2).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import model as model_lib
from repro_torch.optim.optimizers import adamw_update
from repro_torch.runtime import collectives
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


def _data_axis(mesh, tcfg: TrainConfig):
    """The mesh's "data" axis for a data-parallel step, or None."""
    if mesh is None:
        return None
    if mesh.shape.get("model", 1) > 1:
        raise NotImplementedError("tensor-parallel training is not ported yet "
                                  "(ROADMAP queue 1, item 10.2)")
    if mesh.shape.get("data", 1) == 1:
        return None
    if tcfg.fsdp or tcfg.zero1:
        raise NotImplementedError(
            "FSDP / ZeRO-1 execution is not ported yet (ROADMAP queue 1, item 10.2); "
            "pass TrainConfig(fsdp=False, zero1=False) for the replicated "
            "data-parallel step")
    return collectives.axis(mesh, "data")


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None):
    """fwd + bwd (+ gradient accumulation over ``tcfg.microbatches``) +
    AdamW.

    Microbatching splits the batch's leading axis into k equal slices and
    accumulates their gradients in f32, then takes the mean (the mean of
    per-microbatch gradients equals the full-batch gradient for a mean
    loss over equal slices); the loss is the mean of the slices' losses.

    ``mesh``: data parallelism over its "data" axis (see the module
    docstring); the step takes the global batch and slices it."""
    data = _data_axis(mesh, tcfg)

    def train_step(params, opt_state, batch):
        if data is not None:
            batch = {name: v.chunk(data.size)[data.rank] for name, v in batch.items()}
        k = tcfg.microbatches
        if k > 1:
            dev = next(iter(batch.values())).device
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in leaves(params)]
            for i in range(k):
                mb = {name: v.reshape((k, v.shape[0] // k) + tuple(v.shape[1:]))[i]
                      for name, v in batch.items()}
                loss, g = _loss_and_grads(params, cfg, tcfg, mb)
                loss_sum = loss_sum + loss
                for a, t in zip(acc, leaves(g)):
                    a.add_(t.float())
            loss = loss_sum / k
            grads = rebuild(params, iter([a / k for a in acc]))
        else:
            loss, grads = _loss_and_grads(params, cfg, tcfg, batch)
        if data is not None:
            grads = (collectives.compressed_psum_mean(grads, data)
                     if tcfg.grad_compression else collectives.psum_mean(grads, data))
            loss = collectives.all_reduce(loss, data, "sum") / data.size
        params, opt_state, metrics = adamw_update(params, grads, opt_state, tcfg)
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
