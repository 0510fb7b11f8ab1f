"""Optimizers (the port of ``repro/optim/optimizers.py``): AdamW, SGD,
schedules and global-norm clipping, as plain functions.

The state is the reference's dict layout -- ``{"step", "m", "v",
"master"}`` for AdamW, ``{"step", "mom"}`` for SGD, each of ``m`` / ``v``
/ ``master`` / ``mom`` a tree shaped like the params -- so checkpoints
carry across the packages.  Moments and the master copy are f32 whatever
the param dtype; ``step`` is a 0-d int32 tensor.

An update runs in place under ``no_grad``, as the reference's jitted step
donates its trees: the params' and the state's tensors are overwritten,
and the returned trees (the reference's) hold those same tensors.  A
caller that needs the old values clones them first.  The arithmetic is
the reference's, op for op, in f32.

**Sharded trees** (``mesh=`` and the spec trees of ``runtime.sharding``):
each rank holds its blocks.  The global norm sums the squares of the
elements a rank holds -- a leaf replicated over some axes only on the
first rank along them (the others add a 0 selected in its place, so
every rank runs the same ops), so each element counts once -- and one
SUM all-reduce over the world gives the total.  AdamW updates the rank's
blocks of ``m``, ``v`` and ``master``: under ZeRO-1 the optimizer specs
shard a dim over "data" that the param and gradient specs leave whole, so
the rank takes its block of the gradient, and afterwards all-gathers the
new param over "data" along that dim.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.device import resolve_device
from repro_torch.runtime import collectives
from repro_torch.runtime.sharding import spec_leaves
from repro_torch.tree import leaves as _leaves
from repro_torch.tree import tree_map as _map


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _counted(spec, mesh) -> bool:
    """Whether this rank holds the first replica of a leaf with ``spec``:
    its coordinate is 0 along every axis the spec does not shard over."""
    used = {a for entry in spec for a in _axes_of(entry)}
    return all(mesh.axis_rank(a) == 0 for a in mesh.axis_names if a not in used)


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares (0-d f32).  On a
    ``mesh``, ``tree`` holds this rank's blocks under ``specs`` and each
    element is counted once over the mesh (see the module docstring)."""
    flat = _leaves(tree)
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in flat))
    dev = flat[0].device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    keep = {c: torch.full((), c, dtype=torch.bool, device=dev) for c in (False, True)}
    for x, spec in zip(flat, spec_leaves(specs, tree)):
        # every rank runs the same ops (as a compiled step would): a replica
        # after the first selects 0 in place of its sum, even an inf one
        s = torch.sum(torch.square(x.float()))
        total = total + torch.where(keep[_counted(spec, mesh)], s, 0.0)
    return torch.sqrt(collectives.all_reduce(total, collectives.world(mesh), "sum"))


def clip_by_global_norm(tree, max_norm, specs=None, mesh=None):
    """(tree scaled by ``min(1, max_norm / max(norm, 1e-9))`` in f32 and cast
    back to each leaf's dtype, the norm); ``specs`` and ``mesh`` as in
    :func:`global_norm`."""
    norm = global_norm(tree, specs, mesh)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return _map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def make_schedule(cfg: TrainConfig):
    """step (an int tensor) -> learning rate (0-d f32 tensor): linear warmup,
    then cosine / linear decay to 0 at ``total_steps``, or constant."""

    def sched(step):
        step = step.float()
        warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        if cfg.schedule == "constant":
            return cfg.learning_rate * warm
        frac = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
        if cfg.schedule == "linear":
            decay = 1.0 - frac
        else:  # cosine
            decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return cfg.learning_rate * warm * decay

    return sched


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params, device=None):
    """Moments + f32 MASTER weights (params themselves are stored bf16).

    Every state leaf is a new tensor on ``device`` (default: the card): the
    master of an f32 param is a copy, never an alias of it."""
    dev = resolve_device(device)

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=dev)

    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": _map(zeros, params),
        "v": _map(zeros, params),
        "master": _map(lambda p: p.detach().to(device=dev, dtype=torch.float32, copy=True),
                       params),
    }


def zero1_dims(spec, opt_spec) -> list:
    """The dims that ``opt_spec`` shards over "data" and ``spec`` does not."""
    return [i for i, (a, b) in enumerate(zip(spec, opt_spec))
            if "data" in _axes_of(b) and "data" not in _axes_of(a)]


@torch.no_grad()
def adamw_update(params, grads, state, cfg: TrainConfig, lr=None, *, mesh=None,
                 p_specs=None, g_specs=None, o_specs=None):
    """Returns (new_params, new_state, metrics ``{"grad_norm", "lr"}``).

    The update runs on the f32 master copy; the params emitted for the next
    forward are a cast of the new master.  In place (see the module).

    ``mesh``: the trees hold this rank's blocks -- params under
    ``p_specs``, gradients under ``g_specs`` (default ``p_specs``), the
    state under ``o_specs`` (``opt_state_specs``); see the module
    docstring."""
    step = state["step"] + 1
    if lr is None:
        lr = make_schedule(cfg)(step)
    g_specs = p_specs if g_specs is None else g_specs
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, g_specs, mesh)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    flat = [_leaves(t) for t in (params, grads, state["m"], state["v"], state["master"])]
    data = None
    layouts = [((), ())] * len(flat[0])
    if mesh is not None and mesh.shape.get("data", 1) > 1:
        data = collectives.axis(mesh, "data")
        layouts = [(zero1_dims(g, o), zero1_dims(p, o)) for p, g, o in zip(
            spec_leaves(p_specs, params), spec_leaves(g_specs, params),
            spec_leaves(o_specs["m"], params))]
    for (p, g, m, v, master), (take, gather) in zip(zip(*flat), layouts):
        gf = g.float()
        for dim in take:
            part = gf.shape[dim] // data.size
            gf = gf.narrow(dim, data.rank * part, part)
        m.copy_(b1 * m + (1 - b1) * gf)
        v.copy_(b2 * v + (1 - b2) * gf * gf)
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + 1e-8) + cfg.weight_decay * master
        master.copy_(master - lr * delta)
        new = master
        for dim in gather:
            new = collectives.all_gather(new.to(p.dtype), data, dim)
        p.copy_(new)
    new_state = {"step": step, "m": state["m"], "v": state["v"], "master": state["master"]}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# SGD (momentum)
# ---------------------------------------------------------------------------

def sgd_init(params, device=None):
    dev = resolve_device(device)
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "mom": _map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=dev), params),
    }


@torch.no_grad()
def sgd_update(params, grads, state, cfg: TrainConfig, momentum=0.9, lr=None):
    """Momentum SGD on the params themselves (no master copy), in place."""
    step = state["step"] + 1
    if lr is None:
        lr = make_schedule(cfg)(step)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    for p, g, m in zip(_leaves(params), _leaves(grads), _leaves(state["mom"])):
        m.copy_(momentum * m + g.float())
        p.copy_(p.float() - lr * m)
    return params, {"step": step, "mom": state["mom"]}, {"grad_norm": gnorm, "lr": lr}
