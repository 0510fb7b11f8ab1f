"""Collectives over ``torch.distributed`` (the port of
``repro/runtime/collectives.py``): the int8-compressed gradient
all-reduce, its uncompressed reference, the tensor-parallel primitives
the sharded layers call, and the autograd-aware collectives of sharded
training.  This is the one module that issues ``torch.distributed``
collectives.

``compressed_psum_mean`` reuses the SPOGA quantization at the collective
layer: each rank quantizes its local gradient to int8 against a globally
agreed scale (a MAX all-reduce of the absmax), the int8 payload is summed
in int32 and dequantized -- the reference's ops in the reference's order.
Stochastic rounding draws from an explicit ``torch.Generator``.

The reference names an axis inside ``shard_map``; here an axis is an
:class:`Axis` of a ``launch.mesh.Mesh`` (:func:`axis`).

**Backends.**  NCCL reduces CUDA tensors on the card.  Gloo reduces CPU
tensors; a CUDA tensor on a gloo group (several ranks sharing one card)
is copied to the host, reduced there and copied back.  That staging is
the only way gloo serves ``all_gather`` on CUDA tensors, and this module
stages every gloo collective on a CUDA tensor the same way, so the layout
costs two host copies a collective and says so here rather than hiding a
fallback.

**The model axis.**  :func:`model_parallel` opens the context in which
the model's layers see the mesh's ``"model"`` axis (:func:`model_axis`):
the engine and the model entry points enter it around every dispatch.
Outside it, or on a one-rank model axis, the layers run unsharded.

**Training.**  Megatron's two operators carry the gradients of a
tensor-parallel layer: *f* (:func:`model_input`: identity forward, SUM
all-reduce backward) where a replicated activation enters a
column-parallel group, *g* (:func:`model_sum`: SUM all-reduce forward,
identity backward) for the row-parallel sum; :func:`model_gather`
all-gathers a split tensor and takes the rank's slice back,
:func:`model_scatter` (Megatron's scatter) takes a replicated tensor's
block and all-gathers the blocks' gradients back; :func:`global_absmax`
takes a quantization scale over a contraction split across the axis,
its gradient going to the element that holds the maximum.
Inside a data-parallel training step (:func:`data_sharded`), the leaves
that are sharded over "data" (FSDP) are all-gathered just before use
(:func:`gather_params`) and the gather's backward reduce-scatters the
gradient back to the rank's shard, averaged over the axis; a statistic
of the whole batch (the MoE load-balance means, the count of labelled
tokens) is taken over every data rank's rows (:func:`batch_mean`,
:func:`batch_total`), so the step's loss is the global batch's.  On a
multi-pod mesh the ("pod", "data") pair is one data axis for the batch
(:func:`data_axis`), while FSDP gathers over "data" alone and sums the
gradient over "pod" after the reduce-scatter (the reference's specs keep
the params whole over "pod").

**Dry axes and counting.**  An axis of a dry mesh (``launch.mesh.DryMesh``,
``backend == "dry"``) has no process group: each primitive returns a
placeholder of its result's shape and dtype, with finite values (a copy
of the rank's own block where the result would hold others' too), and
never communicates -- one rank's program then runs alone, on ``"meta"``
tensors or on the card.  A real mesh never takes that branch.  While a
``runtime.counters.counting`` count is open (the dry run's, or a test's
around a real run), each primitive records one ``(kind, dtype, shape)``
of its result buffer, in the kinds that XLA's HLO names and the
reference's ``collective_stats`` sums:

==========================  =====================  ==========================
primitive                   kind                   result buffer
==========================  =====================  ==========================
:func:`all_reduce`          ``all-reduce``         ``t``'s shape
:func:`gather_blocks`,      ``all-gather``         ``(size, *t.shape)``, the
:func:`all_gather`                                 blocks of every rank
:func:`reduce_scatter`      ``reduce-scatter``     the rank's block
:func:`broadcast`           ``all-reduce``         ``t``'s shape (XLA has no
                                                   broadcast; a masked sum
                                                   carries it)
==========================  =====================  ==========================

``global_absmax``, ``compressed_psum_mean``, ``psum_mean``, ``mean_over``
and the autograd operators reach these.  :func:`barrier` moves no data
and records nothing; ``all-to-all`` and ``collective-permute`` have no
caller in the port.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import math

import torch
import torch.distributed as dist

from repro_torch.runtime import counters
from repro_torch.tree import leaves, rebuild

INT8_MAX = 127.0


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as the collectives see it."""

    group: object      # torch.distributed ProcessGroup
    size: int
    rank: int          # this rank's coordinate along the axis
    backend: str


DRY = "dry"


def axis(mesh, name) -> Axis:
    """``mesh``'s axis ``name`` (a ``launch.mesh.Mesh``), or the axes of a
    tuple of names as one (the first name major)."""
    names = name if isinstance(name, tuple) else (name,)
    size = math.prod(mesh.shape[n] for n in names)
    rank = 0
    for n in names:
        rank = rank * mesh.shape[n] + mesh.axis_rank(n)
    if getattr(mesh, "backend", None) == DRY:
        return Axis(None, size, rank, DRY)
    g = mesh.group(name)
    return Axis(g, size, rank, str(dist.get_backend(g)))


def data_axis(mesh) -> Optional[Axis]:
    """The data-parallel axis of ``mesh``: ("pod", "data") as one axis on a
    multi-pod mesh, "data" on a (data, model) mesh; ``None`` where it has
    one rank."""
    names = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    if math.prod(mesh.shape[n] for n in names) == 1:
        return None
    return axis(mesh, names if len(names) > 1 else names[0])


def world(mesh) -> Axis:
    """Every rank of ``mesh`` (the default process group) as one axis."""
    if getattr(mesh, "backend", None) == DRY:
        return axis(mesh, tuple(mesh.axis_names))
    return Axis(dist.group.WORLD, mesh.size, dist.get_rank(), str(dist.get_backend()))


def _counted(kind: str, dtype, shape, ax: Axis, real, dry):
    """Record one collective while a count is open, then run
    ``real`` -- or, on a dry axis, ``dry`` -- with its aten ops opaque."""
    counters.collective(kind, dtype, shape)
    with counters.opaque():
        return dry() if ax.backend == DRY else real()


def _staged(t: torch.Tensor, ax: Axis) -> bool:
    return ax.backend == "gloo" and t.is_cuda


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, ax: Axis, op: str = "sum") -> torch.Tensor:
    """The ``op`` ("sum" or "max") of ``t`` over the axis; a new tensor on
    ``t``'s device.  Sums of integers are exact; callers sum floats in f32."""
    if ax.backend == DRY or counters.ACTIVE:
        return _counted("all-reduce", t.dtype, t.shape, ax, lambda: _all_reduce(t, ax, op),
                        lambda: t.detach().clone())
    return _all_reduce(t, ax, op)


def _all_reduce(t: torch.Tensor, ax: Axis, op: str) -> torch.Tensor:
    buf = t.detach().cpu().clone() if _staged(t, ax) else t.detach().clone()
    dist.all_reduce(buf, op=_OPS[op], group=ax.group)
    return buf.to(t.device)


def gather_blocks(t: torch.Tensor, ax: Axis, dst: Optional[int] = None):
    """Every rank's ``t`` (all of one shape and dtype), as a list in axis
    order on ``t``'s device: on every rank (``dst=None``, an all-gather), or
    on axis rank ``dst`` alone (a gather; the others get ``None``).  The
    payload travels as raw bytes, so any dtype gathers bit for bit."""
    if ax.backend == DRY or counters.ACTIVE:
        def dry():
            if dst is not None and ax.rank != dst:
                return None
            return [t.detach().clone() for _ in range(ax.size)]
        return _counted("all-gather", t.dtype, (ax.size, *t.shape), ax,
                        lambda: _gather_blocks(t, ax, dst), dry)
    return _gather_blocks(t, ax, dst)


def _gather_blocks(t: torch.Tensor, ax: Axis, dst: Optional[int]):
    src = t.detach().contiguous()
    host = _staged(src, ax)
    if host:
        src = src.cpu()
    raw = src.reshape(-1).view(torch.uint8)
    if dst is None:
        parts = [torch.empty_like(raw) for _ in range(ax.size)]
        dist.all_gather(parts, raw, group=ax.group)
    else:
        parts = [torch.empty_like(raw) for _ in range(ax.size)] if ax.rank == dst else None
        dist.gather(raw, parts, dst=dist.get_global_rank(ax.group, dst), group=ax.group)
        if parts is None:
            return None
    return [p.view(t.dtype).reshape(t.shape).to(t.device) for p in parts]


def all_gather(t: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in axis order, bit for
    bit (:func:`gather_blocks`)."""
    return torch.cat(gather_blocks(t, ax), dim=dim)


def reduce_scatter(t: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """The SUM of ``t`` over the axis, this rank's ``1/size`` block of it
    along ``dim`` (a new tensor on ``t``'s device).  NCCL reduce-scatters;
    gloo has no reduce-scatter, so there every rank all-reduces and keeps
    its block: every rank sums the same values in the same order."""
    part = t.shape[dim] // ax.size
    if ax.backend == DRY or counters.ACTIVE:
        shape = list(t.shape)
        shape[dim] = part
        return _counted("reduce-scatter", t.dtype, shape, ax,
                        lambda: _reduce_scatter(t, ax, dim, part),
                        lambda: t.detach().narrow(dim, ax.rank * part, part).contiguous())
    return _reduce_scatter(t, ax, dim, part)


def _reduce_scatter(t: torch.Tensor, ax: Axis, dim: int, part: int) -> torch.Tensor:
    if ax.backend == "nccl":
        src = t.detach().movedim(dim, 0).contiguous()
        out = torch.empty((part,) + tuple(src.shape[1:]), dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, src, group=ax.group)
        return out.movedim(0, dim).contiguous()
    return _all_reduce(t, ax, "sum").narrow(dim, ax.rank * part, part).contiguous()


def barrier(ax: Axis) -> None:
    """Every rank of the axis waits for the others (nothing on a dry axis)."""
    if ax.backend != DRY:
        dist.barrier(group=ax.group)


def broadcast(t: torch.Tensor, ax: Axis, src: int = 0) -> torch.Tensor:
    """Axis rank ``src``'s ``t`` on every rank (a new tensor)."""
    if ax.backend == DRY or counters.ACTIVE:
        return _counted("all-reduce", t.dtype, t.shape, ax, lambda: _broadcast(t, ax, src),
                        lambda: t.detach().clone())
    return _broadcast(t, ax, src)


def _broadcast(t: torch.Tensor, ax: Axis, src: int) -> torch.Tensor:
    buf = t.detach().cpu().clone() if _staged(t, ax) else t.detach().clone()
    dist.broadcast(buf, src=dist.get_global_rank(ax.group, src), group=ax.group)
    return buf.to(t.device)


# ---------------------------------------------------------------------------
# Gradient all-reduce (data parallelism)
# ---------------------------------------------------------------------------

def compressed_psum_mean(tree, ax: Axis, generator: Optional[torch.Generator] = None):
    """All-reduce-mean a gradient tree with int8 compression.

    Per leaf: ``absmax = pmax(max |g|)``, ``scale = max(absmax, 1e-12) /
    127``, ``q = clip(round(g / scale [+ noise]), -127, 127)`` as int8, the
    int32 sum of ``q`` over the axis, then ``total * scale / n`` cast to
    the leaf's dtype.  The division by the constant 127 is a multiply by
    its f32 reciprocal, as XLA compiles the reference's; the divisions by
    ``scale`` and by the axis size are true divisions by a tensor (on the
    card a division by a host scalar would also become a reciprocal
    multiply), so the card, the host and the jitted reference agree bit
    for bit.  ``generator``: stochastic rounding (uniform noise in [-0.5,
    0.5) before rounding, drawn on the leaf's device)."""
    out = []
    for g in leaves(tree):
        gf = g.float()
        absmax = all_reduce(gf.abs().max(), ax, "max")
        scale = torch.clamp_min(absmax, 1e-12) * (1.0 / INT8_MAX)
        scaled = gf / scale
        if generator is not None:
            noise = torch.rand(scaled.shape, generator=generator, dtype=torch.float32,
                               device=scaled.device) - 0.5
            q = torch.round(scaled + noise)
        else:
            q = torch.round(scaled)
        q = torch.clamp(q, -INT8_MAX, INT8_MAX).to(torch.int8)
        total = all_reduce(q.to(torch.int32), ax, "sum")
        out.append((total.float() * scale / _size(ax, g.device)).to(g.dtype))
    return rebuild(tree, iter(out))


def _size(ax, device) -> torch.Tensor:
    """The axis size (an ``Axis`` or an int) as a 0-d f32 tensor (a divisor
    that stays a true division on every device)."""
    n = ax.size if isinstance(ax, Axis) else ax
    return torch.full((), float(n), dtype=torch.float32, device=device)


def psum_mean(tree, ax: Axis):
    """Uncompressed reference: the sum over the axis (in f32, rounded once
    to the leaf's dtype), divided by the axis size in f32 -- a bf16 leaf
    comes back f32, as the reference's ``psum(g) / n`` promotes it."""
    return rebuild(tree, iter([all_reduce(g.float(), ax, "sum").to(g.dtype).float()
                               / _size(ax, g.device) for g in leaves(tree)]))


# ---------------------------------------------------------------------------
# The model axis as the layers see it (tensor parallelism)
# ---------------------------------------------------------------------------

_MODEL_AXES: list = []


@contextlib.contextmanager
def model_parallel(mesh):
    """Run the model's layers on ``mesh``'s ``"model"`` axis (``None``, or a
    one-rank axis: unsharded)."""
    ax = None
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        ax = axis(mesh, "model")
    _MODEL_AXES.append(ax)
    try:
        yield ax
    finally:
        _MODEL_AXES.pop()


def model_axis() -> Optional[Axis]:
    """The model axis of the innermost :func:`model_parallel` context, or
    ``None`` (unsharded)."""
    return _MODEL_AXES[-1] if _MODEL_AXES else None


class _ModelInput(torch.autograd.Function):
    """Megatron's *f*: identity forward, SUM all-reduce backward."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.ax, "sum"), None


class _ModelSum(torch.autograd.Function):
    """Megatron's *g*: SUM all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, ax):
        return all_reduce(x, ax, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ModelGather(torch.autograd.Function):
    """All-gather along ``dim`` forward, the rank's block backward."""

    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim, ctx.part = ax, dim, x.shape[dim]
        return all_gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.ax.rank * ctx.part, ctx.part), None, None


class _ModelScatter(torch.autograd.Function):
    """Megatron's scatter: the rank's block along ``dim`` forward, the
    ranks' gradient blocks all-gathered backward."""

    @staticmethod
    def forward(ctx, x, ax, dim, part):
        ctx.ax, ctx.dim = ax, dim
        return x.narrow(dim, ax.rank * part, part)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.ax, ctx.dim), None, None, None


class _GlobalAbsmax(torch.autograd.Function):
    """The absmax of each of ``ts`` along its dim in ``dims`` (kept, size 1)
    over the ranks' slices of that dim: one MAX all-reduce forward.
    Backward, the gradient of a maximum goes to the elements that hold it,
    on the ranks that hold them, split evenly among them as ``amax``
    splits a tie (the tie count summed over the ranks in one SUM
    all-reduce), signed as ``abs``'s gradient is."""

    @staticmethod
    def forward(ctx, ax, dims, *ts):
        outs = _absmax_over(ax, ts, dims)
        ctx.ax, ctx.dims = ax, dims
        ctx.save_for_backward(*ts, *outs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        n = len(gs)
        ts, outs = ctx.saved_tensors[:n], ctx.saved_tensors[n:]
        hits = [(t.float().abs() == o).float() for t, o in zip(ts, outs)]
        counts = [h.sum(dim=d, keepdim=True) for h, d in zip(hits, ctx.dims)]
        total = all_reduce(torch.cat([c.reshape(-1) for c in counts]), ctx.ax, "sum")
        grads, at = [], 0
        for t, h, c, g in zip(ts, hits, counts, gs):
            share = total[at:at + c.numel()].reshape(c.shape)
            at += c.numel()
            grads.append((g * h * torch.sign(t.float()) / share).to(t.dtype))
        return (None, None, *grads)


def global_absmax(ax: Axis, pairs):
    """``[(t, dim), ...]`` -> each ``t``'s absmax along ``dim`` (kept) over
    the whole of that dim, of which every rank of ``ax`` holds a slice:
    the scales of a product whose contraction is split over the axis,
    bitwise the unsharded ``amax``, with the gradient an unsharded
    ``amax`` of ``abs`` would give each rank's slice."""
    ts, dims = [t for t, _ in pairs], tuple(d for _, d in pairs)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return list(_GlobalAbsmax.apply(ax, dims, *ts))
    return _absmax_over(ax, ts, dims)


def _absmax_over(ax: Axis, ts, dims) -> list:
    """Each of ``ts``'s local absmax along its dim, then their MAX over
    ``ax`` in one all-reduce."""
    local = [t.float().abs().amax(dim=d, keepdim=True) for t, d in zip(ts, dims)]
    both = all_reduce(torch.cat([a.reshape(-1) for a in local]), ax, "max")
    outs, at = [], 0
    for a in local:
        outs.append(both[at:at + a.numel()].reshape(a.shape))
        at += a.numel()
    return outs


def model_input(x: torch.Tensor) -> torch.Tensor:
    """A replicated activation entering a column-parallel group of the
    model axis (*f*); ``x`` itself outside training or tensor parallelism."""
    ax = model_axis()
    if ax is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _ModelInput.apply(x, ax)


def model_sum(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The SUM of the ranks' partial ``x`` over ``ax`` (*g*)."""
    return _ModelSum.apply(x, ax)


def model_gather(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``; the gradient of the
    whole goes back as each rank's block."""
    return _ModelGather.apply(x, ax, dim)


def model_scatter(x: torch.Tensor, ax: Axis, dim: int, part: int) -> torch.Tensor:
    """This rank's block (``part`` long along ``dim``) of the replicated
    ``x``.  Under autograd the gradient of the whole comes back as every
    rank's block all-gathered, so a replicated producer of ``x`` gets its
    whole gradient on every rank; without grad a plain ``narrow``."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x.narrow(dim, ax.rank * part, part)
    return _ModelScatter.apply(x, ax, dim, part)


# ---------------------------------------------------------------------------
# FSDP: leaves sharded over "data", gathered just before use
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _DataShards:
    axis: Optional[Axis]           # the FSDP axis ("data")
    dims: dict                     # id(leaf) -> the dim sharded over "data"
    reduce_dtype: Optional[torch.dtype]
    batch: Optional[Axis]          # the axis batch statistics reduce over
    pod: Optional[Axis]            # the replicas the FSDP gradient also sums over


_DATA_SHARDS: list = []
_SAME = object()


@contextlib.contextmanager
def data_sharded(ax: Optional[Axis], dims: dict, reduce_dtype: Optional[torch.dtype] = None,
                 batch=_SAME, pod: Optional[Axis] = None):
    """A data-parallel step over ``ax``: inside, :func:`gather_params`
    all-gathers the leaves ``dims`` names (``id(leaf)`` -> the leaf's dim
    sharded over ``ax``), whose gradients come back reduce-scattered (and
    summed over ``pod``, a multi-pod mesh's replicas of the shards),
    divided by the ranks' count, in ``reduce_dtype`` on the wire (default
    f32); :func:`batch_mean` and :func:`batch_total` reduce over ``batch``
    (default ``ax``; ``None``: each rank's own rows, as a serving step
    keeps them).  ``ax=None``: one data rank."""
    batch = ax if batch is _SAME else batch
    _DATA_SHARDS.append(None if ax is None and batch is None
                        else _DataShards(ax, dims, reduce_dtype, batch, pod))
    try:
        yield
    finally:
        _DATA_SHARDS.pop()


def _data_shards() -> Optional[_DataShards]:
    return _DATA_SHARDS[-1] if _DATA_SHARDS else None


class _BatchMean(torch.autograd.Function):
    """The mean over the data axis forward, identity backward: every rank's
    loss carries the same global statistic, and the step's average of the
    ranks' gradients then gives its exact gradient."""

    @staticmethod
    def forward(ctx, x, ax):
        return mean_over(x, ax).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def batch_mean(t: torch.Tensor) -> torch.Tensor:
    """``t`` (a mean over this rank's rows) as the mean over every data
    rank's rows inside a data-parallel step (equal rows a rank); ``t``
    itself outside one."""
    shards = _data_shards()
    return t if shards is None or shards.batch is None else _BatchMean.apply(t, shards.batch)


def batch_total(t: torch.Tensor):
    """(data ranks, the SUM of ``t`` over them) inside a data-parallel
    step, ``(1, t)`` outside one; no gradient flows through the sum."""
    shards = _data_shards()
    if shards is None or shards.batch is None:
        return 1, t
    return shards.batch.size, all_reduce(t.detach(), shards.batch, "sum")


class _DataGather(torch.autograd.Function):
    """FSDP's gather: all-gather along ``dim`` forward; backward, the
    gradient reduce-scattered back to the rank's block and divided by the
    axis size, summed in f32 (``reduce_dtype`` on the wire when set)."""

    @staticmethod
    def forward(ctx, x, ax, dim, reduce_dtype, pod):
        ctx.ax, ctx.dim, ctx.reduce_dtype, ctx.pod = ax, dim, reduce_dtype, pod
        return all_gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return (mean_over(g, ctx.ax, ctx.dim, ctx.reduce_dtype, ctx.pod).to(g.dtype),
                None, None, None, None)


def mean_over(t: torch.Tensor, ax: Axis, dim: Optional[int] = None,
              wire: Optional[torch.dtype] = None, pod: Optional[Axis] = None) -> torch.Tensor:
    """The mean of ``t`` over the axis in f32: whole (``dim=None``, a SUM
    all-reduce) or this rank's block along ``dim`` (a reduce-scatter), with
    ``wire`` the dtype on the wire (default f32); ``pod``: the sum then
    runs over ``pod`` too (a SUM all-reduce of the result), and the mean
    is over both axes' ranks."""
    payload = t.to(wire or torch.float32)
    total = all_reduce(payload, ax, "sum") if dim is None else reduce_scatter(payload, ax, dim)
    if pod is None:
        return total.float() / _size(ax, t.device)
    return all_reduce(total, pod, "sum").float() / _size(ax.size * pod.size, t.device)


def gather_params(tree, period: Optional[int] = None):
    """``tree`` (period ``period`` of a stacked tree: one slice at a time)
    with every leaf that :func:`data_sharded` registered gathered whole
    over "data"; other leaves as they are (views for a period)."""
    shards = _data_shards()

    def one(t):
        dim = shards.dims.get(id(t)) if shards is not None and shards.axis is not None else None
        v = t if period is None else t[period]
        if dim is None:
            return v
        return _DataGather.apply(v, shards.axis, dim - (period is not None),
                                 shards.reduce_dtype, shards.pod)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return one(node)

    return walk(tree)
