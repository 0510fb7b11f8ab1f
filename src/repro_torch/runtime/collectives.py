"""Collectives over ``torch.distributed`` (the port of
``repro/runtime/collectives.py``): the int8-compressed gradient
all-reduce, its uncompressed reference, and the tensor-parallel
primitives the sharded layers call.  This is the one module that issues
``torch.distributed`` collectives.

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
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.tree import leaves, rebuild

INT8_MAX = 127.0


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as the collectives see it."""

    group: object      # torch.distributed ProcessGroup
    size: int
    rank: int          # this rank's coordinate along the axis
    backend: str


def axis(mesh, name: str) -> Axis:
    """``mesh``'s axis ``name`` (a ``launch.mesh.Mesh``)."""
    g = mesh.group(name)
    return Axis(g, mesh.shape[name], mesh.axis_rank(name), str(dist.get_backend(g)))


def _staged(t: torch.Tensor, ax: Axis) -> bool:
    return ax.backend == "gloo" and t.is_cuda


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, ax: Axis, op: str = "sum") -> torch.Tensor:
    """The ``op`` ("sum" or "max") of ``t`` over the axis; a new tensor on
    ``t``'s device.  Sums of integers are exact; callers sum floats in f32."""
    buf = t.detach().cpu().clone() if _staged(t, ax) else t.detach().clone()
    dist.all_reduce(buf, op=_OPS[op], group=ax.group)
    return buf.to(t.device)


def all_gather(t: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in axis order.  The
    payload travels as raw bytes, so any dtype gathers bit for bit."""
    src = t.detach().contiguous()
    host = _staged(src, ax)
    if host:
        src = src.cpu()
    raw = src.reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(ax.size)]
    dist.all_gather(parts, raw, group=ax.group)
    parts = [p.view(t.dtype).reshape(t.shape) for p in parts]
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if host else out


def broadcast(t: torch.Tensor, ax: Axis, src: int = 0) -> torch.Tensor:
    """Axis rank ``src``'s ``t`` on every rank (a new tensor)."""
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


def _size(ax: Axis, device) -> torch.Tensor:
    """The axis size as a 0-d f32 tensor (a divisor that stays a true
    division on every device)."""
    return torch.full((), float(ax.size), dtype=torch.float32, device=device)


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
