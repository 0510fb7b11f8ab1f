"""The quantized-linear pipeline: quantize -> GEMM -> dequant, one place.

Port of ``repro/backends/pipeline.py``.  Activations quantize per row and
weights per output channel — on every call, as in the reference — to the
spec's (accumulator-aware) widths; leading dims flatten into the (M, K)
layout the kernels take; the resolved backend runs its fused
``gemm_dequant`` when it has one, else ``gemm`` plus the same f32
epilogue.  With the numerics watchdog on (``watch=True``, or inside a
model entry point of a ``ModelConfig(numerics_watchdog=True)``), each GEMM
also stages its operand stats on the device (``_stage_watchdog_stats``);
off, nothing is computed.

A row-parallel call (``row_axis``, a ``runtime.collectives.Axis``: the
activation and the weight each hold K/tp of the contraction) quantizes
against globally exact scales -- the per-row activation and per-column
weight absmax through one MAX all-reduce, the accumulator clamp from the
global K -- runs the backend's int32 ``gemm`` on its K slice, sums the
accumulators with a SUM all-reduce (exact) and applies the f32 epilogue
``(acc * x_scale) * w_scale`` after it, so the output equals the unsharded
call's bit for bit.  The numerics watchdog reports a row-parallel or a
column-parallel (``col_axis``) call's stats as those of the global
operands (``_stage_watchdog_stats``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.backends import impls  # noqa: F401  (populates the registry)
from repro_torch.backends.registry import resolve_backend
from repro_torch.backends.spec import parse_quant_mode
from repro_torch.obs import watchdog as _watchdog
from repro_torch.quant.qtensor import quantize, rail_hits, scale_of_absmax
from repro_torch.runtime.collectives import all_reduce, global_absmax

__all__ = ["ACC_BITS", "dynamic_quant", "effective_bits", "gemm_int",
           "quant_mode_summary", "quantized_linear"]

ACC_BITS = 32  # the kernels accumulate in int32


def dynamic_quant(x: torch.Tensor, dim, bits: int = 8):
    """Symmetric dynamic quantization to ``bits`` -> ``(q, scale)``."""
    q = quantize(x, dim=dim, bits=bits)
    return q.data, q.scale


def effective_bits(spec, k: int) -> tuple[int, int]:
    """Accumulator-aware operand widths for a K-length contraction: shrink
    the wider operand first until ``a + w + ceil(log2 K) <= 33``, so the
    int32 accumulator never wraps."""
    headroom = (k - 1).bit_length() if k > 1 else 0
    budget = ACC_BITS + 1 - headroom
    a, w = spec.a_bits, spec.w_bits
    while a + w > budget and (a > 2 or w > 2):
        if a >= w and a > 2:
            a -= 1
        else:
            w -= 1
    return a, w


def _global_quant(x: torch.Tensor, w: torch.Tensor, a_bits: int, w_bits: int, row_axis):
    """``dynamic_quant`` of the K slices of ``x`` (per row) and ``w`` (per
    column) against the absmax of the whole K: both absmax vectors travel
    in one MAX all-reduce over ``row_axis`` (``collectives.global_absmax``).
    Returns (xq, xs, wq, ws)."""
    xa, wa = global_absmax(row_axis, [(x, -1), (w, 0)])
    xq = quantize(x, scale=scale_of_absmax(xa, a_bits), bits=a_bits)
    wq = quantize(w, scale=scale_of_absmax(wa, w_bits), bits=w_bits)
    return xq.data, xq.scale, wq.data, wq.scale


def _stage_watchdog_stats(ctx, label: str, quant_mode: str, x, xq, xs, wq,
                          a_bits: int, w_bits: int, nominal: int, row_axis=None,
                          col_axis=None) -> None:
    """Stage this GEMM's numerics stats into the watchdog context ``ctx``.

    The reference's 8-vector (``repro/backends/pipeline.py``): at-rail
    occupancy of both quantized operands (``rail_hits`` on the integer
    data, so the weight passes read 1 byte an element), their element
    counts, activation ``amax``, mean relative quantization error, an
    accumulator-magnitude bound in bits (``max_row sum_k |xq|`` times
    ``max |wq|`` is the largest int32 any output can reach; the fused
    kernel never writes the accumulator, so the bound is the only runtime
    view of it) and the bits the accumulator clamp took off the nominal
    widths.  The five data-dependent ones stay on the device, stacked in
    one f32 tensor; the watchdog copies them to the host once per entry
    point.  Nothing here feeds the GEMM.

    On a tensor-parallel mesh the stats are the global operands', as the
    reference computes them on global arrays.  A row-parallel site
    (``row_axis``: each rank holds a K slice of both operands) sums the
    rail hits, the element counts and each row's ``sum_k |xq|`` over the
    ranks, takes the max of ``amax`` and ``|wq|``, and divides the summed
    error by the summed magnitude in f64; a column-parallel one
    (``col_axis``: the rank's output columns) sums the weight's rail hits
    and count and takes the max of ``|wq|``.  Counts, ``amax`` and the
    bound are then the unsharded call's bits; the error's mean sums in
    another order (within a few f32 ulps)."""
    xf = x.float()
    # |q| <= qmax: the integer passes are exact, as the reference's f32 are
    w_amax = torch.maximum(wq.amax(), wq.amin().neg())
    # xf - xq * xs rounded once, as the reference's compiled graph fuses it
    # (a multiply-add; the f32 product is exact in f64)
    err = (xf.double() - xq.double() * xs.double()).float()
    a_hits, w_hits = rail_hits(xq, a_bits).float(), rail_hits(wq, w_bits).float()
    amax = xf.abs().max()
    rows = xq.abs().float().sum(dim=-1)
    ways = 1
    if row_axis is not None:
        ways = row_axis.size
        summed = all_reduce(torch.cat([torch.stack([a_hits, w_hits]).double(),
                                       torch.stack([err.abs().double().sum(),
                                                    xf.abs().double().sum()]),
                                       rows.reshape(-1).double()]), row_axis, "sum")
        a_hits, w_hits = summed[0].float(), summed[1].float()
        n = xq.numel() * ways
        rel = ((summed[2] / n) / (summed[3] / n + 1e-12)).float()
        rows = summed[4:].float()
        amax, w_amax = all_reduce(torch.stack([amax, w_amax.float()]), row_axis, "max")
    else:
        rel = err.abs().mean() / (xf.abs().mean() + 1e-12)
        if col_axis is not None:
            ways = col_axis.size
            w_hits = all_reduce(w_hits, col_axis, "sum")
            w_amax = all_reduce(w_amax.float(), col_axis, "max")
    dev = torch.stack([a_hits, w_hits, amax, rel,
                       torch.log2(1.0 + rows.max() * w_amax.float())])
    a_elems = xq.numel() * (ways if row_axis is not None else 1)
    _watchdog.stage(ctx, label, quant_mode, dev,
                    (a_elems, wq.numel() * ways, nominal - (a_bits + w_bits)))


def quantized_linear(x: torch.Tensor, w: torch.Tensor, quant_mode: str, *,
                     backend: Optional[str] = None,
                     out_dtype: Optional[torch.dtype] = None,
                     watch: Optional[bool] = None,
                     layer: Optional[str] = None, row_axis=None,
                     col_axis=None) -> torch.Tensor:
    """x (..., K) fp @ w (K, N) fp -> (..., N) fp via the quantized pipeline,
    on ``backend`` (a registry name) or, by default, the backend that
    serves ``x``'s device.

    ``watch``/``layer`` drive the numerics watchdog explicitly; by default
    the context that the model entry points open
    (``watchdog.watching``, keyed off ``ModelConfig.numerics_watchdog``)
    decides.  An explicit ``watch=True`` outside any context records
    straight away (one host copy for this GEMM).

    ``row_axis``: the row-parallel form (see the module docstring); it
    launches the backend's int32 ``gemm``, never the fused one.
    ``col_axis``: ``w`` is this rank's block of a column-parallel weight;
    the GEMM is the plain one, and only the watchdog reads the axis (its
    label and stats are the whole weight's)."""
    b, spec = resolve_backend(quant_mode, x.device.type, backend)
    k_all = x.shape[-1] * (row_axis.size if row_axis is not None else 1)
    a_bits, w_bits = effective_bits(spec, k_all)
    if row_axis is None:
        xq, xs = dynamic_quant(x, dim=-1, bits=a_bits)
        wq, ws = dynamic_quant(w, dim=0, bits=w_bits)
    else:
        xq, xs, wq, ws = _global_quant(x, w, a_bits, w_bits, row_axis)

    ctx = _watchdog.trace_ctx()
    if watch if watch is not None else ctx is not None:
        n_all = w.shape[-1] * (col_axis.size if col_axis is not None else 1)
        label = layer or _watchdog.next_label(ctx, k_all, n_all)
        sink = ctx if ctx is not None else _watchdog.standalone()
        _stage_watchdog_stats(sink, label, quant_mode, x, xq, xs, wq, a_bits, w_bits,
                              spec.a_bits + spec.w_bits, row_axis, col_axis)
        if ctx is None:
            _watchdog.flush(sink)

    xq = xq.to(spec.a_dtype)
    wq = wq.to(spec.w_dtype)

    lead = xq.shape[:-1]
    k = xq.shape[-1]
    n = wq.shape[-1]
    # a strided activation (a transposed einsum output) takes one copy
    x2 = xq.reshape(-1, k).contiguous()
    xs2 = xs.reshape(-1, 1)
    ws2 = ws.reshape(1, n)
    if row_axis is not None:
        out = all_reduce(b.gemm(x2, wq, spec), row_axis, "sum").float() * xs2 * ws2
    elif b.gemm_dequant is not None:
        out = b.gemm_dequant(x2, wq, xs2, ws2, spec)
    else:
        out = b.gemm(x2, wq, spec).float() * xs2 * ws2
    out = out.reshape(*lead, n)
    return out.to(out_dtype if out_dtype is not None else x.dtype)


def gemm_int(x_q: torch.Tensor, w_q: torch.Tensor, *, quant_mode: str = "int8_spoga",
             backend: Optional[str] = None) -> torch.Tensor:
    """Already-quantized (..., K) @ (K, N) -> (..., N) int32 accumulator.
    Leading dims flatten around the backend call (the kernels are 2-D)."""
    b, spec = resolve_backend(quant_mode, x_q.device.type, backend)
    lead = x_q.shape[:-1]
    k = x_q.shape[-1]
    acc = b.gemm(x_q.reshape(-1, k), w_q, spec)
    return acc.reshape(*lead, w_q.shape[-1])


def quant_mode_summary(quant_mode: str) -> str:
    """Human-readable one-liner for logs: 'w4a8: spoga, a8/w4, 2x1 planes of 4b'."""
    spec, family = parse_quant_mode(quant_mode)
    return (f"{quant_mode}: {family}, a{spec.a_bits}/w{spec.w_bits}, "
            f"{spec.n_a_slices}x{spec.n_w_slices} planes of {spec.slice_bits}b")
