"""The quantized-linear pipeline: quantize -> GEMM -> dequant, one place.

Port of ``repro/backends/pipeline.py``.  Activations quantize per row and
weights per output channel — on every call, as in the reference — to the
spec's (accumulator-aware) widths; leading dims flatten into the (M, K)
layout the kernels take; the resolved backend runs its fused
``gemm_dequant`` when it has one, else ``gemm`` plus the same f32
epilogue.  (The reference's numerics watchdog hook is not ported yet.)
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.backends import impls  # noqa: F401  (populates the registry)
from repro_torch.backends.registry import resolve_backend
from repro_torch.backends.spec import parse_quant_mode
from repro_torch.quant.qtensor import quantize

__all__ = ["ACC_BITS", "dynamic_quant", "effective_bits", "gemm_int",
           "quant_mode_summary", "quantized_linear"]

ACC_BITS = 32  # the kernels accumulate in int32


def dynamic_quant(x: torch.Tensor, dim, bits: int = 8):
    """Symmetric dynamic quantization to ``bits`` -> ``(q, scale)``."""
    return quantize(x, dim=dim, bits=bits)


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


def quantized_linear(x: torch.Tensor, w: torch.Tensor, quant_mode: str, *,
                     backend: Optional[str] = None,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (..., K) fp @ w (K, N) fp -> (..., N) fp via the quantized pipeline,
    on ``backend`` (a registry name) or, by default, the backend that
    serves ``x``'s device."""
    b, spec = resolve_backend(quant_mode, x.device.type, backend)
    a_bits, w_bits = effective_bits(spec, x.shape[-1])
    xq, xs = dynamic_quant(x, dim=-1, bits=a_bits)
    wq, ws = dynamic_quant(w, dim=0, bits=w_bits)
    xq = xq.to(spec.a_dtype)
    wq = wq.to(spec.w_dtype)

    lead = xq.shape[:-1]
    k = xq.shape[-1]
    n = wq.shape[-1]
    x2 = xq.reshape(-1, k)
    xs2 = xs.reshape(-1, 1)
    ws2 = ws.reshape(1, n)
    if b.gemm_dequant is not None:
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
