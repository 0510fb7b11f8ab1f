"""Bit-sliced integer GEMM dataflows (the port of ``repro/core/spoga.py``).

The algebraic reference the CPU backends run, after the paper's Fig. 2:

* :func:`direct_matmul` — the plain integer product, int32 out;
* :func:`sliced_matmul` — every operand split into bit planes, every plane
  pair multiplied, the partials grouped into ``i + j`` radix lanes and each
  lane shifted once into one accumulator (SPOGA); ``materialize=True``
  keeps every partial as its own tensor before the combine (the DEAS
  prior-work baseline — eager execution materializes them anyway);
  :func:`spoga_matmul` / :func:`deas_matmul` are its W8A8 nibble cases and
  :func:`spoga_dot_slices` the combine of given nibbles;
* :func:`quantized_matmul` — the integer product through the backend
  registry (``backends.gemm_int``) plus the dequantizing epilogue.

All are exactly equal in int32 arithmetic, wrapping mod 2^32 like the
reference's int32 accumulators.  PyTorch has no int32 matrix product on
CUDA, so products run in float64, which is exact while every partial sum
stays below 2^53 (K * 2^30 for int16 x int16 operands, so K < 2^23).
"""

from __future__ import annotations

import torch

from repro_torch.core.slicing import RADIX_BITS, slice_planes

__all__ = ["deas_matmul", "direct_matmul", "int_matmul", "quantized_matmul",
           "sliced_dot_planes", "sliced_matmul", "spoga_dot_slices", "spoga_matmul",
           "wrap_int32"]

_TWO32 = 1 << 32
_TWO31 = 1 << 31


def wrap_int32(t: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap-around (mod 2^32)."""
    return (torch.remainder(t + _TWO31, _TWO32) - _TWO31).to(torch.int32)


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer (M, K) @ (K, N) -> int64 (no wrap), via float64."""
    return torch.round(a.double() @ b.double()).to(torch.int64)


def direct_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Native integer GEMM with int32 accumulation (no slicing)."""
    return wrap_int32(int_matmul(x, w))


def sliced_dot_planes(x_planes, w_planes, slice_bits: int, *, dot_fn=None,
                      materialize: bool = False) -> torch.Tensor:
    """``O = sum_{i,j} (Xp_i . Wp_j) << ((i + j) * slice_bits)``, int32 out.

    Plane pairs are grouped into ``i + j`` radix lanes; each lane is summed,
    then shifted once.  The combine runs in int64 and wraps to int32 once
    at the end, which equals the reference's int32 wrap-around arithmetic.
    ``dot_fn`` (exact, int64 out) defaults to :func:`int_matmul`; the MoE
    grouped GEMM passes its expert-batched product.
    """
    dot = dot_fn or int_matmul
    lanes: dict[int, list] = {}
    for i, xp in enumerate(x_planes):
        for j, wp in enumerate(w_planes):
            lanes.setdefault(i + j, []).append(dot(xp, wp))
    if materialize:
        # every partial is already its own tensor; clone pins it as a
        # separate buffer before any combine touches it
        lanes = {lane: [p.clone() for p in ps] for lane, ps in lanes.items()}
    acc = None
    for lane in sorted(lanes):
        group = lanes[lane][0]
        for p in lanes[lane][1:]:
            group = group + p
        term = group << (lane * slice_bits) if lane else group
        acc = term if acc is None else acc + term
    return wrap_int32(acc)


def sliced_matmul(x: torch.Tensor, w: torch.Tensor, *, n_x_slices: int = 2,
                  n_w_slices: int = 2, slice_bits: int = 4,
                  materialize: bool = False) -> torch.Tensor:
    """Bit-sliced integer GEMM with arbitrary plane counts, int32 out."""
    xp = slice_planes(x, n_x_slices, slice_bits)
    wp = slice_planes(w, n_w_slices, slice_bits)
    return sliced_dot_planes(xp, wp, slice_bits, materialize=materialize)


def spoga_dot_slices(xm, xl, wm, wl) -> torch.Tensor:
    """The four nibble partial GEMMs, radix-weighted in one accumulator:
    ``O = (Xm.Wm << 8) + ((Xm.Wl + Xl.Wm) << 4) + Xl.Wl``, int32 out."""
    return sliced_dot_planes((xl, xm), (wl, wm), RADIX_BITS)


def spoga_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Fused nibble-sliced int8 GEMM (the paper's SPOGA dataflow), int32 out."""
    return sliced_matmul(x, w, slice_bits=RADIX_BITS)


def deas_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Prior-work baseline: four separate nibble GEMMs, each kept as its own
    tensor, then the shift-and-add over the stored partials."""
    return sliced_matmul(x, w, slice_bits=RADIX_BITS, materialize=True)


def quantized_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                     w_scale: torch.Tensor, *, mode: str = "int8_spoga",
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """W8A8 GEMM with dequantizing epilogue.

    ``x_q`` (..., K) int8 with row scales ``x_scale`` (..., 1); ``w_q``
    (K, N) int8 with per-output-channel scales ``w_scale`` (N,) or (1, N).
    The integer product goes through the backend registry
    (``backends.gemm_int``, imported lazily: backends builds on this
    module), so the mode strings that configure model layers pick the
    dataflow here too."""
    from repro_torch.backends import gemm_int  # lazy: avoids the import cycle

    acc = gemm_int(x_q, w_q, quant_mode=mode)
    ws = w_scale.reshape((1,) * (acc.ndim - 1) + (-1,))
    return (acc.float() * x_scale * ws).to(out_dtype)
