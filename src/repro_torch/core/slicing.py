"""Bit-plane slicing (the port of ``repro/core/slicing.py``).

``slice_tc`` splits an int8 tensor into the paper's most and least
significant nibbles, ``x == 16 * msn + lsn``, in two's complement: a
signed high nibble in [-8, 7], an unsigned low one in [0, 15].
``slice_planes(x, n, b)`` splits a signed integer tensor into ``n`` planes
of ``b`` bits, least significant first: the lower planes are the unsigned
digits ``(x >> j*b) & (2^b - 1)``, the top plane is the arithmetically
shifted signed remainder ``x >> (n-1)*b``, so
``x == sum_j planes[j] << (j * b)`` exactly for any input.
"""

from __future__ import annotations

import torch

RADIX = 16  # one nibble
RADIX_BITS = 4

_SIGNED_INTS = (torch.int8, torch.int16, torch.int32, torch.int64)


def slice_tc(x: torch.Tensor) -> tuple:
    """Two's-complement nibbles of an int8 tensor: ``(x >> 4, x & 15)``,
    int8, the shift arithmetic."""
    if x.dtype != torch.int8:
        raise TypeError(f"slice_tc expects int8, got {x.dtype}")
    return x >> RADIX_BITS, x & (RADIX - 1)


def _plane_dtype(slice_bits: int) -> torch.dtype:
    # an unsigned plane spans [0, 2^b - 1]; int8 holds it up to b == 7
    return torch.int8 if slice_bits <= 7 else torch.int16


def slice_planes(x: torch.Tensor, n_slices: int, slice_bits: int) -> tuple:
    """Two's-complement decomposition into ``n_slices`` planes, LSB first.

    The top plane stays in the input dtype: it carries every remaining high
    bit, which keeps reconstruction exact even past the nominal budget.
    """
    if x.dtype not in _SIGNED_INTS:
        raise TypeError(f"slice_planes expects a signed integer tensor, got {x.dtype}")
    if n_slices < 1 or slice_bits < 1:
        raise ValueError(f"need n_slices >= 1 and slice_bits >= 1, got "
                         f"{n_slices}, {slice_bits}")
    out_dtype = _plane_dtype(slice_bits)
    mask = (1 << slice_bits) - 1
    planes = [((x >> (j * slice_bits)) & mask).to(out_dtype)
              for j in range(n_slices - 1)]
    planes.append(x >> ((n_slices - 1) * slice_bits))
    return tuple(planes)


def reconstruct_planes(planes, slice_bits: int) -> torch.Tensor:
    """Exact inverse of :func:`slice_planes` (accumulated in int64)."""
    acc = planes[0].to(torch.int64)
    for j, p in enumerate(planes[1:], start=1):
        acc = acc + (p.to(torch.int64) << (j * slice_bits))
    return acc
