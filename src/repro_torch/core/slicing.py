"""Bit-plane slicing (the port of ``repro/core/slicing.py``).

``slice_tc`` splits an int8 tensor into the paper's most and least
significant nibbles, ``x == 16 * msn + lsn``, in two's complement: a
signed high nibble in [-8, 7], an unsigned low one in [0, 15].
``slice_sm`` is the paper's sign-magnitude encoding (the + and - optical
lanes): the sign folded into both magnitude nibbles, ``msn`` in [-8, 7]
(-8 only for -128), ``lsn`` in [-15, 15], still ``x == 16 * msn + lsn``;
``slice_nibbles(x, encoding)`` picks one, and ``reconstruct`` inverts
either exactly for the whole int8 range, -128 included.
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


def slice_sm(x: torch.Tensor) -> tuple:
    """Sign-magnitude nibbles of an int8 tensor: ``sign(x) * (|x| >> 4)``
    and ``sign(x) * (|x| & 15)``, int8.  The magnitude is taken in int32,
    so ``|-128|`` does not overflow."""
    if x.dtype != torch.int8:
        raise TypeError(f"slice_sm expects int8, got {x.dtype}")
    wide = x.to(torch.int32)
    sign, mag = torch.sign(wide), wide.abs()
    return ((sign * (mag >> RADIX_BITS)).to(torch.int8),
            (sign * (mag & (RADIX - 1))).to(torch.int8))


def slice_nibbles(x: torch.Tensor, encoding: str = "tc") -> tuple:
    """``(msn, lsn)`` of an int8 tensor in ``encoding`` ``"tc"`` or ``"sm"``."""
    if encoding == "tc":
        return slice_tc(x)
    if encoding == "sm":
        return slice_sm(x)
    raise ValueError(f"unknown slicing encoding {encoding!r}")


def reconstruct(msn: torch.Tensor, lsn: torch.Tensor) -> torch.Tensor:
    """Exact inverse of either nibble slicing: ``16 * msn + lsn`` in int32,
    cast to int8."""
    return (msn.to(torch.int32) * RADIX + lsn.to(torch.int32)).to(torch.int8)


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
