"""Prior-work (DEAS) bit-sliced W8A8 GEMM: CUDA kernels + plain twin.

Port of ``repro/kernels/deas_gemm.py``, the paper's Fig. 2(a) baseline
that SPOGA replaces.  x (M, K) int8 @ w (K, N) int8 -> (M, N) int32:

1. both operands are sliced into two's-complement nibble planes with torch
   ops (``t >> 4``, signed in [-8, 7]; ``t & 15``, unsigned in [0, 15]),
   as the reference slices outside Pallas;
2. four separate ``nibble_gemm`` launches (``csrc/deas_gemm.cu``) write
   the partials mm, ml, lm, ll into four distinct int32 (M, N) buffers
   in device memory: one photonic core + its ADCs + its store each;
3. one ``deas_combine`` launch re-reads all four and shift-adds them:
   ``(mm << 8) + ((ml + lm) << 4) + ll``, wrapping mod 2^32.

It stays unfused on purpose: the extra ``8 * M * N * 4`` bytes of
intermediate traffic are the overhead the paper removes.

:func:`deas_gemm` launches the kernels for CUDA tensors and runs
:func:`deas_gemm_plain` for CPU tensors; there is no fallback between the
two.  :func:`nibble_gemm` and :func:`deas_combine` are the wrappers of the
two kernels, each beside its plain version.  ``CALLS`` counts
``deas_gemm`` calls that launched, ``NIBBLE_LAUNCHES`` and
``COMBINE_LAUNCHES`` the launches of each kernel (4 and 1 per call), and
``PLAIN_CALLS`` calls of any plain version.
"""

from __future__ import annotations

import torch

from repro_torch.core.slicing import RADIX_BITS, slice_tc
from repro_torch.core.spoga import deas_matmul, direct_matmul, wrap_int32
from repro_torch.kernels import _build
from repro_torch.kernels.spoga_gemm import check_launchable

CALLS = 0
NIBBLE_LAUNCHES = 0
COMBINE_LAUNCHES = 0
PLAIN_CALLS = 0


def reset_counts() -> None:
    global CALLS, NIBBLE_LAUNCHES, COMBINE_LAUNCHES, PLAIN_CALLS
    CALLS = NIBBLE_LAUNCHES = COMBINE_LAUNCHES = PLAIN_CALLS = 0


def deas_gemm_plain(x, w):
    """Four materialized nibble products, then the shift-add, wrapping to
    int32 — ``repro/core/spoga.py:deas_matmul``."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    return deas_matmul(x, w)


def nibble_gemm_plain(a, b):
    """One plane product, int32 out (``direct_matmul``)."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    return direct_matmul(a, b)


def deas_combine_plain(mm, ml, lm, ll):
    """``(mm << 8) + ((ml + lm) << 4) + ll``, wrapping to int32."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    wide = [t.to(torch.int64) for t in (mm, ml, lm, ll)]
    return wrap_int32((wide[0] << (2 * RADIX_BITS)) + ((wide[1] + wide[2]) << RADIX_BITS)
                      + wide[3])


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def nibble_gemm(a, b):
    """One nibble-plane product (M, K) int8 @ (K, N) int8 -> a fresh int32
    (M, N) buffer: one ``nibble_gemm`` launch on CUDA tensors."""
    global NIBBLE_LAUNCHES
    _check_int8("nibble_gemm", a, b)
    if a.device.type == "cpu":
        return nibble_gemm_plain(a, b)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    err = _build.library().nibble_gemm_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, _stream(a))
    _build.check(err, "nibble_gemm")
    NIBBLE_LAUNCHES += 1
    return out


def deas_combine(mm, ml, lm, ll):
    """The DEAS shift-add over four stored int32 (M, N) partials: one
    ``deas_combine`` launch on CUDA tensors, on 16-byte vectors when every
    partial is 16-byte aligned (a fresh ``torch.empty`` output always is),
    element by element otherwise."""
    global COMBINE_LAUNCHES
    parts = (mm, ml, lm, ll)
    if any(t.dtype != torch.int32 or t.shape != mm.shape or t.ndim != 2 for t in parts):
        raise ValueError("deas_combine expects four int32 (M, N) partials of one shape")
    check_launchable("deas_combine", *parts)
    if mm.device.type == "cpu":
        return deas_combine_plain(*parts)
    m, n = mm.shape
    out = torch.empty((m, n), dtype=torch.int32, device=mm.device)
    vectorized = int(all(t.data_ptr() % 16 == 0 for t in (*parts, out)))
    err = _build.library().deas_combine_launch(
        *(t.data_ptr() for t in parts), out.data_ptr(), m, n, vectorized, _stream(mm))
    _build.check(err, "deas_combine")
    COMBINE_LAUNCHES += 1
    return out


def _check_int8(name, x, w):
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"{name} expects int8 operands, got {x.dtype}, {w.dtype}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"expected x (M, K) and w (K, N), got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    check_launchable(name, x, w)


def deas_gemm(x, w):
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32 via 4 materialized slices."""
    global CALLS
    _check_int8("deas_gemm", x, w)
    if x.device.type == "cpu":
        return deas_gemm_plain(x, w)
    xm, xl = slice_tc(x)
    wm, wl = slice_tc(w)
    # four separate cores -> four device-resident intermediate matrices
    partials = (nibble_gemm(xm, wm), nibble_gemm(xm, wl),
                nibble_gemm(xl, wm), nibble_gemm(xl, wl))
    out = deas_combine(*partials)
    CALLS += 1
    return out
