"""SPOGA fused W8A8 GEMM with dequantizing epilogue: CUDA kernel + plain twin.

Port of ``repro/kernels/spoga_gemm_dequant.py``.  Layout: x (M, K)
int8|int16 with x_scale (M, 1) f32; w (K, N) int8|int16 with w_scale
(1, N) f32; out (M, N) f32 = (x @ w) * x_scale * w_scale.

:func:`spoga_gemm_dequant` launches ``csrc/spoga_gemm_dequant.cu`` for CUDA
tensors and runs :func:`spoga_gemm_dequant_plain` for CPU tensors; there is
no fallback between the two.  ``LAUNCHES`` counts kernel launches and
``PLAIN_CALLS`` calls of the plain version, so a run can show which one it
went through.
"""

from __future__ import annotations

import torch

from repro_torch.core.spoga import direct_matmul
from repro_torch.kernels import _build
from repro_torch.kernels.spoga_gemm import check_launchable, check_operands

LAUNCHES = 0
PLAIN_CALLS = 0


def reset_counts() -> None:
    global LAUNCHES, PLAIN_CALLS
    LAUNCHES = 0
    PLAIN_CALLS = 0


def spoga_gemm_dequant_plain(x, w, x_scale, w_scale):
    """The int32 product (wrapping mod 2^32), then ``(acc.f32 * x_scale) *
    w_scale`` — ``repro/kernels/ref.py:ref_spoga_gemm_dequant``."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    acc = direct_matmul(x, w)
    return acc.float() * x_scale * w_scale


def _check(x, w, x_scale, w_scale, slice_bits):
    check_operands("spoga_gemm_dequant", x, w, slice_bits)
    m, n = x.shape[0], w.shape[1]
    if tuple(x_scale.shape) != (m, 1) or tuple(w_scale.shape) != (1, n):
        raise ValueError(f"expected x_scale ({m}, 1) and w_scale (1, {n}), got "
                         f"{tuple(x_scale.shape)} and {tuple(w_scale.shape)}")
    if x_scale.dtype != torch.float32 or w_scale.dtype != torch.float32:
        raise TypeError("x_scale and w_scale must be float32")
    check_launchable("spoga_gemm_dequant", x, w, x_scale, w_scale)


def spoga_gemm_dequant(x, w, x_scale, w_scale, *, n_x_slices: int = 2,
                       n_w_slices: int = 2, slice_bits: int = 4):
    """(M,K) @ (K,N) int * (M,1) f32 * (1,N) f32 -> (M,N) f32, one fused pass.

    Slice counts are per operand: (2, 2, 4) is W8A8, (2, 1, 4) serves
    ``w4a8``, (4, 4, 4) ``w16a16``.  Operands must honor their plane budget
    (``n * slice_bits`` bits), as the quantizer's clip guarantees.
    """
    global LAUNCHES
    _check(x, w, x_scale, w_scale, slice_bits)
    if x.device.type == "cpu":
        return spoga_gemm_dequant_plain(x, w, x_scale, w_scale)
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    err = _build.library().spoga_gemm_dequant_launch(
        x.data_ptr(), x.element_size(), w.data_ptr(), w.element_size(),
        x_scale.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
        m, k, n, n_x_slices, n_w_slices, slice_bits,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "spoga_gemm_dequant")
    LAUNCHES += 1
    return out
