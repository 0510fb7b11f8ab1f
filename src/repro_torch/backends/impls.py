"""The built-in GEMM backends of the port.

=======================  ====================================================
``cuda_spoga_dequant``   the fused SPOGA CUDA kernel with its dequant
                         epilogue; ``gemm`` is the int32 SPOGA kernel
                         (auto for ``spoga`` on CUDA tensors)
``cuda_spoga``           the int32 SPOGA CUDA kernel + the f32 epilogue
``cuda_deas``            the DEAS baseline kernels: four nibble GEMMs into
                         device memory, then the shift-add (W8A8 only;
                         auto for ``deas`` on CUDA tensors)
``cuda_direct``          the plain int8 product, ``torch._int_mm`` (auto for
                         ``direct`` on CUDA tensors; the reference computes
                         it with a plain ``dot_general``, outside Pallas)
``torch_spoga``          fused radix accumulation, algebraic twin (CPU)
``torch_deas``           prior-work baseline: materialized slice partials
``direct``               the plain integer product, no slicing (CPU)
=======================  ====================================================

The ``cuda_*`` backends serve CPU tensors too, through their wrappers'
plain versions, and ``"meta"`` tensors (the dry run), through their meta
branches.  All are bit-exact against one another in int32
arithmetic.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.backends.registry import GemmBackend, register_backend
from repro_torch.backends.spec import DEFAULT_SPEC, QuantSpec
from repro_torch.core import spoga as _spoga
from repro_torch.kernels.deas_gemm import deas_gemm
from repro_torch.kernels.spoga_gemm import spoga_gemm
from repro_torch.kernels.spoga_gemm_dequant import spoga_gemm_dequant

_CUDA_AND_CPU = ("cuda", "cpu", "meta")

# torch._int_mm calls of the ``cuda_direct`` backend on CUDA tensors
INT_MM_CALLS = 0


def _sliced(materialize):
    def gemm(x_q, w_q, spec: QuantSpec):
        return _spoga.sliced_matmul(
            x_q, w_q, n_x_slices=spec.n_a_slices, n_w_slices=spec.n_w_slices,
            slice_bits=spec.slice_bits, materialize=materialize)
    return gemm


def _direct_gemm(x_q, w_q, spec: QuantSpec):
    return _spoga.direct_matmul(x_q, w_q)


def _roundup(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm_padded(x, w):
    """int8 (M, K) @ int8 (K, N) -> int32 through ``torch._int_mm``.

    On CUDA ``_int_mm`` takes M > 16 and K, N multiples of 8: the operands
    are zero-padded up to that (exact for an integer product) and the
    result cut back to (M, N)."""
    m, k = x.shape
    n = w.shape[1]
    mp, kp, np_ = max(_roundup(m, 8), 24), _roundup(k, 8), _roundup(n, 8)
    if (mp, kp) != (m, k):
        x = F.pad(x, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        w = F.pad(w, (0, np_ - n, 0, kp - k))
    return torch._int_mm(x.contiguous(), w.contiguous())[:m, :n]


def _cuda_direct_gemm(x_q, w_q, spec: QuantSpec):
    global INT_MM_CALLS
    if x_q.device.type == "cpu":
        return _spoga.direct_matmul(x_q, w_q)
    if x_q.device.type == "cuda":
        INT_MM_CALLS += 1
    return int_mm_padded(x_q, w_q)


def _cuda_gemm(x_q, w_q, spec: QuantSpec):
    return spoga_gemm(x_q, w_q, n_x_slices=spec.n_a_slices,
                      n_w_slices=spec.n_w_slices, slice_bits=spec.slice_bits)


def _cuda_gemm_dequant(x_q, w_q, x_scale, w_scale, spec: QuantSpec):
    return spoga_gemm_dequant(
        x_q, w_q, x_scale, w_scale, n_x_slices=spec.n_a_slices,
        n_w_slices=spec.n_w_slices, slice_bits=spec.slice_bits)


def _cuda_deas_gemm(x_q, w_q, spec: QuantSpec):
    return deas_gemm(x_q, w_q)


def _int8_planes(spec: QuantSpec) -> bool:
    # the kernels multiply int8 planes
    return spec.slice_bits <= 7


def _int8_operands(spec: QuantSpec) -> bool:
    return spec.a_dtype == torch.int8 and spec.w_dtype == torch.int8


register_backend(GemmBackend(
    name="cuda_spoga_dequant", family="spoga", devices=_CUDA_AND_CPU,
    gemm=_cuda_gemm, gemm_dequant=_cuda_gemm_dequant, supports=_int8_planes,
))
register_backend(GemmBackend(
    name="cuda_spoga", family="spoga", devices=_CUDA_AND_CPU,
    gemm=_cuda_gemm, supports=_int8_planes,
))
register_backend(GemmBackend(
    name="cuda_deas", family="deas", devices=_CUDA_AND_CPU,
    gemm=_cuda_deas_gemm, supports=lambda spec: spec == DEFAULT_SPEC,
))
register_backend(GemmBackend(
    name="cuda_direct", family="direct", devices=_CUDA_AND_CPU,
    gemm=_cuda_direct_gemm, supports=_int8_operands,
))
register_backend(GemmBackend(
    name="torch_spoga", family="spoga", gemm=_sliced(materialize=False),
))
register_backend(GemmBackend(
    name="torch_deas", family="deas", gemm=_sliced(materialize=True),
))
register_backend(GemmBackend(
    name="direct", family="direct", gemm=_direct_gemm,
))
