"""The built-in GEMM backends of the port.

=======================  ====================================================
``cuda_spoga_dequant``   the fused SPOGA CUDA kernel with its dequant
                         epilogue (CUDA tensors)
``torch_spoga``          fused radix accumulation, algebraic twin (CPU)
``torch_deas``           prior-work baseline: materialized slice partials
``direct``               the plain integer product, no slicing
=======================  ====================================================

All are bit-exact against one another in int32 arithmetic.
"""

from __future__ import annotations

from repro_torch.backends.registry import GemmBackend, register_backend
from repro_torch.backends.spec import QuantSpec
from repro_torch.core import spoga as _spoga
from repro_torch.kernels.spoga_gemm_dequant import spoga_gemm_dequant


def _sliced(materialize):
    def gemm(x_q, w_q, spec: QuantSpec):
        return _spoga.sliced_matmul(
            x_q, w_q, n_x_slices=spec.n_a_slices, n_w_slices=spec.n_w_slices,
            slice_bits=spec.slice_bits, materialize=materialize)
    return gemm


def _direct_gemm(x_q, w_q, spec: QuantSpec):
    return _spoga.direct_matmul(x_q, w_q)


def _cuda_gemm_dequant(x_q, w_q, x_scale, w_scale, spec: QuantSpec):
    return spoga_gemm_dequant(
        x_q, w_q, x_scale, w_scale, n_x_slices=spec.n_a_slices,
        n_w_slices=spec.n_w_slices, slice_bits=spec.slice_bits)


def _int8_planes(spec: QuantSpec) -> bool:
    # the kernel multiplies int8 planes
    return spec.slice_bits <= 7


register_backend(GemmBackend(
    name="cuda_spoga_dequant", family="spoga",
    gemm_dequant=_cuda_gemm_dequant, supports=_int8_planes,
))
register_backend(GemmBackend(
    name="torch_spoga", family="spoga",
    gemm=_sliced(materialize=False),
))
register_backend(GemmBackend(
    name="torch_deas", family="deas",
    gemm=_sliced(materialize=True),
))
register_backend(GemmBackend(
    name="direct", family="direct", gemm=_direct_gemm,
))
