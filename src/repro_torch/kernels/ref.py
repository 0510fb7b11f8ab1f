"""Exact integer oracles for the GEMM kernels (port of ``repro/kernels/ref.py``).

Written apart from the kernels' plain versions (which run the float64
products of ``core/spoga.py``): the products here are int64 sums of
elementwise products over K, taken in chunks, and wrap to int32 mod 2^32
like the reference's int32 accumulator.  They serve the tests and the card
script, never the model's path.
"""

from __future__ import annotations

import torch

# elements of one chunk's (M, k, N) int64 product
_CHUNK_ELEMS = 1 << 26


def _int_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) -> int32 (M, N): int64 sums over chunks of K."""
    m, k = x.shape
    n = w.shape[1]
    step = max(1, _CHUNK_ELEMS // max(1, m * n))
    acc = torch.zeros((m, n), dtype=torch.int64, device=x.device)
    for k0 in range(0, k, step):
        xs = x[:, k0:k0 + step].to(torch.int64)
        ws = w[k0:k0 + step].to(torch.int64)
        acc += (xs[:, :, None] * ws[None, :, :]).sum(dim=1)
    return (torch.remainder(acc + (1 << 31), 1 << 32) - (1 << 31)).to(torch.int32)


def ref_int8_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Ground-truth int8 GEMM with int32 accumulation.  Every bit-sliced
    strategy (SPOGA fused, DEAS materialized) must equal it exactly."""
    return _int_dot(x, w)


def ref_spoga_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Algebraic twin of the fused kernel: nibble slices and the radix
    combine ``(mm << 8) + ((ml + lm) << 4) + ll``."""
    xm, xl = x >> 4, x & 15
    wm, wl = w >> 4, w & 15
    return ((_int_dot(xm, wm) << 8) + ((_int_dot(xm, wl) + _int_dot(xl, wm)) << 4)
            + _int_dot(xl, wl))


def ref_spoga_gemm_dequant(x, w, x_scale, w_scale):
    """W8A8 with the dequantizing epilogue: ``(x @ w) * x_scale * w_scale``, f32."""
    return ref_int8_gemm(x, w).to(torch.float32) * x_scale * w_scale
