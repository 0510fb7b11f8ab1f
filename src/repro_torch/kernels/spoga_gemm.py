"""SPOGA fused bit-sliced integer GEMM, int32 out: CUDA kernel + plain twin.

Port of ``repro/kernels/spoga_gemm.py``.  Layout: x (M, K) int8|int16,
w (K, N) int8|int16 -> out (M, N) int32, wrapping mod 2^32 like the
reference's int32 accumulator.  Slice counts are per operand: (2, 2, 4) is
W8A8, (2, 1, 4) serves ``w4a8``, (4, 4, 4) ``w16a16``; any
``slice_bits <= 7`` (int8 planes).

:func:`spoga_gemm` launches ``csrc/spoga_gemm.cu`` for CUDA tensors and
runs :func:`spoga_gemm_plain` for CPU tensors; there is no fallback
between the two.  ``LAUNCHES`` counts kernel launches and ``PLAIN_CALLS``
calls of the plain version.  ``"meta"`` tensors (the dry run,
``launch.dryrun``) hold no values, so nothing can launch on them: the
wrapper returns an empty meta result of the output's shape and dtype,
counts it in ``META_CALLS`` and reports the kernel's work to the dry
run's counters (``runtime.counters``), as the CPU branch does.
"""

from __future__ import annotations

import torch

from repro_torch.core.slicing import RADIX_BITS
from repro_torch.core.spoga import direct_matmul
from repro_torch.kernels import _build
from repro_torch.runtime import counters

LAUNCHES = 0
PLAIN_CALLS = 0
META_CALLS = 0

_INT_TYPES = (torch.int8, torch.int16)


def reset_counts() -> None:
    global LAUNCHES, PLAIN_CALLS, META_CALLS
    LAUNCHES = 0
    PLAIN_CALLS = 0
    META_CALLS = 0


def check_operands(name: str, x, w, slice_bits: int) -> None:
    """The dtype and shape checks of the sliced GEMM kernels."""
    if x.dtype not in _INT_TYPES or w.dtype not in _INT_TYPES:
        raise TypeError(f"{name} expects int8/int16 operands, got {x.dtype}, {w.dtype}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"expected x (M, K) and w (K, N), got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if not 1 <= slice_bits <= 7:
        raise ValueError(f"slice_bits must be in [1, 7] (int8 planes), got {slice_bits}")


def check_launchable(name: str, *tensors) -> None:
    """One device for every operand; CUDA tensors contiguous."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devices))}")
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}'s kernel takes contiguous tensors")


def spoga_gemm_plain(x, w):
    """The int32 product, wrapping mod 2^32 —
    ``repro/kernels/ref.py:ref_spoga_gemm`` (``direct_matmul``)."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    return direct_matmul(x, w)


def spoga_gemm(x, w, *, n_x_slices: int = 2, n_w_slices: int = 2,
               slice_bits: int = RADIX_BITS):
    """(M, K) @ (K, N) signed int -> (M, N) int32, SPOGA fused dataflow.

    Operands must honor their plane budget (``n * slice_bits`` bits), as
    the quantizer's clip guarantees."""
    global LAUNCHES, META_CALLS
    check_operands("spoga_gemm", x, w, slice_bits)
    if x.device.type == "meta":
        counters.check_meta("spoga_gemm", x, w)
        META_CALLS += 1
        with counters.gemm("spoga_gemm", x, w, torch.int32):
            return torch.empty((x.shape[0], w.shape[1]), dtype=torch.int32, device="meta")
    check_launchable("spoga_gemm", x, w)
    if x.device.type == "cpu":
        with counters.gemm("spoga_gemm", x, w, torch.int32):
            return spoga_gemm_plain(x, w)
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    err = _build.library().spoga_gemm_launch(
        x.data_ptr(), x.element_size(), w.data_ptr(), w.element_size(),
        out.data_ptr(), m, k, n, n_x_slices, n_w_slices, slice_bits,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "spoga_gemm")
    LAUNCHES += 1
    return out
