"""Dispatch wrappers over the GEMM backend registry.

Port of ``repro/kernels/ops.py``.  ``int8_gemm(x, w, mode=...)`` and
``int8_gemm_dequant(...)`` map the call onto a registered backend: the
mode names the dataflow (``int8_spoga`` -> ``cuda_spoga``, ``int8_deas`` ->
``cuda_deas``, ``int8_direct`` -> ``cuda_direct``) and the tensors'
device picks kernel or plain version (CUDA tensors launch the kernels,
CPU tensors run their plain versions).  The reference's ``use_pallas`` and
``interpret`` flags have no counterpart: a CUDA kernel has no interpreter,
and the device, not a flag, decides whether it runs.
"""

from __future__ import annotations

MODES = ("int8_spoga", "int8_deas", "int8_direct")

_BACKENDS = {"int8_spoga": "cuda_spoga", "int8_deas": "cuda_deas",
             "int8_direct": "cuda_direct"}


def int8_gemm(x, w, *, mode: str = "int8_spoga"):
    """INT8 (M, K) @ (K, N) -> int32 (M, N) under the selected dataflow."""
    from repro_torch.backends import gemm_int  # lazy: backends imports kernels

    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return gemm_int(x, w, quant_mode=mode, backend=_BACKENDS[mode])


def int8_gemm_dequant(x, w, x_scale, w_scale):
    """W8A8 GEMM + dequantizing epilogue in one fused pass (f32 out): the
    ``spoga_gemm_dequant`` kernel on CUDA tensors, its plain version on CPU
    tensors."""
    from repro_torch.backends import resolve_backend

    backend, spec = resolve_backend("int8_spoga", x.device.type, "cuda_spoga_dequant")
    return backend.gemm_dequant(x, w, x_scale, w_scale, spec)
