"""GemmBackend registry (the port of ``repro/backends/registry.py``).

A backend owns the integer GEMM and/or the fused dequantizing GEMM for a
:class:`~repro_torch.backends.spec.QuantSpec`, and names the device types
whose tensors it serves.  A quantized linear resolves its backend so:

1. an explicit ``backend=`` override (threaded from ``ModelConfig
   .gemm_backend`` / ``QuantRuntime.gemm_backend``),
2. the process-wide default set by :func:`set_default_backend`,
3. else auto-selection by dataflow family and the tensors' device type:
   CUDA tensors run the CUDA kernels, CPU tensors the plain algebraic twins.

A ``cuda_*`` backend also serves CPU tensors: its kernel wrapper runs the
kernel's plain version there (how the CPU tests reach it).  A CPU twin
(``torch_*``, ``direct``) never serves CUDA tensors: asking for one there
raises, so there is no fallback that could hide a missing kernel.  That
holds for a default as for an override: a CPU twin set as the default
raises on CUDA tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.backends.spec import FAMILIES, QuantSpec, parse_quant_mode

__all__ = [
    "GemmBackend",
    "get_backend",
    "get_default_backend",
    "list_backends",
    "register_backend",
    "resolve_backend",
    "set_default_backend",
]


@dataclasses.dataclass(frozen=True)
class GemmBackend:
    """One GEMM execution strategy.

    ``gemm(x_q, w_q, spec) -> int32 (M, N)`` is mandatory;
    ``gemm_dequant(x_q, w_q, x_scale, w_scale, spec) -> f32 (M, N)`` is the
    fused epilogue.  When it is absent the pipeline composes ``gemm`` with
    the f32 epilogue (the same math, one (M, N) int32 round trip more).
    ``devices`` are the tensor device types it serves.
    """

    name: str
    family: str                      # "spoga" | "deas" | "direct"
    gemm: Callable
    devices: tuple = ("cpu",)
    gemm_dequant: Optional[Callable] = None
    supports: Callable[[QuantSpec], bool] = lambda spec: True


_REGISTRY: dict[str, GemmBackend] = {}
_DEFAULT_BACKEND: Optional[str] = None


def register_backend(backend: GemmBackend) -> GemmBackend:
    if backend.family not in FAMILIES:
        raise ValueError(f"backend {backend.name!r}: family must be one of {FAMILIES}, "
                         f"got {backend.family!r}")
    if backend.name in _REGISTRY:
        raise ValueError(f"backend {backend.name!r} already registered")
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> GemmBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown GEMM backend {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def list_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def set_default_backend(name: Optional[str]) -> None:
    """Process-wide backend, below an explicit override and above
    auto-selection.  ``None`` restores auto-selection; an unknown name
    raises here, not at the first GEMM."""
    global _DEFAULT_BACKEND
    if name is not None:
        get_backend(name)
    _DEFAULT_BACKEND = name


def get_default_backend() -> Optional[str]:
    return _DEFAULT_BACKEND


# (family, device type) -> the backend that serves it
_AUTO = {
    ("spoga", "cuda"): "cuda_spoga_dequant",
    ("deas", "cuda"): "cuda_deas",
    ("direct", "cuda"): "cuda_direct",
    ("spoga", "cpu"): "torch_spoga",
    ("deas", "cpu"): "torch_deas",
    ("direct", "cpu"): "direct",
    # "meta" tensors (the dry run) stand for the card's program
    ("spoga", "meta"): "cuda_spoga_dequant",
    ("deas", "meta"): "cuda_deas",
    ("direct", "meta"): "cuda_direct",
}


def resolve_backend(quant_mode: str, device_type: str,
                    backend: Optional[str] = None) -> tuple[GemmBackend, QuantSpec]:
    """(mode, tensor device type, optional override) -> (backend, spec)."""
    spec, family = parse_quant_mode(quant_mode)
    name = backend or _DEFAULT_BACKEND or _AUTO.get((family, device_type))
    if name is None:
        raise NotImplementedError(
            f"no {device_type} backend for the {family!r} dataflow of {quant_mode!r}")
    b = get_backend(name)
    if device_type not in b.devices:
        raise ValueError(
            f"backend {b.name!r} serves {'/'.join(b.devices)} tensors, not "
            f"{device_type}; CUDA tensors run a cuda_* backend")
    if not b.supports(spec):
        raise ValueError(
            f"backend {b.name!r} does not support quant mode {quant_mode!r} "
            f"(spec {spec}); pick one of {list_backends()}")
    return b, spec
