"""GemmBackend registry (the port of ``repro/backends/registry.py``).

A backend owns the integer GEMM and/or the fused dequantizing GEMM for a
:class:`~repro_torch.backends.spec.QuantSpec`.  A quantized linear
resolves its backend from the mode's dataflow family and the device of
its tensors alone: CUDA tensors run the CUDA kernel, CPU tensors the
plain algebraic twins.  A twin never serves a CUDA tensor — there is no
fallback that could hide a missing kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.backends.spec import QuantSpec, parse_quant_mode

__all__ = ["GemmBackend", "get_backend", "resolve_backend"]


@dataclasses.dataclass(frozen=True)
class GemmBackend:
    """One GEMM execution strategy.

    ``gemm(x_q, w_q, spec) -> int32 (M, N)`` and ``gemm_dequant(x_q, w_q,
    x_scale, w_scale, spec) -> f32 (M, N)``; a backend has at least one.
    """

    name: str
    family: str                      # "spoga" | "deas" | "direct"
    gemm: Optional[Callable] = None
    gemm_dequant: Optional[Callable] = None
    supports: Callable[[QuantSpec], bool] = lambda spec: True


_REGISTRY: dict[str, GemmBackend] = {}


def register_backend(backend: GemmBackend) -> GemmBackend:
    if backend.name in _REGISTRY:
        raise ValueError(f"backend {backend.name!r} already registered")
    if backend.gemm is None and backend.gemm_dequant is None:
        raise ValueError(f"backend {backend.name!r} has neither gemm nor gemm_dequant")
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> GemmBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown GEMM backend {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


# (family, device type) -> the backend that serves it
_AUTO = {
    ("spoga", "cuda"): "cuda_spoga_dequant",
    ("spoga", "cpu"): "torch_spoga",
    ("deas", "cpu"): "torch_deas",
    ("direct", "cpu"): "direct",
}


def resolve_backend(quant_mode: str, device_type: str) -> tuple[GemmBackend, QuantSpec]:
    """(mode, tensor device type) -> (backend, spec)."""
    spec, family = parse_quant_mode(quant_mode)
    name = _AUTO.get((family, device_type))
    if name is None:
        raise NotImplementedError(
            f"no {device_type} backend for the {family!r} dataflow of "
            f"{quant_mode!r}: its kernel is not ported yet (ROADMAP queue 2)")
    b = get_backend(name)
    if not b.supports(spec):
        raise ValueError(
            f"backend {b.name!r} does not support quant mode {quant_mode!r} (spec {spec})")
    return b, spec
