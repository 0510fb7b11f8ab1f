"""GEMM backend registry and the quantized-linear pipeline of the port."""

from repro_torch.backends.pipeline import dynamic_quant, effective_bits, quantized_linear
from repro_torch.backends.registry import GemmBackend, get_backend, resolve_backend
from repro_torch.backends.spec import (
    DEFAULT_SPEC,
    QUANT_MODES,
    QuantSpec,
    parse_quant_mode,
)

__all__ = [
    "DEFAULT_SPEC",
    "GemmBackend",
    "QUANT_MODES",
    "QuantSpec",
    "dynamic_quant",
    "effective_bits",
    "get_backend",
    "parse_quant_mode",
    "quantized_linear",
    "resolve_backend",
]
