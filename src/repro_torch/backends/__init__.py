"""GEMM backend registry and the quantized-linear pipeline of the port."""

from repro_torch.backends.pipeline import (
    dynamic_quant,
    effective_bits,
    gemm_int,
    quant_mode_summary,
    quantized_linear,
)
from repro_torch.backends.registry import (
    GemmBackend,
    get_backend,
    list_backends,
    resolve_backend,
)
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
    "gemm_int",
    "get_backend",
    "list_backends",
    "parse_quant_mode",
    "quant_mode_summary",
    "quantized_linear",
    "resolve_backend",
]
