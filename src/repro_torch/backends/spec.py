"""Quantization execution specs: mode strings -> (bit widths, slicing plan).

The port's own copy of ``repro/backends/spec.py``. Mode strings are the
legacy W8A8 dataflow names ``int8_spoga`` / ``int8_deas`` / ``int8_direct``
and the parametric ``w{W}a{A}[_s{B}]`` names (all SPOGA family).
"""

from __future__ import annotations

import dataclasses
import re

import torch

QUANT_MODES = (
    "bf16",
    "int8_spoga",
    "int8_deas",
    "int8_direct",
    "w4a8",
    "w4a4",
    "w16a16",
)

_PARAMETRIC = re.compile(r"^w(\d+)a(\d+)(?:_s(\d+))?$")


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Bit widths + slicing plan for one quantized GEMM."""

    a_bits: int = 8        # activation operand width
    w_bits: int = 8        # weight operand width
    slice_bits: int = 4    # native slice width of the analog cores

    def __post_init__(self):
        for b in (self.a_bits, self.w_bits):
            if not 2 <= b <= 16:
                raise ValueError(f"operand widths must be in [2, 16], got {b}")
        if not 1 <= self.slice_bits <= 8:
            raise ValueError(f"slice_bits must be in [1, 8], got {self.slice_bits}")

    @property
    def n_a_slices(self) -> int:
        return -(-self.a_bits // self.slice_bits)

    @property
    def n_w_slices(self) -> int:
        return -(-self.w_bits // self.slice_bits)

    @property
    def a_dtype(self) -> torch.dtype:
        return torch.int8 if self.a_bits <= 8 else torch.int16

    @property
    def w_dtype(self) -> torch.dtype:
        return torch.int8 if self.w_bits <= 8 else torch.int16

    @property
    def a_qmax(self) -> float:
        return float(2 ** (self.a_bits - 1) - 1)

    @property
    def w_qmax(self) -> float:
        return float(2 ** (self.w_bits - 1) - 1)


DEFAULT_SPEC = QuantSpec()  # W8A8 on nibble slices — the paper's operating point


def parse_quant_mode(mode: str) -> tuple[QuantSpec, str]:
    """Mode string -> (QuantSpec, dataflow family); ValueError if unknown
    (including ``"bf16"``, which never reaches a GEMM backend)."""
    if mode == "int8_spoga":
        return DEFAULT_SPEC, "spoga"
    if mode == "int8_deas":
        return DEFAULT_SPEC, "deas"
    if mode == "int8_direct":
        return DEFAULT_SPEC, "direct"
    m = _PARAMETRIC.match(mode)
    if m:
        w_bits, a_bits = int(m.group(1)), int(m.group(2))
        slice_bits = int(m.group(3)) if m.group(3) else 4
        return QuantSpec(a_bits=a_bits, w_bits=w_bits, slice_bits=slice_bits), "spoga"
    raise ValueError(
        f"unknown quant mode {mode!r}: expected one of "
        f"{QUANT_MODES[1:]} or a parametric 'w<bits>a<bits>[_s<slice>]' string"
    )
