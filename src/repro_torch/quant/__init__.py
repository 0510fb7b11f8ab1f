"""Symmetric integer quantization for the port."""

from repro_torch.quant.qtensor import qmax_for_bits, quantize, rail_hits, storage_dtype

__all__ = ["qmax_for_bits", "quantize", "rail_hits", "storage_dtype"]
