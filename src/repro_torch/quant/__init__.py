"""Symmetric integer quantization, fake quantization and calibration."""

from repro_torch.quant.calibrate import absmax_calibrate, percentile_calibrate
from repro_torch.quant.fake_quant import fake_quant
from repro_torch.quant.qtensor import (
    QTensor,
    dequantize,
    qmax_for_bits,
    quantize,
    rail_hits,
    storage_dtype,
)

__all__ = ["QTensor", "absmax_calibrate", "dequantize", "fake_quant", "percentile_calibrate",
           "qmax_for_bits", "quantize", "rail_hits", "storage_dtype"]
