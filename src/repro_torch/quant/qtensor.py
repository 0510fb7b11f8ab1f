"""Quantized tensor container and symmetric integer quantization (the
port of ``repro/quant/qtensor.py``).

``x ~= data * scale`` with ``scale = max(absmax, 1e-8) / qmax`` and
``qmax = 2^(bits-1) - 1``; values round half to even (``torch.round``, as
``jnp.round``) and clip to ±qmax.  Storage is int8 up to 8 bits, int16
above.  The division by the constant ``qmax`` is written as a multiply by
its f32 reciprocal, which is what XLA compiles the reference's division
to; the scales, and so the quantized values, then match bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

INT8_MAX = 127.0


def qmax_for_bits(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def storage_dtype(bits: int) -> torch.dtype:
    return torch.int8 if bits <= 8 else torch.int16


@dataclasses.dataclass
class QTensor:
    """Signed-int data + broadcastable f32 scale (``x ~= data * scale``)."""

    data: torch.Tensor   # int8 (bits <= 8) or int16
    scale: torch.Tensor  # f32, broadcastable against ``data``

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return (self.data.float() * self.scale).to(dtype)


def scale_of_absmax(absmax: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """The symmetric scale of an f32 ``absmax``: ``max(absmax, 1e-8) /
    qmax``.  A row-parallel GEMM feeds it the absmax its ranks agreed on
    (a MAX all-reduce), so the scale is the unsharded one bit for bit."""
    return torch.clamp_min(absmax, 1e-8) * (1.0 / qmax_for_bits(bits))


def _absmax_scale(x: torch.Tensor, dim, bits: int = 8) -> torch.Tensor:
    return scale_of_absmax(x.float().abs().amax(dim=dim, keepdim=True), bits)


def quantize(x: torch.Tensor, dim=None, scale: torch.Tensor | None = None,
             bits: int = 8) -> QTensor:
    """Symmetric integer quantization -> :class:`QTensor`.

    ``dim``: reduction dim(s) for the absmax (``0`` for per-output-channel
    weights ``(K, N)``; ``-1`` for per-row activations); ``None`` means
    per-tensor.  A precomputed calibration ``scale`` wins.  ``bits``:
    operand width; values clip to ±(2^(bits-1)-1).  The scale keeps the
    reduced dims with size 1.
    """
    qmax = qmax_for_bits(bits)
    xf = x.float()
    if scale is None:
        if dim is None:
            dim = tuple(range(x.ndim))
        scale = _absmax_scale(xf, dim, bits)
    data = torch.round(xf / scale).clamp_(-qmax, qmax)
    return QTensor(data.to(storage_dtype(bits)), scale)


def dequantize(q: QTensor, dtype=torch.float32) -> torch.Tensor:
    return q.dequantize(dtype)


def rail_hits(data: torch.Tensor, bits: int) -> torch.Tensor:
    """Count of quantized values sitting on the ±qmax rail (a 0-d int64
    tensor on ``data``'s device).  Integer ``data`` is compared as it is
    stored (exact, and a quarter of the bytes of an f32 copy).

    With dynamic absmax scaling the largest-magnitude element maps exactly
    onto ±qmax, so true clipping never occurs; at-rail occupancy is the
    saturation signal all the same: a distribution crowding the rail is
    one re-quantization (or one calibrated static scale) away from
    clipping.  Used by the numerics watchdog."""
    return (data.abs() >= qmax_for_bits(bits)).sum()
