"""Symmetric integer quantization (the port of ``repro/quant/qtensor.py``).

``x ~= data * scale`` with ``scale = max(absmax, 1e-8) / qmax`` and
``qmax = 2^(bits-1) - 1``; values round half to even (``torch.round``, as
``jnp.round``) and clip to ±qmax.  Storage is int8 up to 8 bits, int16
above.  The division by the constant ``qmax`` is written as a multiply by
its f32 reciprocal, which is what XLA compiles the reference's division
to; the scales, and so the quantized values, then match bit for bit.
"""

from __future__ import annotations

import torch

def qmax_for_bits(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def storage_dtype(bits: int) -> torch.dtype:
    return torch.int8 if bits <= 8 else torch.int16


def quantize(x: torch.Tensor, dim=None, bits: int = 8):
    """Symmetric integer quantization -> ``(data, scale)``.

    ``dim``: reduction dim(s) for the absmax (``0`` for per-output-channel
    weights ``(K, N)``; ``-1`` for per-row activations); ``None`` means
    per-tensor.  ``scale`` keeps the reduced dims with size 1.
    """
    qmax = qmax_for_bits(bits)
    xf = x.float()
    if dim is None:
        dim = tuple(range(x.ndim))
    absmax = xf.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp_min(absmax, 1e-8) * (1.0 / qmax)
    data = torch.round(xf / scale).clamp_(-qmax, qmax)
    return data.to(storage_dtype(bits)), scale
