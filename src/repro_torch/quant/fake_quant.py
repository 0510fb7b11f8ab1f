"""QAT fake quantization with straight-through gradients (the port of
``repro/quant/fake_quant.py``).

``fake_quant`` simulates the SPOGA int8 datapath in the forward pass while
passing gradients straight through, so a model can be trained "on" the
accelerator numerics.
"""

from __future__ import annotations

import torch

from repro_torch.quant.qtensor import INT8_MAX, _absmax_scale


def fake_quant(x: torch.Tensor, dim=-1) -> torch.Tensor:
    """Round-trip ``x`` through symmetric int8 along ``dim``; identity
    gradient (STE), as the reference's ``x + stop_gradient(dq - x)``."""
    scale = _absmax_scale(x, dim).detach()
    q = torch.clamp(torch.round(x.detach() / scale), -INT8_MAX, INT8_MAX)
    return x + (q * scale - x).detach()
