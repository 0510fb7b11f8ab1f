"""PTQ calibration: activation scales from sample batches (the port of
``repro/quant/calibrate.py``)."""

from __future__ import annotations

import torch

from repro_torch.quant.qtensor import INT8_MAX


def absmax_calibrate(samples: list[torch.Tensor], dim=None) -> torch.Tensor:
    """Max-abs over every calibration batch -> symmetric scale (f32): a
    0-d tensor per tensor, or per ``dim`` with the reduced dims kept."""
    if dim is None:
        absmax = max(float(s.float().abs().max()) for s in samples)
        return torch.tensor(max(absmax, 1e-8) / INT8_MAX, dtype=torch.float32)
    per_batch = [s.float().abs().amax(dim=dim, keepdim=True) for s in samples]
    absmax = torch.stack(per_batch).amax(dim=0)
    return torch.clamp_min(absmax, 1e-8) / INT8_MAX


def percentile_calibrate(samples: list[torch.Tensor], pct: float = 99.9) -> torch.Tensor:
    """Clip-at-percentile scale (robust to activation outliers); the
    percentile interpolates linearly between order statistics, as
    ``jnp.percentile`` does."""
    flat = torch.cat([s.float().abs().reshape(-1) for s in samples])
    absmax = torch.quantile(flat, pct / 100.0)
    return torch.clamp_min(absmax, 1e-8) / INT8_MAX
