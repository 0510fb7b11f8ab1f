"""Base layers: norms, embeddings, the GLU MLP and the quantized linear.

Port of ``repro/models/layers.py`` (forward only).  Compute dtype is bf16;
weights are stored bf16 and norm scales f32.  Integer modes route through
the :mod:`repro_torch.backends` pipeline; ``"bf16"`` is a bf16 matmul.
"""

from __future__ import annotations

import torch

from repro_torch.backends import quantized_linear

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.bfloat16


def truncated_normal(gen: torch.Generator, device, shape, scale=0.02,
                     dtype=PARAM_DTYPE):
    """Normal truncated to [-2, 2], times ``scale`` (the reference's init
    distribution; a ``torch.Generator`` gives other numbers than
    ``jax.random`` for the same seed)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * scale).to(dtype)


def init_linear(gen, device, shape, scale=0.02):
    return truncated_normal(gen, device, shape, scale)


def linear(x, w, quant_mode: str = "bf16", backend=None):
    """The single matmul entry point for every model layer; bf16 out.

    ``backend`` is an optional GEMM-backend registry name (from
    ``ModelConfig.gemm_backend``); ``None`` defers to the registry's
    resolution order.  A quantized mode quantizes ``x`` as given: an f32
    input is not rounded to bf16 first (the reference's compiled graph
    drops that rounding too, see :func:`glu_mlp`)."""
    if quant_mode == "bf16":
        return torch.matmul(x.to(COMPUTE_DTYPE), w.to(COMPUTE_DTYPE))
    return quantized_linear(x, w, quant_mode, backend=backend, out_dtype=COMPUTE_DTYPE)


def rmsnorm(x, gamma, eps=1e-6, dtype=None):
    """RMS norm in f32, cast to ``dtype`` (default: ``x``'s dtype)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * gamma).to(dtype or x.dtype)


def _silu(x):
    """x * sigmoid(x) with sigmoid written out as 1 / (1 + exp(-x)), each op
    rounding to x's dtype — the reference's logistic expansion, so bf16
    activations round at the same places."""
    return x * torch.reciprocal(1 + torch.exp(-x))


_ACTS = {"silu": _silu, "gelu": torch.nn.functional.gelu, "relu": torch.relu}


def glu_mlp(x, p, act="silu", quant_mode="bf16", backend=None):
    """``down(act(gate(x)) * up(x))``.  The product is formed in f32 and
    quantized unrounded, as the reference's compiled graph does (XLA keeps
    the excess precision there); a bf16 matmul rounds it to the same bf16
    either way."""
    g = _ACTS[act](linear(x, p["w_gate"], quant_mode, backend))
    u = linear(x, p["w_up"], quant_mode, backend)
    return linear(g.float() * u.float(), p["w_down"], quant_mode, backend)


def embed(tokens, table):
    return table[tokens.long()].to(COMPUTE_DTYPE)


def unembed(x, table):
    """Output head kept in bf16 even in quantized modes (logits need full
    range); returns f32 logits of the bf16 product."""
    return torch.matmul(x.to(COMPUTE_DTYPE), table.to(COMPUTE_DTYPE).t()).float()


def rope_frequencies(head_dim, theta, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta=10_000.0):
    """x: (B, S, H, D); positions: (B, S) int."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)                  # (D/2,)
    angles = positions[..., None].float() * freqs                 # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
