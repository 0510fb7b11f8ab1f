"""Base layers: norms, embeddings, the MLPs and the quantized linear.

Port of ``repro/models/layers.py``.  Compute dtype is bf16; weights are
stored bf16 and norm scales f32.  Integer modes route through the
:mod:`repro_torch.backends` pipeline (on the card, the hand-written GEMM
kernels) with a straight-through backward (:class:`_QuantizedLinearSTE`);
``"bf16"`` is a bf16 matmul.

Inside ``runtime.collectives.model_parallel`` (a tensor-parallel mesh)
the layers hold their rank's part of the weights: column-parallel
projections need nothing more (the activation is whole, each output
column's scale local), row-parallel ones (``linear(..., row=True)``: wo,
w_down, w_out) sum across ranks, and the vocab-parallel ``embed`` and
``unembed`` finish with a SUM all-reduce and an all-gather.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.backends import quantized_linear
from repro_torch.runtime.collectives import all_gather, all_reduce, model_axis

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.bfloat16


def truncated_normal_init(gen: torch.Generator, device, shape, scale=0.02,
                          dtype=PARAM_DTYPE):
    """Normal truncated to [-2, 2], times ``scale`` (the reference's init
    distribution; a ``torch.Generator`` gives other numbers than
    ``jax.random`` for the same seed)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * scale).to(dtype)


def init_linear(gen, device, shape, scale=0.02):
    return truncated_normal_init(gen, device, shape, scale)


def init_embedding(gen, device, vocab: int, d_model: int):
    """A (vocab, d_model) table, ``d_model ** -0.5`` times the truncated
    normal, bf16."""
    return truncated_normal_init(gen, device, (vocab, d_model), scale=1.0 / (d_model ** 0.5))


class _QuantizedLinearSTE(torch.autograd.Function):
    """The reference's ``_qmatmul_ste``: the quantized GEMM forward, and a
    straight-through backward, as if the matmul were full precision
    (``_qmatmul_bwd``): ``g`` in f32, ``dx = g @ w^T`` and ``dw = x^T @ g``
    (leading dims flattened) as f32 products, ``dw`` cast to ``w``'s dtype.

    The reference calls its STE on ``x.astype(bf16)``.  Its compiled graph
    quantizes an f32 ``x`` unrounded in the forward (see :func:`linear`),
    but the residual it keeps for the backward is the bf16 one, and ``dx``
    leaves the STE as bf16 before the cast back to ``x``'s dtype: both
    roundings are mirrored here (held against the jitted ``jax.vjp`` in
    ``tests/test_torch_train.py``).  The forward is ``quantized_linear``
    itself, so on the card it launches the GEMM kernel; the backward
    launches none and stages nothing for the numerics watchdog."""

    @staticmethod
    def forward(ctx, x, w, quant_mode, backend):
        ctx.save_for_backward(x.to(COMPUTE_DTYPE), w)
        ctx.x_dtype = x.dtype
        return quantized_linear(x, w, quant_mode, backend=backend, out_dtype=COMPUTE_DTYPE)

    @staticmethod
    def backward(ctx, g):
        xb, w = ctx.saved_tensors
        gf = g.float()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(gf, w.float().t()).to(COMPUTE_DTYPE).to(ctx.x_dtype)
        if ctx.needs_input_grad[1]:
            x2 = xb.reshape(-1, xb.shape[-1]).float()
            dw = torch.matmul(x2.t(), gf.reshape(-1, gf.shape[-1])).to(w.dtype)
        return dx, dw, None, None


def linear(x, w, quant_mode: str = "bf16", backend=None, row: bool = False):
    """The single matmul entry point for every model layer; bf16 out.

    ``backend`` is an optional GEMM-backend registry name (from
    ``ModelConfig.gemm_backend``); ``None`` defers to the registry's
    resolution order.  A quantized mode quantizes ``x`` as given: an f32
    input is not rounded to bf16 first (the reference's compiled graph
    drops that rounding too, see :func:`glu_mlp`).  Its gradients are the
    straight-through ones (:class:`_QuantizedLinearSTE`).

    ``row``: the projection is row-parallel on a tensor-parallel mesh
    (``x`` and ``w`` hold this rank's K slice).  Integer modes then run
    ``quantized_linear``'s row-parallel form, bitwise the unsharded
    product; bf16 sums the ranks' f32 partial products and rounds once,
    which is allclose to the unsharded bf16 product, not bitwise."""
    ax = model_axis() if row else None
    if ax is not None:
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            raise NotImplementedError("tensor-parallel training is not ported yet "
                                      "(ROADMAP queue 1, item 10.2)")
        if quant_mode == "bf16":
            part = torch.matmul(x.to(COMPUTE_DTYPE).float(), w.to(COMPUTE_DTYPE).float())
            return all_reduce(part, ax, "sum").to(COMPUTE_DTYPE)
        return quantized_linear(x, w, quant_mode, backend=backend, out_dtype=COMPUTE_DTYPE,
                                row_axis=ax)
    if quant_mode == "bf16":
        return torch.matmul(x.to(COMPUTE_DTYPE), w.to(COMPUTE_DTYPE))
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _QuantizedLinearSTE.apply(x, w, quant_mode, backend)
    return quantized_linear(x, w, quant_mode, backend=backend, out_dtype=COMPUTE_DTYPE)


def init_rmsnorm(d: int, device=None):
    return torch.ones((d,), dtype=torch.float32, device=device)


def rmsnorm(x, gamma, eps=1e-6, dtype=None):
    """RMS norm in f32, cast to ``dtype`` (default: ``x``'s dtype)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * gamma).to(dtype or x.dtype)


def rmsnorm_columns(x, gamma, eps=1e-6, dtype=None):
    """:func:`rmsnorm` of a (B, W, d) speculative verify window whose mean
    reduces one column (B rows) at a time.  On the card a reduction's
    summation order depends on how many rows it reduces (PyTorch splits a
    row across more threads when there are few rows), and the decode step
    reduces B rows; reducing the window column by column gives every row
    the decode step's bits, which ``int8`` re-quantization would otherwise
    turn from one ulp into whole quantization steps.  The split is
    PyTorch's own heuristic, observed with PyTorch 2.11.0+cu128 on an H100;
    ``tests/test_torch_kernels_gpu.py::test_verify_step_rows_are_the_decode_steps``
    fails on the card if another version reduces otherwise."""
    xf = x.float()
    var = torch.cat([torch.mean(col * col, dim=-1, keepdim=True)
                     for col in (xf[:, c:c + 1] for c in range(x.shape[1]))], dim=1)
    return ((xf * torch.rsqrt(var + eps)) * gamma).to(dtype or x.dtype)


def init_layernorm(d: int, device=None):
    return {"gamma": torch.ones((d,), dtype=torch.float32, device=device),
            "beta": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm(x, p, eps=1e-6):
    """LayerNorm in f32 (the variance is the mean of the centred squares,
    as ``jnp.var`` forms it), cast to ``x``'s dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["gamma"] + p["beta"]).to(x.dtype)


class _Silu(torch.autograd.Function):
    """x * sigmoid(x) with sigmoid written out as 1 / (1 + exp(-x)), each op
    rounding to x's dtype -- the reference's logistic expansion, so bf16
    activations round at the same places.  The backward is JAX's rule for
    ``x * logistic(x)``, op for op in x's dtype: ``g * s + (x * g) * (s *
    (1 - s))``."""

    @staticmethod
    def forward(ctx, x):
        s = torch.reciprocal(1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (x * g) * (s * (1 - s))


def _silu(x):
    return _Silu.apply(x)


_ACTS = {"silu": _silu, "gelu": functools.partial(torch.nn.functional.gelu, approximate="tanh"),
         "relu": torch.relu}


def init_glu_mlp(gen, device, d_model: int, d_ff: int, stack=()):
    return {
        "w_gate": init_linear(gen, device, (*stack, d_model, d_ff)),
        "w_up": init_linear(gen, device, (*stack, d_model, d_ff)),
        "w_down": init_linear(gen, device, (*stack, d_ff, d_model)),
    }


def glu_mlp(x, p, act="silu", quant_mode="bf16", backend=None):
    """``down(act(gate(x)) * up(x))``.  The product is formed in f32 and
    quantized unrounded, as the reference's compiled graph does (XLA keeps
    the excess precision there); a bf16 matmul rounds it to the same bf16
    either way."""
    g = _ACTS[act](linear(x, p["w_gate"], quant_mode, backend))
    u = linear(x, p["w_up"], quant_mode, backend)
    return linear(g.float() * u.float(), p["w_down"], quant_mode, backend, row=True)


def init_mlp(gen, device, d_model: int, d_ff: int, stack=()):
    return {"w_in": init_linear(gen, device, (*stack, d_model, d_ff)),
            "w_out": init_linear(gen, device, (*stack, d_ff, d_model))}


def mlp(x, p, act="gelu", quant_mode="bf16", backend=None):
    """The non-GLU MLP, ``out(act(in(x)))``."""
    return linear(_ACTS[act](linear(x, p["w_in"], quant_mode, backend)),
                  p["w_out"], quant_mode, backend, row=True)


def embed(tokens, table, shape=None):
    """Rows of ``table`` for ``tokens``, bf16.  ``shape``: the full table's
    (vocab, d_model); on a tensor-parallel mesh a vocab-sharded ``table``
    looks up the tokens it holds (zeros elsewhere) and the ranks' rows are
    summed (exact: one rank holds each token), a width-sharded one gathers
    its columns."""
    ax = model_axis()
    if ax is None or shape is None or tuple(table.shape) == tuple(shape):
        return table[tokens.long()].to(COMPUTE_DTYPE)
    if table.shape[0] != shape[0]:
        rows = table.shape[0]
        local = tokens.long() - ax.rank * rows
        held = (local >= 0) & (local < rows)
        part = torch.where(held[..., None], table[local.clamp(0, rows - 1)].float(), 0.0)
        return all_reduce(part, ax, "sum").to(COMPUTE_DTYPE)
    return all_gather(table[tokens.long()].to(COMPUTE_DTYPE), ax, dim=-1)


def unembed(x, table, shape=None):
    """Output head kept in bf16 even in quantized modes (logits need full
    range); returns f32 logits of the bf16 product.  ``shape`` as in
    :func:`embed`: a vocab-sharded head gathers the ranks' logits (bitwise
    the unsharded product where the GEMM sums each column alike), a
    width-sharded one sums the ranks' f32 partial logits and rounds them to
    bf16 once, as the unsharded bf16 product does."""
    ax = model_axis()
    if ax is None or shape is None or tuple(table.shape) == tuple(shape):
        return torch.matmul(x.to(COMPUTE_DTYPE), table.to(COMPUTE_DTYPE).t()).float()
    if table.shape[0] != shape[0]:
        local = torch.matmul(x.to(COMPUTE_DTYPE), table.to(COMPUTE_DTYPE).t()).float()
        return all_gather(local, ax, dim=-1)
    cols = table.shape[1]
    xs = x.to(COMPUTE_DTYPE)[..., ax.rank * cols:(ax.rank + 1) * cols]
    part = torch.matmul(xs.float(), table.to(COMPUTE_DTYPE).float().t())
    return all_reduce(part, ax, "sum").to(COMPUTE_DTYPE).float()


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


# ---------------------------------------------------------------------------
# Causal depthwise 1D conv (Griffin / xLSTM temporal conv)
# ---------------------------------------------------------------------------

def init_conv1d(gen, device, d: int, width: int, stack=()):
    return truncated_normal_init(gen, device, (*stack, width, d), scale=0.1)


def causal_conv1d(x, w):
    """x: (B, S, D), w: (W, D) depthwise causal convolution.  The sum runs
    in f32 (a bf16 ``w`` promotes), tap by tap in the reference's order,
    and is cast to ``x``'s dtype."""
    width = w.shape[0]
    xf = x.float()
    pad = torch.nn.functional.pad(xf, (0, 0, width - 1, 0))
    out = torch.zeros_like(xf)
    for i in range(width):
        out = out + pad[:, i:i + x.shape[1], :] * w[i]
    return out.to(x.dtype)


def conv1d_decode(x_t, conv_state, w):
    """Single-step conv: x_t (B, D), conv_state (B, W-1, D) f32 ->
    (y_t in x_t's dtype, new state (B, W-1, D))."""
    hist = torch.cat([conv_state, x_t.float()[:, None, :]], dim=1)   # (B, W, D)
    y = torch.einsum("bwd,wd->bd", hist, w.float())
    return y.to(x_t.dtype), hist[:, 1:, :]
