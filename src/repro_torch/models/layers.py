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
``unembed`` finish with a SUM all-reduce and an all-gather.  In training
the same layers run under autograd on the rank's slices: a replicated
activation enters each column-parallel group through Megatron's *f*
(``collectives.model_input``), whose backward sums the ranks' partial
input gradients, and the row-parallel sum is *g* (``collectives.model_sum``
or the int32 sum inside ``quantized_linear``), whose backward passes the
gradient through; a rank's block of a replicated tensor
(:func:`rank_block`) is Megatron's scatter, whose backward all-gathers
the ranks' gradient blocks.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.backends import quantized_linear
from repro_torch.runtime.collectives import (
    model_axis,
    model_gather,
    model_input,
    model_scatter,
    model_sum,
)

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
    launches none and stages nothing for the numerics watchdog.

    ``row_axis``: a row-parallel projection's rank (``x`` and ``w`` its K
    slice); the forward is ``quantized_linear``'s row-parallel form (the
    int32 sum over the axis, Megatron's *g*), the backward the same rule on
    the slices: the whole output's gradient times the rank's rows of ``w``
    gives its slice of ``dx``, and ``dw`` is its own rows'."""

    @staticmethod
    def forward(ctx, x, w, quant_mode, backend, row_axis=None, col_axis=None):
        ctx.save_for_backward(x.to(COMPUTE_DTYPE), w)
        ctx.x_dtype = x.dtype
        return quantized_linear(x, w, quant_mode, backend=backend, out_dtype=COMPUTE_DTYPE,
                                row_axis=row_axis, col_axis=col_axis)

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
        return dx, dw, None, None, None, None


def linear(x, w, quant_mode: str = "bf16", backend=None, row: bool = False,
           col: bool = False):
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
    which is allclose to the unsharded bf16 product, not bitwise.  Under
    autograd both forms have the straight-through gradients on the rank's
    slices (see :class:`_QuantizedLinearSTE`).

    ``col``: the projection is column-parallel (``w`` holds this rank's
    output columns).  The product needs nothing more; the numerics
    watchdog labels and counts the whole weight."""
    ax = model_axis() if row else None
    cax = model_axis() if col else None
    grad = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    if quant_mode == "bf16":
        if ax is None:
            return torch.matmul(x.to(COMPUTE_DTYPE), w.to(COMPUTE_DTYPE))
        part = torch.matmul(x.to(COMPUTE_DTYPE).float(), w.to(COMPUTE_DTYPE).float())
        return model_sum(part, ax).to(COMPUTE_DTYPE)
    if grad:
        return _QuantizedLinearSTE.apply(x, w, quant_mode, backend, ax, cax)
    return quantized_linear(x, w, quant_mode, backend=backend, out_dtype=COMPUTE_DTYPE,
                            row_axis=ax, col_axis=cax)


def rank_block(t, n: int, dim: int = -1):
    """This model-axis rank's block of ``n`` along ``dim`` of the whole
    ``t`` (``t`` itself when that dim is ``n`` long: unsharded, or a width
    the rank holds whole).  Under autograd it is Megatron's scatter
    (``collectives.model_scatter``): the gradient of the whole ``t`` comes
    back as every rank's block, so the replicated ``t``'s producer gets
    its whole gradient on every rank."""
    if t.shape[dim] == n:
        return t
    ax = model_axis()
    assert ax is not None and t.shape[dim] == n * ax.size, \
        f"dim {dim} of {tuple(t.shape)} is neither {n} nor the whole of {n}-wide blocks"
    return model_scatter(t, ax, dim % t.dim(), n)


def whole(t, n: int, dim: int = -1):
    """``t`` whole along ``dim`` (``n`` long): the model-axis ranks' blocks
    all-gathered in rank order, bit for bit (``t`` itself when it is
    whole already).  Its backward keeps the rank's block of the gradient,
    which is whole only where every rank computes alike from the gathered
    ``t``; where split computation reads it, *f*
    (``collectives.model_input``) follows the gather."""
    if t.shape[dim] == n:
        return t
    ax = model_axis()
    assert ax is not None and t.shape[dim] * ax.size == n, \
        f"dim {dim} of {tuple(t.shape)} is neither {n} nor a rank's block of it"
    return model_gather(t, ax, dim)


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
    x = model_input(x)
    g = _ACTS[act](linear(x, p["w_gate"], quant_mode, backend, col=True))
    u = linear(x, p["w_up"], quant_mode, backend, col=True)
    return linear(g.float() * u.float(), p["w_down"], quant_mode, backend, row=True)


def init_mlp(gen, device, d_model: int, d_ff: int, stack=()):
    return {"w_in": init_linear(gen, device, (*stack, d_model, d_ff)),
            "w_out": init_linear(gen, device, (*stack, d_ff, d_model))}


def mlp(x, p, act="gelu", quant_mode="bf16", backend=None):
    """The non-GLU MLP, ``out(act(in(x)))``."""
    return linear(_ACTS[act](linear(model_input(x), p["w_in"], quant_mode, backend, col=True)),
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
        return model_sum(part, ax).to(COMPUTE_DTYPE)
    return model_gather(table[tokens.long()].to(COMPUTE_DTYPE), ax, -1)


def tp_block(n: int) -> int:
    """The block of a width ``n`` that the model axis splits, whose
    multiples cut ``n`` at every tp in {2, 4, 8} that divides it:
    ``n / gcd(n, 8)``.  A product run one such block at a time has the
    same shapes on every rank and unsharded: on the card cuBLAS picks its
    kernel, and with it the summation order, by a product's width or
    batch, so a rank's blocks give the unsharded product's bits."""
    return n // math.gcd(n, 8)


def _head_product(x, rows, vocab: int):
    """``x @ rows^T`` in bf16, ``rows`` the head's rows (all ``vocab`` of
    them, or a vocab-parallel rank's block), in column blocks of
    ``tp_block(vocab)`` (so a rank's logits are the unsharded head's bits).
    Under autograd one product, whose backward forms ``dx`` with one
    matmul over every row of the block the rank holds."""
    xb, rb = x.to(COMPUTE_DTYPE), rows.to(COMPUTE_DTYPE)
    if torch.is_grad_enabled() and (xb.requires_grad or rb.requires_grad):
        return torch.matmul(xb, rb.t())
    width = tp_block(vocab)
    return torch.cat([torch.matmul(xb, rb[i:i + width].t())
                      for i in range(0, rb.shape[0], width)], dim=-1)


def unembed(x, table, shape=None):
    """Output head kept in bf16 even in quantized modes (logits need full
    range); returns f32 logits of the bf16 product.  ``shape`` as in
    :func:`embed`: a vocab-sharded head gathers the ranks' logits (bitwise
    the unsharded product where the GEMM sums each column alike), a
    width-sharded one sums the ranks' f32 partial logits and rounds them to
    bf16 once, as the unsharded bf16 product does."""
    ax = model_axis()
    vocab = shape[0] if shape is not None else table.shape[0]
    if ax is None or shape is None or tuple(table.shape) == tuple(shape):
        return _head_product(x, table, vocab).float()
    x = model_input(x)
    if table.shape[0] != shape[0]:
        return model_gather(_head_product(x, table, vocab).float(), ax, -1)
    cols = table.shape[1]
    xs = x.to(COMPUTE_DTYPE)[..., ax.rank * cols:(ax.rank + 1) * cols]
    part = torch.matmul(xs.float(), table.to(COMPUTE_DTYPE).float().t())
    return model_sum(part, ax).to(COMPUTE_DTYPE).float()


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
