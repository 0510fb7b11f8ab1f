"""Mixture-of-Experts FFN: top-k routing with sort-based capacity dispatch
(port of ``repro/models/moe.py``).

Covers granite-moe (40 routed experts, top-8) and deepseek-moe (2 shared
+ 64 routed, top-6, first layer dense).  Each batch row's ``S * k``
(token, expert) pairs are sorted by expert id (stably), packed into an
(E, C, d) buffer -- capacity ``C = ceil(S * k / E * capacity_factor)``,
rounded up to a multiple of 128 above 128; a pair past its expert's
capacity drops into a trash row -- run through the grouped expert GEMMs,
and combined with the renormalized router weights.  The pad tokens of a
prefill bucket route and take capacity like any other, as in the
reference.

The grouped GEMM is plain torch, as the reference keeps it in jnp (its
Pallas kernels are strictly 2-D): the expert weights are quantized per
call to the mode's widths, the integer product of each bit-plane pair
runs as a float64 batched product (exact, since every partial sum stays
far below 2^53; PyTorch has no int32 batched product on CUDA) and the
radix combine is :func:`core.spoga.sliced_dot_planes`, so the int32
accumulators equal the reference's bit for bit in every dataflow.  The
router stays f32.

On a tensor-parallel mesh the experts follow the reference's rule
(``sharding._param_rule``):

* where the model axis divides the expert count they are
  expert-parallel: a rank holds E/tp experts (``shard.shard_params``),
  runs them on its experts' rows of the dispatch buffer (Megatron's
  scatter, ``collectives.model_scatter``), and the ranks' outputs are
  gathered along the expert axis (``collectives.model_gather``) before the
  weighted top-k combine, which then adds in the unsharded order;
* otherwise tensor parallelism runs inside the experts: a rank holds
  every expert's ``d_expert / tp`` block (``experts_gate`` / ``experts_up``
  columns, ``experts_down`` rows) and runs every expert on it.  The
  dispatch buffer enters through *f* (``collectives.model_input``); the
  down product quantizes against the whole ``d_expert``'s scales (one MAX
  all-reduce, ``collectives.global_absmax``) and sums the ranks' integer
  accumulators before it wraps and scales them, so the integer modes are
  bitwise the unsharded product; bf16 sums the ranks' f32 partials and
  rounds once (within one bf16 ulp of the unsharded product).

The experts' weights have no straight-through estimator, as in the
reference: their gradient flows through the absmax scales alone, and a
scale taken over the ranks sends it to the element that holds the
maximum, on the rank that holds it.  The router is replicated (routing,
capacity and the load-balance loss run alike on every rank); the shared
experts follow their ``w_gate`` / ``w_up`` / ``w_down`` specs (column- and
row-parallel, bitwise the unsharded GLU).
"""

from __future__ import annotations

import math

import torch

from repro_torch.backends import dynamic_quant, effective_bits, get_backend
from repro_torch.backends.spec import parse_quant_mode
from repro_torch.configs.base import ModelConfig
from repro_torch.core.slicing import slice_planes
from repro_torch.core.spoga import sliced_dot_planes, wrap_int32
from repro_torch.models.layers import (
    _ACTS,
    COMPUTE_DTYPE,
    glu_mlp,
    init_glu_mlp,
    truncated_normal_init,
)
from repro_torch.quant.qtensor import quantize, scale_of_absmax
from repro_torch.runtime.collectives import (
    all_reduce,
    batch_mean,
    global_absmax,
    model_axis,
    model_gather,
    model_input,
    model_scatter,
    model_sum,
)


def init_moe(cfg: ModelConfig, gen: torch.Generator, device, stack=()):
    m = cfg.moe
    d, e, de = cfg.d_model, m.num_experts, m.d_expert
    p = {
        # the router stays f32: routing logits are precision-sensitive
        "router": truncated_normal_init(gen, device, (*stack, d, e), dtype=torch.float32),
        "experts_gate": truncated_normal_init(gen, device, (*stack, e, d, de)),
        "experts_up": truncated_normal_init(gen, device, (*stack, e, d, de)),
        "experts_down": truncated_normal_init(gen, device, (*stack, e, de, d)),
    }
    if m.num_shared_experts:
        p["shared"] = init_glu_mlp(gen, device, d, m.num_shared_experts * de, stack)
    return p


def _grouped_dot(a, b):
    """Exact integer (..., E, C, K) x (E, K, N) -> int64 (..., E, C, N) of
    operands already held in float64."""
    return torch.round(torch.einsum("...eck,ekn->...ecn", a, b)).to(torch.int64)


def _grouped_int(xq, wq, spec, family: str) -> torch.Tensor:
    """The int32 accumulator of the grouped product in the mode's dataflow.
    Each operand (or bit plane) becomes float64 once, whatever the number
    of plane pairs it enters."""
    if family == "direct":
        return wrap_int32(_grouped_dot(xq.double(), wq.double()))
    xp = [t.double() for t in slice_planes(xq, spec.n_a_slices, spec.slice_bits)]
    wp = [t.double() for t in slice_planes(wq, spec.n_w_slices, spec.slice_bits)]
    return sliced_dot_planes(xp, wp, spec.slice_bits, dot_fn=_grouped_dot,
                             materialize=(family == "deas"))


def _grouped_matmul(x, w, quant_mode: str, backend=None, row_axis=None):
    """x: (..., E, C, K), w: (E, K, N) -> (..., E, C, N) bf16.

    Integer modes quantize x per row and w per (expert, output channel) to
    the spec's accumulator-aware widths, then take the int32 accumulator
    of :func:`_grouped_int`; ``backend`` (a registry name) only picks the
    dataflow family, as in the reference.

    ``row_axis``: x and w hold this rank's K slice (the down product inside
    the experts).  The scales are the whole K's (:func:`global_absmax`),
    the ranks' accumulators are summed exactly before the int32 wrap, and
    the output is the unsharded product's bits; bf16 sums the ranks' f32
    partials (*g*) and rounds once."""
    if quant_mode == "bf16":
        xb, wb = x.to(COMPUTE_DTYPE), w.to(COMPUTE_DTYPE)
        prod = torch.einsum("...eck,ekn->...ecn", xb.float(), wb.float())
        if row_axis is not None:
            prod = model_sum(prod, row_axis)
        return prod.to(COMPUTE_DTYPE)
    spec, family = parse_quant_mode(quant_mode)
    if backend is not None:
        family = get_backend(backend).family
    ways = row_axis.size if row_axis is not None else 1
    a_bits, w_bits = effective_bits(spec, x.shape[-1] * ways)
    if row_axis is None:
        xq, xs = dynamic_quant(x.float(), dim=-1, bits=a_bits)
        wq, ws = dynamic_quant(w.float(), dim=1, bits=w_bits)
        acc = _grouped_int(xq, wq, spec, family)
    else:
        xa, wa = global_absmax(row_axis, [(x, -1), (w, 1)])
        xs, ws = scale_of_absmax(xa, a_bits), scale_of_absmax(wa, w_bits)
        xq = quantize(x, scale=xs.detach(), bits=a_bits).data
        wq = quantize(w, scale=ws.detach(), bits=w_bits).data
        part = _grouped_int(xq, wq, spec, family).to(torch.int64)
        acc = wrap_int32(all_reduce(part, row_axis, "sum"))
    return (acc.float() * xs * ws).to(COMPUTE_DTYPE)


def _grouped_glu(x, p, act: str, quant_mode: str, backend=None, row_axis=None):
    """``down(act(gate(x)) * up(x))`` per expert.  The product stays f32
    into the down projection, as in ``layers.glu_mlp``.  ``row_axis``: the
    rank holds every expert's ``d_expert`` block (gate / up columns, down
    rows), and the down product sums over the axis."""
    g = _ACTS[act](_grouped_matmul(x, p["experts_gate"], quant_mode, backend))
    u = _grouped_matmul(x, p["experts_up"], quant_mode, backend)
    return _grouped_matmul(g.float() * u.float(), p["experts_down"], quant_mode, backend,
                           row_axis)


def capacity(cfg: ModelConfig, s: int) -> int:
    """Expert capacity of a batch row of ``s`` tokens."""
    m = cfg.moe
    cap = max(1, math.ceil(s * m.top_k / m.num_experts * m.capacity_factor))
    if cap > 128:
        # the reference rounds capacity up to a multiple of 128 (it shards
        # the dispatch buffer along capacity when experts do not divide
        # the model axis)
        cap = -(-cap // 128) * 128
    return cap


def _route(x2, router, k: int):
    """Router probabilities (T, E) f32 and the renormalized top-k weights
    and expert ids (T, k), in descending order, the lower expert id first
    on ties (``jax.lax.top_k``'s order)."""
    logits = torch.einsum("td,de->te", x2.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = vals[:, :k], idx[:, :k]
    return probs, topw / topw.sum(dim=-1, keepdim=True), topi


def moe_ffn(x, p, cfg: ModelConfig):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar f32).

    Capacity is enforced per batch row: row b's S*k (token, expert) pairs
    are stably sorted by expert, each pair's rank within its expert is its
    slot, and a pair at rank >= capacity goes to the trash row (the only
    row that several pairs write)."""
    m = cfg.moe
    b, s, d = x.shape
    k, e = m.top_k, m.num_experts
    cap = capacity(cfg, s)
    probs, topw, topi = _route(x.reshape(b * s, d), p["router"], k)
    probs, topw, topi = (t.reshape(b, s, -1) for t in (probs, topw, topi))

    flat_e = topi.reshape(b, s * k)
    sorted_e, sort_idx = torch.sort(flat_e, dim=-1, stable=True)
    group_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_e = torch.arange(s * k, device=x.device)[None, :] - group_start
    dest = torch.where(pos_in_e < cap, sorted_e * cap + pos_in_e,
                       torch.full_like(sorted_e, e * cap))
    rows = torch.arange(b, device=x.device)[:, None]
    x_sorted = x[rows, sort_idx // k]                                # (B, S*k, d)
    buf = torch.zeros((b, e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[rows, dest] = x_sorted
    grouped = buf[:, :e * cap].reshape(b, e, cap, d)
    held = p["experts_gate"].shape[0]
    qm, be = cfg.quant_mode, cfg.gemm_backend
    ax = model_axis()
    if held != e:                                                    # expert-parallel
        mine = model_scatter(grouped, ax, 1, held)
        y = model_gather(_grouped_glu(mine, p, cfg.act, qm, be), ax, 1)
    elif p["experts_down"].shape[-2] != m.d_expert:                  # inside the experts
        y = _grouped_glu(model_input(grouped), p, cfg.act, qm, be, row_axis=ax)
    else:
        y = _grouped_glu(grouped, p, cfg.act, qm, be)                # (B, E, C, d)

    y_flat = torch.cat([y.reshape(b, e * cap, d),
                        torch.zeros((b, 1, d), dtype=y.dtype, device=y.device)], dim=1)
    out_flat = torch.empty((b, s * k, d), dtype=y.dtype, device=y.device)
    out_flat[rows, sort_idx] = y_flat[rows, dest]                    # dropped -> zeros
    out = torch.einsum("bskd,bsk->bsd", out_flat.reshape(b, s, k, d).float(), topw)
    out = out.to(x.dtype)
    if m.num_shared_experts:
        out = out + glu_mlp(x, p["shared"], cfg.act, cfg.quant_mode, cfg.gemm_backend)

    # Switch-style load-balance aux loss, over all B*S tokens (every data
    # rank's in a data-parallel training step)
    # one-hot by comparison: the same ops on every device (``F.one_hot``
    # checks its range on the host, which a "meta" tensor cannot)
    experts = torch.arange(e, device=topi.device)
    dispatch_frac = (topi.long()[..., None] == experts).float().sum(2).mean(dim=(0, 1))
    aux = e * torch.sum(batch_mean(dispatch_frac) * batch_mean(probs.mean(dim=(0, 1)))) / k
    return out, aux


def moe_ffn_reference(x, p, cfg: ModelConfig):
    """Dense every-expert reference for tests: no capacity, no drops."""
    m = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    probs, topw, topi = _route(xf, p["router"], m.top_k)
    gate = torch.zeros_like(probs).scatter_(1, topi, topw)
    ys = _grouped_glu(xf.expand((m.num_experts,) + tuple(xf.shape)), p, cfg.act,
                      cfg.quant_mode, cfg.gemm_backend)              # (E, T, d)
    out = torch.einsum("etd,te->td", ys.float(), gate).to(x.dtype)
    if m.num_shared_experts:
        out = out + glu_mlp(xf, p["shared"], cfg.act, cfg.quant_mode, cfg.gemm_backend)
    return out.reshape(b, s, d)
