"""Numerics watchdog: runtime visibility into quantization headroom (port of
``repro/obs/watchdog.py``).

SPOGA's physical constraint is analog dynamic range — operands wider
than ~4 bits saturate the optical signal chain, which is why the kernels
bit-slice byte-size integers and why ``effective_bits`` shrinks operand
widths until the int32 accumulator cannot wrap.  When enabled, every
quantized GEMM reports how hard the workload pushes against the clamp —
per-layer at-rail occupancy (the fraction of quantized values on the
±qmax rail), activation ``amax``, relative quantization error, and the
accumulator-magnitude bound in bits — into a module-level
:class:`MetricsRegistry` that the ``/metrics`` server exposes beside the
engine's registry.  Series names and labels are the reference's.

Mechanics: the model entry points (``prefill`` / ``decode_step`` /
``verify_step`` / ``forward``) enter :func:`watching` when
``ModelConfig.numerics_watchdog`` is set.  Inside, ``quantized_linear``
finds the context with :func:`trace_ctx`, labels its call site with
:func:`next_label` and :func:`stage`-s its stats **on the device** into
the context.  When the entry point returns, :func:`watching` copies every
staged vector to the host in **one** device-to-host copy and feeds each
to :func:`record`.  Off means the context is never entered: nothing is
computed, staged or copied.  On, the stats read the GEMM's operands and
feed nothing back, so outputs stay bitwise identical.

Labels are ``<tag>.<site>.k<K>n<N>``.  The reference's site counter
advances while JAX traces, and its ``lax.scan`` traces a period's body
once, so every period shares one set of labels and their counters add
up.  The port runs its periods in a Python loop, so the model rewinds the
counter at each period (:func:`period_start`) to the same effect.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.obs.metrics import MetricsRegistry, labeled

_LOCK = threading.Lock()
_REGISTRY: Optional[MetricsRegistry] = None
_TLS = threading.local()


def registry() -> MetricsRegistry:
    """The watchdog's registry, created on first use."""
    global _REGISTRY
    if _REGISTRY is None:
        with _LOCK:
            if _REGISTRY is None:
                _REGISTRY = MetricsRegistry()
    return _REGISTRY


def peek_registry() -> Optional[MetricsRegistry]:
    """The registry if any watchdog stats were recorded, else None."""
    return _REGISTRY


def reset() -> None:
    """Drop all recorded stats (tests; fresh serving sessions)."""
    global _REGISTRY
    with _LOCK:
        _REGISTRY = None


class _Ctx:
    __slots__ = ("tag", "n", "period_base", "staged")

    def __init__(self, tag: str):
        self.tag = tag
        self.n = 0
        self.period_base = 0
        # (label, spec_name, device stats (5,) f32, host tail (3 floats))
        self.staged: list = []


@contextmanager
def watching(tag: Optional[str]) -> Iterator[None]:
    """Enable the watchdog for quantized GEMMs run in this scope, and flush
    their staged stats into :func:`record` when it exits.

    ``tag`` names the entry point (``prefill`` / ``decode`` / ...);
    ``None`` is a no-op so call sites can pass
    ``"decode" if cfg.numerics_watchdog else None`` unconditionally.
    """
    if tag is None:
        yield
        return
    prev = getattr(_TLS, "ctx", None)
    ctx = _TLS.ctx = _Ctx(tag)
    try:
        yield
    finally:
        _TLS.ctx = prev
    flush(ctx)


def standalone() -> _Ctx:
    """A context for a GEMM watched outside any entry point
    (``quantized_linear(..., watch=True)``); flushed right after staging."""
    return _Ctx("direct")


def trace_ctx() -> Optional[_Ctx]:
    """The active context, if any (consulted by ``quantized_linear``)."""
    return getattr(_TLS, "ctx", None)


def next_label(ctx: Optional[_Ctx], k: int, n: int) -> str:
    """Per-call-site layer label: ``<tag>.<idx>.k<K>n<N>``.  The index
    counts call sites in program order; periods share theirs
    (:func:`period_start`)."""
    if ctx is None:
        return f"direct.k{k}n{n}"
    i = ctx.n
    ctx.n += 1
    return f"{ctx.tag}.{i:02d}.k{k}n{n}"


def period_start(first: bool) -> None:
    """Called at the start of each period of a stacked (scanned) group:
    the first period marks the site counter, later ones rewind to the
    mark, so every period reuses the first period's labels."""
    ctx = trace_ctx()
    if ctx is None:
        return
    if first:
        ctx.period_base = ctx.n
    else:
        ctx.n = ctx.period_base


def stage(ctx: _Ctx, label: str, spec_name: str, device_stats: torch.Tensor,
          host_stats: tuple) -> None:
    """Queue one GEMM's stats: ``device_stats`` = ``[act_rail_hits,
    w_rail_hits, amax, rel_err, acc_bits]`` (f32, on the GEMM's device),
    ``host_stats`` = ``(act_elems, w_elems, bits_lost)``."""
    ctx.staged.append((label, spec_name, device_stats, host_stats))


def flush(ctx: _Ctx) -> None:
    """Copy the context's staged stats to the host in one transfer and
    record them in staging order."""
    if not ctx.staged:
        return
    dev = torch.stack([s[2] for s in ctx.staged]).cpu().numpy()
    staged, ctx.staged = ctx.staged, []
    for (label, spec_name, _, (a_n, w_n, lost)), d in zip(staged, dev):
        act_sat, w_sat, amax, err, acc_bits = d
        record(label, spec_name, np.array(
            [act_sat, w_sat, a_n, w_n, amax, err, acc_bits, lost], np.float32))


def record(label: str, spec_name: str, stats) -> None:
    """Host-side sink for one GEMM's stats vector ``[act_rail_hits,
    w_rail_hits, act_elems, w_elems, amax, rel_err, acc_bits,
    bits_lost]`` (the reference's ``jax.debug.callback`` target)."""
    act_sat, w_sat, a_n, w_n, amax, err, acc_bits, lost = (
        float(v) for v in stats)
    reg = registry()
    lab = {"layer": label, "mode": spec_name}
    reg.inc(labeled("watchdog_calls", **lab))
    reg.inc(labeled("watchdog_act_sat", **lab), int(act_sat))
    reg.inc(labeled("watchdog_w_sat", **lab), int(w_sat))
    reg.inc(labeled("watchdog_act_elems", **lab), int(a_n))
    reg.inc(labeled("watchdog_w_elems", **lab), int(w_n))
    if lost:
        reg.inc(labeled("watchdog_bits_clamped", **lab), int(lost))
    reg.observe(labeled("watchdog_amax", **lab), amax)
    reg.observe(labeled("watchdog_quant_err", **lab), err)
    reg.observe(labeled("watchdog_acc_bits", **lab), acc_bits)
    reg.set_max(labeled("watchdog_acc_bits_peak", **lab), acc_bits)


def saturation_report() -> dict:
    """Per-layer at-rail occupancy summary (activation side), for quick
    programmatic checks: ``{layer_key: fraction_at_rail}``."""
    reg = peek_registry()
    if reg is None:
        return {}
    out = {}
    with reg.lock:
        keys = list(reg.counters)
    for key in keys:
        if not key.startswith("watchdog_act_sat"):
            continue
        suffix = key[len("watchdog_act_sat"):]
        n = reg.counters.get("watchdog_act_elems" + suffix)
        if n is None or not n.value:
            continue
        out[suffix.strip("{}")] = reg.counters[key].value / n.value
    return out
