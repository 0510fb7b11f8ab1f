"""Drive the PyTorch port on one NVIDIA GPU and hold every kernel to its plain version.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. card: name and power limit from nvidia-smi; build the CUDA kernels from
   ``src/repro_torch/csrc/`` (one nvcc per source, all started together);
2. GEMM kernels: ``spoga_gemm_dequant`` and the int32 ``spoga_gemm``
   against their plain versions, bitwise, at the main path's shapes for
   W8A8, w4a8 and w16a16 (``spoga_gemm_dequant`` also at M=512, a
   chunked-prefill step's projections, timed at W8A8); the DEAS kernels (``nibble_gemm`` x4 +
   ``deas_combine``) at W8A8 against their plain versions and
   ``spoga_gemm``, 5 launches per call, and ``deas_combine`` alone over
   the int32 range, aligned and misaligned; each time the profiler's device
   time (the event time of back-to-back calls beside it), against the bound
   and ``torch._int_mm``; ``deas_combine`` warm and cold, each in one
   profiler session with a no-op kernel on its grid;
3. paged-attention kernel: bf16 and int8 pools against the plain version at
   rtol/atol 2e-5, stale rows poisoned, two calls bitwise equal, at (a) the
   main path's decode shape and (b) an 8K-token table (B=16, 8 KV heads,
   lengths 1,024-8,192 from a seed, pools read cold); device and event
   times beside the bound and ``scaled_dot_product_attention`` on the
   gathered view;
4. main path: full-width llama3.2-1b, ``int8_spoga``, int8 paged KV, random
   weights from seed 0, served by ``ServingEngine`` (8 staggered requests);
   launch counts of both kernels are read around the run, the plain
   versions must not run; every request again on a 1-slot engine; then a
   4-request pass over a bf16 pool; profiles of a few decode steps (device
   time by kernel, one ``paged_attention`` kernel per layer and step) at
   64- and 2,048-token prompts;
   4b. slot mode: phase 4's traffic through slot-mode ``ServingEngine``s
   (int8, then bf16 KV), every projection on ``spoga_gemm_dequant`` (112
   launches a decode step), no ``paged_attention`` and no plain version;
   tok/s, TTFT and decode step beside the paged run's; a profiled slot
   decode step; then slot against paged inside the port: the same prompts
   prefilled once, 8 teacher-forced decode steps over a slot and a paged
   int8 cache, on phase 6's 2-layer bf16-GEMM model the logits within
   tolerance at every step; at ``int8_spoga`` (2 layers, full depth) the
   difference printed;
5. the paper's dataflows through the ``LLM`` facade: the same weights and
   prompts served by ``int8_spoga`` fused, ``int8_spoga`` with
   ``gemm_backend="cuda_spoga"``, ``int8_deas`` and ``int8_direct``, in
   two rounds of opposite order, each run's kernel counts read around it;
   the greedy streams must be identical; tok/s, decode step and TTFT per
   dataflow; decode-step profiles of the DEAS and direct paths;
   5b. a 16,384-token full-width prefill at ``int8_spoga`` into an int8
   cache (finite logits, time, peak memory), and ``multihead_attention``
   at that length: rows on and beside its chunk edges against the same
   rows computed alone; then ``LLM("llama3.2-1b").generate`` with the
   default runtime (bf16 GEMMs, slot bf16 KV), no kernel launched;
6. card against CPU: a 2-layer full-width model, the same weights on both,
   one prefill: the first greedy token equal, the logits within tolerance;
   then a 1,000-token paged decode over int8 KV, 4 steps fed the CPU's
   tokens, the logits within tolerance at every step;
7. engine features, full-width ``int8_spoga`` over int8 paged KV (runs
   between phases 5b and 6): (a) phase 4's weights saved with
   ``save_checkpoint`` and loaded by ``LLM(checkpoint_dir=)``, every tensor
   equal; (b) 2 prompts of 2,048-4,096 tokens then 8 short ones, chunked
   at 512 tokens and again unchunked (every request finished, the chunk
   steps counted, the short requests' TTFT printed); (c) 8 same-bucket
   prompts stacked into shared prefills, against unstacked; (d) defrag at
   threshold 0.05 against off, greedy streams bitwise equal; each run's
   kernel counts read around it; then chunked against one-shot prefill
   and stacked against batch=1 on phase 6's 2-layer bf16 model (logits
   within tolerance; greedy equal except on near-tie rows, whose top-2
   margin is at most ``NEAR_TIE_ULPS`` bf16 ulps) and at full width
   (printed);
8. the ``kernels`` JSON line, then the ``ok`` line last.

Needs a CUDA card; exits non-zero without one, or without the repo's ``src/``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 tensor rate
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor rate
L2_BYTES = 50 * 2**20

GEMM_KN = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]
GEMM_SPECS = {"w8a8": "int8_spoga", "w4a8": "w4a8", "w16a16": "w16a16"}
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
# card vs CPU logits: bf16 rounding of sums taken in another order
LOGIT_TOL = 2e-2
# a greedy token may flip between two summation orders only on a row whose
# top-2 margin is at most this many bf16 ulps of its top logit
NEAR_TIE_ULPS = 2
ENGINE_SEED = 0
# phase 7's prefill chunk: the M of every projection of a chunk step
CHUNK_M = 512


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, n_bufs: int, iters: int, warmup: int = 3) -> float:
    """Mean time of ``fn(i)`` over ``iters`` back-to-back calls between two
    CUDA events, cycling ``i`` over ``n_bufs`` input copies so that L2 stays
    cold.  A call shorter than its host cost reads as the launch rate."""
    for i in range(warmup):
        fn(i % n_bufs)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_bufs)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, n_bufs: int, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn(i)``: the profiler's kernel time summed over
    ``iters`` calls (every kernel the call launches, gaps between them not
    counted), cycling ``i`` over ``n_bufs`` input copies.  The profiler
    now and then records no kernel in a session: after three such sessions
    the calls are timed as one CUDA-graph replay."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(warmup):
        fn(i % n_bufs)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i % n_bufs)
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA"))
        if total > 0:
            return total / 1e3 / iters
    print("[timing] the profiler recorded no kernel in three sessions: timed by a CUDA-graph "
          "replay instead", flush=True)
    return graph_ms(fn, n_bufs, iters)


def graph_ms(fn, n_bufs: int, iters: int, replays: int = 5) -> float:
    """Mean time of ``fn(i)`` captured ``iters`` times into one CUDA graph
    and replayed between two CUDA events: no host launch cost, but the
    graph's own gap between kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i % n_bufs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i % n_bufs)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def device_ms_by_kernel(fns: dict, n_bufs: int, iters: int, warmup: int = 3) -> dict:
    """Mean device time per call of ``fns`` {kernel name: function launching
    that one kernel}, all in one profiler session: ``iters`` calls of the
    first function, then of the next, ... (back-to-back calls of one kernel,
    as ``device_ms`` times them): {kernel name: ms}.  After three sessions
    that miss a kernel each function is timed alone by a CUDA-graph replay."""
    from torch.profiler import ProfilerActivity, profile
    for fn in fns.values():
        for i in range(warmup):
            fn(i % n_bufs)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for fn in fns.values():
                for i in range(iters):
                    fn(i % n_bufs)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        times = {}
        for name in fns:
            hits = [e.self_device_time_total for e in kernels if name in e.key]
            require(len(hits) <= 1, f"{name}: {len(hits)} kernels of that name")
            if hits and hits[0] > 0:
                times[name] = hits[0] / 1e3 / iters
        if len(times) == len(fns):
            return times
    print("[timing] the profiler missed a kernel in three sessions: timed by CUDA-graph "
          "replays instead", flush=True)
    return {name: graph_ms(fn, n_bufs, iters) for name, fn in fns.items()}


def kernel_times(fn, n_bufs: int, iters: int) -> tuple[float, float]:
    """(device time by the profiler, event time of back-to-back calls)."""
    return device_ms(fn, n_bufs, iters), time_ms(fn, n_bufs, iters)


def copies_for(nbytes: int, cap: int = 16) -> int:
    """Copies of an input that together exceed twice the L2 cache (at most
    ``cap``: past it the copies are only cooler)."""
    return max(1, min(cap, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def bound(nbytes: int, ops: float, rate: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# 1. card
# ---------------------------------------------------------------------------

def phase_card():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card, flush=True)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
          flush=True)
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    print(f"[card] kernels built in {time.perf_counter() - t0:.1f} s -> "
          f"{path.relative_to(Path(__file__).resolve().parent)}", flush=True)
    return card


# ---------------------------------------------------------------------------
# 2. GEMM kernels
# ---------------------------------------------------------------------------

def _lib_int_mm(x, w_copies, m, k, n):
    """``torch._int_mm``'s device time on int8 operands, else None.  Where it does
    not take the shape as it is (M <= 16, K or N not a multiple of 8) the
    operands are zero-padded as the ``cuda_direct`` backend pads them
    (``impls.int_mm_padded``, M up to 24), the padding timed with it."""
    from repro_torch.backends.impls import int_mm_padded
    if not (x.dtype == w_copies[0].dtype == torch.int8):
        return None
    if m > 16 and k % 8 == 0 and n % 8 == 0:
        return device_ms(lambda i: torch._int_mm(x, w_copies[i]), len(w_copies), iters=40)
    return device_ms(lambda i: int_mm_padded(x, w_copies[i]), len(w_copies), iters=40)


def _lib_label(m, k, n):
    if m > 16 and k % 8 == 0 and n % 8 == 0:
        return "torch._int_mm (int32 product)"
    return "torch._int_mm on operands zero-padded to M=24 (int32 product, padding included)"


def _int_product_ops(m, k, n):
    """Operations of the function, one integer (M, K) @ (K, N) product,
    counted at the int8 rate whatever the operand width: however many
    plane pairs a kernel multiplies, the function needs 2*M*K*N.  For int16
    operands (w16a16) the card has no faster integer rate than int8, so
    this still bounds the time from below."""
    return 2.0 * m * k * n


def _gemm_case_shapes():
    shapes = [(m, k, n) for m in (1, 4, 128) for k, n in GEMM_KN]
    return shapes + [(130, 257, 100), (1, 249, 16)]


def _gemm_operands(m, k, n, mode, gen):
    from repro_torch.backends import effective_bits, parse_quant_mode
    spec, _ = parse_quant_mode(mode)
    a_bits, w_bits = effective_bits(spec, k)
    qa, qw = 2 ** (a_bits - 1) - 1, 2 ** (w_bits - 1) - 1
    x = torch.randint(-qa, qa + 1, (m, k), generator=gen, device="cuda").to(spec.a_dtype)
    w = torch.randint(-qw, qw + 1, (k, n), generator=gen, device="cuda").to(spec.w_dtype)
    xs = torch.rand((m, 1), generator=gen, device="cuda") * 0.1 + 1e-3
    ws = torch.rand((1, n), generator=gen, device="cuda") * 0.1 + 1e-3
    return spec, x, w, xs, ws


def phase_gemm():
    from repro_torch.kernels.spoga_gemm_dequant import (
        spoga_gemm_dequant,
        spoga_gemm_dequant_plain,
    )
    gen = torch.Generator(device="cuda").manual_seed(1)
    checked, max_err = 0, 0.0
    for name, mode in GEMM_SPECS.items():
        for m, k, n in _gemm_case_shapes() + [(CHUNK_M, k, n) for k, n in GEMM_KN]:
            spec, x, w, xs, ws = _gemm_operands(m, k, n, mode, gen)
            got = spoga_gemm_dequant(x, w, xs, ws, n_x_slices=spec.n_a_slices,
                                     n_w_slices=spec.n_w_slices, slice_bits=spec.slice_bits)
            want = spoga_gemm_dequant_plain(x, w, xs, ws)
            err = (got - want).abs().max().item()
            max_err = max(max_err, err)
            require(torch.equal(got, want), f"GEMM {name} ({m},{k},{n}): max |diff| {err}")
            checked += 1
    print(f"[gemm] {checked} cases bitwise equal to the plain version (max |diff| "
          f"{max_err})", flush=True)

    timings = {}
    for name, mode in GEMM_SPECS.items():
        # M=CHUNK_M: every projection of a chunked-prefill step (phase 7), at W8A8
        for m in (4, 128) + ((CHUNK_M,) if name == "w8a8" else ()):
            for k, n in GEMM_KN:
                spec, x, w, xs, ws = _gemm_operands(m, k, n, mode, gen)
                nb = copies_for(w.numel() * w.element_size())
                ws_copies = [w.clone() for _ in range(nb)]
                kw = dict(n_x_slices=spec.n_a_slices, n_w_slices=spec.n_w_slices,
                          slice_bits=spec.slice_bits)
                t_kernel, t_event = kernel_times(
                    lambda i: spoga_gemm_dequant(x, ws_copies[i], xs, ws, **kw), nb, iters=40)
                t_plain = time_ms(lambda i: spoga_gemm_dequant_plain(x, ws_copies[i], xs, ws),
                                  nb, iters=5, warmup=1)
                t_lib = _lib_int_mm(x, ws_copies, m, k, n)
                nbytes = (x.numel() * x.element_size() + w.numel() * w.element_size()
                          + 4 * (m + n) + 4 * m * n)
                ops = _int_product_ops(m, k, n)
                b_ms, b_by = bound(nbytes, ops, INT8_OPS_PER_S)
                timings[(name, m, k, n)] = dict(ms=t_kernel, event_ms=t_event,
                                                plain_ms=t_plain, library_ms=t_lib,
                                                bound_ms=b_ms, bound_by=b_by)
                lib = f"{t_lib:.4f} ms" if t_lib is not None else "n/a"
                lib += " (padded)" if m <= 16 and t_lib is not None else ""
                print(f"[gemm] {name} M={m} K={k} N={n}: kernel {t_kernel:.4f} ms device "
                      f"({t_event:.4f} ms by events), plain {t_plain:.4f} ms, _int_mm {lib}, "
                      f"bound {b_ms:.4f} ms ({b_by}, {b_ms / t_kernel:.1%} of it)", flush=True)
                del ws_copies
    # one decode step's projections (q, k, v, o, gate, up, down) per layer
    layer = [(2048, 2048), (2048, 512), (2048, 512), (2048, 2048),
             (2048, 8192), (2048, 8192), (8192, 2048)]
    per_layer = sum(timings[("w8a8", 4, k, n)]["ms"] for k, n in layer)
    print(f"[gemm] W8A8 decode step at M=4, 16 layers x 7 projections: "
          f"{16 * per_layer:.3f} ms of kernel device time", flush=True)
    return timings, max_err


def phase_int_gemm():
    """The int32 SPOGA kernel: bitwise against its plain version on phase
    2's grid; times at the decode and prefill widths."""
    from repro_torch.kernels.spoga_gemm import spoga_gemm, spoga_gemm_plain
    gen = torch.Generator(device="cuda").manual_seed(4)
    checked, max_err = 0, 0
    for name, mode in GEMM_SPECS.items():
        for m, k, n in _gemm_case_shapes():
            spec, x, w, _, _ = _gemm_operands(m, k, n, mode, gen)
            got = spoga_gemm(x, w, n_x_slices=spec.n_a_slices, n_w_slices=spec.n_w_slices,
                             slice_bits=spec.slice_bits)
            want = spoga_gemm_plain(x, w)
            err = (got.long() - want.long()).abs().max().item()
            max_err = max(max_err, err)
            require(got.dtype == torch.int32 and torch.equal(got, want),
                    f"spoga_gemm {name} ({m},{k},{n}): max |diff| {err}")
            checked += 1
    print(f"[spoga_gemm] {checked} cases bitwise equal to the plain version (max |diff| "
          f"{max_err})", flush=True)

    timings = {}
    for name, mode in GEMM_SPECS.items():
        for m in (4, 128):
            for k, n in GEMM_KN:
                spec, x, w, _, _ = _gemm_operands(m, k, n, mode, gen)
                nb = copies_for(w.numel() * w.element_size())
                w_copies = [w.clone() for _ in range(nb)]
                kw = dict(n_x_slices=spec.n_a_slices, n_w_slices=spec.n_w_slices,
                          slice_bits=spec.slice_bits)
                t_kernel, t_event = kernel_times(lambda i: spoga_gemm(x, w_copies[i], **kw), nb,
                                                 iters=40)
                t_plain = time_ms(lambda i: spoga_gemm_plain(x, w_copies[i]), nb, iters=5,
                                  warmup=1)
                t_lib = _lib_int_mm(x, w_copies, m, k, n)
                nbytes = (x.numel() * x.element_size() + w.numel() * w.element_size()
                          + 4 * m * n)
                ops = _int_product_ops(m, k, n)
                b_ms, b_by = bound(nbytes, ops, INT8_OPS_PER_S)
                timings[(name, m, k, n)] = dict(ms=t_kernel, event_ms=t_event,
                                                plain_ms=t_plain, library_ms=t_lib,
                                                bound_ms=b_ms, bound_by=b_by)
                lib = f"{t_lib:.4f} ms" if t_lib is not None else "n/a"
                lib += " (padded)" if m <= 16 and t_lib is not None else ""
                print(f"[spoga_gemm] {name} M={m} K={k} N={n}: kernel {t_kernel:.4f} ms device "
                      f"({t_event:.4f} ms by events), plain {t_plain:.4f} ms, _int_mm {lib}, "
                      f"bound {b_ms:.4f} ms ({b_by}, {b_ms / t_kernel:.1%} of it)", flush=True)
                del w_copies
    return timings, max_err


def combine_times(m, n, parts):
    """``deas_combine``'s device time at (M, N), warm (its partials rewritten
    by a copy kernel just before each call, as the main path finds them just
    written by ``nibble_gemm``) and cold (copies rotated past twice the L2,
    each read once a round), each in one profiler session with as many
    launches of the no-op kernel on the same grid; the event time and the
    plain version's time.  Re-reading the same partials call after call is
    no warm time: the streaming loads mark them evict-first, and L1 may
    keep part of them, so such a loop reads neither as the main path does."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import deas_gemm as deas_mod
    lib = _build.library()

    def noop(_i):
        _build.check(lib.noop_launch(m, n, torch.cuda.current_stream().cuda_stream), "noop")

    sources = [t.clone() for t in parts]

    def fresh(_i):
        for dst, src in zip(parts, sources):
            dst.copy_(src)
        deas_mod.deas_combine(*parts)

    warm = device_ms_by_kernel({"deas_combine_kernel": fresh, "noop_kernel": noop}, 1, iters=40)
    nc = copies_for(4 * parts[0].numel() * 4, cap=256)
    cold_parts = [[t.clone() for t in parts] for _ in range(nc)]
    cold = device_ms_by_kernel({"deas_combine_kernel":
                                lambda i: deas_mod.deas_combine(*cold_parts[i]),
                                "noop_kernel": noop}, nc, iters=max(40, nc))
    del cold_parts, sources
    return dict(warm_ms=warm["deas_combine_kernel"], noop_warm_ms=warm["noop_kernel"],
                cold_ms=cold["deas_combine_kernel"], noop_cold_ms=cold["noop_kernel"],
                copies=nc, event_ms=time_ms(lambda i: deas_mod.deas_combine(*parts), 1, iters=40),
                plain_ms=time_ms(lambda i: deas_mod.deas_combine_plain(*parts), 1, iters=5,
                                 warmup=1))


# deas_combine alone: decode and prefill widths and a count % 4 != 0 shape
COMBINE_CHECKS = [(4, 8192), (128, 8192), (3, 8191)]


def check_combine(gen):
    """``deas_combine`` bitwise against its plain version over the full int32
    range (every shift and add wraps), on aligned partials (16-byte vectors
    and the scalar tail) and on views one element past a 16-byte boundary
    (the scalar path).  Returns the largest |difference| (0)."""
    from repro_torch.kernels import deas_gemm as deas_mod
    max_err = 0
    for m, n in COMBINE_CHECKS:
        parts = [torch.randint(-2 ** 31, 2 ** 31, (m, n), generator=gen, device="cuda",
                               dtype=torch.int64).to(torch.int32) for _ in range(4)]
        bufs = [torch.empty(m * n + 4, dtype=torch.int32, device="cuda") for _ in range(4)]
        shifted = [b[1:1 + m * n].view(m, n) for b in bufs]
        for dst, src in zip(shifted, parts):
            dst.copy_(src)
        require(all(t.data_ptr() % 16 == 4 for t in shifted), "misaligned views are aligned")
        for label, inputs in (("aligned", parts), ("misaligned", shifted)):
            got = deas_mod.deas_combine(*inputs)
            want = deas_mod.deas_combine_plain(*inputs)
            torch.cuda.synchronize()
            err = (got.long() - want.long()).abs().max().item()
            max_err = max(max_err, err)
            require(torch.equal(got, want), f"deas_combine {label} ({m},{n}): max |diff| {err}")
    print(f"[deas] deas_combine bitwise equal to its plain version over the int32 range at "
          f"(M, N) {COMBINE_CHECKS}, aligned and one element off a 16-byte boundary",
          flush=True)
    return max_err


def combine_sustained(gen, m=2048, n=8192):
    """``deas_combine`` on 335 MB of partials (M=2048, N=8192, one copy,
    past the L2 several times over): the rate a long streaming call
    sustains on this card, against the 3.35 TB/s of the bound."""
    from repro_torch.kernels import deas_gemm as deas_mod
    parts = [torch.randint(-2 ** 31, 2 ** 31, (m, n), generator=gen, device="cuda",
                           dtype=torch.int64).to(torch.int32) for _ in range(4)]
    ms = device_ms(lambda i: deas_mod.deas_combine(*parts), 1, iters=20)
    b_ms, _ = bound(20 * m * n, 0.0, INT8_OPS_PER_S)
    print(f"[deas] deas_combine M={m} N={n} (335 MB a call): {ms:.4f} ms device, "
          f"{20 * m * n / ms / 1e9:.3f} TB/s, {b_ms / ms:.1%} of the bytes bound", flush=True)
    return {"shape": f"M={m} N={n}", "ms": ms, "bound_ms": b_ms, "fraction_of_bound": b_ms / ms}


def phase_deas(int_timings):
    """The DEAS kernels at W8A8: each call 4 nibble_gemm launches + 1
    deas_combine launch; bitwise against the plain versions and against
    spoga_gemm; times beside spoga_gemm's at the same shapes."""
    from repro_torch.core.slicing import slice_tc
    from repro_torch.kernels import deas_gemm as deas_mod
    from repro_torch.kernels.spoga_gemm import spoga_gemm
    gen = torch.Generator(device="cuda").manual_seed(5)
    checked, max_err = 0, 0
    for m, k, n in _gemm_case_shapes():
        x = torch.randint(-128, 128, (m, k), generator=gen, device="cuda").to(torch.int8)
        w = torch.randint(-128, 128, (k, n), generator=gen, device="cuda").to(torch.int8)
        before = (deas_mod.CALLS, deas_mod.NIBBLE_LAUNCHES, deas_mod.COMBINE_LAUNCHES)
        got = deas_mod.deas_gemm(x, w)
        after = (deas_mod.CALLS, deas_mod.NIBBLE_LAUNCHES, deas_mod.COMBINE_LAUNCHES)
        require(tuple(a - b for a, b in zip(after, before)) == (1, 4, 1),
                f"deas_gemm ({m},{k},{n}): launches {before} -> {after}, want +(1, 4, 1)")
        want = deas_mod.deas_gemm_plain(x, w)
        fused = spoga_gemm(x, w)
        xm, xl = slice_tc(x)
        wm, wl = slice_tc(w)
        parts = [deas_mod.nibble_gemm(a, b) for a, b in ((xm, wm), (xm, wl), (xl, wm), (xl, wl))]
        require(len({p.data_ptr() for p in parts}) == 4, "partials share a buffer")
        for p, (a, b) in zip(parts, ((xm, wm), (xm, wl), (xl, wm), (xl, wl))):
            require(torch.equal(p, deas_mod.nibble_gemm_plain(a, b)),
                    f"nibble_gemm ({m},{k},{n}) differs from its plain version")
        require(torch.equal(deas_mod.deas_combine(*parts), deas_mod.deas_combine_plain(*parts)),
                f"deas_combine ({m},{k},{n}) differs from its plain version")
        err = (got.long() - want.long()).abs().max().item()
        max_err = max(max_err, err)
        require(torch.equal(got, want), f"deas_gemm ({m},{k},{n}): max |diff| {err}")
        require(torch.equal(got, fused), f"deas_gemm ({m},{k},{n}) differs from spoga_gemm")
        checked += 1
    print(f"[deas] {checked} W8A8 cases bitwise equal to the plain versions and to "
          f"spoga_gemm, 4 + 1 launches per call (max |diff| {max_err})", flush=True)
    combine_err = check_combine(gen)
    sustained = combine_sustained(gen)

    timings, nibble = {}, {}
    for m in (4, 128):
        for k, n in GEMM_KN:
            x = torch.randint(-128, 128, (m, k), generator=gen, device="cuda").to(torch.int8)
            w = torch.randint(-128, 128, (k, n), generator=gen, device="cuda").to(torch.int8)
            nb = copies_for(w.numel())
            w_copies = [w.clone() for _ in range(nb)]
            t_kernel, t_event = kernel_times(lambda i: deas_mod.deas_gemm(x, w_copies[i]), nb,
                                             iters=40)
            t_plain = time_ms(lambda i: deas_mod.deas_gemm_plain(x, w_copies[i]), nb, iters=5,
                              warmup=1)
            t_lib = _lib_int_mm(x, w_copies, m, k, n)
            xm, xl = slice_tc(x)
            wm = [slice_tc(c)[0] for c in w_copies]
            t_nibble, t_nibble_event = kernel_times(lambda i: deas_mod.nibble_gemm(xm, wm[i]), nb,
                                                    iters=40)
            t_nibble_plain = time_ms(lambda i: deas_mod.nibble_gemm_plain(xm, wm[i]), nb, iters=5,
                                     warmup=1)
            t_nibble_lib = _lib_int_mm(xm, wm, m, k, n)
            parts = [deas_mod.nibble_gemm(xm, wm[0]) for _ in range(4)]
            comb = combine_times(m, n, parts)
            c_ms, _ = bound(20 * m * n, 0.0, INT8_OPS_PER_S)
            spoga = int_timings[("w8a8", m, k, n)]
            inter = 8 * m * n * 4
            # one plane product: its plane operands read once, its int32 output written once
            n_bytes = m * k + k * n + 4 * m * n
            nb_ms, nb_by = bound(n_bytes, _int_product_ops(m, k, n), INT8_OPS_PER_S)
            timings[(m, k, n)] = dict(ms=t_kernel, event_ms=t_event, plain_ms=t_plain,
                                      library_ms=t_lib, bound_ms=spoga["bound_ms"],
                                      bound_by=spoga["bound_by"], deas_combine=comb,
                                      deas_combine_bound_ms=c_ms,
                                      intermediate_bytes=inter, spoga_gemm_ms=spoga["ms"])
            nibble[(m, k, n)] = dict(ms=t_nibble, event_ms=t_nibble_event,
                                     plain_ms=t_nibble_plain, library_ms=t_nibble_lib,
                                     bound_ms=nb_ms, bound_by=nb_by)
            lib = f"{t_lib:.4f} ms" + (" (padded)" if m <= 16 else "")
            print(f"[deas] W8A8 M={m} K={k} N={n}: deas_gemm {t_kernel:.4f} ms device "
                  f"({t_event:.4f} ms by events; one nibble_gemm {t_nibble:.4f} ms device, "
                  f"{t_nibble_event:.4f} by events, plain {t_nibble_plain:.4f} ms, _int_mm on "
                  f"the planes {t_nibble_lib:.4f} ms, bound {nb_ms:.4f} ms; deas_combine "
                  f"{comb['warm_ms']:.4f} ms device warm, just written (no-op kernel "
                  f"{comb['noop_warm_ms']:.4f}),"
                  f" {comb['cold_ms']:.4f} cold (no-op {comb['noop_cold_ms']:.4f}; "
                  f"{comb['copies']} copies; bound {c_ms:.5f} ms, {c_ms / comb['cold_ms']:.1%} of "
                  f"it), {comb['event_ms']:.4f} by events, plain {comb['plain_ms']:.4f}; "
                  f"intermediates "
                  f"{inter} B) vs spoga_gemm {spoga['ms']:.4f} ms; plain {t_plain:.4f} ms, "
                  f"_int_mm {lib}, bound {spoga['bound_ms']:.4f} ms ({spoga['bound_by']}, "
                  f"{spoga['bound_ms'] / t_kernel:.1%} of it)", flush=True)
            del w_copies, wm, parts
    return timings, nibble, max_err, combine_err, sustained


# ---------------------------------------------------------------------------
# 3. paged-attention kernel
# ---------------------------------------------------------------------------

# (a) the main path's decode shape; (b) llama3.2-1b's heads at an 8K-token table;
# (c) the same table with every lane at length 1: the launch and clusters alone
ATTN_SHAPES = {
    "main": dict(b=4, hkv=8, g=4, d=64, ps=16, n_tbl=11),
    "long": dict(b=16, hkv=8, g=4, d=64, ps=16, n_tbl=512),
    "short": dict(b=16, hkv=8, g=4, d=64, ps=16, n_tbl=512),
}
ATTN_MAIN_LENGTHS = [1, 17, 100, 165]
ATTN_LONG_SEED = 7


def attn_lengths(name, shape):
    if name == "main":
        return ATTN_MAIN_LENGTHS
    return [1] * shape["b"] if name == "short" else long_lengths(shape)


def long_lengths(shape):
    """Lengths between 1,024 and the table's 8,192 rows, from the seed: one
    lane at 8,192, one on a page boundary, one on a split boundary (a
    multiple of MAX_SPLITS pages: as many pages in every split at the
    shape's S = MAX_SPLITS; split r takes pages r, r + S, ...)."""
    from repro_torch.kernels.paged_attention import MAX_SPLITS
    rows = shape["n_tbl"] * shape["ps"]
    lens = np.random.default_rng(ATTN_LONG_SEED).integers(1024, rows + 1, shape["b"])
    edge = MAX_SPLITS * shape["ps"]
    lens[:3] = [rows, 313 * shape["ps"], edge * (rows // edge * 5 // 8)]
    return lens.tolist()


def _attn_pools(kind, gen, n_pages, shape):
    shp = (n_pages, shape["ps"], shape["hkv"], shape["d"])
    if kind == "int8":
        kp = torch.randint(-127, 128, shp, generator=gen, device="cuda").to(torch.int8)
        vp = torch.randint(-127, 128, shp, generator=gen, device="cuda").to(torch.int8)
        scales = {"k_scale": torch.rand(shp[:3], generator=gen, device="cuda") * 0.02 + 1e-3,
                  "v_scale": torch.rand(shp[:3], generator=gen, device="cuda") * 0.02 + 1e-3}
        return kp, vp, scales
    kp = torch.randn(shp, generator=gen, device="cuda").bfloat16()
    vp = torch.randn(shp, generator=gen, device="cuda").bfloat16()
    return kp, vp, {}


def _attn_case(kind, gen, shape, lengths):
    """The pool holds each lane's pages below its length (distinct, in
    shuffled order) and the trash page 0, which every table entry past a
    lane's length names.  Returns the poisoned inputs and the clean pools:
    stale rows of each lane's last page and the whole trash page poisoned."""
    b, ps, n_tbl = shape["b"], shape["ps"], shape["n_tbl"]
    used = [-(-n // ps) for n in lengths]
    n_pages = 1 + sum(used)
    perm = (torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1).to(torch.int32)
    tables = torch.zeros((b, n_tbl), dtype=torch.int32, device="cuda")
    start = 0
    for lane, n in enumerate(used):
        tables[lane, :n] = perm[start:start + n]
        start += n
    q = torch.randn((b, shape["hkv"], shape["g"], shape["d"]), generator=gen,
                    device="cuda").bfloat16()
    kp, vp, scales = _attn_pools(kind, gen, n_pages, shape)
    clean = (kp.clone(), vp.clone())
    big = 127 if kind == "int8" else 3.0e4
    for lane, n in enumerate(lengths):
        last, off = tables[lane, (n - 1) // ps], (n - 1) % ps + 1
        for pool in (kp, vp):
            pool[last, off:] = big
    for pool in (kp, vp):
        pool[0] = -big
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables, lengths, scales, clean


def _attn_bound(q, kp, tables, lengths, scales):
    """Bytes the function needs: q, the K and V rows below each length (and
    their scales), the table entries naming them, lengths and the output;
    operations: QK and PV, 4 per row, head and element, at the bf16 rate."""
    b, hkv, g, d = q.shape
    ps = kp.shape[1]
    rows = int(lengths.sum())
    pages = int(((lengths + ps - 1) // ps).sum())
    kv_bytes = 2 * rows * hkv * d * kp.element_size() + (2 * rows * hkv * 4 if scales else 0)
    nbytes = q.numel() * q.element_size() + kv_bytes + 4 * pages + 4 * b + 4 * b * hkv * g * d
    return bound(nbytes, 4.0 * rows * hkv * g * d, BF16_OPS_PER_S)


def _sdpa_ms(q, kp, vp, tables, lengths):
    """``scaled_dot_product_attention`` on the gathered bf16 view (the G query
    heads of a KV head as its queries, the table's rows as keys, masked
    past each length)."""
    import torch.nn.functional as F
    b, hkv, g, d = q.shape
    n_tbl, ps = tables.shape[1], kp.shape[1]
    k_all = kp[tables.long()].reshape(b, n_tbl * ps, hkv, d).permute(0, 2, 1, 3)
    v_all = vp[tables.long()].reshape(b, n_tbl * ps, hkv, d).permute(0, 2, 1, 3)
    mask = (torch.arange(n_tbl * ps, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    return device_ms(lambda i: F.scaled_dot_product_attention(q, k_all, v_all, attn_mask=mask),
                     1, iters=50)


def phase_attention(card):
    """Both pools at shapes (a), (b) and (c): the kernel against the plain version
    on clean and on poisoned pools, two calls bitwise equal; device and
    event time (shape (b) cold: pool copies rotated past the L2), plain
    time, bound and ``scaled_dot_product_attention`` (bf16 pools)."""
    from repro_torch.kernels.paged_attention import paged_attention, paged_attention_plain
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for name, shape in ATTN_SHAPES.items():
        lengths = attn_lengths(name, shape)
        for kind in ("bf16", "int8"):
            q, kp, vp, tables, lengths_t, scales, (kc, vc) = _attn_case(kind, gen, shape, lengths)
            got = paged_attention(q, kp, vp, tables, lengths_t, **scales)
            again = paged_attention(q, kp, vp, tables, lengths_t, **scales)
            want = paged_attention_plain(q, kc, vc, tables, lengths_t, **scales)
            want_p = paged_attention_plain(q, kp, vp, tables, lengths_t, **scales)
            torch.cuda.synchronize()
            err = max((got - want).abs().max().item(), (got - want_p).abs().max().item())
            label = f"paged attention {kind} {name}"
            require(torch.allclose(got, want, **ATTN_TOL)
                    and torch.allclose(got, want_p, **ATTN_TOL), f"{label}: max |diff| {err}")
            require(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
            require(torch.equal(got, again), f"{label}: two calls differ")
            del kc, vc, want, want_p, again

            nb = copies_for(kp.numel() * kp.element_size() * 2) if name == "long" else 1
            pools = [(kp, vp, scales)] + [(kp.clone(), vp.clone(),
                                           {k: v.clone() for k, v in scales.items()})
                                          for _ in range(nb - 1)]
            iters = 50 if name == "long" else 200
            t_kernel, t_event = kernel_times(
                lambda i: paged_attention(q, pools[i][0], pools[i][1], tables, lengths_t,
                                          **pools[i][2]), nb, iters=iters)
            t_plain = time_ms(lambda i: paged_attention_plain(q, pools[i][0], pools[i][1], tables,
                                                              lengths_t, **pools[i][2]),
                              nb, iters=20 if name == "main" else 5, warmup=1)
            t_lib = _sdpa_ms(q, kp, vp, tables, lengths_t) if kind == "bf16" else None
            b_ms, b_by = _attn_bound(q, kp, tables, lengths_t, scales)
            b, hkv, g, d = q.shape
            out[(kind, name)] = dict(
                ms=t_kernel, event_ms=t_event, plain_ms=t_plain, library_ms=t_lib,
                bound_ms=b_ms, bound_by=b_by, fraction_of_bound=b_ms / t_kernel,
                max_abs_err=err, copies=nb,
                shape=(f"{kind} pool B={b} Hkv={hkv} G={g} D={d} ps={kp.shape[1]} "
                       f"P={tables.shape[1]}, {int(lengths_t.sum())} rows"))
            lib = f"{t_lib:.4f} ms" if t_lib is not None else "n/a"
            lens = (lengths if name == "main"
                    else f"{min(lengths)}..{max(lengths)} (mean {np.mean(lengths):.0f})")
            print(f"[attn] {kind} {name} B={b} Hkv={hkv} G={g} D={d} ps={kp.shape[1]} "
                  f"P={tables.shape[1]} lengths {lens}: max |diff| {err:.3g} (stale rows "
                  f"poisoned), two calls bitwise equal; kernel {t_kernel:.4f} ms device "
                  f"({t_event:.4f} ms by events; {nb} pool cop{'y' if nb == 1 else 'ies'}), "
                  f"plain {t_plain:.4f} ms, sdpa {lib}, bound {b_ms:.5f} ms ({b_by}, "
                  f"{b_ms / t_kernel:.1%} of it) [{card}]", flush=True)
            del pools, q, kp, vp, tables, scales
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 4. main path
# ---------------------------------------------------------------------------

def _traffic(n, vocab, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(17, 129, n)
    gens = rng.integers(16, 33, n)
    return [(2 * i, rng.integers(0, vocab, int(p)).tolist(), int(g))
            for i, (p, g) in enumerate(zip(lens, gens))]


def _serve(cfg, params, arrivals, n_slots, cache_mode="paged"):
    from repro_torch.configs import default_cache_len
    from repro_torch.serving import EngineConfig, ServingEngine
    ecfg = EngineConfig(n_slots=n_slots, page_size=16, prefill_buckets=(32, 64, 128),
                        cache_len=default_cache_len(128, 32), cache_mode=cache_mode)
    engine = ServingEngine(cfg, params, ecfg, device="cuda")
    metrics = engine.run(arrivals)
    torch.cuda.synchronize()
    return engine, metrics


def _kernel_modules():
    from repro_torch.backends import impls
    from repro_torch.kernels import deas_gemm, paged_attention, spoga_gemm, spoga_gemm_dequant
    return impls, deas_gemm, paged_attention, spoga_gemm, spoga_gemm_dequant


def reset_counts() -> None:
    impls, *kernels = _kernel_modules()
    for mod in kernels:
        mod.reset_counts()
    impls.INT_MM_CALLS = 0


def read_counts() -> tuple[dict, dict]:
    """(launches by kernel, plain-version calls by module) since the reset;
    ``torch._int_mm`` counts the ``cuda_direct`` backend's library calls."""
    impls, deas, attn, int_gemm, gemm = _kernel_modules()
    launches = {"spoga_gemm_dequant": gemm.LAUNCHES, "spoga_gemm": int_gemm.LAUNCHES,
                "nibble_gemm": deas.NIBBLE_LAUNCHES, "deas_combine": deas.COMBINE_LAUNCHES,
                "paged_attention": attn.LAUNCHES, "torch._int_mm": impls.INT_MM_CALLS}
    plain = {"spoga_gemm_dequant": gemm.PLAIN_CALLS, "spoga_gemm": int_gemm.PLAIN_CALLS,
             "deas_gemm": deas.PLAIN_CALLS, "paged_attention": attn.PLAIN_CALLS}
    return launches, plain


def check_counts(launches, plain, expect, label) -> None:
    """The kernels in ``expect`` launched, every other GEMM route did not,
    and no plain version ran."""
    print(f"[counts] {label}: launches {launches}, plain-version calls {plain}", flush=True)
    for name, n in launches.items():
        if name in expect:
            require(n > 0, f"{label}: {name} never launched")
        else:
            require(n == 0, f"{label}: {name} launched {n} times off its path")
    require(all(v == 0 for v in plain.values()), f"{label}: a plain version ran on the card")


def _counted_run(cfg, params, arrivals, n_slots, label):
    """Serve ``arrivals`` with every kernel count at 0 just before; return
    (metrics, engine, launches) read just after."""
    reset_counts()
    engine, metrics = _serve(cfg, params, arrivals, n_slots)
    launches, plain = read_counts()
    check_counts(launches, plain, ("spoga_gemm_dequant", "paged_attention"), label)
    return metrics, engine, launches


def _check_finished(metrics, arrivals, vocab, label):
    require(len(metrics.finished) == len(arrivals),
            f"{label}: {len(metrics.finished)} of {len(arrivals)} requests finished")
    streams = {r.req_id: r.output_tokens for r in metrics.finished}
    for rid, (_, _, gen) in enumerate(arrivals):
        toks = streams[rid]
        require(len(toks) == gen, f"{label}: request {rid} gave {len(toks)} of {gen} tokens")
        require(all(0 <= t < vocab for t in toks), f"{label}: token out of range")
    return streams


def full_width_params():
    """Full-width llama3.2-1b weights from ``init_params(seed=0)`` on the card
    (the weights do not depend on the quant mode)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config("llama3.2-1b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=ENGINE_SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"[weights] llama3.2-1b full width ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}) "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    return params


def phase_main(card, params):
    from repro_torch.configs import get_config
    cfg = get_config("llama3.2-1b").with_(quant_mode="int8_spoga", kv_cache_dtype="int8")
    print("[main] int8_spoga, int8 paged KV, ServingEngine", flush=True)

    arrivals = _traffic(8, cfg.vocab_size, ENGINE_SEED)
    torch.cuda.reset_peak_memory_stats()
    metrics, engine, launches = _counted_run(cfg, params, arrivals, 4, "int8 KV, 8 requests")
    streams = _check_finished(metrics, arrivals, cfg.vocab_size, "int8 KV")
    rep = metrics.report()
    require(not engine.store.manager.invariant_violations(), "page bookkeeping broken")
    require(engine.store.manager.pages_in_use == 0, "pages leaked after the run")
    print(f"[main] {rep['requests']} finished, {rep['generated_tokens']} tokens in "
          f"{rep['wall_s']:.3f} s: {rep['tokens_per_s']:.1f} tok/s, TTFT mean "
          f"{1e3 * rep['ttft_mean_s']:.1f} ms, decode step mean "
          f"{1e3 * rep['decode_step_mean_s']:.2f} ms ({rep['decode_steps']} steps, "
          f"{rep['prefills']} prefills, peak lanes {rep['peak_running']}, defrag "
          f"{rep['defrag_count']} times, {rep['defrag_pages_moved']} pages), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]", flush=True)
    expect_gemm = 7 * cfg.n_layers * (rep["decode_steps"] + rep["prefills"])
    expect_attn = cfg.n_layers * rep["decode_steps"]
    require(launches["spoga_gemm_dequant"] == expect_gemm,
            f"GEMM launches {launches['spoga_gemm_dequant']} != {expect_gemm}")
    require(launches["paged_attention"] == expect_attn,
            f"attention launches {launches['paged_attention']} != {expect_attn}")

    agree = total = 0
    for rid, (_, prompt, gen) in enumerate(arrivals):
        _, solo = _serve(cfg, params, [(0, prompt, gen)], 1)
        toks = solo.finished[0].output_tokens
        require(toks[0] == streams[rid][0],
                f"request {rid}: solo first token {toks[0]} != batched {streams[rid][0]}")
        agree += sum(a == b for a, b in zip(toks, streams[rid]))
        total += len(toks)
    print(f"[main] solo runs: first tokens equal, greedy agreement {agree}/{total}", flush=True)

    cfg16 = cfg.with_(kv_cache_dtype="bf16")
    arrivals16 = _traffic(4, cfg.vocab_size, ENGINE_SEED + 1)
    m16, _, launches16 = _counted_run(cfg16, params, arrivals16, 4, "bf16 KV, 4 requests")
    _check_finished(m16, arrivals16, cfg.vocab_size, "bf16 KV")
    r16 = m16.report()
    print(f"[main] bf16 KV: {r16['tokens_per_s']:.1f} tok/s, decode step mean "
          f"{1e3 * r16['decode_step_mean_s']:.2f} ms [{card}]", flush=True)
    profile = {"cache_len_168": phase_profile(cfg, params, card, "int8_spoga"),
               "context_2048": phase_profile(cfg, params, card, "int8_spoga", steps=4,
                                             prompt_len=2048)}
    return launches, launches16, profile, rep


def _kernel_group(name: str) -> str:
    for kernel in ("spoga_gemm_dequant_kernel", "spoga_gemm_kernel", "nibble_gemm_kernel",
                   "deas_combine_kernel"):
        if kernel in name:
            return kernel.replace("_kernel", " kernel")
    if "paged_attention_kernel" in name:
        return "paged_attention kernel"
    if any(t in name.lower() for t in ("gemm", "xmma", "cutlass", "cublas", "matmul", "nvjet")):
        return "library matmul (bf16 unembed)"
    return ("elementwise and reductions (weight + activation quantization, nibble slicing, "
            "norms, rope)")


def _busy_engine(cfg, params, prompt_len=64, cache_mode="paged"):
    """A 4-lane engine with 4 requests of ``prompt_len`` tokens admitted and
    decoding (same every call)."""
    from repro_torch.configs import default_cache_len
    from repro_torch.serving import EngineConfig, ServingEngine
    buckets = (32, 64, 128) if prompt_len <= 128 else (prompt_len,)
    engine = ServingEngine(cfg, params, EngineConfig(
        n_slots=4, page_size=16, prefill_buckets=buckets,
        cache_len=default_cache_len(max(128, prompt_len), 32), cache_mode=cache_mode),
        device="cuda")
    rng = np.random.default_rng(ENGINE_SEED + 2)
    for _ in range(4):
        engine.add_request(rng.integers(0, cfg.vocab_size, prompt_len).tolist(), 32)
    for _ in range(6):                       # 4 admissions, then decode only
        engine.step()
    torch.cuda.synchronize()
    return engine


def _timed_steps(engine, steps):
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_profile(cfg, params, card, label, steps=5, prompt_len=64, cache_mode="paged"):
    """Device time by kernel over ``steps`` decode steps with 4 busy lanes of
    ``prompt_len``-token prompts; returns {"attn_ms": ``paged_attention``'s
    device time per step, "device_ms", "wall_ms", "busy"} per step, or None
    where the profiler recorded no device time.  A paged engine launches one
    ``paged_attention`` kernel per layer and step, a slot engine none.

    Two engines fed the same requests do the same steps: the first is
    timed without the profiler (wall), the second under it (device time
    per kernel), so the busy share divides like by like."""
    from torch.profiler import ProfilerActivity, profile

    wall_plain = _timed_steps(_busy_engine(cfg, params, prompt_len, cache_mode), steps)
    engine = _busy_engine(cfg, params, prompt_len, cache_mode)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = _timed_steps(engine, steps)
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / steps   # ms per step
    label = f"{label}, {cache_mode} KV, {prompt_len}-token prompts"
    if not kernels or total <= 0:
        print(f"[profile] {label}: the profiler recorded no device time: breakdown not "
              f"measured", flush=True)
        return None
    step_ms, plain_ms = 1e3 * wall / steps, 1e3 * wall_plain / steps
    print(f"[profile] {label}, {steps} decode steps, 4 lanes: {total:.3f} ms/step device time; "
          f"wall {plain_ms:.3f} ms/step without the profiler (device busy "
          f"{100 * total / plain_ms:.1f}%), {step_ms:.3f} ms/step with it (busy "
          f"{100 * total / step_ms:.1f}%) [{card}]", flush=True)
    groups: dict[str, float] = {}
    for e in kernels:
        g = _kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3 / steps
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {ms:.3f} ms/step ({100 * ms / total:.1f}% of device time) {g}",
              flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile]   top: {e.self_device_time_total / 1e3 / steps:.3f} ms/step, "
              f"{e.count // steps} launches/step  {e.key[:90]}", flush=True)
    attn = [e for e in kernels if "paged_attention_kernel" in e.key]
    n_attn = sum(e.count for e in attn)
    want_attn = cfg.n_layers * steps if cache_mode == "paged" else 0
    require(n_attn == want_attn,
            f"{label}: {n_attn} paged_attention kernels in {steps} steps, want {want_attn}")
    attn_ms = groups.get("paged_attention kernel", 0.0)
    print(f"[profile]   paged_attention: {attn_ms:.4f} ms/step, {100 * attn_ms / total:.2f}% of "
          f"device time, {n_attn // steps} launches/step", flush=True)
    return {"attn_ms": attn_ms, "device_ms": total, "wall_ms": plain_ms,
            "busy": total / plain_ms}


# ---------------------------------------------------------------------------
# 4b. slot-mode serving
# ---------------------------------------------------------------------------

def phase_slot(card, params, paged_rep):
    """Phase 4's traffic through slot-mode ``ServingEngine``s (int8, then
    bf16 slot KV): every request finishes; every projection launches
    ``spoga_gemm_dequant`` (112 a step: 7 per layer), ``paged_attention``
    never launches and no plain version runs; the decode profile of 4 busy
    lanes.  Returns the int8 run's GEMM launches and the profile."""
    from repro_torch.configs import get_config
    cfg = get_config("llama3.2-1b").with_(quant_mode="int8_spoga")
    arrivals = _traffic(8, cfg.vocab_size, ENGINE_SEED)
    out = {}
    for kv in ("int8", "bf16"):
        c = cfg.with_(kv_cache_dtype=kv)
        label = f"slot {kv} KV, 8 requests"
        reset_counts()
        engine, metrics = _serve(c, params, arrivals, 4, cache_mode="slot")
        launches, plain = read_counts()
        check_counts(launches, plain, ("spoga_gemm_dequant",), label)
        _check_finished(metrics, arrivals, cfg.vocab_size, label)
        rep = metrics.report()
        per_pass = 7 * cfg.n_layers
        require(launches["spoga_gemm_dequant"] == per_pass * (rep["decode_steps"] + rep["prefills"]),
                f"{label}: {launches['spoga_gemm_dequant']} GEMM launches, want {per_pass} per "
                f"decode step and per prefill")
        require(engine.store.pos.tolist() == [0] * 4, f"{label}: a free lane's pos drifted")
        print(f"[slot] {kv} KV: {rep['requests']} finished, {rep['generated_tokens']} tokens, "
              f"{rep['tokens_per_s']:.1f} tok/s, TTFT mean {1e3 * rep['ttft_mean_s']:.1f} ms, "
              f"decode step mean {1e3 * rep['decode_step_mean_s']:.2f} ms ({rep['decode_steps']} "
              f"steps, {launches['spoga_gemm_dequant']} spoga_gemm_dequant launches = "
              f"{per_pass} a step); paged int8 (phase 4): {paged_rep['tokens_per_s']:.1f} tok/s, "
              f"TTFT mean {1e3 * paged_rep['ttft_mean_s']:.1f} ms, decode step mean "
              f"{1e3 * paged_rep['decode_step_mean_s']:.2f} ms [{card}]", flush=True)
        out[kv] = launches["spoga_gemm_dequant"]
    prof = phase_profile(cfg.with_(kv_cache_dtype="int8"), params, card, "int8_spoga",
                         cache_mode="slot")
    return out, prof


SLOT_VS_PAGED_STEPS = 8


def _slot_vs_paged(cfg, params):
    """4 prompts of phase 4's traffic prefilled once each, their caches
    inserted into a slot cache and into a paged one (int8 KV), then
    SLOT_VS_PAGED_STEPS decode steps over each, both fed the paged run's
    greedy tokens.  Returns (max |logit diff| / max |logit| over the steps,
    greedy agreement, the steps' paged_attention launches)."""
    from repro_torch.configs import pages_for
    from repro_torch.models import decode_step, prefill
    from repro_torch.paging.cache import PagedCache
    from repro_torch.serving import SlotCache
    ps, cache_len, steps = 16, 176, SLOT_VS_PAGED_STEPS
    prompts = [p for _, p, _ in _traffic(8, cfg.vocab_size, ENGINE_SEED)][:4]
    slot = SlotCache(cfg, 4, cache_len, device="cuda")
    paged = PagedCache(cfg, 4, cache_len, ps, device="cuda")
    mgr = paged.manager
    first = []
    for lane, prompt in enumerate(prompts):
        single_len = pages_for(len(prompt), ps) * ps
        tokens = torch.zeros((1, single_len), dtype=torch.int32)
        tokens[0, :len(prompt)] = torch.tensor(prompt, dtype=torch.int32)
        logits, single = prefill(params, cfg, tokens.cuda(), single_len,
                                 lengths=torch.tensor([len(prompt)], dtype=torch.int32,
                                                      device="cuda"))
        slot.insert(single, lane)
        mgr.admit(lane, len(prompt) + steps + 1)
        ids = mgr.alloc(lane, single_len // ps)
        mgr.set_length(lane, len(prompt))
        paged.insert(single, lane, ids, len(prompt))
        first.append(int(logits.argmax(-1)[0]))
    tok = torch.tensor(first, dtype=torch.int32, device="cuda")
    active = torch.ones((4,), dtype=torch.bool, device="cuda")
    reset_counts()
    worst, agree = 0.0, 0
    for step in range(steps):
        for lane in range(4):
            mgr.ensure(lane, int(mgr.lengths[lane]) + 1)
        paged.sync_tables()
        lp, _ = decode_step(params, cfg, tok, paged.cache, active=active)
        ls, _ = decode_step(params, cfg, tok, slot.cache, active=active)
        mgr.advance(range(4))
        lp, ls = lp.float(), ls.float()
        require(bool(torch.isfinite(ls).all()), f"slot vs paged step {step}: slot logits "
                                                f"not finite")
        worst = max(worst, (lp - ls).abs().max().item() / lp.abs().max().item())
        agree += int((lp.argmax(-1) == ls.argmax(-1)).sum())
        tok = lp.argmax(-1).to(torch.int32)                # teacher: the paged stream
    torch.cuda.synchronize()
    launches, plain = read_counts()
    gemm = ("spoga_gemm_dequant",) if cfg.quant_mode == "int8_spoga" else ()
    check_counts(launches, plain, gemm + ("paged_attention",),
                 f"slot vs paged decode, {cfg.n_layers} layers, {cfg.quant_mode}")
    require(launches["paged_attention"] == cfg.n_layers * steps,
            f"slot vs paged: {launches['paged_attention']} paged_attention launches, want "
            f"{cfg.n_layers * steps} (the paged cache's steps only)")
    return worst, agree


def phase_slot_vs_paged(card, params):
    """Slot against paged decode inside the port, on the card, int8 KV.
    Paged attention is the kernel here, slot attention plain torch
    (bitwise equality is a CPU contract only).

    Held: phase 6's decode model (2 layers at full width, bf16 GEMMs,
    weights from seed 3), the logits within phase 6's LOGIT_TOL x max at
    every step.  Printed: the same model at ``int8_spoga`` and the full
    16-layer model at ``int8_spoga``, where every projection re-quantizes
    its input to int8 per row, so that a difference of one f32 ulp can move
    a value by a whole quantization step; card and CPU differ there by as
    much as slot and paged do."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config("llama3.2-1b").with_(quant_mode="int8_spoga", kv_cache_dtype="int8")
    small = cfg.with_(quant_mode="bf16", n_layers=2)
    small_params = init_params(small, seed=3, device="cuda")
    n = 4 * SLOT_VS_PAGED_STEPS
    for c, p, what in ((small, small_params, "2 layers at full width, bf16 GEMMs"),
                       (small.with_(quant_mode="int8_spoga"), small_params,
                        "2 layers at full width, int8_spoga"),
                       (cfg, params, f"{cfg.n_layers} layers, int8_spoga, phase 4's weights")):
        worst, agree = _slot_vs_paged(c, p)
        print(f"[slot] slot vs paged, {what}, int8 KV, 4 lanes, {SLOT_VS_PAGED_STEPS} decode "
              f"steps fed the paged tokens: max |logit diff| {worst:.4g} x max |logit|, greedy "
              f"agreement {agree}/{n} [{card}]", flush=True)
        if c is small:
            require(worst <= LOGIT_TOL, f"slot vs paged: logits differ by {worst:.4g} x max > "
                                        f"{LOGIT_TOL}")


def phase_default_llm(card):
    """``LLM("llama3.2-1b").generate(...)`` with no runtime: bf16 GEMMs (no
    kernel of the port runs), slot bf16 KV, its own random weights."""
    from repro_torch.api import LLM
    prompts = [p for _, p, _ in _traffic(4, 128_256, ENGINE_SEED + 3)]
    t0 = time.perf_counter()
    llm = LLM("llama3.2-1b")
    require(llm.runtime.kv.mode == "slot" and llm.config.quant_mode == "bf16",
            "the default runtime is not slot KV with bf16 GEMMs")
    reset_counts()
    outs = llm.generate(prompts, max_new_tokens=12)
    torch.cuda.synchronize()
    launches, plain = read_counts()
    check_counts(launches, plain, (), "default LLM")
    require(all(len(o.token_ids) == 12 and o.finish_reason == "length" for o in outs),
            "default LLM: a request did not finish")
    require(all(0 <= t < llm.config.vocab_size for o in outs for t in o.token_ids),
            "default LLM: token out of range")
    rep = llm.metrics.report()
    print(f"[default] LLM('llama3.2-1b').generate: {rep['requests']} prompts x 12 tokens on "
          f"{llm.device}, slot bf16 KV, bf16 GEMMs; {rep['tokens_per_s']:.1f} tok/s, decode "
          f"step mean {1e3 * rep['decode_step_mean_s']:.2f} ms; "
          f"{time.perf_counter() - t0:.1f} s with its init [{card}]", flush=True)
    del llm


LONG_PREFILL = 16_384


def phase_long_prefill(card, params):
    """Full-width llama3.2-1b prefills LONG_PREFILL tokens at ``int8_spoga``
    into an int8 cache: finite logits, time and peak memory.  Then
    ``multihead_attention`` alone at that length (B=1, 32/8 heads, D=64):
    64 query rows on and beside chunk edges equal those rows computed on
    their own (a one-row chunk at the row's offset) within one bf16 ulp of
    the output's largest magnitude (cuBLAS may sum a one-row product in
    another order)."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn
    from repro_torch.models import prefill
    cfg = get_config("llama3.2-1b").with_(quant_mode="int8_spoga", kv_cache_dtype="int8")
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, LONG_PREFILL))
                              .astype(np.int32)).cuda()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg, tokens, LONG_PREFILL)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches, plain = read_counts()
    check_counts(launches, plain, ("spoga_gemm_dequant",), f"{LONG_PREFILL}-token prefill")
    require(launches["spoga_gemm_dequant"] == 7 * cfg.n_layers,
            f"long prefill: {launches['spoga_gemm_dequant']} GEMM launches, want "
            f"{7 * cfg.n_layers}")
    require(tuple(logits.shape) == (1, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
            "long prefill: logits not finite")
    require(int(cache["pos"][0]) == LONG_PREFILL, "long prefill: cache pos wrong")
    print(f"[long] llama3.2-1b full width, int8_spoga, int8 KV, {LONG_PREFILL}-token prefill: "
          f"{elapsed:.3f} s, logits finite, peak memory {peak / 2**30:.2f} GiB "
          f"({(peak - base) / 2**30:.2f} GiB above the weights and inputs) [{card}]", flush=True)
    del logits, cache

    g = torch.Generator(device="cuda").manual_seed(6)
    q = torch.randn((1, LONG_PREFILL, 32, 64), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((1, LONG_PREFILL, 8, 64), generator=g, device="cuda").bfloat16()
            for _ in range(2))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = attn.multihead_attention(q, k, v)
    torch.cuda.synchronize()
    attn_s = time.perf_counter() - t0
    attn_peak = torch.cuda.max_memory_allocated() - base
    chunk = attn._pick_chunk(LONG_PREFILL)
    edges = range(chunk, LONG_PREFILL, chunk)
    rows = sorted({0, LONG_PREFILL - 1} | {e + d for e in edges for d in (-1, 0)})[:64]
    qg = q.reshape(1, LONG_PREFILL, 4, 8, 64)
    kf, vf = k.float(), v.float()
    want = torch.cat([attn._attend_chunk(qg[:, r:r + 1], kf, vf, r, v.dtype).reshape(1, 1, 32, 64)
                      for r in rows], dim=1).float()
    got = out[:, rows].float()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    same = int((got == want).all(dim=-1).all(dim=-1).sum())
    require(bool(torch.isfinite(out.float()).all()), "16K attention: output not finite")
    require(err <= 2.0 ** -7 * scale, f"16K attention: chunked rows off their own by {err} > "
                                      f"{2.0 ** -7 * scale}")
    print(f"[long] multihead_attention B=1 S={LONG_PREFILL} 32/8 heads D=64: {chunk}-row chunks, "
          f"{attn_s:.3f} s, peak memory {attn_peak / 2**30:.2f} GiB above its inputs; {len(rows)} "
          f"rows on and beside chunk edges against their own one-row chunks: max |diff| "
          f"{err:.3g} (scale {scale:.3g}), {same} of {len(rows)} rows bitwise [{card}]",
          flush=True)
    return {"prefill_s": elapsed, "prefill_peak_gib": peak / 2**30, "attention_s": attn_s,
            "attention_peak_gib": attn_peak / 2**30, "attention_max_abs_err": err}


# ---------------------------------------------------------------------------
# 5. the paper's dataflows through the LLM facade
# ---------------------------------------------------------------------------

# (label, QuantRuntime arguments, the GEMM route its run must launch)
DATAFLOWS = [
    ("spoga fused", ("int8_spoga", None), ("spoga_gemm_dequant",)),
    ("spoga unfused", ("int8_spoga", "cuda_spoga"), ("spoga_gemm",)),
    ("deas", ("int8_deas", None), ("nibble_gemm", "deas_combine")),
    ("direct", ("int8_direct", None), ("torch._int_mm",)),
]
FACADE_NEW_TOKENS = 24


def phase_dataflows(card, params):
    """The same weights and prompts through one ``LLM`` per dataflow, in two
    rounds in opposite orders (so that drift on the card or its host shows
    as a difference between rounds); every kernel count is set to 0 just
    before each ``generate`` and read just after.  Returns {label: launches}
    of the first round."""
    from repro_torch.api import LLM, KVConfig, QuantRuntime, RuntimeConfig, SchedulerConfig
    from repro_torch.configs import default_cache_len, get_config
    prompts = [p for _, p, _ in _traffic(8, 128_256, ENGINE_SEED)]
    kv = KVConfig(mode="paged", dtype="int8", page_size=16,
                  cache_len=default_cache_len(128, 32))
    sched = SchedulerConfig(n_slots=4, prefill_buckets=(32, 64, 128))
    per_call = {"spoga_gemm_dequant": 1, "spoga_gemm": 1, "nibble_gemm": 4,
                "deas_combine": 1, "torch._int_mm": 1}
    first, counts = None, {}
    reports: dict[str, list] = {label: [] for label, _, _ in DATAFLOWS}
    for rnd, order in enumerate((DATAFLOWS, DATAFLOWS[::-1])):
        for label, (mode, backend), route in order:
            llm = LLM(arch="llama3.2-1b", params=params, runtime=RuntimeConfig(
                quant=QuantRuntime(mode=mode, gemm_backend=backend), kv=kv, scheduler=sched))
            reset_counts()
            outs = llm.generate(prompts, max_new_tokens=FACADE_NEW_TOKENS)
            torch.cuda.synchronize()
            launches, plain = read_counts()
            check_counts(launches, plain, route + ("paged_attention",),
                         f"facade {label}, round {rnd + 1}")
            streams = [o.token_ids for o in outs]
            require(all(len(t) == FACADE_NEW_TOKENS and o.finish_reason == "length"
                        for t, o in zip(streams, outs)),
                    f"facade {label}: a request did not finish")
            require(all(0 <= t < llm.config.vocab_size for s in streams for t in s),
                    f"facade {label}: token out of range")
            if first is None:
                first = streams
                require(len({t for s in streams for t in s}) > 2, "facade streams collapsed")
            require(streams == first, f"facade {label}: greedy streams differ from the "
                                      f"first run's")
            rep = llm.metrics.report()
            gemms = 7 * llm.config.n_layers * (rep["decode_steps"] + rep["prefills"])
            for name in route:
                require(launches[name] == per_call[name] * gemms,
                        f"facade {label}: {name} launched {launches[name]}, want "
                        f"{per_call[name] * gemms}")
            counts.setdefault(label, launches)
            reports[label].append(rep)
            print(f"[facade] round {rnd + 1} {label} ({mode}, gemm_backend={backend}): "
                  f"{rep['requests']} finished, {rep['generated_tokens']} tokens, "
                  f"{rep['tokens_per_s']:.1f} tok/s, decode step mean "
                  f"{1e3 * rep['decode_step_mean_s']:.2f} ms ({rep['decode_steps']} steps), "
                  f"TTFT mean {1e3 * rep['ttft_mean_s']:.1f} ms, prefill total "
                  f"{rep['prefill_s']:.3f} s, defrag {rep['defrag_count']} times "
                  f"[{card}]", flush=True)
            del llm
    base = reports[DATAFLOWS[0][0]]
    for label, reps in reports.items():
        ratios = [(r["decode_step_mean_s"] / b["decode_step_mean_s"],
                   r["tokens_per_s"] / b["tokens_per_s"]) for r, b in zip(reps, base)]
        print(f"[facade] {label} against spoga fused, rounds 1 and 2: decode step "
              f"{', '.join(f'{d:.2f}x' for d, _ in ratios)}; tok/s "
              f"{', '.join(f'{t:.2f}x' for _, t in ratios)}", flush=True)
    print(f"[facade] 4 dataflows x 2 rounds, 8 prompts x {FACADE_NEW_TOKENS} tokens: greedy "
          f"streams identical", flush=True)
    for mode in ("int8_deas", "int8_direct"):
        phase_profile(get_config("llama3.2-1b").with_(quant_mode=mode, kv_cache_dtype="int8"),
                      params, card, mode)
    return counts


# ---------------------------------------------------------------------------
# 6. card against CPU
# ---------------------------------------------------------------------------

def _to_cpu(t):
    if isinstance(t, dict):
        return {k: _to_cpu(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_to_cpu(v) for v in t)
    return t.cpu()


def phase_cpu_parity():
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, prefill
    cfg = get_config("llama3.2-1b").with_(quant_mode="int8_spoga", kv_cache_dtype="int8",
                                          n_layers=2)
    params = init_params(cfg, seed=3, device="cuda")
    cpu_params = _to_cpu(params)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 16)).astype(np.int32))
    t0 = time.perf_counter()
    got, _ = prefill(params, cfg, tokens.cuda(), 16)
    got = got.cpu()
    want, _ = prefill(cpu_params, cfg, tokens, 16)
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    top2 = torch.topk(want[0], 2).values
    print(f"[cpu] 2-layer full width, 16-token prefill: max |logit diff| {err:.4g} of "
          f"max |logit| {scale:.4g} (tolerance {LOGIT_TOL} x max), greedy token card "
          f"{int(got.argmax())} cpu {int(want.argmax())} (cpu top-2 margin "
          f"{(top2[0] - top2[1]).item():.4g}); {time.perf_counter() - t0:.1f} s", flush=True)
    require(bool(torch.isfinite(got).all()), "card logits not finite")
    require(int(got.argmax()) == int(want.argmax()), "first greedy token differs from the CPU's")
    require(err <= LOGIT_TOL * scale, f"card logits off the CPU's by {err} > {LOGIT_TOL * scale}")


LONG_PROMPT = 1000
LONG_STEPS = 4


def phase_cpu_long_decode(card):
    """Paged decode over a long context, card against CPU: the same 2-layer
    full-width model and int8 paged KV on both, a 1,000-token prompt, then
    LONG_STEPS decode steps fed the CPU's greedy tokens; the card's logits
    within LOGIT_TOL x max of the CPU's at every step.

    ``quant_mode="bf16"`` keeps the CPU's prefill of 1,000 tokens within
    seconds: the plain sliced GEMMs on the CPU would take minutes there.
    The card's decode attention is the ``paged_attention`` kernel over 8
    KV heads of one lane: the prompt gives every one of its splits (at most
    MAX_SPLITS; split r takes pages r, r + S, ...) at least 4 pages."""
    from repro_torch.configs import default_cache_len, get_config, pages_for
    from repro_torch.kernels import paged_attention as attn_mod
    from repro_torch.kernels.paged_attention import MAX_SPLITS
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.paging.cache import PagedCache
    cfg = get_config("llama3.2-1b").with_(quant_mode="bf16", kv_cache_dtype="int8", n_layers=2)
    ps = 16
    cache_len = default_cache_len(LONG_PROMPT, LONG_STEPS)
    require(LONG_PROMPT >= 4 * MAX_SPLITS * ps,
            f"the {LONG_PROMPT}-token prompt gives fewer than 4 pages to each of "
            f"{MAX_SPLITS} splits")
    params = init_params(cfg, seed=3, device="cuda")
    rng = np.random.default_rng(4)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, LONG_PROMPT)).astype(np.int32))
    single_len = pages_for(LONG_PROMPT, ps) * ps
    tokens = torch.zeros((1, single_len), dtype=torch.int32)
    tokens[0, :LONG_PROMPT] = prompt[0]
    lengths = torch.tensor([LONG_PROMPT], dtype=torch.int32)

    def start(device, p):
        store = PagedCache(cfg, n_lanes=1, cache_len=cache_len, page_size=ps, device=device)
        mgr = store.manager
        mgr.admit(0, LONG_PROMPT + LONG_STEPS)
        page_ids = mgr.alloc(0, single_len // ps)
        mgr.set_length(0, LONG_PROMPT)
        logits, single = prefill(p, cfg, tokens.to(device), single_len,
                                 lengths=lengths.to(device))
        store.insert(single, 0, page_ids, LONG_PROMPT)
        return store, logits

    def step(store, p, tok):
        mgr = store.manager
        mgr.ensure(0, int(mgr.lengths[0]) + 1)
        store.sync_tables()
        device = store.device
        logits, _ = decode_step(p, cfg, tok.to(device), store.cache,
                                active=torch.ones((1,), dtype=torch.bool, device=device))
        mgr.advance([0])
        return logits

    t0 = time.perf_counter()
    card_store, card_logits = start("cuda", params)
    cpu_params = _to_cpu(params)
    cpu_store, cpu_logits = start("cpu", cpu_params)
    agree, worst = 0, 0.0
    launches = attn_mod.LAUNCHES
    for i in range(LONG_STEPS + 1):
        got, want = card_logits.float().cpu(), cpu_logits.float()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        worst = max(worst, err / scale)
        require(bool(torch.isfinite(got).all()), f"long decode step {i}: card logits not finite")
        require(err <= LOGIT_TOL * scale, f"long decode step {i}: card logits off the CPU's by "
                                          f"{err} > {LOGIT_TOL * scale}")
        agree += int(got.argmax()) == int(want.argmax())
        if i == LONG_STEPS:
            break
        tok = want.argmax(dim=-1).to(torch.int32)          # the CPU's greedy token
        card_logits = step(card_store, params, tok)
        cpu_logits = step(cpu_store, cpu_params, tok)
    torch.cuda.synchronize()
    n_launch = attn_mod.LAUNCHES - launches
    require(n_launch == cfg.n_layers * LONG_STEPS,
            f"long decode: {n_launch} paged_attention launches, want {cfg.n_layers * LONG_STEPS}")
    print(f"[cpu] 2-layer full width, bf16 GEMMs, int8 paged KV, {LONG_PROMPT}-token prompt "
          f"({pages_for(LONG_PROMPT, ps)} pages) + {LONG_STEPS} decode steps fed the CPU's tokens: max "
          f"|logit diff| {worst:.4g} x max |logit| (tolerance {LOGIT_TOL}), greedy agreement "
          f"{agree}/{LONG_STEPS + 1}, {n_launch} kernel launches; "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)


# ---------------------------------------------------------------------------
# 7. engine features: checkpoint, chunked prefill, stacked admission, defrag
# ---------------------------------------------------------------------------

def _roundup(n: int, m: int) -> int:
    return -(-n // m) * m


def _leaves(tree):
    """(path, tensor) pairs of a parameter tree, dict keys sorted."""
    if isinstance(tree, dict):
        return [(f"{k}.{p}", t) for k in sorted(tree) for p, t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [(f"{i}.{p}", t) for i, v in enumerate(tree) for p, t in _leaves(v)]
    return [("", tree)]


def _feature_runtime(cache_len, page_size=16, **sched):
    """``int8_spoga`` over int8 paged KV, 4 lanes unless ``sched`` says
    otherwise."""
    from repro_torch.api import KVConfig, QuantRuntime, RuntimeConfig, SchedulerConfig
    sched = {"n_slots": 4, "prefill_buckets": (32, 64, 128), **sched}
    return RuntimeConfig(quant=QuantRuntime(mode="int8_spoga"),
                         kv=KVConfig(mode="paged", dtype="int8", page_size=page_size,
                                     cache_len=cache_len),
                         scheduler=SchedulerConfig(**sched))


def phase_checkpoint(card, params):
    """(a) Phase 4's seed-0 full-width weights saved with the port's
    ``save_checkpoint`` into a temporary directory (deleted at the end) and
    loaded by ``LLM(checkpoint_dir=)``: every tensor ``torch.equal`` to the
    one in memory.  Returns the loaded params and the numbers."""
    import tempfile
    from repro_torch.api import LLM
    from repro_torch.checkpoint import save_checkpoint
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(d, 1, params, metadata={"arch": "llama3.2-1b",
                                                       "seed": ENGINE_SEED})
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
        t0 = time.perf_counter()
        llm = LLM(arch="llama3.2-1b", runtime=_feature_runtime(512), checkpoint_dir=d)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    got, want = _leaves(llm.params), _leaves(params)
    require([n for n, _ in got] == [n for n, _ in want], "checkpoint: leaf names differ")
    for (name, a), (_, b) in zip(got, want):
        require(a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a, b),
                f"checkpoint: {name} differs from the tensor in memory")
    print(f"[features] (a) checkpoint of llama3.2-1b full width: {len(got)} tensors, "
          f"{nbytes / 2**30:.3f} GiB written in {save_s:.2f} s, LLM(checkpoint_dir=) loaded "
          f"it onto the card in {load_s:.2f} s; every tensor equal [{card}]", flush=True)
    return llm.params, {"bytes": nbytes, "save_s": save_s, "load_s": load_s}


def _features_run(params, runtime, arrivals, label):
    """Serve ``arrivals`` through an ``LLM``'s engine with every kernel count
    at 0 just before; every request must finish, no plain version run, the
    pool end clean, and the kernels launch exactly as the path implies:
    ``spoga_gemm_dequant`` 7 times a layer for every decode step and every
    prefill dispatch (a chunk step or a stacked prefill is one dispatch),
    ``paged_attention`` once a layer for every decode step (chunk steps
    attend the gathered pages in plain torch).  Returns (engine, metrics,
    streams, launches)."""
    from repro_torch.api import LLM
    engine = LLM(arch="llama3.2-1b", params=params, runtime=runtime).engine
    reset_counts()
    metrics = engine.run(arrivals)
    torch.cuda.synchronize()
    launches, plain = read_counts()
    check_counts(launches, plain, ("spoga_gemm_dequant", "paged_attention"), label)
    rep, n_layers = metrics.report(), engine.cfg.n_layers
    expect_gemm = 7 * n_layers * (rep["decode_steps"] + rep["prefill_dispatches"])
    expect_attn = n_layers * rep["decode_steps"]
    require(launches["spoga_gemm_dequant"] == expect_gemm,
            f"{label}: GEMM launches {launches['spoga_gemm_dequant']} != {expect_gemm}")
    require(launches["paged_attention"] == expect_attn,
            f"{label}: attention launches {launches['paged_attention']} != {expect_attn}")
    streams = _check_finished(metrics, arrivals, engine.cfg.vocab_size, label)
    mgr = engine.store.manager
    mgr.check_invariants()
    require(mgr.pages_in_use == 0, f"{label}: pages leaked after the run")
    return engine, metrics, streams, launches


def _agreement(a: dict, b: dict) -> tuple[int, int]:
    same = sum(x == y for rid in a for x, y in zip(a[rid], b[rid]))
    return same, sum(len(s) for s in a.values())


def _long_traffic(vocab):
    """Seed 0: 2 prompts of 2,048-4,096 tokens at step 0, then 8 of 17-128
    tokens one a step from step 1; 16-32 new tokens each."""
    rng = np.random.default_rng(ENGINE_SEED)
    lens = [int(n) for n in rng.integers(2048, 4097, 2)] + [int(n) for n in
                                                            rng.integers(17, 129, 8)]
    gens = [int(g) for g in rng.integers(16, 33, 10)]
    return [(0 if i < 2 else i - 1, rng.integers(0, vocab, n).tolist(), g)
            for i, (n, g) in enumerate(zip(lens, gens))]


def phase_chunked(card, params):
    """(b) Chunked prefill: phase 7's long and short traffic on 4 lanes,
    ``prefill_chunk=CHUNK_M``, and again unchunked.  Gated: every request
    finishes in both, the chunk steps are sum(ceil(len / CHUNK_M)) over the
    long prompts, the kernels launch and no plain version runs.  Printed:
    the short requests' TTFT p50/p99, decode step mean, tok/s and the
    greedy agreement of the two runs."""
    arrivals = _long_traffic(128_256)
    longest = max(len(p) for _, p, _ in arrivals)
    # long enough for the longest prompt's budget and for its last padded chunk
    cache_len = max(longest + 32, _roundup(longest, CHUNK_M))
    want_chunks = sum(-(-len(p) // CHUNK_M) for _, p, _ in arrivals[:2])
    out = {}
    for label, chunk in (("chunked", CHUNK_M), ("unchunked", None)):
        engine, metrics, streams, launches = _features_run(
            params, _feature_runtime(cache_len, prefill_chunk=chunk), arrivals,
            f"features {label}")
        rep = metrics.report()
        require(rep["chunk_steps"] == (want_chunks if chunk else 0),
                f"{label}: {rep['chunk_steps']} chunk steps, want {want_chunks if chunk else 0}")
        short = [r.ttft_s for r in metrics.finished if r.req_id >= 2]
        p50, p99 = (float(np.percentile(short, q)) for q in (50, 99))
        out[label] = dict(streams=streams, launches=launches, ttft_short_p50_s=p50,
                          ttft_short_p99_s=p99, report=rep)
        print(f"[features] (b) {label} (prefill_chunk={chunk}), 2 prompts of "
              f"{[len(p) for _, p, _ in arrivals[:2]]} tokens + 8 short, 4 lanes, cache_len "
              f"{cache_len}: {rep['requests']} finished, {rep['chunk_steps']} chunk steps, "
              f"{rep['prefill_dispatches']} prefill dispatches; short requests' TTFT p50 "
              f"{1e3 * p50:.1f} ms, p99 {1e3 * p99:.1f} ms; decode step mean "
              f"{1e3 * rep['decode_step_mean_s']:.2f} ms ({rep['decode_steps']} steps), "
              f"per-token latency p99 {1e3 * rep['per_token_p99_s']:.1f} ms; "
              f"{rep['tokens_per_s']:.1f} tok/s; defrag {rep['defrag_count']} times; launches "
              f"spoga_gemm_dequant {launches['spoga_gemm_dequant']}, paged_attention "
              f"{launches['paged_attention']} [{card}]", flush=True)
        del engine
    same, total = _agreement(out["chunked"]["streams"], out["unchunked"]["streams"])
    print(f"[features] (b) chunked against unchunked, greedy agreement {same}/{total} "
          f"(int8_spoga; chunks attend the dequantized int8 pages, the one-shot prefill "
          f"its bf16 K/V)", flush=True)
    return out


def phase_stacked(card, params):
    """(c) Stacked admission: 8 prompts of 33-64 tokens (bucket 64) at step
    0, 4 lanes, ``batched_admission=True``, 2 dispatches a step.  Gated:
    fewer dispatches than prefills, at least 2 stacked prefills, every
    request finished, the kernels launched and no plain version.  Printed:
    the greedy agreement with the same run unstacked."""
    rng = np.random.default_rng(ENGINE_SEED + 7)
    arrivals = [(0, rng.integers(0, 128_256, int(n)).tolist(), int(g))
                for n, g in zip(rng.integers(33, 65, 8), rng.integers(16, 33, 8))]
    from repro_torch.configs import default_cache_len
    out = {}
    for label, stacked in (("stacked", True), ("unstacked", False)):
        _, metrics, streams, launches = _features_run(
            params, _feature_runtime(default_cache_len(128, 32), batched_admission=stacked,
                                     max_prefills_per_step=2), arrivals, f"features {label}")
        rep = metrics.report()
        if stacked:
            require(rep["prefill_dispatches"] < rep["prefills"] and rep["stacked_prefills"] >= 2,
                    f"stacked: {rep['prefill_dispatches']} dispatches for {rep['prefills']} "
                    f"prefills, {rep['stacked_prefills']} stacked")
        out[label] = dict(streams=streams, launches=launches, report=rep)
        print(f"[features] (c) {label}: {rep['requests']} finished, {rep['prefills']} prefills in "
              f"{rep['prefill_dispatches']} dispatches ({rep['stacked_prefills']} stacked), TTFT "
              f"mean {1e3 * rep['ttft_mean_s']:.1f} ms, {rep['tokens_per_s']:.1f} tok/s; launches "
              f"spoga_gemm_dequant {launches['spoga_gemm_dequant']} [{card}]", flush=True)
    same, total = _agreement(out["stacked"]["streams"], out["unstacked"]["streams"])
    print(f"[features] (c) stacked against unstacked, greedy agreement {same}/{total}",
          flush=True)
    return out


def phase_defrag(card, params):
    """(d) Defrag: the traffic of ``tests/test_api.py::
    test_defrag_policy_triggers_and_is_output_invisible`` (3 lanes, pages of
    8 rows, cache_len 32; a short request ends early while later lanes
    hold higher pages) at full width, threshold 0.05 against None.  Gated:
    at least one compaction moving at least one page, the page bookkeeping
    consistent, and the greedy streams bitwise equal on and off: defrag
    only renames pages, and ``paged_attention`` splits a lane's pages by
    their index in its table, so it reads the same rows in the same order."""
    rng = np.random.default_rng(0)
    arrivals = [(0, rng.integers(0, 128_256, 14).tolist(), 2),
                (0, rng.integers(0, 128_256, 12).tolist(), 10),
                (1, rng.integers(0, 128_256, 9).tolist(), 8)]
    out = {}
    for label, threshold in (("on", 0.05), ("off", None)):
        _, metrics, streams, launches = _features_run(
            params, _feature_runtime(32, page_size=8, n_slots=3, prefill_buckets=None,
                                     defrag_threshold=threshold), arrivals, f"defrag {label}")
        out[label] = dict(streams=streams, launches=launches, report=metrics.report())
    on, off = out["on"]["report"], out["off"]["report"]
    require(on["defrag_count"] >= 1 and on["defrag_pages_moved"] >= 1,
            f"defrag: {on['defrag_count']} compactions, {on['defrag_pages_moved']} pages moved")
    require(off["defrag_count"] == 0, "defrag off compacted")
    require(out["on"]["streams"] == out["off"]["streams"],
            "defrag changed a greedy stream")
    print(f"[features] (d) defrag at threshold 0.05: {on['defrag_count']} compactions, "
          f"{on['defrag_pages_moved']} pages moved; greedy streams bitwise equal to defrag off "
          f"({sum(len(s) for s in out['on']['streams'].values())} tokens) [{card}]", flush=True)
    return out


def _bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at ``|x|`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def _chunked_and_one_shot(cfg, params, prompt, chunk):
    """Last-token logits of ``prompt`` through ``make_chunk_step`` (chunks
    of ``chunk`` into a paged cache) and through one ``model.prefill``."""
    from repro_torch.models import prefill
    from repro_torch.paging import PagedCache, make_chunk_step
    n, ps = len(prompt), 16
    store = PagedCache(cfg, 1, _roundup(n, chunk), ps, device="cuda")
    mgr = store.manager
    mgr.admit(0, _roundup(n, chunk))
    step = make_chunk_step(cfg, chunk)
    for start in range(0, n, chunk):
        k = min(chunk, n - start)
        mgr.ensure(0, start + chunk)
        store.sync_tables()
        tokens = torch.zeros((1, chunk), dtype=torch.int32)
        tokens[0, :k] = torch.tensor(prompt[start:start + k], dtype=torch.int32)
        chunked = step(params, store.cache, tokens.cuda(), 0, start, k)
    tokens = torch.zeros((1, _roundup(n, ps)), dtype=torch.int32)
    tokens[0, :n] = torch.tensor(prompt, dtype=torch.int32)
    one_shot, _ = prefill(params, cfg, tokens.cuda(), tokens.shape[1],
                          lengths=torch.tensor([n], dtype=torch.int32, device="cuda"))
    return chunked.float(), one_shot.float()


def _stacked_and_solo(cfg, params, prompts, padded):
    """Last-token logits of ``prompts`` prefilled as one batch and each alone
    (right-padded to ``padded``)."""
    from repro_torch.models import prefill
    tokens = torch.zeros((len(prompts), padded), dtype=torch.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = torch.tensor(p, dtype=torch.int32)
    lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    stacked, _ = prefill(params, cfg, tokens.cuda(), padded, lengths=lengths.cuda())
    solo = torch.cat([prefill(params, cfg, tokens[i:i + 1].cuda(), padded,
                              lengths=lengths[i:i + 1].cuda())[0] for i in range(len(prompts))])
    return stacked.float(), solo.float()


def phase_feature_parity(card, params):
    """Chunked against one-shot prefill and stacked against batch=1, on the
    card, where another M or key length may sum in another order (the CPU
    tests hold both bitwise): on phase 6's model (2 layers at full width,
    bf16 GEMMs, bf16 pool, seed 3) the last-token logits within LOGIT_TOL
    of their largest magnitude; at full width and ``int8_spoga`` (phase 4's
    weights, bf16 pool) printed, not gated (per-row int8 re-quantization
    amplifies one-ulp differences, ROADMAP queue 3).  On the 2-layer model
    the greedy tokens are gated too: a row may flip only where its
    reference top-2 margin is at most ``NEAR_TIE_ULPS`` bf16 ulps of its top
    logit (a near-tie that one rounding in another order decides, ROADMAP
    queue 3); every flip is printed with its margin."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    full = get_config("llama3.2-1b").with_(quant_mode="int8_spoga")
    small = full.with_(quant_mode="bf16", n_layers=2)
    small_params = init_params(small, seed=3, device="cuda")
    rng = np.random.default_rng(8)
    prompt = rng.integers(0, full.vocab_size, 1000).tolist()
    prompts = [rng.integers(0, full.vocab_size, n).tolist() for n in (40, 50, 61, 64)]
    out = {}
    for c, p, what in ((small, small_params, "2 layers, bf16 GEMMs"),
                       (full, params, f"{full.n_layers} layers, int8_spoga")):
        for kind, (got, want) in (("chunked 256 vs one-shot, 1,000 tokens",
                                   _chunked_and_one_shot(c, p, prompt, 256)),
                                  ("4 stacked vs batch=1, 40-64 tokens",
                                   _stacked_and_solo(c, p, prompts, 64))):
            err = (got - want).abs().max().item() / want.abs().max().item()
            flips = (got.argmax(-1) != want.argmax(-1)).nonzero().flatten().tolist()
            top2 = torch.topk(want, 2, dim=-1).values
            margins = [(top2[r, 0] - top2[r, 1]).item() for r in flips]
            ulps = [m / _bf16_ulp(top2[r, 0].item()) for r, m in zip(flips, margins)]
            require(bool(torch.isfinite(got).all()), f"{what}, {kind}: logits not finite")
            print(f"[features] {what}, bf16 pool, {kind}: max |logit diff| {err:.4g} x max "
                  f"|logit| ({want.abs().max().item():.4g}), greedy "
                  f"{got.shape[0] - len(flips)}/{got.shape[0]}"
                  + (f"; rows {flips} flip on top-2 margins {[f'{m:.4g}' for m in margins]} "
                     f"({[f'{u:.3g}' for u in ulps]} bf16 ulps)" if flips else "")
                  + f" [{card}]", flush=True)
            if c is small:
                require(err <= LOGIT_TOL, f"{what}, {kind}: logits differ by {err:.4g} x max "
                                          f"(tolerance {LOGIT_TOL})")
                wide = [(r, u) for r, u in zip(flips, ulps) if u > NEAR_TIE_ULPS]
                require(not wide, f"{what}, {kind}: greedy token flips on rows whose top-2 "
                                  f"margin is more than {NEAR_TIE_ULPS} bf16 ulps: {wide}")
            out[f"{what}: {kind}"] = {"max_rel_diff": err, "flipped_rows": flips,
                                      "flip_margins": margins, "flip_margin_ulps": ulps}
    del small_params
    return out


def phase_features(card, params):
    """Phase 7: (a) checkpoint, (b) chunked prefill, (c) stacked admission,
    (d) defrag, each on the weights loaded in (a); then the card-side
    parity of chunking and stacking."""
    loaded, ckpt = phase_checkpoint(card, params)
    out = {"checkpoint": ckpt, "chunked": phase_chunked(card, loaded),
           "stacked": phase_stacked(card, loaded), "defrag": phase_defrag(card, loaded),
           "parity": phase_feature_parity(card, params)}
    del loaded
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: the port's package is missing ({src / 'repro_torch'})",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    card = phase_card()
    gemm, gemm_err = phase_gemm()
    int_gemm, int_err = phase_int_gemm()
    deas, nibble, deas_err, combine_err, combine_long = phase_deas(int_gemm)
    attn = phase_attention(card)
    params = full_width_params()
    launches, launches16, attn_profile, paged_rep = phase_main(card, params)
    slot_launches, slot_profile = phase_slot(card, params, paged_rep)
    phase_slot_vs_paged(card, params)
    facade = phase_dataflows(card, params)
    long_prefill = phase_long_prefill(card, params)
    features = phase_features(card, params)
    del params
    torch.cuda.empty_cache()
    phase_default_llm(card)
    phase_cpu_parity()
    phase_cpu_long_decode(card)

    from repro_torch.configs import get_config
    calls_per_step = 7 * get_config("llama3.2-1b").n_layers   # GEMM calls per decode step

    def gemm_row(name, source, replaces, launches, per_call, err, times, **extra):
        """A GEMM kernel's line: W8A8 K=2048 N=8192, decode M=4 at the top
        level (device time), prefill M=128 under "prefill"."""
        dec, pre = times[4], times[128]
        frac = {"fraction_of_bound": dec["bound_ms"] / dec["ms"]}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "launches_per_decode_step": per_call * calls_per_step,
                "max_abs_err": err, "shape": "W8A8 M=4 K=2048 N=8192",
                "library": _lib_label(4, 2048, 8192), **dec, **frac, **extra,
                "prefill": {"shape": "W8A8 M=128 K=2048 N=8192",
                            "library": _lib_label(128, 2048, 8192), **pre,
                            "fraction_of_bound": pre["bound_ms"] / pre["ms"]},
                "card": card}

    def at(table, key):
        return {m: table[key(m)] for m in (4, 128)}

    def feature_launches(name):
        """A kernel's launches in each of phase 7's runs."""
        return {f"{part} {label}": run["launches"][name]
                for part in ("chunked", "stacked", "defrag")
                for label, run in features[part].items()}

    chunk = gemm[("w8a8", CHUNK_M, 2048, 8192)]
    kernels = [gemm_row("spoga_gemm_dequant", "src/repro_torch/csrc/spoga_gemm_dequant.cu",
                        "src/repro/kernels/spoga_gemm_dequant.py:62",
                        launches["spoga_gemm_dequant"], 1, gemm_err,
                        at(gemm, lambda m: ("w8a8", m, 2048, 8192)),
                        launches_slot={f"{kv} KV": n for kv, n in slot_launches.items()},
                        launches_engine_features=feature_launches("spoga_gemm_dequant"),
                        chunk_prefill={"shape": f"W8A8 M={CHUNK_M} K=2048 N=8192",
                                       "library": _lib_label(CHUNK_M, 2048, 8192), **chunk,
                                       "fraction_of_bound": chunk["bound_ms"] / chunk["ms"]},
                        slot_decode_profile=slot_profile, long_prefill=long_prefill)]
    for kind, count in (("int8", launches["paged_attention"]),
                        ("bf16", launches16["paged_attention"])):
        a, long, short = (dict(attn[(kind, name)]) for name in ("main", "long", "short"))
        kernels.append({"name": f"paged_attention/{kind}", "route": "cuda",
                        "source": "src/repro_torch/csrc/paged_attention.cu",
                        "replaces": "src/repro/kernels/paged_attention.py:91",
                        "launches": count, "max_abs_err": max(a.pop("max_abs_err"),
                                                              long["max_abs_err"],
                                                              short["max_abs_err"]),
                        **a, "long_context": long, "long_table_short_lanes": short,
                        "decode_profile_ms_per_step": {
                            k: v and v["attn_ms"] for k, v in attn_profile.items()},
                        **({"launches_engine_features": feature_launches("paged_attention")}
                           if kind == "int8" else {}),
                        "card": card})
    unfused, deas_run = facade["spoga unfused"], facade["deas"]
    kernels.append(gemm_row("spoga_gemm", "src/repro_torch/csrc/spoga_gemm.cu",
                            "src/repro/kernels/spoga_gemm.py:116", unfused["spoga_gemm"], 1,
                            int_err, at(int_gemm, lambda m: ("w8a8", m, 2048, 8192))))
    kernels.append(gemm_row("nibble_gemm", "src/repro_torch/csrc/deas_gemm.cu",
                            "src/repro/kernels/deas_gemm.py:50", deas_run["nibble_gemm"], 4,
                            deas_err, at(nibble, lambda m: (m, 2048, 8192)),
                            library_operands="the int8 nibble planes of this call"))
    kernels.append(gemm_row("deas_gemm", "src/repro_torch/csrc/deas_gemm.cu",
                            "src/repro/kernels/deas_gemm.py:95",
                            deas_run["nibble_gemm"] + deas_run["deas_combine"], 5, deas_err,
                            at(deas, lambda m: (m, 2048, 8192)),
                            replaces_parts={"nibble_gemm": "src/repro/kernels/deas_gemm.py:50",
                                            "deas_combine": "src/repro/kernels/deas_gemm.py:79"},
                            nibble_gemm_launches=deas_run["nibble_gemm"],
                            deas_combine_launches=deas_run["deas_combine"]))

    def combine_at(m):
        t = deas[(m, 2048, 8192)]
        c = t["deas_combine"]
        return {"shape": f"M={m} N=8192, partials cold", "ms": c["cold_ms"],
                "warm_ms": c["warm_ms"], "noop_ms": c["noop_cold_ms"],
                "noop_warm_ms": c["noop_warm_ms"], "event_ms": c["event_ms"],
                "plain_ms": c["plain_ms"], "bound_ms": t["deas_combine_bound_ms"],
                "bound_by": "bytes", "fraction_of_bound": t["deas_combine_bound_ms"] / c["cold_ms"],
                "library_ms": None}

    kernels.append({"name": "deas_combine", "route": "cuda",
                    "source": "src/repro_torch/csrc/deas_gemm.cu",
                    "replaces": "src/repro/kernels/deas_gemm.py:79",
                    "launches": deas_run["deas_combine"], "launches_per_decode_step": calls_per_step,
                    "max_abs_err": combine_err, **combine_at(4), "prefill": combine_at(128),
                    "sustained": combine_long,
                    "library": "none: no one PyTorch call computes the shift-add", "card": card})
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
