"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Every test needs a CUDA device and skips inside the test without one.
The GEMMs are held bitwise (same int32 accumulator, same two f32
multiplies); paged attention at rtol/atol 2e-5, the JAX package's contract.
"""

import numpy as np
import pytest
import torch

from repro_torch.backends import effective_bits, get_backend, parse_quant_mode
from repro_torch.backends import impls
from repro_torch.core.spoga import direct_matmul
from repro_torch.kernels import deas_gemm as deas_mod
from repro_torch.kernels import paged_attention as attn_mod
from repro_torch.kernels import spoga_gemm as int_gemm_mod
from repro_torch.kernels import spoga_gemm_dequant as gemm_mod
from repro_torch.kernels.deas_gemm import deas_gemm, deas_gemm_plain
from repro_torch.kernels.paged_attention import MAX_SPLITS, paged_attention, paged_attention_plain
from repro_torch.kernels.spoga_gemm import spoga_gemm, spoga_gemm_plain
from repro_torch.kernels.spoga_gemm_dequant import (
    spoga_gemm_dequant,
    spoga_gemm_dequant_plain,
)

pytestmark = pytest.mark.gpu

# tiny, exact tiles, ragged, the paper's DPU shape, decode and prefill widths;
# then one shape of every class the core's tiling creates: M in {1, 4, 16,
# 17, 64, 128, 130} (one and two 8-row decode tiles, prefill tiles with
# ragged M), K in {249, 257, 2048, 8192} (unaligned rows, ragged stages,
# cluster K splits up to 8), N in {16, 100, 512, 8192} (one partial N tile
# to 64 of them)
SHAPES = [(8, 16, 8), (128, 128, 128), (130, 257, 100), (1, 249, 16),
          (4, 2048, 512), (16, 2048, 2048), (17, 8192, 2048), (128, 2048, 8192),
          (1, 2048, 8192), (4, 8192, 512), (4, 257, 100), (16, 249, 16), (16, 8192, 8192),
          (17, 2048, 100), (64, 2048, 512), (64, 249, 8192), (130, 8192, 512),
          (128, 257, 16)]
MODES = ["int8_spoga", "w4a8", "w4a4", "w16a16", "w8a8_s2", "w8a8_s3", "w6a6_s1"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _operands(m, k, n, mode, seed):
    spec, _ = parse_quant_mode(mode)
    a_bits, w_bits = effective_bits(spec, k)
    rng = np.random.default_rng(seed)
    qa, qw = 2 ** (a_bits - 1) - 1, 2 ** (w_bits - 1) - 1
    x = torch.from_numpy(rng.integers(-qa, qa + 1, (m, k))).to(spec.a_dtype)
    w = torch.from_numpy(rng.integers(-qw, qw + 1, (k, n))).to(spec.w_dtype)
    xs = torch.from_numpy(rng.uniform(1e-3, 0.1, (m, 1)).astype(np.float32))
    ws = torch.from_numpy(rng.uniform(1e-3, 0.1, (1, n)).astype(np.float32))
    return spec, [t.cuda() for t in (x, w, xs, ws)]


@pytest.mark.parametrize("mode", MODES)
def test_gemm_kernel_matches_plain_bitwise(mode):
    _card()
    for m, k, n in SHAPES:
        spec, ops = _operands(m, k, n, mode, seed=m + k + n)
        launches = gemm_mod.LAUNCHES
        got = spoga_gemm_dequant(*ops, n_x_slices=spec.n_a_slices,
                                 n_w_slices=spec.n_w_slices, slice_bits=spec.slice_bits)
        assert gemm_mod.LAUNCHES == launches + 1
        want = spoga_gemm_dequant_plain(*ops)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (mode, m, k, n)


def test_gemm_wrapper_raises_on_what_the_kernel_does_not_take():
    _card()
    spec, (x, w, xs, ws) = _operands(8, 64, 16, "int8_spoga", seed=0)
    with pytest.raises(ValueError):
        spoga_gemm_dequant(x, w.t().contiguous().t(), xs, ws)   # not contiguous
    with pytest.raises(ValueError):
        spoga_gemm_dequant(x, w.cpu(), xs, ws)                  # mixed devices
    with pytest.raises(ValueError):
        spoga_gemm_dequant(x, w, xs, ws, slice_bits=8)


@pytest.mark.parametrize("mode", MODES)
def test_int32_gemm_kernel_matches_plain_bitwise(mode):
    _card()
    for m, k, n in SHAPES:
        spec, (x, w, _, _) = _operands(m, k, n, mode, seed=m * k + n)
        launches = int_gemm_mod.LAUNCHES
        got = spoga_gemm(x, w, n_x_slices=spec.n_a_slices, n_w_slices=spec.n_w_slices,
                         slice_bits=spec.slice_bits)
        assert int_gemm_mod.LAUNCHES == launches + 1
        want = spoga_gemm_plain(x, w)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and torch.equal(got, want), (mode, m, k, n)


# (x value, w value, dtype, planes per operand, (M, K, N)): operands at the
# extremes of their type, constant so that every partial sum is extreme too
EXTREMES = {
    "int16 max x -max": (32767, -32767, torch.int16, 4, (3, 64, 5)),
    "int16 min x max": (-32768, 32767, torch.int16, 4, (16, 257, 100)),
    "int8 min x max": (-128, 127, torch.int8, 2, (4, 2048, 512)),
    "int8 min x min": (-128, -128, torch.int8, 2, (17, 8192, 512)),
    # decode at N=512 splits K=8192 over 8 blocks of a cluster: each block's
    # partial sum (1024 x 32767^2) is past 2^31 before the cluster adds them
    "split-K partials past 2^31": (32767, 32767, torch.int16, 4, (4, 8192, 512)),
}


@pytest.mark.parametrize("case", list(EXTREMES))
def test_int32_gemm_wraps_like_the_plain_version(case):
    """Past the int32 range (w16a16 operands at full width, K split across a
    cluster) both wrap mod 2^32 the same way."""
    _card()
    xv, wv, dtype, planes, (m, k, n) = EXTREMES[case]
    x = torch.full((m, k), xv, dtype=dtype, device="cuda")
    w = torch.full((k, n), wv, dtype=dtype, device="cuda")
    got = spoga_gemm(x, w, n_x_slices=planes, n_w_slices=planes, slice_bits=4)
    torch.cuda.synchronize()
    assert torch.equal(got, spoga_gemm_plain(x, w)), case


def test_deas_gemm_kernels_match_plain_bitwise():
    """Four nibble_gemm launches and one deas_combine launch per call, equal
    to the plain version and to the SPOGA kernel, over the full int8 range."""
    _card()
    rng = np.random.default_rng(5)
    for m, k, n in SHAPES:
        x = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8)).cuda()
        w = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8)).cuda()
        before = (deas_mod.CALLS, deas_mod.NIBBLE_LAUNCHES, deas_mod.COMBINE_LAUNCHES)
        got = deas_gemm(x, w)
        after = (deas_mod.CALLS, deas_mod.NIBBLE_LAUNCHES, deas_mod.COMBINE_LAUNCHES)
        assert tuple(a - b for a, b in zip(after, before)) == (1, 4, 1)
        want = deas_gemm_plain(x, w)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (m, k, n)
        assert torch.equal(got, spoga_gemm(x, w)), (m, k, n)


# deas_combine: decode, prefill and long-prompt widths, and count % 4 in
# {0, 1, 2, 3} (the scalar tail)
COMBINE_SHAPES = [(1, 8192), (4, 8192), (128, 8192), (2048, 8192), (4, 2048),
                  (3, 7), (1, 2), (5, 11), (1, 1), (17, 103)]


def _partials(m, n, seed, lo=-(2 ** 31), hi=2 ** 31):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(lo, hi, (m, n), dtype=np.int64).astype(np.int32))
            .cuda() for _ in range(4)]


@pytest.mark.parametrize("m,n", COMBINE_SHAPES)
def test_deas_combine_kernel_matches_plain_bitwise(m, n):
    """The shift-add over the full int32 range (every sum and shift wraps)
    and over nibble-product-sized partials, bitwise the plain version; one
    launch a call."""
    _card()
    for parts in (_partials(m, n, m * n), _partials(m, n, m + n, -(2 ** 15), 2 ** 15)):
        launches = deas_mod.COMBINE_LAUNCHES
        got = deas_mod.deas_combine(*parts)
        assert deas_mod.COMBINE_LAUNCHES == launches + 1
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and got.shape == (m, n)
        assert torch.equal(got, deas_mod.deas_combine_plain(*parts)), (m, n)


def test_deas_combine_wraps_like_int32():
    """Extremes: int32 min and max in every partial, so each shift and add
    wraps mod 2^32 as the TPU's int32 does."""
    _card()
    vals = torch.tensor([-(2 ** 31), 2 ** 31 - 1, -1, 0, 1, 2 ** 27, -(2 ** 27), 12345],
                        dtype=torch.int32)
    grid = torch.cartesian_prod(*(torch.arange(len(vals)),) * 4)     # 4,096 combinations
    parts = [vals[grid[:, i]].reshape(64, 64).contiguous().cuda() for i in range(4)]
    got = deas_mod.deas_combine(*parts)
    torch.cuda.synchronize()
    assert torch.equal(got, deas_mod.deas_combine_plain(*parts))


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("m,n", [(4, 8192), (3, 7)])
def test_deas_combine_misaligned_views_take_the_scalar_path(m, n, offset):
    """Contiguous views 4, 8 or 12 bytes past a 16-byte boundary: the
    wrapper asks for the element-wise path, which gives the same result;
    asking the C entry point for vectors there is refused."""
    _card()
    count = m * n
    parts = []
    for t in _partials(m, n, 7 * offset):
        buf = torch.empty(count + 4, dtype=torch.int32, device="cuda")
        view = buf[offset:offset + count].view(m, n)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        parts.append(view)
    got = deas_mod.deas_combine(*parts)
    torch.cuda.synchronize()
    assert torch.equal(got, deas_mod.deas_combine_plain(*parts))
    from repro_torch.kernels import _build
    out = torch.empty((m, n), dtype=torch.int32, device="cuda")
    err = _build.library().deas_combine_launch(
        *(t.data_ptr() for t in parts), out.data_ptr(), m, n, 1,
        torch.cuda.current_stream().cuda_stream)
    assert err != 0


def test_cuda_direct_backend_matches_direct_matmul():
    """torch._int_mm, with M, K and N padded to what it takes, is bitwise
    the plain integer product."""
    _card()
    spec, _ = parse_quant_mode("int8_direct")
    gemm = get_backend("cuda_direct").gemm
    rng = np.random.default_rng(6)
    for m, k, n in SHAPES:
        x = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8)).cuda()
        w = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8)).cuda()
        calls = impls.INT_MM_CALLS
        got = gemm(x, w, spec)
        assert impls.INT_MM_CALLS == calls + 1
        torch.cuda.synchronize()
        assert torch.equal(got, direct_matmul(x, w)), (m, k, n)


def test_new_wrappers_raise_on_what_the_kernels_do_not_take():
    _card()
    _, (x, w, _, _) = _operands(8, 64, 16, "int8_spoga", seed=0)
    with pytest.raises(ValueError):
        spoga_gemm(x, w.t().contiguous().t())                   # not contiguous
    with pytest.raises(ValueError):
        deas_gemm(x, w.cpu())                                   # mixed devices
    with pytest.raises(TypeError):
        deas_gemm(x.to(torch.int16), w)                         # W8A8 only


# Paged-attention shapes: (B, Hkv, G, D, page size, table pages, lengths).
# Lengths are a list, or a name the test resolves on the card:
# "edges" (split and page edges), "long" (8K context, drawn from the seed).
ATTN_CASES = {
    "main": (4, 8, 4, 64, 16, 11, [1, 17, 100, 165]),       # the main path's decode
    "edges": (26, 4, 4, 64, 16, 64, "edges"),
    "wide table, short lanes": (4, 8, 4, 64, 16, 512, [1, 9, 16, 40]),
    "long": (16, 8, 4, 64, 16, 512, "long"),
    "G1 D128 ps8": (3, 2, 1, 128, 8, 40, "random"),
    "G2 D64 ps32": (3, 2, 2, 64, 32, 20, "random"),
    "G8 D128 ps16": (2, 4, 8, 128, 16, 24, "random"),
    "G3 D64 ps8": (3, 2, 3, 64, 8, 30, "random"),
    "G16 D64 ps16": (2, 2, 16, 64, 16, 12, "random"),
    "G32 D256 ps8": (2, 1, 32, 256, 8, 12, "random"),
    "D24 (element loads)": (3, 2, 4, 24, 16, 10, "random"),
    "G1 D20 (element loads)": (3, 2, 1, 20, 16, 10, "random"),
    "G2 D32 ps8": (3, 2, 2, 32, 8, 20, "random"),
}
ATTN_KINDS = [("bf16", torch.bfloat16), ("int8", torch.bfloat16), ("bf16", torch.float32),
              ("int8", torch.float32)]


def _lengths(spec, b, ps, n_tbl, rng):
    if isinstance(spec, list):
        return spec
    rows = n_tbl * ps
    # split r takes pages r, r + S, ... with S <= MAX_SPLITS: a lane of k pages,
    # k up to MAX_SPLITS, ends on every split edge the kernel can choose
    if spec == "edges":   # one row; k pages less a row, exactly, plus a row; the whole table
        lens = [1] + [k * ps + o for k in range(1, MAX_SPLITS + 1) for o in (-1, 0, 1)] + [rows]
        assert len(lens) == b
        return lens
    if spec == "long":    # one lane at the table's end, one on a page edge, one on a split
        lens = rng.integers(1024, rows + 1, b)   # edge (a multiple of MAX_SPLITS pages)
        edge = MAX_SPLITS * ps
        lens[:3] = [rows, 313 * ps, edge * (rows // edge * 5 // 8)]
        return lens.tolist()
    return rng.integers(1, rows + 1, b).tolist()


def _pool_case(kind, seed, q_dtype=torch.bfloat16, case="main"):
    """Inputs on the card.  Each lane's pages below its length are distinct
    pages of the pool; its table entries past the length name page 0, the
    trash page.  The pool holds those pages and nothing else."""
    b, hkv, g, d, ps, n_tbl, spec = ATTN_CASES[case]
    rng = np.random.default_rng(seed)
    lengths = _lengths(spec, b, ps, n_tbl, rng)
    used = [-(-n // ps) for n in lengths]
    n_pages = 1 + sum(used)
    ids = rng.permutation(n_pages - 1) + 1
    tables = np.zeros((b, n_tbl), np.int32)
    start = 0
    for lane, n in enumerate(used):
        tables[lane, :n] = ids[start:start + n]
        start += n
    q = torch.from_numpy(rng.normal(size=(b, hkv, g, d)).astype(np.float32)).to(q_dtype)
    shp = (n_pages, ps, hkv, d)
    scales = {}
    if kind == "int8":
        kp = torch.from_numpy(rng.integers(-127, 128, shp).astype(np.int8))
        vp = torch.from_numpy(rng.integers(-127, 128, shp).astype(np.int8))
        scales = {k: torch.from_numpy(rng.uniform(1e-3, 0.02, shp[:3]).astype(np.float32)).cuda()
                  for k in ("k_scale", "v_scale")}
    else:
        kp = torch.from_numpy(rng.normal(size=shp).astype(np.float32)).bfloat16()
        vp = torch.from_numpy(rng.normal(size=shp).astype(np.float32)).bfloat16()
    lengths = torch.tensor(lengths, dtype=torch.int32)
    return [t.cuda() for t in (q, kp, vp, torch.from_numpy(tables), lengths)], scales


def _poison(kp, vp, tables, lengths, kind):
    """Stale rows of each lane's last page, and the trash page, poisoned."""
    big = 127 if kind == "int8" else 3.0e4
    ps = kp.shape[1]
    for lane, n in enumerate(lengths.tolist()):
        last, off = tables[lane, (n - 1) // ps], (n - 1) % ps + 1
        for pool in (kp, vp):
            pool[last, off:] = big
    for pool in (kp, vp):
        pool[0] = -big


@pytest.mark.parametrize("case,kind,q_dtype",
                         [("main", k, q) for k, q in ATTN_KINDS]
                         + [(c, k, q) for c in list(ATTN_CASES)[1:]
                            for k, q in ATTN_KINDS[:2]]
                         + [("edges", "int8", torch.float32), ("long", "bf16", torch.float32)])
def test_paged_attention_kernel_matches_plain(case, kind, q_dtype):
    _card()
    args, scales = _pool_case(kind, seed=3, q_dtype=q_dtype, case=case)
    launches = attn_mod.LAUNCHES
    got = paged_attention(*args, **scales)
    assert attn_mod.LAUNCHES == launches + 1
    want = paged_attention_plain(*args, **scales)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", ["main", "edges", "long", "G3 D64 ps8", "D24 (element loads)",
                                  "G1 D20 (element loads)"])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_paged_attention_kernel_never_reads_stale_rows(kind, case):
    """Rows at or past a lane's length, in its last page and in the pages
    after it, are poisoned; the kernel's output must not move."""
    _card()
    (q, kp, vp, tables, lengths), scales = _pool_case(kind, seed=4, case=case)
    clean = paged_attention(q, kp, vp, tables, lengths, **scales)
    _poison(kp, vp, tables, lengths, kind)
    poisoned = paged_attention(q, kp, vp, tables, lengths, **scales)
    torch.cuda.synchronize()
    assert torch.equal(poisoned, clean)


@pytest.mark.parametrize("case", ["main", "long"])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_paged_attention_kernel_is_deterministic(kind, case):
    """The splits combine in a fixed order: two calls are bitwise equal, and
    each call is one launch."""
    _card()
    args, scales = _pool_case(kind, seed=5, case=case)
    launches = attn_mod.LAUNCHES
    first = paged_attention(*args, **scales)
    second = paged_attention(*args, **scales)
    torch.cuda.synchronize()
    assert attn_mod.LAUNCHES == launches + 2
    assert torch.equal(first, second)
