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
# the projections of minicpm3-4b (MLA), deepseek-moe-16b (attention, the
# dense FFN, the shared experts) and granite-moe-3b-a800m, at the widths
# their serving path gives them: decode (4 lanes), a 5-row verify window
# on 4 lanes, a prefill bucket, a 512-row chunk step or stacked prefill;
# and MLA's w_uk / w_uv over a gathered latent prefix of 1,216 and 4,096
# rows (the prefix-cache and long-prompt chunk steps)
ARCH_KN = [(2560, 768), (768, 3840), (2560, 256), (2560, 32), (2560, 2560), (2560, 6400),
           (6400, 2560), (256, 2560), (2048, 10944), (10944, 2048), (2048, 2816),
           (2816, 2048), (1536, 1536), (1536, 512)]
SHAPES += [(m, k, n) for k, n in ARCH_KN for m in (4, 20, 128, 512)]
SHAPES += [(1216, 256, 2560), (4096, 256, 2560)]
# the recurrent archs' projections: recurrentgemma-9b (the RG-LRU branches
# and gates, MQA's K/V heads, the GLU) and xlstm-125m (q/k/v/o, the two
# 4-wide gate projections, w_zifo) at decode, prefill and chunk widths
RECURRENT_KN = [(4096, 4096), (4096, 256), (4096, 12288), (12288, 4096), (768, 768),
                (768, 4), (768, 3072)]
SHAPES += [(m, k, n) for k, n in RECURRENT_KN for m in (4, 128, 256)]
# the encoder-decoder and frontend archs' projections at the widths their
# serve_batch gives them: seamless-m4t-large-v2 (4 decode rows, 32 target
# rows, 512 source rows) and llava-next-mistral-7b (4 decode rows, 4 x 576
# patch rows)
SHAPES += [(m, k, n) for k, n in [(1024, 1024), (1024, 8192), (8192, 1024)]
           for m in (4, 32, 128, 512)]
SHAPES += [(m, k, n) for k, n in [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
           for m in (4, 128, 2304)]
# a tp=2 rank's projections of minicpm3-4b (MLA: w_uq, gate/up by
# columns, w_dq / w_dkv / w_kr whole, w_uk / w_uv over the latent prefix),
# recurrentgemma-9b (the RG-LRU branches and gates, the MQA head's half
# columns, the GLU) and llava-next-mistral-7b (q, k/v, gate/up) on
# spoga_gemm_dequant, and their row-parallel o / w_out / down halves on
# spoga_gemm, at the decode step's 4 lanes and a prefill's 64 rows
TP_ARCH_DEQUANT_KN = [(2560, 768), (768, 1920), (2560, 256), (2560, 32), (2560, 3200),
                      (256, 1280), (4096, 2048), (4096, 128), (4096, 6144), (4096, 512),
                      (4096, 7168)]
TP_ARCH_INT_KN = [(1280, 2560), (3200, 2560), (2048, 4096), (6144, 4096), (7168, 4096)]
# llama3.2-1b's four projection shapes at a training step's M = B * S =
# 4 x 1,024 rows
LLAMA_KN = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]
SHAPES += [(4096, k, n) for k, n in LLAMA_KN]
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
    # the MoE archs' decode layouts: deepseek-moe-16b, granite-moe-3b-a800m
    "deepseek G1 D128": (4, 16, 1, 128, 16, 11, [1, 17, 100, 165]),
    "granite G3 D64": (4, 8, 3, 64, 16, 11, [1, 17, 100, 165]),
    # mistral-large-123b's layout (G12 runs on the CUDA-core kernel), whole
    # and on a rank of a tp=2 mesh
    "mistral-large G12 D128": (4, 8, 12, 128, 16, 11, [1, 17, 100, 165]),
    "mistral-large tp=2 G12 D128": (4, 4, 12, 128, 16, 11, [1, 17, 100, 165]),
    "llama tp=2 G4 D64": (4, 4, 4, 64, 16, 11, [1, 17, 100, 165]),
    "deepseek tp=2 G1 D128": (4, 8, 1, 128, 16, 11, [1, 17, 100, 165]),
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
                                  "G1 D20 (element loads)", "mistral-large tp=2 G12 D128"])
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


@pytest.mark.parametrize("case", ["llama tp=2 G4 D64", "deepseek tp=2 G1 D128",
                                  "mistral-large tp=2 G12 D128"])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_paged_attention_tp_rank_split_matches_plain(kind, case):
    """A rank of a tp=2 mesh launches half the KV heads and splits them as
    2B lanes would (``split_lanes``): the plain version's result, and on
    poisoned pools the same bits."""
    _card()
    (q, kp, vp, tables, lengths), scales = _pool_case(kind, seed=6, case=case)
    split = 2 * q.shape[0]
    got = paged_attention(q, kp, vp, tables, lengths, split_lanes=split, **scales)
    want = paged_attention_plain(q, kp, vp, tables, lengths, **scales)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    _poison(kp, vp, tables, lengths, kind)
    poisoned = paged_attention(q, kp, vp, tables, lengths, split_lanes=split, **scales)
    torch.cuda.synchronize()
    assert torch.equal(poisoned, got)


def _verify_case(kind, b, n_tbl, w, seed, hkv=8, g=4, d=64, ps=16):
    """A speculative verify window on the card: ``b`` lanes at positions
    ``pos`` (from the seed, the last at the table's end), each lane's pages
    distinct, ``w`` query rows a lane.  Returns (q (b*w, Hkv, G, D), kp,
    vp, tables (b, P), pos (b,)), scales."""
    rng = np.random.default_rng(seed)
    rows = n_tbl * ps
    pos = rng.integers(0, rows - w + 1, b)
    pos[-1] = rows - w
    used = [-(-(p + w) // ps) for p in pos]
    n_pages = 1 + sum(used)
    ids = rng.permutation(n_pages - 1) + 1
    tables = np.zeros((b, n_tbl), np.int32)
    start = 0
    for lane, n in enumerate(used):
        tables[lane, :n] = ids[start:start + n]
        start += n
    q = torch.from_numpy(rng.normal(size=(b * w, hkv, g, d)).astype(np.float32)).bfloat16()
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
    pos = torch.tensor(pos, dtype=torch.int32)
    return [t.cuda() for t in (q, kp, vp, torch.from_numpy(tables), pos)], scales


@pytest.mark.parametrize("n_tbl", [11, 512])
@pytest.mark.parametrize("b", [4, 16])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_paged_attention_verify_layout_is_the_decode_step(kind, b, n_tbl):
    """The verify layout (B*W lanes, lane b's table row repeated W times,
    row c at length ``pos + c + 1``, the split count chosen for B lanes) is
    bitwise the W decode calls of B lanes at those lengths; with the split
    count chosen for B*W lanes it is the plain version within 2e-5."""
    _card()
    w = 5
    (q, kp, vp, tables, pos), scales = _verify_case(kind, b, n_tbl, w, seed=b + n_tbl)
    vtables = tables.repeat_interleave(w, dim=0).contiguous()
    vlengths = (pos[:, None] + 1 + torch.arange(w, device="cuda", dtype=torch.int32)[None])
    vlengths = vlengths.reshape(b * w).to(torch.int32).contiguous()
    launches = attn_mod.LAUNCHES
    got = paged_attention(q, kp, vp, vtables, vlengths, split_lanes=b, **scales)
    assert attn_mod.LAUNCHES == launches + 1
    qb = q.reshape(b, w, *q.shape[1:])
    for c in range(w):
        step = paged_attention(qb[:, c].contiguous(), kp, vp, tables,
                               (pos + 1 + c).to(torch.int32), **scales)
        assert torch.equal(got.reshape(b, w, *got.shape[1:])[:, c], step), c
    wide = paged_attention(q, kp, vp, vtables, vlengths, **scales)
    want = paged_attention_plain(q, kp, vp, vtables, vlengths, **scales)
    torch.cuda.synchronize()
    torch.testing.assert_close(wide, want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_verify_step_rows_are_the_decode_steps(kv):
    """A 5-row verify window over paged KV on the card (llama3.2-1b's
    widths, 2 layers, ``int8_spoga``) gives, row by row, the logits of 5
    teacher-forced decode steps bitwise, and leaves the same pool: the
    attention kernel splits each row as the decode step does and the
    window's norms reduce column by column (``layers.rmsnorm_columns``)."""
    _card()
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill, verify_step
    from repro_torch.paging.cache import PagedCache
    cfg = get_config("llama3.2-1b").with_(n_layers=2, quant_mode="int8_spoga",
                                          kv_cache_dtype=kv)
    params = init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 1040)).astype(np.int32))
    window = rng.integers(0, cfg.vocab_size, 5).tolist()
    _, single = prefill(params, cfg, {"tokens": prompt.cuda()}, 1040)
    stores = []
    for _ in range(2):
        store = PagedCache(cfg, 4, 1104, 16, device="cuda")
        store.manager.admit(0, 1104)
        ids = store.manager.alloc(0, 65)
        store.manager.ensure(0, 1045)
        store.insert(single, 0, ids, 1040)
        store.sync_tables()
        stores.append(store)
    active = torch.tensor([True, False, False, False], device="cuda")
    toks = torch.zeros((4, 5), dtype=torch.int32, device="cuda")
    toks[0] = torch.tensor(window, dtype=torch.int32)
    got, _ = verify_step(params, cfg, toks, stores[0].cache, active)
    for c in range(5):
        want, _ = decode_step(params, cfg, toks[:, c].contiguous(), stores[1].cache, active=active)
        assert torch.equal(got[0, c], want[0]), c
    torch.cuda.synchronize()
    for a, b in zip(stores[0].cache["blocks"][0].values(), stores[1].cache["blocks"][0].values()):
        assert torch.equal(a[:, 1:], b[:, 1:])      # page 0 is the trash page


# ---------------------------------------------------------------------------
# The MLA and MoE layers on the card against the same call on the CPU
# ---------------------------------------------------------------------------

def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


def test_grouped_expert_product_int32_on_card_is_the_cpus():
    """The routed experts' grouped product at deepseek-moe-16b's expert
    shape (64 experts, d 2048, d_expert 1408; capacity 1 a decode row):
    the int32 accumulators on the card equal the CPU's bitwise in every
    int8 dataflow, and so does the dequantized product."""
    _card()
    from repro_torch.models import moe
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 64, 1, 2048)).astype(np.float32)).bfloat16()
    w = torch.from_numpy((rng.normal(size=(64, 2048, 1408)) * 0.02).astype(np.float32)).bfloat16()
    for mode in ("int8_spoga", "int8_deas", "int8_direct"):
        spec, family = parse_quant_mode(mode)
        accs, outs = [], []
        for dev in ("cpu", "cuda"):
            xd, wd = x.to(dev), w.to(dev)
            xq, _ = moe.dynamic_quant(xd.float(), dim=-1, bits=8)
            wq, _ = moe.dynamic_quant(wd.float(), dim=1, bits=8)
            accs.append(moe._grouped_int(xq, wq, spec, family).cpu())
            outs.append(moe._grouped_matmul(xd, wd, mode).cpu())
        assert torch.equal(accs[0], accs[1]), mode
        assert torch.equal(outs[0], outs[1]), mode


def _layer_setup(arch):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config(arch).with_(n_layers=1, quant_mode="int8_spoga")
    return cfg, init_params(cfg, seed=0, device="cpu")


def _rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def test_moe_ffn_on_card_matches_cpu():
    """granite-moe-3b-a800m's routed FFN (40 experts, top-8) at full width
    over 4 decode rows and a 64-token prefill row: the card's output within
    2% of the output's scale of the CPU's (router logits and norms sum in
    another order on the card), the greedy-relevant scale."""
    _card()
    from repro_torch.models import moe
    cfg, params = _layer_setup("granite-moe-3b-a800m")
    p = params["blocks"][0]["moe"]
    p = {k: v[0] for k, v in p.items()}
    rng = np.random.default_rng(1)
    for shape in ((4, 1), (1, 64)):
        x = torch.from_numpy(rng.normal(size=shape + (cfg.d_model,)).astype(np.float32)).bfloat16()
        want, _ = moe.moe_ffn(x, p, cfg)
        launches = gemm_mod.LAUNCHES
        got, _ = moe.moe_ffn(x.cuda(), _to(p, "cuda"), cfg)
        assert gemm_mod.LAUNCHES == launches          # the experts are plain torch
        assert _rel(got.cpu(), want) < 2e-2, shape


def test_mla_paged_decode_on_card_matches_cpu():
    """minicpm3-4b's paged MLA decode (gather form on both devices) at full
    width over 4 lanes of random latent pages: the output and the written
    pools within 2% of their scale of the CPU's; no attention kernel."""
    _card()
    from repro_torch.models import attention as attn
    cfg, params = _layer_setup("minicpm3-4b")
    p = {k: v[0] for k, v in params["blocks"][0]["attn"].items()}
    m = cfg.mla
    rng = np.random.default_rng(2)
    pools = {"ckvp": torch.from_numpy(rng.normal(size=(45, 16, m.kv_lora_rank))
                                      .astype(np.float32)).bfloat16(),
             "krp": torch.from_numpy(rng.normal(size=(45, 16, m.qk_rope_head_dim))
                                     .astype(np.float32)).bfloat16()}
    tables = torch.from_numpy(rng.permutation(44)[:44].reshape(4, 11).astype(np.int32) + 1)
    pos = torch.tensor([0, 16, 99, 164], dtype=torch.int32)
    x = torch.from_numpy(rng.normal(size=(4, 1, cfg.d_model)).astype(np.float32)).bfloat16()
    cpu_pools = {k: v.clone() for k, v in pools.items()}
    want, _ = attn.mla_paged_decode(x, p, cfg, cpu_pools, pos, tables)
    card_pools = _to(pools, "cuda")
    launches = attn_mod.LAUNCHES
    got, _ = attn.mla_paged_decode(x.cuda(), _to(p, "cuda"), cfg, card_pools, pos.cuda(),
                                   tables.cuda())
    assert attn_mod.LAUNCHES == launches
    assert _rel(got.cpu(), want) < 2e-2
    for k in pools:
        assert _rel(card_pools[k].cpu(), cpu_pools[k]) < 2e-2, k


def test_mla_verify_rows_are_the_decode_steps_on_card():
    """A 5-row MLA verify window over latent pages on the card gives, row
    by row, what 5 decode steps give, bitwise, and leaves the same pools
    (rows attend one at a time, the window's norms column by column)."""
    _card()
    from repro_torch.models import attention as attn
    cfg, params = _layer_setup("minicpm3-4b")
    p = _to({k: v[0] for k, v in params["blocks"][0]["attn"].items()}, "cuda")
    m = cfg.mla
    rng = np.random.default_rng(3)
    pools = {"ckvp": torch.from_numpy(rng.normal(size=(45, 16, m.kv_lora_rank))
                                      .astype(np.float32)).bfloat16().cuda(),
             "krp": torch.from_numpy(rng.normal(size=(45, 16, m.qk_rope_head_dim))
                                     .astype(np.float32)).bfloat16().cuda()}
    tables = torch.from_numpy(rng.permutation(44).reshape(4, 11).astype(np.int32) + 1).cuda()
    pos = torch.tensor([0, 16, 99, 150], dtype=torch.int32, device="cuda")
    x = torch.from_numpy(rng.normal(size=(4, 5, cfg.d_model)).astype(np.float32)) \
        .bfloat16().cuda()
    vpools = {k: v.clone() for k, v in pools.items()}
    got, _ = attn.mla_paged_verify(x, p, cfg, vpools, pos, tables)
    for c in range(5):
        want, _ = attn.mla_paged_decode(x[:, c:c + 1].contiguous(), p, cfg, pools, pos + c,
                                        tables)
        assert torch.equal(got[:, c], want[:, 0]), c
    for k in pools:
        assert torch.equal(pools[k], vpools[k]), k


@pytest.mark.parametrize("kernel", ["spoga_gemm_dequant", "spoga_gemm"])
def test_gemm_tp_rank_shapes_bitwise(kernel):
    """Both GEMM kernels at a tp=2 rank's projection shapes of minicpm3-4b,
    recurrentgemma-9b and llava-next-mistral-7b (column-parallel and
    replicated on ``spoga_gemm_dequant``, row-parallel halves on
    ``spoga_gemm``) at M = 4 and 64: bitwise the plain versions, one
    launch a call."""
    _card()
    kns = TP_ARCH_DEQUANT_KN if kernel == "spoga_gemm_dequant" else TP_ARCH_INT_KN
    mod = gemm_mod if kernel == "spoga_gemm_dequant" else int_gemm_mod
    for k, n in kns:
        for m in (4, 64):
            spec, ops = _operands(m, k, n, "int8_spoga", seed=3 * m + k + n)
            kw = dict(n_x_slices=spec.n_a_slices, n_w_slices=spec.n_w_slices,
                      slice_bits=spec.slice_bits)
            launches = mod.LAUNCHES
            if kernel == "spoga_gemm_dequant":
                got, want = spoga_gemm_dequant(*ops, **kw), spoga_gemm_dequant_plain(*ops)
            else:
                got, want = spoga_gemm(*ops[:2], **kw), spoga_gemm_plain(*ops[:2])
            assert mod.LAUNCHES == launches + 1
            torch.cuda.synchronize()
            assert torch.equal(got, want), (kernel, m, k, n)


@pytest.mark.parametrize("vocab,tp", [(73448, 2), (73448, 4), (128256, 2), (32000, 8)])
def test_head_rank_block_is_the_unsharded_heads_columns(vocab, tp):
    """The head's bf16 product on the card (``layers._head_product``): a
    vocab-parallel rank's block of rows gives exactly its columns of the
    whole head's logits, at 4 decode rows and a 37-row prefill (the
    product runs in column blocks a rank's rows never cut)."""
    from repro_torch.models.layers import _head_product
    _card()
    gen = torch.Generator(device="cuda").manual_seed(vocab + tp)
    d = 2560
    table = (torch.randn((vocab, d), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    part = vocab // tp
    for m in (4, 37):
        x = torch.randn((m, d), generator=gen, device="cuda").to(torch.bfloat16)
        full = _head_product(x, table, vocab)
        for r in range(tp):
            got = _head_product(x, table[r * part:(r + 1) * part], vocab)
            assert torch.equal(got, full[:, r * part:(r + 1) * part]), (vocab, tp, m, r)


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_mla_rank_heads_are_the_unsharded_heads(tp):
    """MLA's absorbed attention on the card (``attention._mla_attend_rows``)
    over a tp rank's heads gives exactly those heads' outputs of the
    unsharded run, at minicpm3-4b's full width, 4 lanes and 300 latent
    rows (the rank's heads run in place among zero heads)."""
    from repro_torch import configs
    from repro_torch.models.attention import _mla_attend_rows
    from repro_torch.runtime import collectives
    from repro_torch.shard import local_config
    _card()
    cfg = configs.get_config("minicpm3-4b")
    m, h, b, s = cfg.mla, cfg.n_heads, 4, 300
    gen = torch.Generator(device="cuda").manual_seed(tp)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    q_nope, q_rope = rnd(b, 1, h, m.qk_nope_head_dim), rnd(b, 1, h, m.qk_rope_head_dim)
    ckv, kr = rnd(b, s, m.kv_lora_rank), rnd(b, s, m.qk_rope_head_dim)
    p = {"w_uk": rnd(m.kv_lora_rank, h * m.qk_nope_head_dim, scale=0.05),
         "w_uv": rnd(m.kv_lora_rank, h * m.v_head_dim, scale=0.05)}
    lens = torch.tensor([300, 17, 150, 64], device="cuda")
    valid = torch.arange(s, device="cuda")[None, :] < lens[:, None]
    full = _mla_attend_rows(q_nope, q_rope, ckv, kr, valid, p, cfg)
    local, hl = local_config(cfg, tp), h // tp
    for r in range(tp):
        heads = slice(r * hl, (r + 1) * hl)
        pr = {"w_uk": p["w_uk"][:, r * hl * m.qk_nope_head_dim:(r + 1) * hl * m.qk_nope_head_dim],
              "w_uv": p["w_uv"][:, r * hl * m.v_head_dim:(r + 1) * hl * m.v_head_dim]}
        # the rank's coordinate on the model axis (no collective runs)
        collectives._MODEL_AXES.append(collectives.Axis(None, tp, r, "gloo"))
        try:
            got = _mla_attend_rows(q_nope[:, :, heads], q_rope[:, :, heads], ckv, kr, valid,
                                   pr, local)
        finally:
            collectives._MODEL_AXES.pop()
        assert torch.equal(got, full[:, :, heads]), (tp, r)


def test_gemm_recurrent_shapes_bitwise():
    """``spoga_gemm_dequant`` at ``int8_spoga`` on the recurrent archs'
    narrowest and widest projections -- xlstm's 4-wide gates (K x N 768 x
    4: one partial N tile, element loads), recurrentgemma's MQA K/V (4096
    x 256) and GLU down projection (12288 x 4096) -- at the decode step's
    4 lanes, a 37-token prefill and a 256-token chunk: bitwise the plain
    version."""
    _card()
    for k, n in [(768, 4), (4096, 256), (12288, 4096)]:
        for m in (1, 4, 37, 256):
            spec, ops = _operands(m, k, n, "int8_spoga", seed=m * 7 + n)
            launches = gemm_mod.LAUNCHES
            got = spoga_gemm_dequant(*ops, n_x_slices=spec.n_a_slices,
                                     n_w_slices=spec.n_w_slices, slice_bits=spec.slice_bits)
            assert gemm_mod.LAUNCHES == launches + 1
            assert torch.equal(got, spoga_gemm_dequant_plain(*ops)), (m, k, n)


def test_rglru_and_ring_decode_step_on_card_match_cpu():
    """recurrentgemma-9b at full width, one RG-LRU and one local-attention
    layer (int8_spoga, a 64-row int8 ring), 4 lanes prefilled with 40
    tokens (the ring rolled), then 3 decode steps fed the CPU's tokens: the
    card's logits within 2% of their scale of the CPU's at every step (the
    cells' f32 math and the norms sum in another order on the card), and
    the RG-LRU state within 2% of its scale."""
    _card()
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill
    cfg = get_config("recurrentgemma-9b").with_(
        n_layers=2, block_pattern=("rglru", "local_attn"), sliding_window=64,
        quant_mode="int8_spoga", kv_cache_dtype="int8")
    params = init_params(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 40))
                              .astype(np.int32))
    card = _to(params, "cuda")
    want, cpu_cache = prefill(params, cfg, {"tokens": tokens}, 96)
    got, card_cache = prefill(card, cfg, {"tokens": tokens.cuda()}, 96)
    assert tuple(card_cache["blocks"][1]["k"].shape)[2] == 64
    launches = gemm_mod.LAUNCHES
    for step in range(3):
        assert _rel(got.cpu(), want) < 2e-2, step
        h = card_cache["blocks"][0]["h"]
        assert _rel(h.cpu(), cpu_cache["blocks"][0]["h"]) < 2e-2, step
        tok = want.argmax(-1).to(torch.int32)
        want, cpu_cache = decode_step(params, cfg, tok, cpu_cache)
        got, card_cache = decode_step(card, cfg, tok.cuda(), card_cache)
    # 8 projections of the RG-LRU layer, 7 of the local-attention layer
    assert gemm_mod.LAUNCHES - launches == 3 * 15


# ---------------------------------------------------------------------------
# The numerics watchdog on the card
# ---------------------------------------------------------------------------

def test_watchdog_on_card_is_bitwise_and_copies_once_per_entry_point():
    """With the watchdog on, ``quantized_linear`` through
    ``spoga_gemm_dequant`` gives the watchdog-off output bitwise with the
    same kernel launches, and a watched ``decode_step`` (2 layers, 14
    GEMMs) moves its stats to the host in one device-to-host copy."""
    _card()
    from repro_torch.backends.pipeline import quantized_linear
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.obs import watchdog
    watchdog.reset()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 2048)).astype(np.float32)).cuda().bfloat16()
    w = torch.from_numpy(rng.standard_normal((2048, 512)).astype(np.float32) * 0.02).cuda()
    gemm_mod.reset_counts()
    off = quantized_linear(x, w, "int8_spoga")
    with watchdog.watching("decode"):
        on = quantized_linear(x, w, "int8_spoga")
    assert gemm_mod.LAUNCHES == 2 and torch.equal(off, on)
    assert watchdog.peek_registry().counters[
        'watchdog_calls{layer="decode.00.k2048n512",mode="int8_spoga"}'].value == 1

    cfg = get_config("llama3.2-1b").with_(n_layers=2, quant_mode="int8_spoga")
    params = init_params(cfg, seed=0, device="cuda")
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)).cuda()
    tok = torch.zeros((4,), dtype=torch.int32, device="cuda")
    outs = []
    for watch in (False, True):
        c = cfg.with_(numerics_watchdog=watch)
        _, cache = prefill(params, c, {"tokens": prompt}, 32)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            logits, _ = decode_step(params, c, tok, cache)
            torch.cuda.synchronize()
        d2h = [e for e in prof.events() if "Memcpy DtoH" in e.name]
        outs.append((logits, len(d2h)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert outs[1][1] == outs[0][1] + 1, (outs[0][1], outs[1][1])
    watchdog.reset()


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_straight_through_linear_on_card(x_dtype):
    """``layers.linear`` at ``int8_spoga`` with grad on the card: the
    forward is ``quantized_linear``'s output bitwise (one
    ``spoga_gemm_dequant`` launch, no plain version), the backward launches
    no GEMM kernel and is the straight-through f32 formula bitwise: ``dx =
    (g @ w^T)`` rounded to bf16 then cast to ``x``'s dtype, ``dw = x_bf16^T
    @ g`` cast to bf16, at llama's (K, N) and a training step's M."""
    _card()
    from repro_torch.backends.pipeline import quantized_linear
    from repro_torch.models.layers import linear
    rng = np.random.default_rng(3)
    for k, n in LLAMA_KN:
        x = torch.from_numpy(rng.standard_normal((4, 1024, k)).astype(np.float32)).cuda()
        x = x.to(x_dtype).requires_grad_(True)
        w = (torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)) * 0.02)
        w = w.cuda().bfloat16().requires_grad_(True)
        g = torch.from_numpy(rng.standard_normal((4, 1024, n)).astype(np.float32)).cuda()
        g = g.bfloat16()
        gemm_mod.reset_counts()
        y = linear(x, w, "int8_spoga")
        assert gemm_mod.LAUNCHES == 1 and gemm_mod.PLAIN_CALLS == 0
        with torch.no_grad():
            assert torch.equal(y, quantized_linear(x, w, "int8_spoga",
                                                   out_dtype=torch.bfloat16))
        gemm_mod.reset_counts()
        dx, dw = torch.autograd.grad(y, (x, w), g)
        assert gemm_mod.LAUNCHES == 0 and gemm_mod.PLAIN_CALLS == 0
        gf = g.float()
        want_dx = torch.matmul(gf, w.detach().float().t()).bfloat16().to(x_dtype)
        xb = x.detach().bfloat16().reshape(-1, k).float()
        want_dw = torch.matmul(xb.t(), gf.reshape(-1, n)).bfloat16()
        assert dx.dtype == x_dtype and torch.equal(dx, want_dx), (k, n)
        assert torch.equal(dw, want_dw), (k, n)
        assert (dw != 0).float().mean() > 0.99


def test_step_profiler_trace_holds_every_kernel_of_its_window(tmp_path):
    """``StepProfiler`` on the card: a warm-up step, then 3 recorded steps of
    200 ``spoga_gemm_dequant`` launches each; the trace holds exactly the
    recorded steps' 600 kernels (none of the warm-up's, none lost at an end
    of the window) and a kernel record for every launch call in it."""
    import json

    from repro_torch.backends.pipeline import quantized_linear
    from repro_torch.obs.profile import StepProfiler
    _card()
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 2048)).astype(np.float32)).cuda().bfloat16()
    w = torch.from_numpy(rng.standard_normal((2048, 512)).astype(np.float32) * 0.02).cuda()
    prof = StepProfiler(str(tmp_path), n_steps=3)
    gemm_mod.reset_counts()
    for _ in range(4):
        prof.step_begin("cuda")
        for _ in range(200):
            quantized_linear(x, w, "int8_spoga")
        prof.step_end()
    assert prof.done and gemm_mod.LAUNCHES == 800 and gemm_mod.PLAIN_CALLS == 0
    with open(prof.trace_path) as f:
        trace = json.load(f)["traceEvents"]
    kernels = [e for e in trace if e.get("cat") == "kernel"]
    assert sum("spoga_gemm_dequant_kernel" in e["name"] for e in kernels) == 600
    recorded = {e["args"].get("correlation") for e in kernels}
    calls = [e for e in trace if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "aunchKernel" in e.get("name", "")]
    assert calls and all(e["args"].get("correlation") in recorded for e in calls)
