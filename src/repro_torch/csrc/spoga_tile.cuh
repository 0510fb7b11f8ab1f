// The sliced radix GEMM core shared by the SPOGA kernels (spoga_gemm.cu,
// spoga_gemm_dequant.cu) and the DEAS nibble products (deas_gemm.cu), for
// Hopper (sm_90a).
//
// Port of the tile work of src/repro/kernels/spoga_gemm.py
// (`_slice_planes_tile`, `_radix_accumulate`, `spoga_gemm_kernel`).  Each
// operand is split inside the kernel into bit planes of `bits` bits (low
// planes unsigned digits, the top plane the arithmetically shifted signed
// remainder; every plane an int8).  Every plane pair is multiplied on the
// int8 tensor cores (mma.sync m16n8k32 s8.s8.s32, no .satfinite, so the
// sums wrap like the TPU's int32) into one s32 accumulator fragment per
// radix lane i + j; each lane is shifted once and the lanes are summed in
// uint32_t.  The caller's epilogue stores one value per output element: no
// plane or lane reaches device memory.
//
// What bounds it on an H100.  The function is one integer (M, K) @ (K, N)
// product.  At decode (M <= 16) the weight bytes bound it: K=2048, N=8192
// is 16.8 MB, 5.0 us at 3.35 TB/s.  At prefill (M = 128) the bytes still
// do (6.3 us), but the W8A8 plane products are 4 x 2*M*K*N = 17.2 G
// operations, 8.7 us of tensor-core time at the int8 peak, so the kernel
// has to keep both the copies and the MMAs busy.  What the design does:
//
// * The products run outᵀ = wᵀ·xᵀ: the weights fill the MMA's 16-row A slot
//   and the few activation rows its 8-wide B slot.  The s8 A operand is
//   K-contiguous, w is N-contiguous: each thread reads a 4 x 4 byte block
//   (4 K rows of 4 N values) from shared memory and transposes it with
//   __byte_perm while it slices.  Which N value sits in which MMA row is a
//   permutation the epilogue undoes.
// * Raw operand tiles (BK = 128 deep, BN = 128 wide) stream through a
//   STAGES-deep ring in shared memory with 16-byte cp.async copies,
//   neighbouring threads on neighbouring addresses, XOR-swizzled so that the
//   fragment reads are free of bank conflicts.  Shapes whose rows are not
//   16-byte aligned take a masked element-wise copy into the same layout.
// * Blocks split K inside a thread-block cluster of up to 8 blocks, sized
//   from the SM count so that even N = 512 fills the card.  Each block
//   reduces its warps' radix-combined sums into shared memory, the cluster
//   sums the partials through distributed shared memory (integer sums are
//   associative mod 2^32, so any order is bitwise the same) and each block
//   runs the epilogue on its share of the tile: one launch, no (M, N)
//   intermediate in device memory.
// * Each warp slices the fragments it multiplies: a shift and two logic
//   operations per packed word (constants made once per window), prmt for
//   the signs and the transpose.  At prefill the issue of this work, the
//   fragment reads and the MMAs sets the time, not the copies, so the warp
//   tile there is tall in M (32 rows): each weight fragment it slices feeds
//   more products.
// * Plane counts above four per operand run in windows of at most four
//   planes (a window of three is run as four with a zero plane); each window
//   walks K again and adds its shifted lanes into the same uint32 tile.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace spoga_tile {

namespace cg = cooperative_groups;

constexpr int BK = 128;       // K depth of one ring stage
constexpr int BN = 128;       // N width of a block tile
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 4;
constexpr int MAX_CLUSTER = 8;  // portable cluster size

enum Mode { DECODE = 0, PREFILL = 1 };  // M <= 16, M > 16

// Block and warp tiling of one kernel instance.  A warp owns WN_T m16 tiles
// along N and WM_T n8 tiles along M; at decode the warps split each stage's
// K instead of M.
template <int NXW_, int NWW_, int XB_, int WB_, int MODE_>
struct Cfg {
    static constexpr int NXW = NXW_, NWW = NWW_, XB = XB_, WB = WB_, MODE = MODE_;
    static constexpr int LANES = NXW + NWW - 1;
    // fewer lanes, larger warp tile: wide in N at decode, in M at prefill
    static constexpr int WN_T = (LANES <= 3 && MODE == DECODE) ? 4 : 2;
    static constexpr int G = WN_T / 2;              // 4-wide N groups per thread
    static constexpr int WARPS_N = BN / (16 * WN_T);
    static constexpr int WM_T = MODE == DECODE ? 1 : LANES <= 3 ? 4 : 2;
    static constexpr int WARPS_M = MODE == PREFILL ? WARPS / WARPS_N : 1;
    static constexpr int WARPS_K = MODE == PREFILL ? 1 : WARPS / WARPS_N;
    static constexpr int BM = 8 * WM_T * WARPS_M;
    static constexpr int W_ROW = BN * WB;   // bytes of one K row of the w tile
    static constexpr int X_ROW = BK * XB;   // bytes of one M row of the x tile
    static constexpr int STAGE = BK * W_ROW + BM * X_ROW;
    static constexpr int RING = STAGES * STAGE;
    static constexpr int SMEM = RING + BM * BN * 4;  // ring + the uint32 output tile
    static_assert(WARPS_N * WARPS_M * WARPS_K == WARPS, "8 warps");
};

// One call's operands.  k_chunk: the K range of one block of the cluster
// (a multiple of BK); aligned: rows and bases are 16-byte aligned.
struct Problem {
    const void* x;
    const void* w;
    int M, K, N, nx, nw, bits, aligned, k_chunk;
};

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// d += a (16x32, row) * b (32x8, col), s8 in, s32 accumulate, wrapping.
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// slicing: four packed values at a time
// ---------------------------------------------------------------------------

// Plane q of packed values of B bytes (four int8 or two int16 to a word):
// an arithmetic shift of each value by s = q*bits (at most 8*B - 1: a value
// shifted further is all sign), masked to `bits` bits for a low plane, the
// whole (sign-extended) value for the top plane, zero past the operand's
// count.  The constants depend on the window only and are made once per
// K walk; a plane then costs a shift and two logic operations per word.
struct PlaneK {
    int s;
    uint32_t keep;  // the bits of each value that the shift brings from the value itself
    uint32_t mask;  // the plane's bits of each value
};

template <int B>
__device__ __forceinline__ PlaneK plane_k(int q, int n, int bits) {
    constexpr uint32_t all = B == 1 ? 0xFFu : 0xFFFFu;
    constexpr uint32_t rep = B == 1 ? 0x01010101u : 0x00010001u;
    PlaneK k;
    k.s = min(q * bits, 8 * B - 1);
    k.keep = (all >> k.s) * rep;
    k.mask = q >= n ? 0u : q < n - 1 ? ((1u << bits) - 1u) * rep : 0xFFFFFFFFu;
    return k;
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
    uint32_t r;
    asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
    return r;
}

// Each value's sign bit over all of its bits (prmt's sign-replicate mode).
template <int B>
__device__ __forceinline__ uint32_t signs(uint32_t w) {
    return prmt(w, 0u, B == 1 ? 0xBA98u : 0xBB99u);
}

__device__ __forceinline__ uint32_t plane(uint32_t w, uint32_t sg, const PlaneK& k) {
    return (((w >> k.s) & k.keep) | (sg & ~k.keep)) & k.mask;
}

// Plane k of four consecutive values of B bytes each at `p` (one word of
// int8, two of int16), as four packed int8.
template <int B>
__device__ __forceinline__ uint32_t plane_of(const uint32_t* p, const PlaneK& k) {
    if constexpr (B == 1) {
        return plane(p[0], signs<1>(p[0]), k);
    } else {  // the low byte of each int16 plane value
        return prmt(plane(p[0], signs<2>(p[0]), k), plane(p[1], signs<2>(p[1]), k), 0x6420u);
    }
}

// 4 x 4 byte transpose: r[j] holds byte e of row j -> t[e] holds byte j of
// row e, i.e. four N values of four K rows become four K-packed words.
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4], uint32_t (&t)[4]) {
    const uint32_t a = prmt(r[0], r[1], 0x5140u);
    const uint32_t b = prmt(r[0], r[1], 0x7362u);
    const uint32_t c = prmt(r[2], r[3], 0x5140u);
    const uint32_t d = prmt(r[2], r[3], 0x7362u);
    t[0] = prmt(a, c, 0x5410u);
    t[1] = prmt(a, c, 0x7632u);
    t[2] = prmt(b, d, 0x5410u);
    t[3] = prmt(b, d, 0x7632u);
}

// ---------------------------------------------------------------------------
// shared-memory layout: 16-byte chunks XOR-swizzled inside 128-byte groups
// ---------------------------------------------------------------------------

// byte `b` of K row `r` of the w tile
template <class C>
__device__ __forceinline__ int w_off(int r, int b) {
    return r * C::W_ROW + (((b >> 4) ^ (((r >> 2) & 3) << 1)) << 4) + (b & 15);
}

// byte `b` of M row `r` of the x tile
template <class C>
__device__ __forceinline__ int x_off(int r, int b) {
    return r * C::X_ROW + (((b >> 4) ^ (r & 7)) << 4) + (b & 15);
}

template <int B>
__device__ __forceinline__ int load_elem(const void* p, size_t idx) {
    if constexpr (B == 1) return static_cast<const int8_t*>(p)[idx];
    else return static_cast<const int16_t*>(p)[idx];
}

template <int B>
__device__ __forceinline__ void store_elem(char* p, int v) {
    if constexpr (B == 1) *reinterpret_cast<int8_t*>(p) = static_cast<int8_t>(v);
    else *reinterpret_cast<int16_t*>(p) = static_cast<int16_t>(v);
}

// Copy stage `k0` (rows k0 .. k0 + BK of w, columns of x) of the block's
// tile into `st`; rows and columns past the block's K range or the matrix
// are zero.
template <class C>
__device__ __forceinline__ void load_stage(const Problem& p, char* st, int k0, int k_end,
                                           int m0, int n0) {
    char* sw = st;
    char* sx = st + BK * C::W_ROW;
    const int tid = threadIdx.x;
    if (p.aligned) {
        const uint32_t sw_a = static_cast<uint32_t>(__cvta_generic_to_shared(sw));
        const uint32_t sx_a = static_cast<uint32_t>(__cvta_generic_to_shared(sx));
        constexpr int WC = C::W_ROW / 16;
        for (int id = tid; id < BK * WC; id += THREADS) {
            const int r = id / WC, c = id % WC;
            const int k = k0 + r, n = n0 + c * (16 / C::WB);
            const bool ok = k < k_end && n < p.N;
            const char* src = static_cast<const char*>(p.w)
                + (ok ? ((size_t)k * p.N + n) * C::WB : 0);
            cp_async16(sw_a + w_off<C>(r, c * 16), src, ok ? 16 : 0);
        }
        constexpr int XC = C::X_ROW / 16;
        for (int id = tid; id < C::BM * XC; id += THREADS) {
            const int r = id / XC, c = id % XC;
            const int m = m0 + r, k = k0 + c * (16 / C::XB);
            const bool ok = m < p.M && k < k_end;
            const char* src = static_cast<const char*>(p.x)
                + (ok ? ((size_t)m * p.K + k) * C::XB : 0);
            cp_async16(sx_a + x_off<C>(r, c * 16), src, ok ? 16 : 0);
        }
    } else {  // masked element-wise copy for rows that are not 16-byte aligned
        for (int id = tid; id < BK * BN; id += THREADS) {
            const int r = id / BN, c = id % BN;
            const int k = k0 + r, n = n0 + c;
            const int v = (k < k_end && n < p.N) ? load_elem<C::WB>(p.w, (size_t)k * p.N + n) : 0;
            store_elem<C::WB>(sw + w_off<C>(r, c * C::WB), v);
        }
        for (int id = tid; id < C::BM * BK; id += THREADS) {
            const int r = id / BK, c = id % BK;
            const int m = m0 + r, k = k0 + c;
            const int v = (m < p.M && k < k_end) ? load_elem<C::XB>(p.x, (size_t)m * p.K + k) : 0;
            store_elem<C::XB>(sx + x_off<C>(r, c * C::XB), v);
        }
    }
}

// The plane products of one ring stage for this warp, into the lanes.
template <class C>
__device__ __forceinline__ void compute_stage(
        const char* st, const PlaneK (&kx)[C::NXW], const PlaneK (&kw)[C::NWW],
        int (&acc)[C::LANES][C::WN_T][C::WM_T][4]) {
    const char* sw = st;
    const char* sx = st + BK * C::W_ROW;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int g = lane >> 2, t = lane & 3;
    const int wn = warp % C::WARPS_N;
    const int wm = (warp / C::WARPS_N) % C::WARPS_M;
    const int wk = warp / (C::WARPS_N * C::WARPS_M);
    constexpr int TB = 4 * C::G * C::WB;      // w bytes per thread per K row
    constexpr int TW = TB / 4;                // ... in words
    static_assert(TB == 4 || TB == 8, "one 4- or 8-byte read per K row");
    const int wbyte = (wn * 16 * C::WN_T) * C::WB + g * TB;

#pragma unroll
    for (int s = wk; s < BK / 32; s += C::WARPS_K) {
        // B fragments: x rows (8 per m-tile), K packed 4 to a word
        uint32_t b[C::NXW][C::WM_T][2];
#pragma unroll
        for (int jm = 0; jm < C::WM_T; ++jm) {
            const int r = wm * 8 * C::WM_T + 8 * jm + g;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                uint32_t raw[C::XB];
                const char* src = sx + x_off<C>(r, (32 * s + 16 * h + 4 * t) * C::XB);
                if constexpr (C::XB == 1) {
                    raw[0] = *reinterpret_cast<const uint32_t*>(src);
                } else {
                    const uint2 v = *reinterpret_cast<const uint2*>(src);
                    raw[0] = v.x;
                    raw[1] = v.y;
                }
#pragma unroll
                for (int q = 0; q < C::NXW; ++q) b[q][jm][h] = plane_of<C::XB>(raw, kx[q]);
            }
        }
        // A fragments: w rows 4t + j of each half, TB bytes each
        uint32_t raw[2][4][TW];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int r = 32 * s + 16 * h + 4 * t + j;
                if constexpr (TB == 4) {
                    raw[h][j][0] = *reinterpret_cast<const uint32_t*>(sw + w_off<C>(r, wbyte));
                } else {
                    const uint2 v = *reinterpret_cast<const uint2*>(sw + w_off<C>(r, wbyte));
                    raw[h][j][0] = v.x;
                    raw[h][j][1] = v.y;
                }
            }
#pragma unroll
        for (int cg4 = 0; cg4 < C::G; ++cg4) {
            // a[q][h][e]: plane q of N value e of this group, K half h
            uint32_t a[C::NWW][2][4];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                if constexpr (C::WB == 1) {
                    uint32_t r4[4] = {raw[h][0][cg4], raw[h][1][cg4], raw[h][2][cg4],
                                      raw[h][3][cg4]};
                    uint32_t t4[4], sg[4];
                    transpose4(r4, t4);
#pragma unroll
                    for (int e = 0; e < 4; ++e) sg[e] = signs<1>(t4[e]);
#pragma unroll
                    for (int q = 0; q < C::NWW; ++q)
#pragma unroll
                        for (int e = 0; e < 4; ++e) a[q][h][e] = plane(t4[e], sg[e], kw[q]);
                } else {
#pragma unroll
                    for (int q = 0; q < C::NWW; ++q) {
                        uint32_t r4[4];
#pragma unroll
                        for (int j = 0; j < 4; ++j)
                            r4[j] = plane_of<2>(&raw[h][j][2 * cg4], kw[q]);
                        transpose4(r4, a[q][h]);
                    }
                }
            }
#pragma unroll
            for (int hi = 0; hi < 2; ++hi) {
                const int i = 2 * cg4 + hi;
#pragma unroll
                for (int q = 0; q < C::NWW; ++q) {
#pragma unroll
                    for (int pp = 0; pp < C::NXW; ++pp) {
#pragma unroll
                        for (int jm = 0; jm < C::WM_T; ++jm)
                            mma_s8(acc[pp + q][i][jm], a[q][0][2 * hi], a[q][0][2 * hi + 1],
                                   a[q][1][2 * hi], a[q][1][2 * hi + 1], b[pp][jm][0],
                                   b[pp][jm][1]);
                    }
                }
            }
        }
    }
}

// The block's share of the cluster's output tile: calls epi(m, n, v, count)
// for the elements it owns, `count` (up to 4) consecutive N values from n on,
// each the int32 product mod 2^32 as uint32.  Every thread of the block
// must call it.
template <class C, class Epi>
__device__ __forceinline__ void gemm_block(const Problem& p, const Epi& epi, char* smem) {
    const int n0 = blockIdx.y * BN;
    const int m0 = blockIdx.z * C::BM;
    const int k_begin = blockIdx.x * p.k_chunk;
    const int k_end = min(p.K, k_begin + p.k_chunk);
    const int n_st = k_begin < k_end ? (k_end - k_begin + BK - 1) / BK : 0;

    // the block's (BM, BN) uint32 tile, after the ring
    uint32_t* red = reinterpret_cast<uint32_t*>(smem + C::RING);
    for (int e = threadIdx.x; e < C::BM * BN; e += THREADS) red[e] = 0u;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int g = lane >> 2, t = lane & 3;
    const int wn = warp % C::WARPS_N;
    const int wm = (warp / C::WARPS_N) % C::WARPS_M;

    for (int i0 = 0; i0 < p.nx; i0 += C::NXW) {
        for (int j0 = 0; j0 < p.nw; j0 += C::NWW) {
            PlaneK kx[C::NXW], kw[C::NWW];
#pragma unroll
            for (int q = 0; q < C::NXW; ++q) kx[q] = plane_k<C::XB>(i0 + q, p.nx, p.bits);
#pragma unroll
            for (int q = 0; q < C::NWW; ++q) kw[q] = plane_k<C::WB>(j0 + q, p.nw, p.bits);
            int acc[C::LANES][C::WN_T][C::WM_T][4];
#pragma unroll
            for (int l = 0; l < C::LANES; ++l)
#pragma unroll
                for (int i = 0; i < C::WN_T; ++i)
#pragma unroll
                    for (int jm = 0; jm < C::WM_T; ++jm)
#pragma unroll
                        for (int c = 0; c < 4; ++c) acc[l][i][jm][c] = 0;

#pragma unroll
            for (int st = 0; st < STAGES - 1; ++st) {
                if (st < n_st)
                    load_stage<C>(p, smem + st * C::STAGE, k_begin + st * BK, k_end, m0, n0);
                cp_async_commit();
            }
            for (int it = 0; it < n_st; ++it) {
                cp_async_wait<STAGES - 2>();
                __syncthreads();
                const int nxt = it + STAGES - 1;
                if (nxt < n_st)
                    load_stage<C>(p, smem + (nxt % STAGES) * C::STAGE, k_begin + nxt * BK, k_end,
                                  m0, n0);
                cp_async_commit();
                compute_stage<C>(smem + (it % STAGES) * C::STAGE, kx, kw, acc);
            }
            cp_async_wait<0>();
            __syncthreads();

            // one shift per radix lane, summed in uint32 (wraps like int32),
            // added into the block's tile (the warps of a K split too)
#pragma unroll
            for (int i = 0; i < C::WN_T; ++i)
#pragma unroll
                for (int jm = 0; jm < C::WM_T; ++jm)
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        uint32_t v = 0u;
#pragma unroll
                        for (int l = 0; l < C::LANES; ++l) {
                            const int shift = (i0 + j0 + l) * p.bits;
                            if (shift < 32) v += static_cast<uint32_t>(acc[l][i][jm][c]) << shift;
                        }
                        // undo the N permutation of the A fragments
                        const int n = wn * 16 * C::WN_T + 4 * (g * C::G + (i >> 1))
                                      + 2 * (i & 1) + (c >> 1);
                        const int m = wm * 8 * C::WM_T + 8 * jm + 2 * t + (c & 1);
                        atomicAdd(&red[m * BN + n], v);
                    }
        }
    }

    // the cluster's K splits -> this block's share of the tile, then the
    // epilogue, four consecutive N values at a time
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int splits = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const uint4* part[MAX_CLUSTER];
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)
        part[q] = cluster.map_shared_rank(reinterpret_cast<const uint4*>(red), q < splits ? q : 0);
    constexpr int QUADS = C::BM * BN / 4;
    const int per = (QUADS + splits - 1) / splits;
    const int q_end = min(QUADS, (rank + 1) * per);
#pragma unroll 2
    for (int e = rank * per + threadIdx.x; e < q_end; e += THREADS) {
        const int m = m0 + 4 * e / BN, n = n0 + 4 * e % BN;
        if (m >= p.M || n >= p.N) continue;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int q = 0; q < MAX_CLUSTER; ++q) {
            if (q < splits) {
                const uint4 u = part[q][e];
                v.x += u.x;
                v.y += u.y;
                v.z += u.z;
                v.w += u.w;
            }
        }
        epi(m, n, v, min(4, p.N - n));
    }
    cluster.sync();  // peers' shared memory stays alive until every block has read it
}

// The int32 epilogue of spoga_gemm and nibble_gemm: one store per output
// element (the paper's one ADC per dot product).
struct StoreInt32 {
    int32_t* out;
    int N;
    __device__ __forceinline__ void operator()(int m, int n, uint4 v, int count) const {
        int32_t* o = out + (size_t)m * N + n;
        if (count == 4 && (N & 3) == 0) {
            *reinterpret_cast<uint4*>(o) = v;
            return;
        }
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
        for (int i = 0; i < count; ++i) o[i] = static_cast<int32_t>(w[i]);
    }
};

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

inline cudaError_t sm_count(int* out) {
    static int cached = 0;
    if (cached == 0) {
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return err;
        err = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return err;
    }
    *out = cached;
    return cudaSuccess;
}

inline bool is_aligned16(const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// The operand checks every SPOGA entry point shares.
inline bool valid_spoga_args(int M, int K, int N, int x_bytes, int w_bytes,
                             int n_x_slices, int n_w_slices, int slice_bits) {
    return M > 0 && K > 0 && N > 0 && n_x_slices >= 1 && n_w_slices >= 1
        && slice_bits >= 1 && slice_bits <= 7
        && (x_bytes == 1 || x_bytes == 2) && (w_bytes == 1 || w_bytes == 2);
}

inline Problem make_problem(const void* x, int x_bytes, const void* w, int w_bytes,
                            int M, int K, int N, int nx, int nw, int bits) {
    const bool aligned = is_aligned16(x) && is_aligned16(w)
        && (static_cast<long long>(K) * x_bytes) % 16 == 0
        && (static_cast<long long>(N) * w_bytes) % 16 == 0;
    return Problem{x, w, M, K, N, nx, nw, bits, aligned ? 1 : 0, 0};
}

// Launch `Kernel` (a __global__ taking (Problem, Epi)) for config C: the grid
// is (K splits, N tiles, M tiles), one cluster per (N, M) tile holding its K
// splits.  The split count fills the card (one block per SM, at most
// MAX_CLUSTER splits) as far as all clusters stay resident at once, which
// the occupancy query says per cluster size.  Templated on the kernel itself, so that
// each kernel keeps its own shared-memory opt-in flag.
template <class C, auto Kernel, class Epi>
cudaError_t launch(Problem p, Epi epi, cudaStream_t stream) {
    int sms = 0;
    cudaError_t err = sm_count(&sms);
    if (err != cudaSuccess) return err;
    static bool configured = false;
    if (!configured) {
        err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
        if (err != cudaSuccess) return err;
        configured = true;
    }
    const int n_tiles = (p.N + BN - 1) / BN;
    const int m_tiles = (p.M + C::BM - 1) / C::BM;
    const int stages = (p.K + BK - 1) / BK;
    const int target = sms;  // one block per SM (the warp tiles need the registers)
    const long long tiles = static_cast<long long>(n_tiles) * m_tiles;
    int splits = 1;
    if (4 * tiles < 3LL * target) {
        splits = static_cast<int>((target + tiles - 1) / tiles);
        splits = splits < MAX_CLUSTER ? splits : MAX_CLUSTER;
    }
    splits = splits < stages ? splits : stages;
    // fewer splits until every cluster is resident at once (one wave)
    static int resident[MAX_CLUSTER + 1] = {};
    while (splits > 1) {
        if (resident[splits] == 0) {
            cudaLaunchConfig_t q = {};
            cudaLaunchAttribute a[1];
            a[0].id = cudaLaunchAttributeClusterDimension;
            a[0].val.clusterDim.x = splits;
            a[0].val.clusterDim.y = 1;
            a[0].val.clusterDim.z = 1;
            q.gridDim = dim3(splits, 1, 1);
            q.blockDim = dim3(THREADS, 1, 1);
            q.dynamicSmemBytes = C::SMEM;
            q.attrs = a;
            q.numAttrs = 1;
            err = cudaOccupancyMaxActiveClusters(&resident[splits], Kernel, &q);
            if (err != cudaSuccess) return err;
        }
        if (tiles <= resident[splits]) break;
        --splits;
    }
    const int per = (stages + splits - 1) / splits;
    splits = (stages + per - 1) / per;
    p.k_chunk = per * BK;

    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(splits, n_tiles, m_tiles);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = C::SMEM;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, Kernel, p, epi);
}

// Host-side dispatch: calls launcher.template run<Cfg<...>>() with the
// tiling that suits M and plane windows of at most four planes per operand
// (int8 operands: windows of 1, 2 or 4 planes, a 3 run as 4; int16: 4).
inline int window(int n) { return n >= 3 ? 4 : n; }

template <int XB, int WB, int MODE, class L>
void dispatch_windows(const L& launcher, int nxw, int nww) {
    if constexpr (XB == 2 || WB == 2) {
        launcher.template run<Cfg<4, 4, XB, WB, MODE>>();
        return;
    } else {
#define SPOGA_TILE_W(NX)                                                            \
    switch (nww) {                                                                  \
        case 1: launcher.template run<Cfg<NX, 1, 1, 1, MODE>>(); break;             \
        case 2: launcher.template run<Cfg<NX, 2, 1, 1, MODE>>(); break;             \
        default: launcher.template run<Cfg<NX, 4, 1, 1, MODE>>(); break;            \
    }
    switch (nxw) {
        case 1: SPOGA_TILE_W(1) break;
        case 2: SPOGA_TILE_W(2) break;
        default: SPOGA_TILE_W(4) break;
    }
#undef SPOGA_TILE_W
    }
}

template <int XB, int WB, class L>
void dispatch_mode(const L& launcher, int M, int nxw, int nww) {
    if (M <= 16) dispatch_windows<XB, WB, DECODE>(launcher, nxw, nww);
    else dispatch_windows<XB, WB, PREFILL>(launcher, nxw, nww);
}

// One plane window, the tiling by M only (the DEAS nibble products).
template <int NXW, int NWW, class L>
void dispatch_fixed(const L& launcher, int M) {
    if (M <= 16) launcher.template run<Cfg<NXW, NWW, 1, 1, DECODE>>();
    else launcher.template run<Cfg<NXW, NWW, 1, 1, PREFILL>>();
}

template <class L>
void dispatch(const L& launcher, int M, int x_bytes, int w_bytes, int n_x_slices,
              int n_w_slices) {
    const int nxw = window(n_x_slices), nww = window(n_w_slices);
    if (x_bytes == 1 && w_bytes == 1) dispatch_mode<1, 1>(launcher, M, nxw, nww);
    else if (x_bytes == 1) dispatch_mode<1, 2>(launcher, M, nxw, nww);
    else if (w_bytes == 1) dispatch_mode<2, 1>(launcher, M, nxw, nww);
    else dispatch_mode<2, 2>(launcher, M, nxw, nww);
}

}  // namespace spoga_tile
