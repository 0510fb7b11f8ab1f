// The sliced radix GEMM core shared by the SPOGA kernels (spoga_gemm.cu,
// spoga_gemm_dequant.cu) and the DEAS nibble products (deas_gemm.cu).
//
// Port of the tile work of src/repro/kernels/spoga_gemm.py
// (`_slice_planes_tile`, `_radix_accumulate`, `spoga_gemm_kernel`).  One
// block owns a (16*TM) x (16*TN) output tile and walks K itself.  Each
// operand is split into bit planes of `bits` bits (low planes unsigned
// digits, the top plane the arithmetically shifted signed remainder; every
// plane an int8).  Every plane pair is multiplied with __dp4a into one
// int32 accumulator per radix lane i + j; each lane is then shifted once
// and the lanes are summed in uint32_t, which wraps exactly like the TPU's
// int32 and sidesteps C++'s undefined left shift of a negative int.  The
// caller's kernel stores the sum: one write per output element.
//
// Tiles go from global memory into shared memory as int16 (whatever the
// operand type) and are sliced in registers as they are read back, four K
// values packed at a time for __dp4a.  Plane counts above four per operand
// run in windows of at most four planes; each window walks K again and adds
// its shifted lanes into the same uint32 total.  wgmma, TMA and pipelining
// are later work: this core is right first.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace spoga_tile {

constexpr int BK = 32;        // K depth of one shared-memory tile
constexpr int PAD = 4;        // keeps 8-byte row alignment, spreads banks
constexpr int THREADS = 256;  // 16 x 16 threads; BM = 16 * TM, BN = 16 * TN

__device__ __forceinline__ int load_elem(const void* p, int bytes, size_t idx) {
    return bytes == 1 ? (int)static_cast<const int8_t*>(p)[idx]
                      : (int)static_cast<const int16_t*>(p)[idx];
}

// Plane `pi` of value v: low planes are unsigned digits, the top plane the
// signed remainder; planes past the operand's count are zero.  The result
// is taken as an int8 byte (as the TPU kernel's astype(int8)).
__device__ __forceinline__ uint32_t plane_byte(int v, int pi, int n, int bits) {
    if (pi >= n) return 0u;
    int s = v >> (pi * bits);
    if (pi < n - 1) s &= (1 << bits) - 1;
    return static_cast<uint32_t>(s) & 0xFFu;
}

__device__ __forceinline__ int pack4(const int16_t* v, int pi, int n, int bits) {
    return static_cast<int>(plane_byte(v[0], pi, n, bits)
                            | (plane_byte(v[1], pi, n, bits) << 8)
                            | (plane_byte(v[2], pi, n, bits) << 16)
                            | (plane_byte(v[3], pi, n, bits) << 24));
}

// Shared-memory tiles of one block.
template <int TM, int TN>
struct __align__(16) Smem {
    int16_t x[16 * TM][BK + PAD];
    int16_t w[16 * TN][BK + PAD];  // transposed: [n][k]
};

// Thread (tx, ty) of the block owns outputs (m0 + ty + 16 i, n0 + tx + 16 j).
struct TileCoords {
    int tx, ty, m0, n0;
};

template <int TM, int TN>
__device__ __forceinline__ TileCoords tile_coords() {
    return TileCoords{static_cast<int>(threadIdx.x % 16), static_cast<int>(threadIdx.x / 16),
                      static_cast<int>(blockIdx.y) * 16 * TM,
                      static_cast<int>(blockIdx.x) * 16 * TN};
}

// total[i][j] = the int32 product (mod 2^32) of the block's output element
// (i, j), computed from nx x-planes and nw w-planes of `bits` bits.
template <int TM, int TN, int NXW, int NWW>
__device__ __forceinline__ void radix_accumulate(
        const void* __restrict__ x, int x_bytes, const void* __restrict__ w, int w_bytes,
        int M, int K, int N, int nx, int nw, int bits, Smem<TM, TN>& s,
        uint32_t (&total)[TM][TN]) {
    constexpr int BM = 16 * TM;
    constexpr int BN = 16 * TN;
    constexpr int LANES = NXW + NWW - 1;
    const int tid = threadIdx.x;
    const TileCoords c = tile_coords<TM, TN>();

#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) total[i][j] = 0u;

    for (int i0 = 0; i0 < nx; i0 += NXW) {
        for (int j0 = 0; j0 < nw; j0 += NWW) {
            int lane_acc[LANES][TM][TN];
#pragma unroll
            for (int l = 0; l < LANES; ++l)
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int j = 0; j < TN; ++j) lane_acc[l][i][j] = 0;

            for (int k0 = 0; k0 < K; k0 += BK) {
                for (int e = tid; e < BM * BK; e += THREADS) {
                    const int r = e / BK, col = e % BK;
                    const int gm = c.m0 + r, gk = k0 + col;
                    s.x[r][col] = (gm < M && gk < K)
                        ? (int16_t)load_elem(x, x_bytes, (size_t)gm * K + gk) : (int16_t)0;
                }
                for (int e = tid; e < BK * BN; e += THREADS) {
                    const int r = e / BN, col = e % BN;
                    const int gk = k0 + r, gn = c.n0 + col;
                    s.w[col][r] = (gk < K && gn < N)
                        ? (int16_t)load_elem(w, w_bytes, (size_t)gk * N + gn) : (int16_t)0;
                }
                __syncthreads();

#pragma unroll
                for (int g = 0; g < BK / 4; ++g) {
                    int xp[NXW][TM];
                    int wp[NWW][TN];
#pragma unroll
                    for (int i = 0; i < TM; ++i) {
                        const int16_t* v = &s.x[c.ty + 16 * i][4 * g];
#pragma unroll
                        for (int p = 0; p < NXW; ++p) xp[p][i] = pack4(v, i0 + p, nx, bits);
                    }
#pragma unroll
                    for (int j = 0; j < TN; ++j) {
                        const int16_t* v = &s.w[c.tx + 16 * j][4 * g];
#pragma unroll
                        for (int q = 0; q < NWW; ++q) wp[q][j] = pack4(v, j0 + q, nw, bits);
                    }
#pragma unroll
                    for (int p = 0; p < NXW; ++p)
#pragma unroll
                        for (int q = 0; q < NWW; ++q)
#pragma unroll
                            for (int i = 0; i < TM; ++i)
#pragma unroll
                                for (int j = 0; j < TN; ++j)
                                    lane_acc[p + q][i][j] =
                                        __dp4a(xp[p][i], wp[q][j], lane_acc[p + q][i][j]);
                }
                __syncthreads();
            }

            // one shift per radix lane, summed in uint32 (wraps like int32)
#pragma unroll
            for (int l = 0; l < LANES; ++l) {
                const int shift = (i0 + j0 + l) * bits;
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int j = 0; j < TN; ++j)
                        total[i][j] += shift < 32
                            ? static_cast<uint32_t>(lane_acc[l][i][j]) << shift : 0u;
            }
        }
    }
}

// The int32 epilogue of spoga_gemm and nibble_gemm: one store per output
// element (the paper's one ADC per dot product).
template <int TM, int TN>
__device__ __forceinline__ void store_int32(int32_t* __restrict__ out, int M, int N,
                                            const uint32_t (&total)[TM][TN]) {
    const TileCoords c = tile_coords<TM, TN>();
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int m = c.m0 + c.ty + 16 * i;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int n = c.n0 + c.tx + 16 * j;
            if (n < N) out[(size_t)m * N + n] = static_cast<int32_t>(total[i][j]);
        }
    }
}

template <int TM, int TN>
inline dim3 grid_for(int M, int N) {
    return dim3((N + 16 * TN - 1) / (16 * TN), (M + 16 * TM - 1) / (16 * TM));
}

// Host-side dispatch: calls launcher.template run<TM, TN, NXW, NWW>() with the
// block tile that suits M (a thin tile for decode-sized M) and plane windows
// of at most four planes per operand.
template <int TM, int TN, int NXW, class L>
void dispatch_w(const L& launcher, int nww) {
    switch (nww) {
        case 1: launcher.template run<TM, TN, NXW, 1>(); break;
        case 2: launcher.template run<TM, TN, NXW, 2>(); break;
        case 3: launcher.template run<TM, TN, NXW, 3>(); break;
        default: launcher.template run<TM, TN, NXW, 4>(); break;
    }
}

template <int TM, int TN, class L>
void dispatch_tile(const L& launcher, int nxw, int nww) {
    switch (nxw) {
        case 1: dispatch_w<TM, TN, 1>(launcher, nww); break;
        case 2: dispatch_w<TM, TN, 2>(launcher, nww); break;
        case 3: dispatch_w<TM, TN, 3>(launcher, nww); break;
        default: dispatch_w<TM, TN, 4>(launcher, nww); break;
    }
}

template <class L>
void dispatch(const L& launcher, int M, int n_x_slices, int n_w_slices) {
    const int nxw = n_x_slices < 4 ? n_x_slices : 4;
    const int nww = n_w_slices < 4 ? n_w_slices : 4;
    if (M <= 16) {
        dispatch_tile<1, 2>(launcher, nxw, nww);
    } else {
        dispatch_tile<4, 4>(launcher, nxw, nww);
    }
}

// The operand checks every SPOGA entry point shares.
inline bool valid_spoga_args(int M, int K, int N, int x_bytes, int w_bytes,
                             int n_x_slices, int n_w_slices, int slice_bits) {
    return M > 0 && K > 0 && N > 0 && n_x_slices >= 1 && n_w_slices >= 1
        && slice_bits >= 1 && slice_bits <= 7
        && (x_bytes == 1 || x_bytes == 2) && (w_bytes == 1 || w_bytes == 2);
}

}  // namespace spoga_tile
