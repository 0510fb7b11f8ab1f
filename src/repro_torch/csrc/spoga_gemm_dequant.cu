// SPOGA fused bit-sliced integer GEMM with dequantizing epilogue, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/spoga_gemm_dequant.py:spoga_gemm_dequant
// (Pallas body `_kernel`, with `_slice_planes_tile` and `_radix_accumulate`
// from src/repro/kernels/spoga_gemm.py).
//
//   out (M, N) f32 = (x (M, K) int8|int16  @  w (K, N) int8|int16)
//                    * x_scale (M, 1) f32 * w_scale (1, N) f32
//
// Each operand is split into bit planes of `slice_bits` bits (low planes are
// unsigned digits, the top plane the arithmetically shifted signed
// remainder; every plane is an int8).  Every plane pair is multiplied with
// __dp4a into one int32 accumulator per radix lane i + j; at the end each
// lane is shifted once, the lanes are summed in uint32 (which wraps exactly
// like the TPU's int32 and sidesteps C++'s undefined signed left shift) and
// the epilogue writes (acc * x_scale) * w_scale once per output element.
//
// What bounds it on an H100: at decode (M = a few lanes) it reads every
// weight byte once for a handful of products, so weight bytes over memory
// bandwidth bound it; at prefill (M = 128) the plane products, n_x * n_w
// times the operations of a plain int8 GEMM, bound it.
//
// This first version is simple on purpose: tiles go from global memory into
// shared memory as int16 (whatever the operand type), the K loop runs inside
// the block, and planes are sliced in registers as the tiles are read from
// shared memory and packed four K values at a time for __dp4a.  Nothing
// carries across blocks.  wgmma, TMA and pipelining are later work.
//
// Plane counts above four per operand (exotic slice widths) run in windows
// of at most four planes: each window loops over K again and adds its
// shifted lanes into the same uint32 total.  Every spec with
// slice_bits <= 7 is served.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <int TM, int TN, int NXW, int NWW>
__global__ void __launch_bounds__(THREADS)
spoga_gemm_dequant_kernel(const void* __restrict__ x, int x_bytes,
                          const void* __restrict__ w, int w_bytes,
                          const float* __restrict__ xs,
                          const float* __restrict__ ws,
                          float* __restrict__ out,
                          int M, int K, int N, int nx, int nw, int bits) {
    constexpr int BM = 16 * TM;
    constexpr int BN = 16 * TN;
    constexpr int LANES = NXW + NWW - 1;
    __shared__ __align__(16) int16_t x_tile[BM][BK + PAD];
    __shared__ __align__(16) int16_t w_tile[BN][BK + PAD];  // transposed [n][k]

    const int tid = threadIdx.x;
    const int tx = tid % 16;  // along N
    const int ty = tid / 16;  // along M
    const int m0 = blockIdx.y * BM;
    const int n0 = blockIdx.x * BN;

    uint32_t total[TM][TN];
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
                    const int r = e / BK, c = e % BK;
                    const int gm = m0 + r, gk = k0 + c;
                    x_tile[r][c] = (gm < M && gk < K)
                        ? (int16_t)load_elem(x, x_bytes, (size_t)gm * K + gk) : (int16_t)0;
                }
                for (int e = tid; e < BK * BN; e += THREADS) {
                    const int r = e / BN, c = e % BN;
                    const int gk = k0 + r, gn = n0 + c;
                    w_tile[c][r] = (gk < K && gn < N)
                        ? (int16_t)load_elem(w, w_bytes, (size_t)gk * N + gn) : (int16_t)0;
                }
                __syncthreads();

#pragma unroll
                for (int g = 0; g < BK / 4; ++g) {
                    int xp[NXW][TM];
                    int wp[NWW][TN];
#pragma unroll
                    for (int i = 0; i < TM; ++i) {
                        const int16_t* v = &x_tile[ty + 16 * i][4 * g];
#pragma unroll
                        for (int p = 0; p < NXW; ++p) xp[p][i] = pack4(v, i0 + p, nx, bits);
                    }
#pragma unroll
                    for (int j = 0; j < TN; ++j) {
                        const int16_t* v = &w_tile[tx + 16 * j][4 * g];
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

    // dequantizing epilogue: one store per output, (acc * x_scale) * w_scale
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int m = m0 + ty + 16 * i;
        if (m >= M) continue;
        const float sx = xs[m];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int n = n0 + tx + 16 * j;
            if (n < N) {
                const float acc = static_cast<float>(static_cast<int32_t>(total[i][j]));
                out[(size_t)m * N + n] = (acc * sx) * ws[n];
            }
        }
    }
}

template <int TM, int TN, int NXW, int NWW>
void launch(const void* x, int xb, const void* w, int wb, const float* xs,
            const float* ws, float* out, int M, int K, int N, int nx, int nw,
            int bits, cudaStream_t stream) {
    dim3 grid((N + 16 * TN - 1) / (16 * TN), (M + 16 * TM - 1) / (16 * TM));
    spoga_gemm_dequant_kernel<TM, TN, NXW, NWW><<<grid, THREADS, 0, stream>>>(
        x, xb, w, wb, xs, ws, out, M, K, N, nx, nw, bits);
}

template <int TM, int TN, int NXW>
void dispatch_w(int nww, const void* x, int xb, const void* w, int wb,
                const float* xs, const float* ws, float* out, int M, int K,
                int N, int nx, int nw, int bits, cudaStream_t s) {
    switch (nww) {
        case 1: launch<TM, TN, NXW, 1>(x, xb, w, wb, xs, ws, out, M, K, N, nx, nw, bits, s); break;
        case 2: launch<TM, TN, NXW, 2>(x, xb, w, wb, xs, ws, out, M, K, N, nx, nw, bits, s); break;
        case 3: launch<TM, TN, NXW, 3>(x, xb, w, wb, xs, ws, out, M, K, N, nx, nw, bits, s); break;
        default: launch<TM, TN, NXW, 4>(x, xb, w, wb, xs, ws, out, M, K, N, nx, nw, bits, s); break;
    }
}

template <int TM, int TN>
void dispatch(int nxw, int nww, const void* x, int xb, const void* w, int wb,
              const float* xs, const float* ws, float* out, int M, int K,
              int N, int nx, int nw, int bits, cudaStream_t s) {
    switch (nxw) {
        case 1: dispatch_w<TM, TN, 1>(nww, x, xb, w, wb, xs, ws, out, M, K, N, nx, nw, bits, s); break;
        case 2: dispatch_w<TM, TN, 2>(nww, x, xb, w, wb, xs, ws, out, M, K, N, nx, nw, bits, s); break;
        case 3: dispatch_w<TM, TN, 3>(nww, x, xb, w, wb, xs, ws, out, M, K, N, nx, nw, bits, s); break;
        default: dispatch_w<TM, TN, 4>(nww, x, xb, w, wb, xs, ws, out, M, K, N, nx, nw, bits, s); break;
    }
}

}  // namespace

// C entry point.  x_bytes / w_bytes: 1 (int8) or 2 (int16).  All tensors
// contiguous; x_scale (M), w_scale (N), out (M, N).  Returns cudaGetLastError().
extern "C" int spoga_gemm_dequant_launch(
    const void* x, int x_bytes, const void* w, int w_bytes,
    const void* x_scale, const void* w_scale, void* out,
    int M, int K, int N, int n_x_slices, int n_w_slices, int slice_bits,
    void* stream) {
    if (M <= 0 || K <= 0 || N <= 0 || n_x_slices < 1 || n_w_slices < 1
        || slice_bits < 1 || slice_bits > 7
        || (x_bytes != 1 && x_bytes != 2) || (w_bytes != 1 && w_bytes != 2)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int nxw = n_x_slices < 4 ? n_x_slices : 4;
    const int nww = n_w_slices < 4 ? n_w_slices : 4;
    const float* xs = static_cast<const float*>(x_scale);
    const float* ws = static_cast<const float*>(w_scale);
    float* o = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (M <= 16) {
        dispatch<1, 2>(nxw, nww, x, x_bytes, w, w_bytes, xs, ws, o, M, K, N,
                       n_x_slices, n_w_slices, slice_bits, s);
    } else {
        dispatch<4, 4>(nxw, nww, x, x_bytes, w, w_bytes, xs, ws, o, M, K, N,
                       n_x_slices, n_w_slices, slice_bits, s);
    }
    return static_cast<int>(cudaGetLastError());
}
