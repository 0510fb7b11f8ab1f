// SPOGA fused bit-sliced integer GEMM with dequantizing epilogue, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/spoga_gemm_dequant.py:spoga_gemm_dequant
// (Pallas body `_kernel`, with `_slice_planes_tile` and `_radix_accumulate`
// from src/repro/kernels/spoga_gemm.py).
//
//   out (M, N) f32 = (x (M, K) int8|int16  @  w (K, N) int8|int16)
//                    * x_scale (M, 1) f32 * w_scale (1, N) f32
//
// The sliced radix product is the shared core in spoga_tile.cuh (dp4a
// plane products, one int32 accumulator per radix lane, the shift-add in
// uint32); this kernel adds the epilogue: (acc * x_scale) * w_scale, one
// store per output element, so no (M, N) int32 intermediate reaches memory.
//
// What bounds it on an H100: the function is one integer product, 2*M*K*N
// operations at the int8 rate (the plane pairs are how this kernel computes
// it, not what the function needs), against each operand read once and the
// output written once; at the main path's shapes (M up to 128) the weight
// bytes over memory bandwidth bound it.  Every spec with slice_bits <= 7 is
// served.

#include "spoga_tile.cuh"

namespace {

using namespace spoga_tile;

template <int TM, int TN, int NXW, int NWW>
__global__ void __launch_bounds__(THREADS)
spoga_gemm_dequant_kernel(const void* __restrict__ x, int x_bytes,
                          const void* __restrict__ w, int w_bytes,
                          const float* __restrict__ xs,
                          const float* __restrict__ ws,
                          float* __restrict__ out,
                          int M, int K, int N, int nx, int nw, int bits) {
    __shared__ Smem<TM, TN> smem;
    uint32_t total[TM][TN];
    radix_accumulate<TM, TN, NXW, NWW>(x, x_bytes, w, w_bytes, M, K, N, nx, nw, bits,
                                       smem, total);

    // dequantizing epilogue: one store per output, (acc * x_scale) * w_scale
    const TileCoords c = tile_coords<TM, TN>();
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int m = c.m0 + c.ty + 16 * i;
        if (m >= M) continue;
        const float sx = xs[m];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int n = c.n0 + c.tx + 16 * j;
            if (n < N) {
                const float acc = static_cast<float>(static_cast<int32_t>(total[i][j]));
                out[(size_t)m * N + n] = (acc * sx) * ws[n];
            }
        }
    }
}

struct Launcher {
    const void* x;
    int xb;
    const void* w;
    int wb;
    const float* xs;
    const float* ws;
    float* out;
    int M, K, N, nx, nw, bits;
    cudaStream_t stream;

    template <int TM, int TN, int NXW, int NWW>
    void run() const {
        const dim3 grid = grid_for<TM, TN>(M, N);
        spoga_gemm_dequant_kernel<TM, TN, NXW, NWW>
            <<<grid, THREADS, 0, stream>>>(
                x, xb, w, wb, xs, ws, out, M, K, N, nx, nw, bits);
    }
};

}  // namespace

// C entry point.  x_bytes / w_bytes: 1 (int8) or 2 (int16).  All tensors
// contiguous; x_scale (M), w_scale (N), out (M, N).  Returns cudaGetLastError().
extern "C" int spoga_gemm_dequant_launch(
    const void* x, int x_bytes, const void* w, int w_bytes,
    const void* x_scale, const void* w_scale, void* out,
    int M, int K, int N, int n_x_slices, int n_w_slices, int slice_bits,
    void* stream) {
    if (!spoga_tile::valid_spoga_args(M, K, N, x_bytes, w_bytes, n_x_slices, n_w_slices, slice_bits)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Launcher launcher{x, x_bytes, w, w_bytes, static_cast<const float*>(x_scale),
                            static_cast<const float*>(w_scale), static_cast<float*>(out),
                            M, K, N, n_x_slices, n_w_slices, slice_bits,
                            static_cast<cudaStream_t>(stream)};
    spoga_tile::dispatch(launcher, M, n_x_slices, n_w_slices);
    return static_cast<int>(cudaGetLastError());
}
