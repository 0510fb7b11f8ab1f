// SPOGA fused bit-sliced integer GEMM with dequantizing epilogue, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/spoga_gemm_dequant.py:spoga_gemm_dequant
// (Pallas body `_kernel`, with `_slice_planes_tile` and `_radix_accumulate`
// from src/repro/kernels/spoga_gemm.py).
//
//   out (M, N) f32 = (x (M, K) int8|int16  @  w (K, N) int8|int16)
//                    * x_scale (M, 1) f32 * w_scale (1, N) f32
//
// The sliced radix product is the shared core in spoga_tile.cuh (int8
// tensor-core plane products, one s32 accumulator fragment per radix lane,
// the shift-add in uint32, K split across a cluster and reduced on chip);
// this kernel adds the epilogue: (acc * x_scale) * w_scale, one store per
// output element, so no (M, N) int32 intermediate reaches memory.
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

// dequantizing epilogue: one store per output, (acc * x_scale) * w_scale
struct DequantStore {
    const float* xs;
    const float* ws;
    float* out;
    int N;
    __device__ __forceinline__ void operator()(int m, int n, uint4 v, int count) const {
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
        const float sx = xs[m];
        float r[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < 4; ++i)
            if (i < count) r[i] = (static_cast<float>(static_cast<int32_t>(w[i])) * sx) * ws[n + i];
        float* o = out + (size_t)m * N + n;
        if (count == 4 && (N & 3) == 0) {
            *reinterpret_cast<float4*>(o) = make_float4(r[0], r[1], r[2], r[3]);
            return;
        }
        for (int i = 0; i < count; ++i) o[i] = r[i];
    }
};

template <class C>
__global__ void __launch_bounds__(THREADS, 1)
spoga_gemm_dequant_kernel(Problem p, DequantStore epi) {
    extern __shared__ __align__(128) char smem[];
    gemm_block<C>(p, epi, smem);
}

struct Launcher {
    Problem p;
    DequantStore epi;
    cudaStream_t stream;
    mutable cudaError_t err;

    template <class C>
    void run() const { err = launch<C, spoga_gemm_dequant_kernel<C>>(p, epi, stream); }
};

}  // namespace

// C entry point.  x_bytes / w_bytes: 1 (int8) or 2 (int16).  All tensors
// contiguous; x_scale (M), w_scale (N), out (M, N).  Returns the launch's
// cudaError_t.
extern "C" int spoga_gemm_dequant_launch(
    const void* x, int x_bytes, const void* w, int w_bytes,
    const void* x_scale, const void* w_scale, void* out,
    int M, int K, int N, int n_x_slices, int n_w_slices, int slice_bits,
    void* stream) {
    if (!spoga_tile::valid_spoga_args(M, K, N, x_bytes, w_bytes, n_x_slices, n_w_slices, slice_bits)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Launcher launcher{
        spoga_tile::make_problem(x, x_bytes, w, w_bytes, M, K, N, n_x_slices, n_w_slices,
                                 slice_bits),
        DequantStore{static_cast<const float*>(x_scale), static_cast<const float*>(w_scale),
                     static_cast<float*>(out), N},
        static_cast<cudaStream_t>(stream), cudaSuccess};
    spoga_tile::dispatch(launcher, M, x_bytes, w_bytes, n_x_slices, n_w_slices);
    if (launcher.err != cudaSuccess) return static_cast<int>(launcher.err);
    return static_cast<int>(cudaGetLastError());
}
