// SPOGA fused bit-sliced integer GEMM, int32 out, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/spoga_gemm.py:spoga_gemm
// (Pallas body `spoga_gemm_kernel`, with `_slice_planes_tile` and
// `_radix_accumulate`).
//
//   out (M, N) int32 = x (M, K) int8|int16  @  w (K, N) int8|int16   (mod 2^32)
//
// The same arithmetic as spoga_gemm_dequant.cu without the epilogue: every
// plane pair is an int8 tensor-core product, partials are grouped into i + j
// radix lanes, each lane is shifted once, the shift-add runs in uint32 and
// each output element is stored once (the core is spoga_tile.cuh).  This is
// the `gemm` half of the SPOGA backends (`cuda_spoga`, `cuda_spoga_dequant`),
// behind `backends/pipeline.gemm_int` and `kernels/ops.int8_gemm`.
//
// What bounds it on an H100: the function is one integer product, 2*M*K*N
// operations at the int8 rate however many plane pairs the kernel
// multiplies, against each operand read once and the output written once.
// At the main path's shapes (M up to 128, K >= 2048) the bytes, mostly the
// weights', bound it.  Its (M, N) int32 output is 4 bytes per element,
// where the dequant kernel writes f32: the same bytes.

#include "spoga_tile.cuh"

namespace {

using namespace spoga_tile;


template <class C>
__global__ void __launch_bounds__(THREADS, 1)
spoga_gemm_kernel(Problem p, StoreInt32 epi) {
    extern __shared__ __align__(128) char smem[];
    gemm_block<C>(p, epi, smem);
}

struct Launcher {
    Problem p;
    StoreInt32 epi;
    cudaStream_t stream;
    mutable cudaError_t err;

    template <class C>
    void run() const { err = launch<C, spoga_gemm_kernel<C>>(p, epi, stream); }
};

}  // namespace

// C entry point.  x_bytes / w_bytes: 1 (int8) or 2 (int16).  All tensors
// contiguous; out (M, N) int32.  Returns the launch's cudaError_t.
extern "C" int spoga_gemm_launch(
    const void* x, int x_bytes, const void* w, int w_bytes, void* out,
    int M, int K, int N, int n_x_slices, int n_w_slices, int slice_bits,
    void* stream) {
    if (!spoga_tile::valid_spoga_args(M, K, N, x_bytes, w_bytes, n_x_slices, n_w_slices, slice_bits)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Launcher launcher{
        spoga_tile::make_problem(x, x_bytes, w, w_bytes, M, K, N, n_x_slices, n_w_slices,
                                 slice_bits),
        StoreInt32{static_cast<int32_t*>(out), N}, static_cast<cudaStream_t>(stream),
        cudaSuccess};
    spoga_tile::dispatch(launcher, M, x_bytes, w_bytes, n_x_slices, n_w_slices);
    if (launcher.err != cudaSuccess) return static_cast<int>(launcher.err);
    return static_cast<int>(cudaGetLastError());
}
