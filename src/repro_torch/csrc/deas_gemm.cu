// The prior-work DEAS baseline (paper Fig. 2a), for Hopper: two kernels.
//
// Replaces the TPU kernels of src/repro/kernels/deas_gemm.py:deas_gemm:
//
//   nibble_gemm   <- `_nibble_gemm` (body `_nibble_gemm_kernel`): ONE INT4-plane
//                    GEMM, plane (M, K) int8 @ plane (K, N) int8 -> int32 (M, N),
//                    written to device memory.  The wrapper launches it four
//                    times (mm, ml, lm, ll) into four distinct buffers: one
//                    photonic core + its ADCs + its intermediate store each.
//   deas_combine  <- `_deas_combine` (body `_deas_combine_kernel`): the Digital
//                    Electronic Shifter-and-Adder, re-reading all four
//                    intermediates: out = (mm << 8) + ((ml + lm) << 4) + ll.
//
// Unfused on purpose: the 4 writes + 4 reads of (M, N) int32 intermediates
// (8 * M * N * 4 bytes) are the overhead class the SPOGA kernel removes, and
// the baseline exists to show it.  Do not fold the combine into the GEMMs.
//
// nibble_gemm is the sliced core of spoga_tile.cuh with one plane per
// operand (the planes are already int8 nibbles: the high one signed in
// [-8, 7], the low one unsigned in [0, 15]), so it multiplies on the int8
// tensor cores and stores int32 once per element.  deas_combine is
// elementwise; its shift-add runs in uint32, which wraps like the TPU's
// int32.
//
// What bounds them on an H100: each nibble_gemm reads its weight plane once
// (K * N bytes) and writes M * N * 4 bytes; at decode the weight planes'
// bytes bound it, and at prefill (M = 128) still the bytes: one plane
// product is 2 * M * K * N operations at the int8 rate.
// deas_combine moves 20 bytes per output element: memory bandwidth.

#include "spoga_tile.cuh"

namespace {

using namespace spoga_tile;

// one int8 plane per operand: lane 0 only, no shift
template <class C>
__global__ void __launch_bounds__(THREADS, 1)
nibble_gemm_kernel(Problem p, StoreInt32 epi) {
    extern __shared__ __align__(128) char smem[];
    gemm_block<C>(p, epi, smem);
}

struct NibbleLauncher {
    Problem p;
    StoreInt32 epi;
    cudaStream_t stream;
    mutable cudaError_t err;

    template <class C>
    void run() const { err = launch<C, nibble_gemm_kernel<C>>(p, epi, stream); }
};

constexpr int COMBINE_THREADS = 256;

__global__ void __launch_bounds__(COMBINE_THREADS)
deas_combine_kernel(const int32_t* __restrict__ mm, const int32_t* __restrict__ ml,
                    const int32_t* __restrict__ lm, const int32_t* __restrict__ ll,
                    int32_t* __restrict__ out, size_t count) {
    const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
    for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
         i += stride) {
        const uint32_t hi = static_cast<uint32_t>(mm[i]);
        const uint32_t mid = static_cast<uint32_t>(ml[i]) + static_cast<uint32_t>(lm[i]);
        const uint32_t lo = static_cast<uint32_t>(ll[i]);
        out[i] = static_cast<int32_t>((hi << 8) + (mid << 4) + lo);
    }
}

}  // namespace

// C entry point: one nibble-plane GEMM.  a (M, K) int8, b (K, N) int8,
// out (M, N) int32, all contiguous.  Returns cudaGetLastError().
extern "C" int nibble_gemm_launch(const void* a, const void* b, void* out,
                                  int M, int K, int N, void* stream) {
    if (M <= 0 || K <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const NibbleLauncher launcher{spoga_tile::make_problem(a, 1, b, 1, M, K, N, 1, 1, 4),
                                  StoreInt32{static_cast<int32_t*>(out), N},
                                  static_cast<cudaStream_t>(stream), cudaSuccess};
    spoga_tile::dispatch_fixed<1, 1>(launcher, M);
    if (launcher.err != cudaSuccess) return static_cast<int>(launcher.err);
    return static_cast<int>(cudaGetLastError());
}

// C entry point: the DEAS shift-add over four int32 (M, N) intermediates
// into out (M, N) int32, all contiguous.  Returns cudaGetLastError().
extern "C" int deas_combine_launch(const void* mm, const void* ml, const void* lm,
                                   const void* ll, void* out, int M, int N, void* stream) {
    if (M <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
    int sms = 0;
    const cudaError_t err = spoga_tile::sm_count(&sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t count = static_cast<size_t>(M) * N;
    const size_t want = (count + COMBINE_THREADS - 1) / COMBINE_THREADS;
    const size_t max_blocks = static_cast<size_t>(sms) * 32;  // 32 per SM, grid-stride beyond
    const unsigned blocks = static_cast<unsigned>(want < max_blocks ? want : max_blocks);
    deas_combine_kernel<<<blocks, COMBINE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(mm), static_cast<const int32_t*>(ml),
        static_cast<const int32_t*>(lm), static_cast<const int32_t*>(ll),
        static_cast<int32_t*>(out), count);
    return static_cast<int>(cudaGetLastError());
}
