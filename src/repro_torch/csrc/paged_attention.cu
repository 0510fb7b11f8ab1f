// Single-query flash decode attention over a paged KV pool, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py:paged_attention
// (Pallas body `_kernel`).
//
//   q        (B, Hkv, G, D)               bf16 | f32
//   kp, vp   (n_pages, page_size, Hkv, D) bf16 | int8
//   k_scale, v_scale (n_pages, page_size, Hkv) f32   (int8 pools only)
//   tables   (B, P) int32 physical page ids; lengths (B,) int32 valid rows
//   out      (B, Hkv, G, D) f32
//
// One block per (lane, kv head); its G query heads share every page it
// loads.  The block reads its page ids from `tables` and its length from
// `lengths` and walks only the first ceil(length / page_size) pages: a page
// past the length is fully masked, its exp terms are 0 and alpha is 1, so
// skipping it is exact.  Rows at or past `length` inside the last page get
// the score -1e30 (as the TPU kernel), so stale rows never leak.  The
// softmax is online, in f32: running max, denominator and value
// accumulator per query head; scores are scaled by 1/sqrt(D) and, for int8
// pools, by k_scale; probabilities are multiplied by v_scale before PV.
//
// What bounds it on an H100: the page bytes it reads (K and V rows up to
// each lane's length, plus scales) over memory bandwidth; its arithmetic is
// a few operations per byte.
//
// This first version is simple on purpose: each page is copied to shared
// memory as f32 by the whole block, one warp per query head scores up to 32
// rows at a time (one row per thread) and folds them into its accumulator.
// Vector loads, cp.async/TMA double buffering and splitting long contexts
// across blocks are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_D_PER_LANE = 8;   // head_dim <= 256
constexpr int MAX_G_PER_WARP = 4;   // query heads per warp
constexpr int MAX_WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
}

template <typename Q, typename KV, bool INT8>
__global__ void paged_attention_kernel(
    const Q* __restrict__ q, const KV* __restrict__ kp, const KV* __restrict__ vp,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ tables, const int* __restrict__ lengths,
    float* __restrict__ out, int Hkv, int G, int D, int ps, int P, float scale) {
    extern __shared__ float smem[];
    const int DS = D + 1;                  // padded row: no bank conflicts
    float* q_s = smem;                     // G * D
    float* k_s = q_s + G * D;              // ps * DS
    float* v_s = k_s + ps * DS;            // ps * DS
    float* ks_s = v_s + ps * DS;           // ps
    float* vs_s = ks_s + ps;               // ps

    const int b = blockIdx.x;
    const int h = blockIdx.y;
    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int n_warps = blockDim.x / 32;

    const size_t q_base = ((size_t)b * Hkv + h) * G * D;
    for (int e = tid; e < G * D; e += blockDim.x) q_s[e] = to_float(q[q_base + e]);

    const int length = lengths[b];
    int n_pg = (length + ps - 1) / ps;
    n_pg = n_pg < P ? n_pg : P;

    float m[MAX_G_PER_WARP], l[MAX_G_PER_WARP];
    float acc[MAX_G_PER_WARP][MAX_D_PER_LANE];
#pragma unroll
    for (int t = 0; t < MAX_G_PER_WARP; ++t) {
        m[t] = NEG_INF;
        l[t] = 0.f;
#pragma unroll
        for (int i = 0; i < MAX_D_PER_LANE; ++i) acc[t][i] = 0.f;
    }

    for (int pg = 0; pg < n_pg; ++pg) {
        const size_t page = static_cast<size_t>(tables[(size_t)b * P + pg]);
        __syncthreads();  // previous page fully consumed
        for (int e = tid; e < ps * D; e += blockDim.x) {
            const int r = e / D, d = e % D;
            const size_t off = ((page * ps + r) * Hkv + h) * D + d;
            k_s[r * DS + d] = to_float(kp[off]);
            v_s[r * DS + d] = to_float(vp[off]);
        }
        if (INT8) {
            for (int r = tid; r < ps; r += blockDim.x) {
                const size_t off = (page * ps + r) * Hkv + h;
                ks_s[r] = k_scale[off];
                vs_s[r] = v_scale[off];
            }
        }
        __syncthreads();

        const int base = pg * ps;
#pragma unroll
        for (int t = 0; t < MAX_G_PER_WARP; ++t) {
            const int g = warp + n_warps * t;
            if (g >= G) break;
            const float* qg = q_s + g * D;
            for (int r0 = 0; r0 < ps; r0 += 32) {
                const int r = r0 + lane;
                float s = NEG_INF;
                if (r < ps) {
                    float dot = 0.f;
                    for (int d = 0; d < D; ++d) dot += qg[d] * k_s[r * DS + d];
                    s = dot * scale;
                    if (INT8) s *= ks_s[r];
                    if (base + r >= length) s = NEG_INF;
                }
                const float m_new = fmaxf(m[t], warp_max(s));
                const float alpha = expf(m[t] - m_new);
                float p = r < ps ? expf(s - m_new) : 0.f;
                l[t] = alpha * l[t] + warp_sum(p);
                m[t] = m_new;
                if (INT8 && r < ps) p *= vs_s[r];
#pragma unroll
                for (int i = 0; i < MAX_D_PER_LANE; ++i) acc[t][i] *= alpha;
                const int rows = ps - r0 < 32 ? ps - r0 : 32;
                for (int rr = 0; rr < rows; ++rr) {
                    const float pr = __shfl_sync(FULL, p, rr);
                    const float* vrow = v_s + (r0 + rr) * DS;
#pragma unroll
                    for (int i = 0; i < MAX_D_PER_LANE; ++i) {
                        const int d = lane + 32 * i;
                        if (d < D) acc[t][i] += pr * vrow[d];
                    }
                }
            }
        }
    }

#pragma unroll
    for (int t = 0; t < MAX_G_PER_WARP; ++t) {
        const int g = warp + n_warps * t;
        if (g >= G) break;
#pragma unroll
        for (int i = 0; i < MAX_D_PER_LANE; ++i) {
            const int d = lane + 32 * i;
            if (d < D) out[q_base + (size_t)g * D + d] = acc[t][i] / l[t];
        }
    }
}

template <typename Q, typename KV, bool INT8>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const int* tables,
                   const int* lengths, float* out, int B, int Hkv, int G,
                   int D, int ps, int P, cudaStream_t stream) {
    const int warps = G < MAX_WARPS ? G : MAX_WARPS;
    const size_t smem = sizeof(float) * ((size_t)G * D + 2 * (size_t)ps * (D + 1) + 2 * (size_t)ps);
    auto kernel = paged_attention_kernel<Q, KV, INT8>;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    const float scale = static_cast<float>(pow((double)D, -0.5));
    kernel<<<dim3(B, Hkv), 32 * warps, smem, stream>>>(
        static_cast<const Q*>(q), static_cast<const KV*>(kp), static_cast<const KV*>(vp),
        static_cast<const float*>(ks), static_cast<const float*>(vs),
        tables, lengths, out, Hkv, G, D, ps, P, scale);
    return cudaGetLastError();
}

}  // namespace

// C entry point.  q_is_bf16: q dtype bf16 (else f32); kv_int8: int8 pools
// with k_scale / v_scale (else bf16 pools, scales NULL).  All tensors
// contiguous.  Returns cudaGetLastError().
extern "C" int paged_attention_launch(
    const void* q, int q_is_bf16, const void* kp, const void* vp, int kv_int8,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, void* out, int B, int Hkv, int G, int D,
    int page_size, int P, void* stream) {
    if (B <= 0 || Hkv <= 0 || G <= 0 || G > MAX_WARPS * MAX_G_PER_WARP
        || D <= 0 || D > 32 * MAX_D_PER_LANE || page_size <= 0 || P <= 0
        || (kv_int8 && (k_scale == nullptr || v_scale == nullptr))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int* t = static_cast<const int*>(tables);
    const int* len = static_cast<const int*>(lengths);
    float* o = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (q_is_bf16) {
        err = kv_int8
            ? launch<__nv_bfloat16, int8_t, true>(q, kp, vp, k_scale, v_scale, t, len, o, B, Hkv, G, D, page_size, P, s)
            : launch<__nv_bfloat16, __nv_bfloat16, false>(q, kp, vp, k_scale, v_scale, t, len, o, B, Hkv, G, D, page_size, P, s);
    } else {
        err = kv_int8
            ? launch<float, int8_t, true>(q, kp, vp, k_scale, v_scale, t, len, o, B, Hkv, G, D, page_size, P, s)
            : launch<float, __nv_bfloat16, false>(q, kp, vp, k_scale, v_scale, t, len, o, B, Hkv, G, D, page_size, P, s);
    }
    return static_cast<int>(err);
}
