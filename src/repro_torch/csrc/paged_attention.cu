// Single-query flash decode attention over a paged KV pool, for Hopper (sm_90a).
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
// What it computes, as the TPU kernel: the G query heads of one KV head
// attend to that head's rows below lengths[b]; scores are scaled by
// 1/sqrt(D) and, for int8 pools, by k_scale; the softmax is online, in f32;
// probabilities are multiplied by v_scale before PV.  Rows at or past the
// length never reach a sum: they are not even loaded.
//
// What bounds it on an H100: the bytes of the K and V rows (and scales) up
// to each lane's length, read once, over memory bandwidth; at G = 4 there
// are 4 to 8 operations per byte.  A call at a short context is a few
// microseconds of latency; at thousands of tokens the rows' bytes should
// set the time, and the per-row work competes with them for issue slots.
// What the design does:
//
// * The page axis is split.  The grid is (S splits x B*Hkv, head groups);
//   the S blocks of one (lane, kv head) form a thread-block cluster of at
//   most 8 (portable size).  Split r takes the pages r, r + S, r + 2S, ...
//   of the table, so every split of a lane gets an equal share of its pages
//   whatever the length.  S comes from P and the SM count on the host,
//   never from `lengths` (they live on the device).  A split whose pages
//   all lie past the length loads no K or V and contributes m = -1e30,
//   l = 0.
// * The splits meet in distributed shared memory: every block arrives at
//   the cluster barrier on entry and waits on it (every block of the
//   cluster has started) only before it stores its (m, l, acc) into its own
//   slot of rank 0's shared memory; one more barrier later rank 0 combines
//   the slots in rank order and stores the output.  A call is one launch with one store per output element, no
//   scratch in device memory, and the same result on every run.
// * Inside a block 4 warps take the split's pages in turn; the page ids
//   are read once into shared memory first.  K and V rows (and scales)
//   stream into shared memory through a per-warp ring with 16-byte cp.async
//   copies, so the next rows are in flight while the oldest are scored.
//   Row groups, then warps (through shared memory), then splits combine
//   once, at the end, in a fixed order.
//
// Two kernels share that frame:
//
// * paged_attention_kernel_mma, for D of 64 or 128, at most 8 query heads
//   and 16-byte aligned rows (the main path): a warp takes its rows 16 at
//   a time; QK^T and PV run on the tensor cores (bf16 mma.sync, f32 sums),
//   the block's heads as the rows of the QK^T tile and D as the rows of the
//   PV tile (O^T = V^T P^T), so that the probabilities feed PV from the
//   registers that hold the scores.  int8 values are exact in bf16; q and
//   the probabilities are f32 and go in as three bf16 parts each (24 bits),
//   so the sums keep f32 accuracy.
// * paged_attention_kernel, every other shape the kernel accepts, on the
//   CUDA cores: L lanes hold one row as 16-byte chunks (int8 at D=64: 4
//   lanes, bf16: 8) and reduce their partial dot products with log2(L)
//   shuffles; q for the block's heads (at most 4) sits in registers as f32;
//   every row group runs its own online softmax (exp2 of scores pre-scaled
//   by log2 e, the accumulator rescaled only when its max grows) and PV
//   accumulates in registers, each lane owning a slice of D.  G > 4 splits
//   the heads across blocks, which then each read the pages.  Rows that
//   are not 16-byte aligned (D * element size not a multiple of 16, or an
//   offset pool) take element loads.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int DEPTH = 8;          // passes in flight per warp (CUDA-core kernel)
constexpr int MAX_CLUSTER = 8;    // portable cluster size
constexpr int CGT = 4;            // query heads of a CUDA-core block
constexpr int MAX_G = 32;
constexpr int MAX_D = 256;
constexpr int WAVES = 8;          // blocks aimed for, in multiples of the SM count
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// Raw element type and elements per 16-byte chunk of each pool type.
template <bool INT8> struct Pool;
template <> struct Pool<true> { using Raw = uint8_t; static constexpr int EL = 16; };
template <> struct Pool<false> { using Raw = uint16_t; static constexpr int EL = 8; };

template <bool INT8>
union Chunk {
    uint4 u;
    typename Pool<INT8>::Raw r[Pool<INT8>::EL];
};

// 16 int8 or 8 bf16 values -> f32.  int8: the biased byte is placed in the
// mantissa of 2^23 with one prmt and the bias taken off with one add
// (exact), instead of the slow integer conversion.
template <bool INT8>
__device__ __forceinline__ void widen(const uint4& u, float (&f)[Pool<INT8>::EL]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        if constexpr (INT8) {
            const uint32_t x = w[i] ^ 0x80808080u;
#pragma unroll
            for (int j = 0; j < 4; ++j)
                f[4 * i + j] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540u + j))
                               - 8388736.f;
        } else {
            f[2 * i] = __uint_as_float(w[i] << 16);
            f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
    }
}

struct Params {
    const void* q;
    const void* kp;
    const void* vp;
    const float* ks;
    const float* vs;
    const int* tables;
    const int* lengths;
    float* out;
    int q_bf16, Hkv, G, D, ps, P;
    int S;          // splits of the table = cluster size
    int per;        // pages per split
    int L;          // lanes per row (power of two)
    float scale2;   // log2(e) / sqrt(D)
    float inv_ps;   // 1 / page size
};

// Shared memory of a CUDA-core block, in bytes: the pass ring, page ids,
// the warps' partials and one slot per split.
inline size_t smem_bytes(bool int8, int per, int splits, int D) {
    const size_t slot = 2 * sizeof(uint4) + (int8 ? 2 * sizeof(float) : 0);
    const size_t ring = (size_t)DEPTH * THREADS * slot;
    return ring + sizeof(float) * ((size_t)per + (size_t)(WARPS + splits) * CGT * (D + 2));
}

__device__ __forceinline__ float fast_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// A copy of BYTES (16 or 4) that fills zeros and reads nothing when !ok.
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src, bool ok) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if constexpr (BYTES == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(s), "l"(src), "r"(ok ? 16 : 0));
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(s), "l"(src), "r"(ok ? 4 : 0));
    }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The cluster barrier, two phases: every block arrives (relaxed) on entry,
// and waits for that phase before it touches rank 0's shared memory, since
// distributed shared memory may be accessed only once every block of the
// cluster has started; every block arrives again after storing its slot,
// and rank 0 waits for that before it reads the slots.
__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A split whose pages all lie past the length (never rank 0, which holds
// the first page) loads nothing: it completes both phases of the cluster
// barrier and leaves.  Returns whether it left.
__device__ __forceinline__ bool leave_if_empty(int nv, int rank) {
    if (nv > 0 || rank == 0) return false;
    cluster_wait();
    cluster_arrive();
    return true;
}

// The warps' (m, l, acc) in red_* -> the block's, in warp order, stored
// into this split's slot of rank 0's shared memory (distributed shared
// memory) once the entry phase of the cluster barrier is complete; after
// the second phase rank 0 combines the slots of the n_splits splits that
// hold pages, in rank order, and stores the output, one store per
// element.  A split without pages stores nothing (see `leave_if_empty`).
template <int GT>
__device__ __forceinline__ void combine_and_store(
    const Params& p, const float* red_m, const float* red_l, const float* red_acc,
    float* push_m, float* push_l, float* push_acc, int rank, int bh, int g0, int n_splits) {
    const int tid = threadIdx.x;
    __syncthreads();
    cluster_wait();   // every block of the cluster has started
    cg::cluster_group cluster = cg::this_cluster();
    float* pm = cluster.map_shared_rank(push_m, 0) + rank * GT;
    float* pl = cluster.map_shared_rank(push_l, 0) + rank * GT;
    float* pacc = cluster.map_shared_rank(push_acc, 0) + rank * GT * p.D;
    for (int e = tid; e < GT * p.D; e += THREADS) {
        const int g = e / p.D, d = e % p.D;
        float mx = NEG_INF;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, red_m[w * GT + g]);
        float a = 0.f, s = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            const float f = fast_exp2(red_m[w * GT + g] - mx);
            a += red_acc[(w * GT + g) * p.D + d] * f;
            s += red_l[w * GT + g] * f;
        }
        pacc[e] = a;
        if (d == 0) {
            pm[g] = mx;
            pl[g] = s;
        }
    }
    cluster_arrive();
    if (rank != 0) return;
    cluster_wait();   // every split's slot is filled

    const size_t q_base = (size_t)bh * p.G * p.D;
    for (int e = tid; e < GT * p.D; e += THREADS) {
        const int g = e / p.D, d = e % p.D;
        if (g0 + g >= p.G) continue;
        float mx = NEG_INF;
        for (int r = 0; r < n_splits; ++r) mx = fmaxf(mx, push_m[r * GT + g]);
        float a = 0.f, s = 0.f;
        for (int r = 0; r < n_splits; ++r) {
            const float f = fast_exp2(push_m[r * GT + g] - mx);
            a += push_acc[(r * GT + g) * p.D + d] * f;
            s += push_l[r * GT + g] * f;
        }
        p.out[q_base + (size_t)(g0 + g) * p.D + d] = a / s;
    }
}

// int8 pools with 4 heads hold 64 q and 64 accumulator floats a thread: at
// three blocks an SM (168 registers, a few spilled) the long-context walk is
// faster than at two.
template <bool INT8, bool VEC>
__global__ void __launch_bounds__(THREADS, INT8 ? 3 : 1)
paged_attention_kernel(const Params p) {
    using Raw = typename Pool<INT8>::Raw;
    constexpr int EL = Pool<INT8>::EL;
    constexpr int GT = CGT;
    extern __shared__ uint4 smem[];
    // ring of DEPTH passes, each thread its own slot: K and V chunks (and scales)
    uint4* kring = smem;                                                  // DEPTH * THREADS
    uint4* vring = kring + DEPTH * THREADS;                               // DEPTH * THREADS
    float* ksr = reinterpret_cast<float*>(vring + DEPTH * THREADS);      // DEPTH * THREADS
    float* vsr = ksr + (INT8 ? DEPTH * THREADS : 0);                      // DEPTH * THREADS
    int* ids = reinterpret_cast<int*>(vsr + (INT8 ? DEPTH * THREADS : 0));   // per
    float* red_m = reinterpret_cast<float*>(ids + p.per);                // WARPS * GT
    float* red_l = red_m + WARPS * GT;                                    // WARPS * GT
    float* red_acc = red_l + WARPS * GT;                                  // WARPS * GT * D
    // each split's (m, l, acc), filled in rank 0's copy by every block of the cluster
    float* push_m = red_acc + WARPS * GT * p.D;                           // S * GT
    float* push_l = push_m + p.S * GT;                                    // S * GT
    float* push_acc = push_l + p.S * GT;                                  // S * GT * D

    const int rank = blockIdx.x % p.S;
    const int bh = blockIdx.x / p.S;
    const int b = bh / p.Hkv, h = bh % p.Hkv;
    const int g0 = blockIdx.y * GT;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int L = p.L, RW = 32 / L;                 // lanes per row, rows per pass
    const int lr = lane & (L - 1), rg = lane / L;   // lane in its row, row in the pass
    const int d0 = lr * EL;
    cluster_arrive_relaxed();

    // lanes past D feed zeros to the dot products (their q is 0 too)
    if (d0 >= p.D) {
        for (int i = 0; i < DEPTH; ++i)
            kring[i * THREADS + tid] = vring[i * THREADS + tid] = make_uint4(0u, 0u, 0u, 0u);
    }
    // the split's pages: rank, rank + S, ... below the length and the table's end
    const int length = __ldg(p.lengths + b);
    const int n_valid = min(p.P, (length + p.ps - 1) / p.ps);
    const int nv = n_valid > rank ? (n_valid - rank + p.S - 1) / p.S : 0;
    if (leave_if_empty(nv, rank)) return;
    for (int i = tid; i < nv; i += THREADS)
        ids[i] = __ldg(p.tables + (size_t)b * p.P + rank + (size_t)p.S * i);

    __syncthreads();

    float m[GT], l[GT], acc[GT][EL];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
        m[g] = NEG_INF;
        l[g] = 0.f;
#pragma unroll
        for (int e = 0; e < EL; ++e) acc[g][e] = 0.f;
    }

    // this warp's pages of the split: warp, warp + WARPS, ... of its list
    const int my_pages = nv > warp ? (nv - warp + WARPS - 1) / WARPS : 0;
    const int n_pass = my_pages * ((p.ps + RW - 1) / RW);

    // A pass: RW rows of one page, row group rg taking row `row + rg`.
    // Returns whether this lane's row is below the length.
    auto pass_row = [&](int k, int row, size_t* pool_row) {
        const int i = warp + k * WARPS;
        const int r = row + rg;
        const bool ok = i < nv && r < p.ps && (rank + p.S * i) * p.ps + r < length;
        if (ok) *pool_row = ((size_t)ids[i] * p.ps + r) * p.Hkv + h;
        return ok;
    };

    int lk = 0, lrow = 0;  // load stream: the warp's k-th page, first row of the pass
    auto issue = [&](int t) {
        const int slot = (t % DEPTH) * THREADS + tid;
        size_t row = 0;
        const bool ok = pass_row(lk, lrow, &row);
        const Raw* kr = static_cast<const Raw*>(p.kp) + row * p.D + d0;
        const Raw* vr = static_cast<const Raw*>(p.vp) + row * p.D + d0;
        if constexpr (VEC) {
            if (ok && d0 < p.D) {
                cp_async_zfill<16>(kring + slot, kr, true);
                cp_async_zfill<16>(vring + slot, vr, true);
            }
        } else {
            Chunk<INT8> ck, cv;
            ck.u = make_uint4(0u, 0u, 0u, 0u);
            cv.u = ck.u;
#pragma unroll
            for (int e = 0; e < EL; ++e) {
                if (ok && d0 + e < p.D) {
                    ck.r[e] = kr[e];
                    cv.r[e] = vr[e];
                }
            }
            kring[slot] = ck.u;
            vring[slot] = cv.u;
        }
        if (INT8 && ok) {
            cp_async_zfill<4>(ksr + slot, p.ks + row, true);
            cp_async_zfill<4>(vsr + slot, p.vs + row, true);
        }
        cp_async_commit();
        lrow += RW;
        if (lrow >= p.ps) {
            lrow = 0;
            ++lk;
        }
    };

#pragma unroll
    for (int i = 0; i < DEPTH - 1; ++i) issue(i);

    // q, while the first passes are in flight
    float q[GT][EL];
    const size_t q_base = (size_t)bh * p.G * p.D;
#pragma unroll
    for (int g = 0; g < GT; ++g) {
#pragma unroll
        for (int e = 0; e < EL; ++e) {
            const int d = d0 + e;
            float v = 0.f;
            if (g0 + g < p.G && d < p.D) {
                const size_t i = q_base + (size_t)(g0 + g) * p.D + d;
                v = p.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.q)[i])
                             : static_cast<const float*>(p.q)[i];
            }
            q[g][e] = v;
        }
    }
    int ck = 0, crow = 0;  // consume stream
    for (int t = 0; t < n_pass; ++t) {
        issue(t + DEPTH - 1);
        cp_async_wait<DEPTH - 1>();
        const int slot = (t % DEPTH) * THREADS + tid;
        size_t unused = 0;
        const bool val = pass_row(ck, crow, &unused);
        crow += RW;
        if (crow >= p.ps) {
            crow = 0;
            ++ck;
        }
        float kf[EL], vf[EL];
        widen<INT8>(kring[slot], kf);
        widen<INT8>(vring[slot], vf);
        float sk = p.scale2, pv = 1.f;
        if constexpr (INT8) {
            sk *= ksr[slot];
            pv = vsr[slot];
        }
        float part[GT];
#pragma unroll
        for (int g = 0; g < GT; ++g) {
            float s = 0.f;
#pragma unroll
            for (int e = 0; e < EL; ++e) s = fmaf(q[g][e], kf[e], s);
            part[g] = s;
        }
        for (int o = 1; o < L; o <<= 1) {
#pragma unroll
            for (int g = 0; g < GT; ++g) part[g] += __shfl_xor_sync(FULL, part[g], o);
        }
        if (val) {
#pragma unroll
            for (int g = 0; g < GT; ++g) {
                const float s = part[g] * sk;
                if (s > m[g]) {
                    const float a = fast_exp2(m[g] - s);
                    l[g] *= a;
#pragma unroll
                    for (int e = 0; e < EL; ++e) acc[g][e] *= a;
                    m[g] = s;
                }
                const float pr = fast_exp2(s - m[g]);
                l[g] += pr;
                const float w = INT8 ? pr * pv : pr;
#pragma unroll
                for (int e = 0; e < EL; ++e) acc[g][e] = fmaf(w, vf[e], acc[g][e]);
            }
        }
    }
    cp_async_wait<0>();

    // row groups of the warp -> row group 0, in a fixed butterfly order
    for (int o = L; o < 32; o <<= 1) {
#pragma unroll
        for (int g = 0; g < GT; ++g) {
            const float mo = __shfl_xor_sync(FULL, m[g], o);
            const float lo = __shfl_xor_sync(FULL, l[g], o);
            const float mx = fmaxf(m[g], mo);
            const float a = fast_exp2(m[g] - mx), c = fast_exp2(mo - mx);
            l[g] = l[g] * a + lo * c;
#pragma unroll
            for (int e = 0; e < EL; ++e)
                acc[g][e] = acc[g][e] * a + __shfl_xor_sync(FULL, acc[g][e], o) * c;
            m[g] = mx;
        }
    }
    if (rg == 0) {
#pragma unroll
        for (int g = 0; g < GT; ++g) {
#pragma unroll
            for (int e = 0; e < EL; ++e)
                if (d0 + e < p.D) red_acc[(warp * GT + g) * p.D + d0 + e] = acc[g][e];
            if (lr == 0) {
                red_m[warp * GT + g] = m[g];
                red_l[warp * GT + g] = l[g];
            }
        }
    }
    combine_and_store<GT>(p, red_m, red_l, red_acc, push_m, push_l, push_acc, rank, bh, g0,
                          min(p.S, n_valid));
}

// ---------------------------------------------------------------------------
// The tensor-core kernel: D of 64 or 128, at most 8 query heads, 16-byte
// aligned rows.  A warp takes its rows 16 at a time (a tile): QK^T runs as
// bf16 mma.sync m16n8k16 with the block's query heads as the first 8 of
// the 16 rows of A, PV as O^T = V^T P^T with D as the rows; sums in f32.
// bf16 carries int8 values exactly; an f32 operand (q, and the
// probabilities times v_scale) is split into three bf16 parts whose sum is
// it to 24 bits, one product each, so the sums keep f32 accuracy.
// ---------------------------------------------------------------------------

constexpr int MGT = 8;  // query heads of a tensor-core block

template <bool INT8, int DK>
struct MmaTile {
    static constexpr int E = INT8 ? 1 : 2;           // bytes per element
    static constexpr int KT = DK / 16;               // k-steps of QK^T
    static constexpr int MT = DK / 16;               // m-tiles of PV (D as the 16 rows)
    static constexpr int CPR = DK * E / 16;          // 16-byte chunks per row
    // row strides in shared memory, bytes, chosen so that the fragment
    // reads are free of bank conflicts (bf16 tiles use an XOR swizzle)
    static constexpr int KS = INT8 ? (DK == 64 ? 64 : DK + 16) : 2 * DK;
    static constexpr int VS = INT8 ? DK + 16 : 2 * DK;
    static constexpr int STAGE = 16 * KS + 16 * VS + (INT8 ? 2 * 16 * 4 : 0);
    static constexpr int DEPTH = 12288 / STAGE >= 4 ? 4 : 12288 / STAGE >= 3 ? 3 : 2;
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) -> three bf16x2 words whose sum is (x, y) to 24 bits
__device__ __forceinline__ void split3(float x, float y, uint32_t (&o)[3]) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        o[i] = pack_bf16(x, y);
        x -= __uint_as_float(o[i] << 16);
        y -= __uint_as_float(o[i] & 0xffff0000u);
    }
}

// The int8 in the low byte of each 16-bit half of v -> bf16x2, exactly:
// (128 + low 7 bits) - (128 + 128 * sign bit), both exact in bf16.
__device__ __forceinline__ uint32_t i8x2_bf16x2(uint32_t v) {
    const uint32_t a = (v & 0x007f007fu) | 0x43004300u;
    const uint32_t b = (v & 0x00800080u) | 0x43004300u;
    uint32_t d;
    asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
}

template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* ptr) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
    if constexpr (TRANS) {
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                     : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
    } else {
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                     : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
    }
}

// Shared memory of a tensor-core block, in bytes: the warps' tile rings
// (each warp's ring holds its partials after its walk), page ids, one slot
// per split.
template <bool INT8, int DK>
size_t smem_bytes_mma(int per, int splits) {
    using T = MmaTile<INT8, DK>;
    return (size_t)WARPS * T::DEPTH * T::STAGE
        + sizeof(float) * ((size_t)per + (size_t)splits * MGT * (DK + 2));
}

template <bool INT8, int DK>
__global__ void __launch_bounds__(THREADS) paged_attention_kernel_mma(const Params p) {
    using T = MmaTile<INT8, DK>;
    extern __shared__ uint4 smem[];
    uint8_t* ring = reinterpret_cast<uint8_t*>(smem);                       // WARPS * DEPTH * STAGE
    int* ids = reinterpret_cast<int*>(ring + WARPS * T::DEPTH * T::STAGE);  // per
    float* push_m = reinterpret_cast<float*>(ids + p.per);                  // S * MGT
    float* push_l = push_m + p.S * MGT;                                     // S * MGT
    float* push_acc = push_l + p.S * MGT;                                   // S * MGT * D

    const int rank = blockIdx.x % p.S;
    const int bh = blockIdx.x / p.S;
    const int b = bh / p.Hkv, h = bh % p.Hkv;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gq = lane >> 2, j = lane & 3;   // fragment row (query head), column pair
    cluster_arrive_relaxed();

    const int length = __ldg(p.lengths + b);
    const int n_valid = min(p.P, (length + p.ps - 1) / p.ps);
    const int nv = n_valid > rank ? (n_valid - rank + p.S - 1) / p.S : 0;
    if (leave_if_empty(nv, rank)) return;
    for (int i = tid; i < nv; i += THREADS)
        ids[i] = __ldg(p.tables + (size_t)b * p.P + rank + (size_t)p.S * i);
    __syncthreads();

    // this warp's rows: the rows of its pages warp, warp + WARPS, ... of the
    // split's list, in order; the first nvr are below the length
    const int my_pages = nv > warp ? (nv - warp + WARPS - 1) / WARPS : 0;
    int nvr = 0;
    if (my_pages > 0) {
        const int last = rank + p.S * (warp + (my_pages - 1) * WARPS);
        nvr = (my_pages - 1) * p.ps + min(p.ps, length - last * p.ps);
    }
    const int n_tiles = (nvr + 15) / 16;
    uint8_t* wring = ring + warp * T::DEPTH * T::STAGE;

    auto pool_row = [&](int q, size_t* row) {
        if (q >= nvr) return false;
        const int k = __float2int_rz((q + 0.5f) * p.inv_ps);
        *row = ((size_t)ids[warp + k * WARPS] * p.ps + (q - k * p.ps)) * p.Hkv + h;
        return true;
    };
    // tile t -> its ring stage: K rows, V rows (and scales); rows past the
    // length are filled with zeros, not read
    auto issue = [&](int t) {
        uint8_t* st = wring + (t % T::DEPTH) * T::STAGE;
        if (t < n_tiles) {
#pragma unroll
            for (int mm = 0; mm < T::CPR / 2; ++mm) {
                const int c = lane + 32 * mm, i = c / T::CPR, cc = c % T::CPR;
                size_t row = 0;
                const bool ok = pool_row(16 * t + i, &row);
                const int sc = INT8 ? cc : cc ^ (i & 7);
                const size_t off = row * p.D * T::E + 16 * cc;
                cp_async_zfill<16>(st + i * T::KS + 16 * sc,
                                   static_cast<const uint8_t*>(p.kp) + off, ok);
                cp_async_zfill<16>(st + 16 * T::KS + i * T::VS + 16 * sc,
                                   static_cast<const uint8_t*>(p.vp) + off, ok);
            }
            if constexpr (INT8) {
                size_t row = 0;
                const bool ok = pool_row(16 * t + (lane & 15), &row);
                float* scales = reinterpret_cast<float*>(st + 16 * T::KS + 16 * T::VS);
                cp_async_zfill<4>(scales + lane, (lane < 16 ? p.ks : p.vs) + row, ok);
            }
        }
        cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < T::DEPTH - 1; ++i) issue(i);

    // q of head gq as A fragments, three bf16 parts (one for a bf16 q)
    const bool three = !p.q_bf16;
    uint32_t qa[3][T::KT][2];
    {
        const size_t q_row = ((size_t)bh * p.G + gq) * p.D;
#pragma unroll
        for (int kt = 0; kt < T::KT; ++kt) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                // A columns 2j, 2j+1 (hh = 0) and 2j+8, 2j+9 (hh = 1) of k-step kt;
                // for int8 pools the k order is permuted to match the K rows' bytes
                const int d = INT8 ? 4 * T::KT * j + 4 * kt + 2 * hh : 16 * kt + 8 * hh + 2 * j;
                float x = 0.f, y = 0.f;
                if (gq < p.G) {
                    if (p.q_bf16) {
                        const __nv_bfloat16* qb =
                            static_cast<const __nv_bfloat16*>(p.q) + q_row + d;
                        x = __bfloat162float(qb[0]);
                        y = __bfloat162float(qb[1]);
                    } else {
                        const float* qf = static_cast<const float*>(p.q) + q_row + d;
                        x = qf[0];
                        y = qf[1];
                    }
                }
                uint32_t parts[3];
                split3(x, y, parts);
#pragma unroll
                for (int s3 = 0; s3 < 3; ++s3) qa[s3][kt][hh] = parts[s3];
            }
        }
    }

    // O^T: D as the 16 rows of m-tile mt, the heads 2j, 2j+1 as columns
    float acc[T::MT][4];
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
    float m_run = NEG_INF, l_run = 0.f;

    for (int t = 0; t < n_tiles; ++t) {
        __syncwarp();   // the stage refilled below was read by every lane
        issue(t + T::DEPTH - 1);
        cp_async_wait<T::DEPTH - 1>();
        __syncwarp();   // every lane's copies of tile t have landed
        const uint8_t* st = wring + (t % T::DEPTH) * T::STAGE;

        // scores: keys 2j, 2j+1 (n-tile 0) and 8+2j, 9+2j (n-tile 1) of head gq
        float sc[2][4] = {};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
            if constexpr (INT8) {
                const uint4* kr = reinterpret_cast<const uint4*>(st + (8 * nt + gq) * T::KS
                                                                 + 4 * T::KT * j);
                uint32_t kw[T::KT];
#pragma unroll
                for (int v = 0; v < T::KT / 4; ++v) {
                    const uint4 x = kr[v];
                    kw[4 * v] = x.x;
                    kw[4 * v + 1] = x.y;
                    kw[4 * v + 2] = x.z;
                    kw[4 * v + 3] = x.w;
                }
#pragma unroll
                for (int kt = 0; kt < T::KT; ++kt) {
                    const uint32_t b0 = i8x2_bf16x2(__byte_perm(kw[kt], 0u, 0x1100));
                    const uint32_t b1 = i8x2_bf16x2(__byte_perm(kw[kt], 0u, 0x3322));
                    mma_bf16(sc[nt], qa[0][kt][0], qa[0][kt][1], b0, b1);
                    if (three) {
                        mma_bf16(sc[nt], qa[1][kt][0], qa[1][kt][1], b0, b1);
                        mma_bf16(sc[nt], qa[2][kt][0], qa[2][kt][1], b0, b1);
                    }
                }
            }
        }
        if constexpr (!INT8) {
#pragma unroll
            for (int kt = 0; kt < T::KT; ++kt) {
                // matrices: keys 0-7 / 8-15 x columns 16kt..+7 / 16kt+8..+15
                const int mi = lane >> 3, row = 8 * (mi >> 1) + (lane & 7);
                const int chunk = (2 * kt + (mi & 1)) ^ (row & 7);
                uint32_t bk[4];
                ldsm_x4<false>(bk, st + row * T::KS + 16 * chunk);
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) {
                    mma_bf16(sc[nt], qa[0][kt][0], qa[0][kt][1], bk[2 * nt], bk[2 * nt + 1]);
                    if (three) {
                        mma_bf16(sc[nt], qa[1][kt][0], qa[1][kt][1], bk[2 * nt], bk[2 * nt + 1]);
                        mma_bf16(sc[nt], qa[2][kt][0], qa[2][kt][1], bk[2 * nt], bk[2 * nt + 1]);
                    }
                }
            }
        }

        // online softmax over the tile's 16 keys; the 4 lanes of a head share m
        const int key0 = 16 * t + 2 * j;
        float s4[4] = {sc[0][0], sc[0][1], sc[1][0], sc[1][1]};
        float vs4[4] = {1.f, 1.f, 1.f, 1.f};
        if constexpr (INT8) {
            const float* scales = reinterpret_cast<const float*>(st + 16 * T::KS + 16 * T::VS);
            const float2 k0 = *reinterpret_cast<const float2*>(scales + 2 * j);
            const float2 k1 = *reinterpret_cast<const float2*>(scales + 8 + 2 * j);
            const float2 v0 = *reinterpret_cast<const float2*>(scales + 16 + 2 * j);
            const float2 v1 = *reinterpret_cast<const float2*>(scales + 24 + 2 * j);
            s4[0] *= k0.x;
            s4[1] *= k0.y;
            s4[2] *= k1.x;
            s4[3] *= k1.y;
            vs4[0] = v0.x;
            vs4[1] = v0.y;
            vs4[2] = v1.x;
            vs4[3] = v1.y;
        }
        float mx = NEG_INF;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int key = key0 + (i & 1) + 8 * (i >> 1);
            s4[i] = key < nvr ? s4[i] * p.scale2 : NEG_INF;
            mx = fmaxf(mx, s4[i]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        // a head whose max grew rescales its sums; the accumulator columns of
        // this lane are heads 2j and 2j+1, whose quads are lanes 8j and 8j+4
        const bool grew = mx > m_run;
        if (__any_sync(FULL, grew)) {
            const float a = grew ? fast_exp2(m_run - mx) : 1.f;
            const float a0 = __shfl_sync(FULL, a, 8 * j), a1 = __shfl_sync(FULL, a, 8 * j + 4);
            l_run *= a;
#pragma unroll
            for (int mt = 0; mt < T::MT; ++mt) {
                acc[mt][0] *= a0;
                acc[mt][1] *= a1;
                acc[mt][2] *= a0;
                acc[mt][3] *= a1;
            }
            m_run = fmaxf(m_run, mx);
        }
        float w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float pr = fast_exp2(s4[i] - m_run);
            l_run += pr;
            w[i] = INT8 ? pr * vs4[i] : pr;
        }
        uint32_t pa0[3], pa2[3];   // A fragments of P: keys 2j, 2j+1 and 8+2j, 9+2j
        split3(w[0], w[1], pa0);
        split3(w[2], w[3], pa2);

        // PV as O^T += V^T P^T: V^T is the A operand (D rows), P^T the B operand,
        // whose fragment is this lane's own probabilities
        if constexpr (INT8) {
            // m-tile mt, row i  <->  d = 64 (mt / 4) + 32 (i / 8) + 4 (i % 8) + mt % 4
            const uint8_t* vb = st + 16 * T::KS;
            uint32_t vw[DK / 32][4];   // rows 2j, 2j+1, 2j+8, 2j+9 at bytes 32 gi + 4 gq
#pragma unroll
            for (int gi = 0; gi < DK / 32; ++gi) {
                const int col = 32 * gi + 4 * gq;
                vw[gi][0] = *reinterpret_cast<const uint32_t*>(vb + (2 * j) * T::VS + col);
                vw[gi][1] = *reinterpret_cast<const uint32_t*>(vb + (2 * j + 1) * T::VS + col);
                vw[gi][2] = *reinterpret_cast<const uint32_t*>(vb + (2 * j + 8) * T::VS + col);
                vw[gi][3] = *reinterpret_cast<const uint32_t*>(vb + (2 * j + 9) * T::VS + col);
            }
#pragma unroll
            for (int mt = 0; mt < T::MT; ++mt) {
                const int lo = 2 * (mt / 4), hi = lo + 1, uu = mt % 4;
                const unsigned sel = uu | ((4 + uu) << 8);
                const uint32_t a[4] = {i8x2_bf16x2(__byte_perm(vw[lo][0], vw[lo][1], sel)),
                                       i8x2_bf16x2(__byte_perm(vw[hi][0], vw[hi][1], sel)),
                                       i8x2_bf16x2(__byte_perm(vw[lo][2], vw[lo][3], sel)),
                                       i8x2_bf16x2(__byte_perm(vw[hi][2], vw[hi][3], sel))};
#pragma unroll
                for (int s3 = 0; s3 < 3; ++s3) mma_bf16(acc[mt], a, pa0[s3], pa2[s3]);
            }
        } else {
            // m-tile mt, row i  <->  d = 16 mt + i
            const uint8_t* vb = st + 16 * T::KS;
#pragma unroll
            for (int mt = 0; mt < T::MT; ++mt) {
                // matrices: keys 0-7 / 8-15 x columns 16mt..+7 / 16mt+8..+15
                const int mi = lane >> 3, row = 8 * (mi >> 1) + (lane & 7);
                const int chunk = (2 * mt + (mi & 1)) ^ (row & 7);
                uint32_t a[4];
                ldsm_x4<true>(a, vb + row * T::VS + 16 * chunk);
#pragma unroll
                for (int s3 = 0; s3 < 3; ++s3) mma_bf16(acc[mt], a, pa0[s3], pa2[s3]);
            }
        }
    }
    cp_async_wait<0>();
    __syncwarp();

    // the warp's (m, l, acc) of its 8 heads, over the rings (free now)
    l_run += __shfl_xor_sync(FULL, l_run, 1);
    l_run += __shfl_xor_sync(FULL, l_run, 2);
    float* red_acc = reinterpret_cast<float*>(ring);       // WARPS * MGT * D, over the rings
    float* red_m = red_acc + WARPS * MGT * DK;             // WARPS * MGT
    float* red_l = red_m + WARPS * MGT;                    // WARPS * MGT
    __syncthreads();   // every warp is done with its ring
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int i = gq + 8 * (c >> 1), head = 2 * j + (c & 1);
            const int d = INT8 ? 64 * (mt / 4) + 32 * (i / 8) + 4 * (i % 8) + mt % 4 : 16 * mt + i;
            red_acc[(warp * MGT + head) * DK + d] = acc[mt][c];
        }
    }
    if (j == 0) {
        red_m[warp * MGT + gq] = m_run;
        red_l[warp * MGT + gq] = l_run;
    }
    combine_and_store<MGT>(p, red_m, red_l, red_acc, push_m, push_l, push_acc, rank, bh, 0,
                           min(p.S, n_valid));
}

cudaError_t sm_count(int* out) {
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

cudaLaunchConfig_t cluster_config(dim3 grid, int splits, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// Split the table into S = ceil(P / per) runs of `per` pages: as many as
// it takes for about WAVES blocks per SM over `split_lanes` lanes, at most
// MAX_CLUSTER and at most one page each, and no more than a cluster the
// occupancy query says can be resident.  Clusters beyond one wave run in
// later waves.  `split_lanes` is B for a decode step; a speculative verify
// launches B*W lanes with split_lanes = B, so every row splits (and its
// partial results combine) exactly as the decode step's lane does.
// `smem_of` gives a block's shared memory for (per, S).
template <auto Kernel, class SmemOf>
cudaError_t launch(Params p, int B, int split_lanes, int HG, SmemOf smem_of,
                   cudaStream_t stream) {
    int sms = 0;
    cudaError_t err = sm_count(&sms);
    if (err != cudaSuccess) return err;
    const long long blocks = static_cast<long long>(split_lanes) * p.Hkv * HG;
    long long want = (static_cast<long long>(WAVES) * sms + blocks - 1) / blocks;
    int splits = static_cast<int>(want < MAX_CLUSTER ? want : MAX_CLUSTER);
    splits = splits < p.P ? splits : p.P;
    static int smem_allowed = 48 * 1024;
    static int resident[MAX_CLUSTER + 1] = {};
    static size_t resident_smem[MAX_CLUSTER + 1] = {};
    size_t smem = 0;
    for (;;) {
        p.per = (p.P + splits - 1) / splits;
        p.S = (p.P + p.per - 1) / p.per;
        smem = smem_of(p.per, p.S);
        if (smem > static_cast<size_t>(smem_allowed)) {
            err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
            if (err != cudaSuccess) return err;
            smem_allowed = static_cast<int>(smem);
        }
        if (p.S == 1) break;
        if (resident_smem[p.S] != smem) {
            cudaLaunchAttribute a[1];
            cudaLaunchConfig_t q = cluster_config(dim3(p.S, 1, 1), p.S, smem, stream, a);
            err = cudaOccupancyMaxActiveClusters(&resident[p.S], Kernel, &q);
            if (err != cudaSuccess) return err;
            resident_smem[p.S] = smem;
        }
        if (resident[p.S] >= 1) break;
        splits = p.S - 1;
    }
    const long long grid_x = static_cast<long long>(p.S) * B * p.Hkv;
    if (grid_x > 0x7fffffffLL) return cudaErrorInvalidValue;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = cluster_config(dim3(static_cast<unsigned>(grid_x), HG, 1), p.S,
                                            smem, stream, attr);
    err = cudaLaunchKernelEx(&cfg, Kernel, p);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// The CUDA-core kernel, for every shape the kernel accepts: CGT heads a
// block (heads at or past G are masked).
template <bool INT8>
cudaError_t launch_cores(Params p, int B, int split_lanes, bool vec, cudaStream_t stream) {
    const int HG = (p.G + CGT - 1) / CGT;
    auto smem_of = [&](int per, int splits) { return smem_bytes(INT8, per, splits, p.D); };
    return vec ? launch<paged_attention_kernel<INT8, true>>(p, B, split_lanes, HG, smem_of,
                                                            stream)
               : launch<paged_attention_kernel<INT8, false>>(p, B, split_lanes, HG, smem_of,
                                                             stream);
}

template <bool INT8, int DK>
cudaError_t launch_mma(Params p, int B, int split_lanes, cudaStream_t stream) {
    auto smem_of = [](int per, int splits) { return smem_bytes_mma<INT8, DK>(per, splits); };
    return launch<paged_attention_kernel_mma<INT8, DK>>(p, B, split_lanes, 1, smem_of, stream);
}

// Tensor cores where the shape allows (D of 64 or 128, at most 8 query
// heads, 16-byte aligned rows, tables short enough for the f32 row
// arithmetic), the CUDA-core kernel otherwise.
template <bool INT8>
cudaError_t dispatch(Params p, int B, int split_lanes, bool vec, cudaStream_t stream) {
    const bool mma = vec && p.G <= MGT && static_cast<long long>(p.P) * p.ps < (1LL << 22);
    if (mma && p.D == 64) return launch_mma<INT8, 64>(p, B, split_lanes, stream);
    if (mma && p.D == 128) return launch_mma<INT8, 128>(p, B, split_lanes, stream);
    return launch_cores<INT8>(p, B, split_lanes, vec, stream);
}

Params make_params(const void* q, int q_is_bf16, const void* kp, const void* vp,
                   const void* k_scale, const void* v_scale, const void* tables,
                   const void* lengths, void* out, int kv_int8, int Hkv, int G, int D,
                   int page_size, int P) {
    const int el = kv_int8 ? Pool<true>::EL : Pool<false>::EL;
    int lanes = 1;
    while (lanes * el < D) lanes <<= 1;   // D <= 256 keeps this <= 32
    return Params{q, kp, vp, static_cast<const float*>(k_scale),
                  static_cast<const float*>(v_scale), static_cast<const int*>(tables),
                  static_cast<const int*>(lengths), static_cast<float*>(out), q_is_bf16, Hkv, G, D,
                  page_size, P, 1, P, lanes,
                  static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D))),
                  1.f / static_cast<float>(page_size)};
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

}  // namespace

// C entry point.  q_is_bf16: q dtype bf16 (else f32); kv_int8: int8 pools
// with k_scale / v_scale (else bf16 pools, scales NULL).  split_lanes: the
// lane count that chooses the split count (B, or the decode batch a
// verify's B*W rows stand for).  All tensors contiguous.  Returns the
// launch's error, then cudaGetLastError().
extern "C" int paged_attention_launch(
    const void* q, int q_is_bf16, const void* kp, const void* vp, int kv_int8,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, void* out, int B, int Hkv, int G, int D,
    int page_size, int P, int split_lanes, void* stream) {
    if (B <= 0 || split_lanes <= 0 || Hkv <= 0 || G <= 0 || G > MAX_G || D <= 0 || D > MAX_D
        || page_size <= 0
        || P <= 0 || (kv_int8 && (k_scale == nullptr || v_scale == nullptr))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int elem = kv_int8 ? 1 : 2;
    const bool vec = (D * elem) % 16 == 0 && aligned16(kp) && aligned16(vp);
    const Params p = make_params(q, q_is_bf16, kp, vp, k_scale, v_scale, tables, lengths, out,
                                 kv_int8, Hkv, G, D, page_size, P);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err = kv_int8 ? dispatch<true>(p, B, split_lanes, vec, s)
                                    : dispatch<false>(p, B, split_lanes, vec, s);
    return static_cast<int>(err);
}
