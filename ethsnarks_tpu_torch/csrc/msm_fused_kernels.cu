// Hopper (sm_90a) kernels of the fused (dense all-windows) and scan MSMs.
//
// Two templates, each instantiated for G1 (Fq) and G2 (Fq2):
//
//   K5 bucket_fold <- ethsnarks_tpu/ops/pallas_msm.py _k_fold (:130),
//                     _k_fold_grid (:295), _k_fold_grid_g2 (:484)
//   K6 seg_scan    <- ethsnarks_tpu/ops/pallas_msm.py _k_scan (:56)
//
// K5: (n_win * 2^c) window-major buckets S -> (n_win) points
// sum_b b * S_b per window.  The Pallas form reduces c bit planes, each a
// full-width tree (about c * 2^c adds a window), because a TPU core runs
// one wide vector at a time.  Here a window is split over 2^log_g blocks
// of 2^log_t threads; each thread walks 2^log_m consecutive buckets from
// the top, keeping a running sum R and a weighted sum W (2 adds a bucket),
// and the pairs are combined level by level:
//     (R, W) of n parts = (sum_i R_i, sum_i W_i + 2^s sum_i i R_i)
// where s = log2(buckets per part) and sum_i i R_i = sum_{i>=1} (suffix
// sum of R at i): a Hillis-Steele suffix scan over the parts, a halving
// tree over the suffix sums and the W's, and s doublings.  One block per
// window-slice combines its threads in shared memory; the last block of a
// window to finish (an atomic ticket) combines the blocks' pairs from
// global scratch.  So a window costs about 2 * 2^c adds in all, spread
// over every thread, and about 2^log_m + 4 log_t + log_g + c serial ones.
//
// K6: out[j] = sum of P[idx[j]] over i <= j in j's run of equal keys.
// Keys are sorted (non-decreasing); a negative key never merges (the -1
// and -2 of the reference's tile padding and first carry).  One block
// scans a tile of blockDim * v elements: each thread walks v elements
// (serial segmented sum), a Hillis-Steele segmented scan over the
// threads' trailing-run sums in shared memory gives each thread the carry
// of the threads before it, which the thread adds into its leading run.
// Runs that cross tiles are finished by the caller: it scans the tiles'
// last elements (the tile aggregates, as in the reference) with this
// kernel again and adds each tile's carry with K1.  No tile padding: the
// last tile is ragged and masked here.
//
// What bounds them on this card: integer multiplies, as K1 (3168 IMADs per
// G1 add, 11088 per G2 add): K5 does about 2 adds per bucket plus
// log-depth combines, K6 about 1 add per element, against 96 or 192 bytes
// read per bucket or element.  Both keep every partial sum in registers or
// shared memory; the buckets and points are read once with 16-byte loads.
// The G2 point add is called out of line (p_add below), so each G2 kernel
// holds one copy of the formulas: fully inlined Fq2 formulas crash the
// compiler's front end (see curve.cuh).  The G1 add is inlined in the
// walks over buckets and elements, and called out of line in the
// log-depth combines.
//
// Every launcher returns cudaGetLastError() after the launch; the Python
// wrapper raises on a non-zero value.  This file is not compiled on its
// own: msm_kernels.cu includes it, so every kernel is one library.

#include <cuda_runtime.h>
#include <stdint.h>

#include "curve.cuh"

namespace esn {

// Threads per block: G2 points are twice as large and their kernels use
// about twice the registers.
template <class F> struct FusedCfg;
template <> struct FusedCfg<fq> { static constexpr int kThreads = 128; };
template <> struct FusedCfg<fq2> { static constexpr int kThreads = 64; };

__device__ __forceinline__ point<fq> p_add(const point<fq>& a, const point<fq>& b) {
    return rcb_add(a, b);
}
__device__ __noinline__ point<fq2> p_add(const point<fq2>& a, const point<fq2>& b) {
    return rcb_add(a, b);
}
// The log-depth combines run a few adds a thread: one out-of-line copy
// keeps the G1 kernels small.
template <class F>
__device__ __noinline__ point<F> p_add_cold(const point<F>& a, const point<F>& b) {
    return p_add(a, b);
}
template <class F>
__device__ __noinline__ point<F> p_dbl_cold(const point<F>& a) {
    return rcb_double(a);
}

// Point i of a tensor written earlier in the same launch: an L2 load (the
// read-only path of load_point may hold stale lines).
template <class P>
__device__ __forceinline__ P load_point_cg(const uint32_t* base, long long i) {
    constexpr int V = sizeof(P) / 16;
    const uint4* src = reinterpret_cast<const uint4*>(base) + i * V;
    P p;
    uint4* dst = reinterpret_cast<uint4*>(&p);
#pragma unroll
    for (int k = 0; k < V; k++) dst[k] = __ldcg(src + k);
    return p;
}

// n pairs (R[i], W[i]) in shared memory, n a power of two <= blockDim.x
// -> thread 0 gets r = sum_i R[i], w = sum_i W[i] + 2^s * sum_i i R[i].
// R and W are overwritten.  Every thread of the block must call it.
template <class F>
__device__ __noinline__ void fold_combine(point<F>* R, point<F>* W, int n, int s,
                                          point<F>& r, point<F>& w) {
    const int t = threadIdx.x;
    // inclusive suffix sums R[i] <- R[i] + R[i+d] ...
#pragma unroll 1
    for (int d = 1; d < n; d <<= 1) {
        const bool take = t + d < n;
        point<F> q;
        __syncthreads();
        if (take) q = R[t + d];
        __syncthreads();
        if (take) R[t] = p_add_cold(R[t], q);
    }
    __syncthreads();
    if (t == 0) {
        r = R[0];
        set_identity(R[0]);  // sum_i i R_i = sum over the suffix sums at i >= 1
    }
    // halving trees over the suffix sums and over W
#pragma unroll 1
    for (int h = n >> 1; h >= 1; h >>= 1) {
        __syncthreads();
        if (t < h) {
            R[t] = p_add_cold(R[t], R[t + h]);
            W[t] = p_add_cold(W[t], W[t + h]);
        }
    }
    __syncthreads();
    if (t == 0) {
        point<F> x = R[0];
#pragma unroll 1
        for (int k = 0; k < s; k++) x = p_dbl_cold(x);
        w = p_add_cold(W[0], x);
    }
}

// buckets: (n_win << c) points, window w's bucket b at (w << c) + b.
// Grid (2^log_g, n_win), block 2^log_t, log_t + log_m + log_g = c.
// part: (n_win << log_g) x 2 points of scratch; tickets: n_win zeros.
template <class F>
__global__ void __launch_bounds__(FusedCfg<F>::kThreads)
k_bucket_fold(const uint32_t* __restrict__ buckets, uint32_t* __restrict__ out,
              uint32_t* __restrict__ part, unsigned int* __restrict__ tickets,
              int c, int log_t, int log_m, int log_g) {
    constexpr int kT = FusedCfg<F>::kThreads;
    __shared__ point<F> R[kT];
    __shared__ point<F> W[kT];
    __shared__ int last;
    const int t = threadIdx.x, g = blockIdx.x, w = blockIdx.y;
    const int m = 1 << log_m, n_blk = 1 << log_g;
    const long long base = ((long long)w << c) + ((long long)g << (log_t + log_m))
                           + ((long long)t << log_m);
    // walk the thread's buckets from the top: run = suffix sum, acc = sum
    // of the suffix sums above bucket 0 = sum_i i S_(base+i)
    point<F> run = load_point<point<F>>(buckets, base + m - 1);
    point<F> acc;
    if (m == 1)
        set_identity(acc);
    else
        acc = run;
#pragma unroll 1
    for (int i = m - 2; i >= 0; i--) {
        run = p_add(run, load_point<point<F>>(buckets, base + i));
        if (i > 0) acc = p_add(acc, run);
    }
    R[t] = run;
    W[t] = acc;
    point<F> r, wsum;
    fold_combine(R, W, 1 << log_t, log_m, r, wsum);
    if (log_g == 0) {
        if (t == 0) store_point(out, w, wsum);
        return;
    }
    if (t == 0) {
        const long long slot = 2 * ((long long)w * n_blk + g);
        store_point(part, slot, r);
        store_point(part, slot + 1, wsum);
        __threadfence();
        last = atomicAdd(&tickets[w], 1u) == (unsigned int)(n_blk - 1);
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (t < n_blk) {
        const long long slot = 2 * ((long long)w * n_blk + t);
        R[t] = load_point_cg<point<F>>(part, slot);
        W[t] = load_point_cg<point<F>>(part, slot + 1);
    }
    fold_combine(R, W, n_blk, log_t + log_m, r, wsum);
    if (t == 0) {
        store_point(out, w, wsum);
        tickets[w] = 0;
    }
}

// One tile of blockDim.x * v elements per block (the last one ragged).
// idx == nullptr means element j reads P[j].
template <class F>
__global__ void __launch_bounds__(FusedCfg<F>::kThreads)
k_seg_scan(const uint32_t* __restrict__ P, const int64_t* __restrict__ idx,
           const int64_t* __restrict__ keys, uint32_t* __restrict__ out, int n, int v) {
    constexpr int kT = FusedCfg<F>::kThreads;
    __shared__ point<F> S[kT];
    __shared__ long long K[kT];
    const int t = threadIdx.x, T = blockDim.x;
    const long long start = ((long long)blockIdx.x * T + t) * v;
    const long long end = min(start + v, (long long)n);
    point<F> acc;
    set_identity(acc);
    long long kprev = -1;  // stays -1 (never merges) for a thread without elements
#pragma unroll 1
    for (long long j = start; j < end; j++) {
        const long long k = keys[j];
        const point<F> p = load_point<point<F>>(P, idx ? idx[j] : j);
        acc = (j > start && k == kprev && k >= 0) ? p_add(acc, p) : p;
        store_point(out, j, acc);
        kprev = k;
    }
    S[t] = acc;
    K[t] = kprev;
    // inclusive segmented scan of the threads' trailing-run sums
#pragma unroll 1
    for (int d = 1; d < T; d <<= 1) {
        __syncthreads();
        const bool merge = t >= d && K[t - d] == K[t] && K[t] >= 0;
        point<F> q;
        if (merge) q = S[t - d];
        __syncthreads();
        if (merge) S[t] = p_add_cold(q, S[t]);
    }
    __syncthreads();
    // the carry of threads 0..t-1 into this thread's leading run
    if (t > 0 && start < end && K[t - 1] >= 0) {
        const long long ck = K[t - 1];
        const point<F> cv = S[t - 1];
#pragma unroll 1
        for (long long j = start; j < end && keys[j] == ck; j++)
            store_point(out, j, p_add(cv, load_point_cg<point<F>>(out, j)));
    }
}

}  // namespace esn

#define ESN_FUSED_LAUNCHERS(SUFFIX, F)                                          \
    extern "C" int esn_bucket_fold_##SUFFIX(                                    \
        const void* buckets, void* out, void* part, void* tickets, int n_win,   \
        int c, int log_t, int log_m, int log_g, void* stream) {                 \
        if (n_win > 0)                                                          \
            esn::k_bucket_fold<F><<<dim3(1u << log_g, n_win), 1u << log_t, 0,   \
                                    (cudaStream_t)stream>>>(                    \
                (const uint32_t*)buckets, (uint32_t*)out, (uint32_t*)part,      \
                (unsigned int*)tickets, c, log_t, log_m, log_g);                \
        return (int)cudaGetLastError();                                         \
    }                                                                           \
    extern "C" int esn_seg_scan_##SUFFIX(const void* P, const void* idx,        \
                                         const void* keys, void* out, int n,    \
                                         int log_t, int v, void* stream) {      \
        const long long tile = (long long)v << log_t;                           \
        if (n > 0)                                                              \
            esn::k_seg_scan<F><<<(unsigned int)((n + tile - 1) / tile),         \
                                 1u << log_t, 0, (cudaStream_t)stream>>>(       \
                (const uint32_t*)P, (const int64_t*)idx, (const int64_t*)keys,  \
                (uint32_t*)out, n, v);                                          \
        return (int)cudaGetLastError();                                         \
    }

ESN_FUSED_LAUNCHERS(g1, fq)
ESN_FUSED_LAUNCHERS(g2, fq2)
