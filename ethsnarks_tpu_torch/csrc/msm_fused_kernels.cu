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
// scans a tile of blockDim * v elements, thread t the v elements from
// t v (v = 64 by default, ops/fold.py); the last tile is ragged and masked
// here, not padded.  Runs that cross tiles are finished by the caller: it
// scans the tiles' last elements (the tile aggregates, as in the
// reference) with this kernel again and adds each tile's carry into its
// leading run with K1.
//
// What bounds them on this card: integer multiplies, as K1 (3168 IMADs per
// G1 add, 11088 per G2 add): K5 does about 2 adds per bucket plus
// log-depth combines, K6 needs one add per element that merges, against
// 96 or 192 bytes read per bucket or element.  Both keep every partial
// sum in registers or shared memory; the buckets and points are read once
// with 16-byte loads.
//
// K6's design keeps its adds near that one per element.  A thread first
// sums only its trailing run (from its last element back while the key
// holds: about 8.5 elements at the 2^20 MSM's runs of 16 keys, 0.13 adds
// an element at v = 64).  The threads' (key, sum) pairs are scanned by
// warp shuffles within each warp (log2(32) steps, no barrier) and by
// thread 0 over the warps; a step adds only where a run covers a whole
// thread, which runs shorter than v almost never do.  Then each thread
// walks its elements once, forwards, starting from the inclusive sum of
// the thread before it where its first key continues that thread's run,
// and writes every prefix: the carry is the walk's seed, so no prefix is
// written twice.  One add site serves both walks.  A Hillis-Steele scan
// over all the threads' sums in shared memory (log2(threads) levels of
// adds, two barriers each) with a second pass adding the carry into each
// thread's leading run costs about two more adds an element at v = 8.
// On an H100, 64 elements a thread ran faster than 32 and 16 (fewer
// trailing-run adds; python -m ethsnarks_tpu_torch.ab_kernels, PERF.md).
//
// Occupancy (ScanCfg, FusedCfg): the most blocks an SM that ptxas fits
// without spilling.  G1: 128 threads, at least 3 blocks an SM: 166
// registers (of 168), 0 bytes of stack and spills (at 4 blocks, 128
// registers and 80 bytes of spills).  G2: 64 threads at 255 registers: the walk's two
// points and state do not fit, and ptxas spills about 200 bytes (an
// 88-byte frame).
//
// The point add is inlined everywhere but in K5's log-depth combines,
// which call one out-of-line copy (p_add_cold, p_dbl_cold) to keep the
// kernels small.

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

// The log-depth combines run a few adds a thread: one out-of-line copy
// keeps the kernels small.
template <class F>
__device__ __noinline__ point<F> p_add_cold(const point<F>& a, const point<F>& b) {
    return rcb_add(a, b);
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
        run = rcb_add(run, load_point<point<F>>(buckets, base + i));
        if (i > 0) acc = rcb_add(acc, run);
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

// K6's occupancy: the most blocks of FusedCfg<F>::kThreads an SM that
// ptxas fits without spilling (see the note at the top).
template <class F> struct ScanCfg;
template <> struct ScanCfg<fq> { static constexpr int kMinBlocks = 3; };
template <> struct ScanCfg<fq2> { static constexpr int kMinBlocks = 2; };

__device__ __forceinline__ fq shfl_up(const fq& a, int d, unsigned mask) {
    fq r;
#pragma unroll
    for (int k = 0; k < 8; k++) r.w[k] = __shfl_up_sync(mask, a.w[k], d);
    return r;
}
__device__ __forceinline__ fq2 shfl_up(const fq2& a, int d, unsigned mask) {
    return {shfl_up(a.c0, d, mask), shfl_up(a.c1, d, mask)};
}
template <class F>
__device__ __forceinline__ point<F> shfl_up(const point<F>& p, int d,
                                            unsigned mask) {
    return {shfl_up(p.x, d, mask), shfl_up(p.y, d, mask),
            shfl_up(p.z, d, mask)};
}

// One tile of blockDim.x * v elements per block (the last one ragged);
// thread t walks elements [t v, (t + 1) v) of its tile.  idx == nullptr
// means element j reads P[j].
template <class F>
__global__ void __launch_bounds__(FusedCfg<F>::kThreads, ScanCfg<F>::kMinBlocks)
k_seg_scan(const uint32_t* __restrict__ P, const int64_t* __restrict__ idx,
           const int64_t* __restrict__ keys, uint32_t* __restrict__ out,
           int n, int v) {
    constexpr int kWarps = (FusedCfg<F>::kThreads + 31) / 32;
    __shared__ point<F> Y[kWarps];   // inclusive sum at each warp's last lane
    __shared__ long long KY[kWarps];  // and its key
    const int t = threadIdx.x, T = blockDim.x;
    const int lane = t & 31, warp = t >> 5;
    const int width = T < 32 ? T : 32;
    const unsigned mask = width == 32 ? 0xffffffffu : (1u << width) - 1u;
    const long long start = ((long long)blockIdx.x * T + t) * v;
    const long long end = min(start + v, (long long)n);

    // Pass 1 walks the thread's trailing run backwards from its last
    // element (k: its key, -1 for a thread without elements, which never
    // merges); pass 2 walks all its elements forwards, the first one merged
    // into the carry of the threads before it when the key continues, and
    // writes every prefix.  One add site serves both passes.
    long long k = -1;
    point<F> acc;
    set_identity(acc);
#pragma unroll 1
    for (int pass = 1; pass <= 2; pass++) {
        long long kl;  // key of the previous element; -1 never merges
        if (pass == 1) {
            if (start < end) k = keys[end - 1];
            kl = -1;
        } else {
            // segmented inclusive scan of the trailing-run sums (k, acc):
            // over the lanes of each warp by shuffles, then over the warps
            // by thread 0, then each lane takes its warps' carry
#pragma unroll 1
            for (int d = 1; d < width; d <<= 1) {
                const long long kd = __shfl_up_sync(mask, k, d);
                const point<F> ad = shfl_up(acc, d, mask);
                if (lane >= d && kd == k && k >= 0) acc = rcb_add(ad, acc);
            }
            const int n_warps = (T + 31) >> 5;
            if (n_warps > 1) {
                if (lane == 31) {
                    Y[warp] = acc;
                    KY[warp] = k;
                }
                __syncthreads();
                if (t == 0) {
#pragma unroll 1
                    for (int w = 1; w < n_warps; w++)
                        if (KY[w] == KY[w - 1] && KY[w] >= 0)
                            Y[w] = rcb_add(Y[w - 1], Y[w]);
                }
                __syncthreads();
                if (warp > 0 && k == KY[warp - 1] && k >= 0)
                    acc = rcb_add(Y[warp - 1], acc);
            }
            // the carry into this thread: the inclusive sum of thread t - 1
            kl = __shfl_up_sync(mask, k, 1);
            const point<F> cin = shfl_up(acc, 1, mask);
            if (lane > 0) {
                acc = cin;
            } else if (warp > 0) {
                kl = KY[warp - 1];
                acc = Y[warp - 1];
            } else {
                kl = -1;
            }
        }
        long long len = end - start;
        if (pass == 1 && k < 0) len = min(len, 1LL);
#pragma unroll 1
        for (long long i = 0; i < len; i++) {
            const long long j = pass == 1 ? end - 1 - i : start + i;
            const long long kj = keys[j];
            if (pass == 1 && kj != k) break;
            const point<F> p = load_point<point<F>>(P, idx ? idx[j] : j);
            const bool merge = pass == 1 ? i > 0 : (kj == kl && kj >= 0);
            acc = merge ? rcb_add(acc, p) : p;
            if (pass == 2) store_point(out, j, acc);
            kl = kj;
        }
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
