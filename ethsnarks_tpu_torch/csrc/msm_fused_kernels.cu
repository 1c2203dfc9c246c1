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
// one wide vector at a time.  Here the launch is sized to the card, not
// to c: ops/fold.py fold_schedule gives the windows one wave of blocks
// (SMs x blocks an SM, from CUDA's occupancy query, ops/kernels.py
// card_shape), so a window of 2^16 buckets gets 16 G1 blocks of 128
// threads at 16 windows and 128 at 2 windows on an H100, and a thread
// walks m = 32 or 4 consecutive buckets (m is any count, not only a power
// of two; the last part is ragged, parts past 2^c are empty).
//
// A thread walks its part from the top with one add a step: r = the
// running (suffix) sum, a = sum of the suffix sums above its first
// bucket = sum_i i S_i, 2m - 3 adds.  Parts are combined by offset: with
// lane l's part starting l spans after lane 0's and r_l scaled to the span
// length (r <- m r by double-and-add, since m need not be a power of two),
//     a = sum_l (a_l + l r_l) = sum_l a_l + sum_{l>=1} sum_{i>=l} r_i,
// which a warp computes by shuffles: a suffix scan of r (5 steps), a_l +=
// r_l, and a halving tree over a (5 steps): 11 adds, whatever the lanes
// hold.  (A pairwise tree (r_lo + r_hi, a_lo + a_hi + n_lo r_hi) does
// fewer adds over all lanes, but a warp issues every step for all 32
// lanes, and its scales by n_lo cost a doubling a level: 20 adds and 10
// doublings a warp.)  Warp 0 then folds the block's warps the same way
// (r x 32 first), and each block writes its partial (r scaled to the
// block's span, a) to global scratch.  A second launch, one block a
// window of the fewest warps that hold its partials (32 threads for 16
// partials), walks and folds the partials the same way.  Measured on an
// H100 (python -m ethsnarks_tpu_torch.ab_kernels, PERF.md): that
// second launch was faster in 14 of 16 schedules than letting each
// window's last block finish it behind an atomic ticket (at most 1.3%
// slower in the other two), so there is no ticket.
//
// Each thread's r and a live in its own shared-memory slots (24 KB a
// block): registers hold one add's operands only, so G2 fits 255
// registers with a 40-byte frame (with r and a in registers ptxas spilled
// 1,292 bytes) and G1 166 registers with none.  Every add and double is
// inlined, through one add site each in the walk, the scale and the warp
// fold.
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
// K6's occupancy (ScanCfg, FusedCfg): the most blocks an SM that ptxas
// fits without spilling.  G1: 128 threads, at least 3 blocks an SM: 166
// registers (of 168), 0 bytes of stack and spills (at 4 blocks, 128
// registers and 80 bytes of spills).  G2: 64 threads at 255 registers: the
// walk's two points and state do not fit, and ptxas spills about 200
// bytes (an 88-byte frame).  K5 (FoldCfg) needs no bound below 255 for
// G2 (4 blocks of 64 threads an SM) and at least 2 blocks for G1; its
// schedule fills at most 2 G1 blocks an SM (fold.FOLD_MAX_BLOCKS): at the
// occupancy of 3, G1 ran slower at both shapes measured.

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

// K5's occupancy: the most blocks of FusedCfg<F>::kThreads an SM that
// ptxas fits without spilling (see the note at the top).
template <class F> struct FoldCfg;
template <> struct FoldCfg<fq> { static constexpr int kMinBlocks = 2; };
template <> struct FoldCfg<fq2> { static constexpr int kMinBlocks = 1; };

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
__device__ __forceinline__ fq shfl_down(const fq& a, int d) {
    fq r;
#pragma unroll
    for (int k = 0; k < 8; k++) r.w[k] = __shfl_down_sync(0xffffffffu, a.w[k], d);
    return r;
}
__device__ __forceinline__ fq2 shfl_down(const fq2& a, int d) {
    return {shfl_down(a.c0, d), shfl_down(a.c1, d)};
}
template <class F>
__device__ __forceinline__ point<F> shfl_down(const point<F>& p, int d) {
    return {shfl_down(p.x, d), shfl_down(p.y, d), shfl_down(p.z, d)};
}

// c ? a : b, word by word: selects on registers.  (A conditional lvalue
// passed by reference takes the address of both points and puts them in
// the stack frame.)
__device__ __forceinline__ fq pick(bool c, const fq& a, const fq& b) {
    fq r;
#pragma unroll
    for (int k = 0; k < 8; k++) r.w[k] = c ? a.w[k] : b.w[k];
    return r;
}
__device__ __forceinline__ fq2 pick(bool c, const fq2& a, const fq2& b) {
    return {pick(c, a.c0, b.c0), pick(c, a.c1, b.c1)};
}
template <class F>
__device__ __forceinline__ point<F> pick(bool c, const point<F>& a,
                                         const point<F>& b) {
    return {pick(c, a.x, b.x), pick(c, a.y, b.y), pick(c, a.z, b.z)};
}

// k p for k >= 1: double-and-add from the top bit of k (uniform k).
template <class F>
__device__ __forceinline__ point<F> scale(const point<F>& p, unsigned k) {
    point<F> x = p;
#pragma unroll 1
    for (int b = 30 - __clz((int)k); b >= 0; b--) {
        x = rcb_double(x);
        if ((k >> b) & 1u) x = rcb_add(x, p);
    }
    return x;
}

// Lanes l < width (a power of two <= 32) of a whole warp hold (r_l, a_l)
// in their slots *r, *a (shared memory, one pair a thread): lane l's span
// starts l spans after lane 0's, r_l is the span length in buckets times
// the sum of its buckets and a_l its weighted sum relative to its first
// bucket.  Lane 0 gets r = sum r_l and
//     a = sum_l (a_l + l r_l) = sum_l a_l + sum_{l>=1} sum_{i>=l} r_i:
// a suffix scan of r (log2 width steps), a_l += r_l on lanes l >= 1, and a
// halving tree over a (log2 width steps), all through one add.
template <class F>
__device__ __forceinline__ void warp_fold(point<F>* r, point<F>* a, int width) {
    if (width == 1) return;
    const int lane = threadIdx.x & 31, L = 31 - __clz(width);
#pragma unroll 1
    for (int s = 0; s <= 2 * L; s++) {
        const bool scan = s < L, mid = s == L;
        const int d = scan ? 1 << s : mid ? 0 : width >> (s - L);
        point<F>* const dst = scan ? r : a;
        const point<F> x = *dst;
        const point<F> z = rcb_add(x, pick(mid, *r, shfl_down(x, d)));
        if (scan ? lane + d < width : mid ? lane > 0 && lane < width : lane < d)
            *dst = z;
    }
}

// Item idx of a thread's walk: bucket idx of window w (pass 0), or the r
// (second: a) point of block idx's partial (tail); the identity at
// idx >= limit.
template <class F>
__device__ __forceinline__ point<F> fold_item(const uint32_t* buckets,
                                              const uint32_t* part, int w, int c,
                                              long long slot0, long long idx,
                                              long long limit, bool tail,
                                              bool second) {
    point<F> p;
    if (idx >= limit)
        set_identity(p);
    else if (tail)
        p = load_point<point<F>>(part, slot0 + 2 * idx + second);
    else
        p = load_point<point<F>>(buckets, ((long long)w << c) + idx);
    return p;
}

// buckets: (n_win << c) points, window w's bucket b at (w << c) + b;
// part: (n_win * n_blk) x 2 points, block g's partial (r, a) of window w
// at 2 (w n_blk + g).
// Pass 0 (tail = 0): grid (n_blk, n_win), blocks of 32, 64 or 128
// threads; thread t of block g walks part j = g T + t, buckets [j m, j m
// + m) (the identity past 2^c; a part past 2^c is empty).  It writes the
// window's sum to out where n_blk = 1, else the block's partial.
// Tail (tail = 1): grid (1, n_win), blockDim a power of two >= 32;
// thread t walks partials [t q, t q + q), q = ceil(n_blk / blockDim).
template <class F>
__global__ void __launch_bounds__(FusedCfg<F>::kThreads, FoldCfg<F>::kMinBlocks)
k_bucket_fold(const uint32_t* __restrict__ buckets, uint32_t* __restrict__ out,
              uint32_t* __restrict__ part, int c, int m, int n_blk, int tail) {
    // each thread's r (its run, then its span times it) and its weighted
    // sum a live in its own slots: registers hold only one add's operands
    __shared__ point<F> R[FusedCfg<F>::kThreads];
    __shared__ point<F> A[FusedCfg<F>::kThreads];
    const int t = threadIdx.x, T = blockDim.x, lane = t & 31, warp = t >> 5;
    const int n_warps = T >> 5, w = blockIdx.y;
    const long long slot0 = 2LL * w * n_blk;  // the window's partials
    const int n_items = tail ? (n_blk + T - 1) / T : m;
    const long long first = tail ? (long long)t * n_items
                                 : ((long long)blockIdx.x * T + t) * m;
    const long long limit = tail ? n_blk : 1LL << c;
    const bool partial = !tail && n_blk > 1;
    point<F>* const r = &R[t];
    point<F>* const a = &A[t];
    set_identity(*r);
    set_identity(*a);
    // the walk from the top item down, one add a step: r = suffix sum of
    // the items, a = sum of the suffix sums above item 0 (plus the
    // partials' a's in the tail)
    if (first < limit) {
        const long long top = first + n_items - 1;
        *r = fold_item<F>(buckets, part, w, c, slot0, top, limit, tail, false);
        if (tail) *a = fold_item<F>(buckets, part, w, c, slot0, top, limit, tail, true);
        const int S = tail ? 3 : 2;  // a += r; r += r_i; a += a_i
        int k = 0;
        if (!tail && n_items > 1) {
            *a = *r;
            k = 1;
        }
#pragma unroll 1
        for (; k < (n_items - 1) * S; k++) {
            const int i = n_items - 2 - k / S, s = k % S;
            point<F>* const dst = s == 1 ? r : a;
            point<F> y;
            if (s == 0)
                y = *r;
            else
                y = fold_item<F>(buckets, part, w, c, slot0, first + i, limit,
                                 tail, s == 2);
            *dst = rcb_add(*dst, y);
        }
    }
    // levels, each a scale of r to the lanes' span and a warp fold: the
    // lanes of each warp (r = thread span x run), then the warps of the
    // block (r x 32); a partial's r is then scaled to the block's span
    unsigned k = n_items;
    int width = 32;
#pragma unroll 1
    for (;;) {
        *r = scale(*r, k);
        if (width == 1) break;
        warp_fold(r, a, width);
        if (width == 32 && n_warps > 1) {
            __syncthreads();
            if (warp > 0) return;
            if (lane < n_warps) {  // warp 0 takes the warps' lane-0 slots
                *r = R[32 * lane];
                *a = A[32 * lane];
            }
            __syncwarp();
            k = 32;
            width = n_warps;
        } else {
            if (!partial) break;
            k = width == 32 ? 32 : n_warps;
            width = 1;
        }
    }
    if (t != 0) return;
    if (!partial) {
        store_point(out, w, *a);
    } else {
        store_point(part, slot0 + 2LL * blockIdx.x, *r);
        store_point(part, slot0 + 2LL * blockIdx.x + 1, *a);
    }
}

// K6's occupancy: the most blocks of FusedCfg<F>::kThreads an SM that
// ptxas fits without spilling (see the note at the top).
template <class F> struct ScanCfg;
template <> struct ScanCfg<fq> { static constexpr int kMinBlocks = 3; };
template <> struct ScanCfg<fq2> { static constexpr int kMinBlocks = 2; };


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
        const void* buckets, void* out, void* part, int n_win, int c,           \
        int threads, int m, int n_blk, int tail_threads, void* stream) {        \
        if (n_win > 0) {                                                        \
            esn::k_bucket_fold<F><<<dim3(n_blk, n_win), threads, 0,             \
                                    (cudaStream_t)stream>>>(                    \
                (const uint32_t*)buckets, (uint32_t*)out, (uint32_t*)part, c,   \
                m, n_blk, 0);                                                   \
            if (n_blk > 1)                                                      \
                esn::k_bucket_fold<F><<<dim3(1, n_win), tail_threads, 0,        \
                                        (cudaStream_t)stream>>>(                \
                    (const uint32_t*)buckets, (uint32_t*)out, (uint32_t*)part,  \
                    c, m, n_blk, 1);                                            \
        }                                                                       \
        return (int)cudaGetLastError();                                         \
    }                                                                           \
    extern "C" int esn_bucket_fold_blocks_##SUFFIX(int threads) {               \
        int n = 0;                                                              \
        const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(    \
            &n, esn::k_bucket_fold<F>, threads, 0);                             \
        return e == cudaSuccess ? n : -(int)e;                                  \
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
