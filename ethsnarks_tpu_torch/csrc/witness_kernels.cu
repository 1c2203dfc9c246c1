// Hopper (sm_90a) kernels of the QAP witness map, on Fr words.
//
// The witness map (ethsnarks_tpu_torch/qap.py QAP.witness_map) turns the
// witness into the coefficients of H = (A B - C) / Z: three sparse
// mat-vecs, then seven transforms of size m (three inverse, three coset
// forward, one coset inverse) with pointwise steps between them.  The
// reference runs it in XLA (ethsnarks_tpu/qap.py:82 _matvec and :98
// _witness_map_params; ethsnarks_tpu/ops/ntt.py:137 _dif and :171 _dit), so
// no Pallas kernel is replaced.  Two kernels do the whole map on the card:
//
//   K8 csr_matvec_fr  the three mat-vecs in one launch, one thread a row of
//                     the stacked CSR matrices [A with its input rows; B;
//                     C], the row summed lazily below 2r
//   K9 ntt_pass_fr    one pass over the stacked vectors: each block loads a
//                     tile of 2^(t+g) elements of a vector (or of the three)
//                     into shared memory, runs the t radix-2 stages of the
//                     pass's index bits [lo, lo + t) there, and the
//                     pointwise steps fused into the pass, and stores it
//
// Values are plain residues mod r, not Montgomery forms.  The Montgomery
// product of a plain value by a constant in Montgomery form is plain, so
// the coefficients, the twiddles and the coset planes are kept in
// Montgomery form and the witness and H need no conversion.  The one
// product of two plain values, A B on the coset, comes out as A B / R; C
// is brought to C / R by a product with the plain word 1, and the last
// plane (g^-i / m, bit-reversed) carries the factor R / Z(coset).
//
// The passes of one map (ops/witness_words.py pass_plan): the index bits
// are cut into ranges of at most kTileLog bits, the lowest [0, t0).  A DIF
// (natural -> bit-reversed) runs the ranges from the top down, a DIT
// (bit-reversed -> natural) from the bottom up, so the DIF's last pass and
// the next DIT's first pass cover the same tiles and are one launch with
// the coset scale between them; the DIT's last pass, (A B - C) / Z and the
// next DIF's first pass are one launch too.  At m = 2^19 or 2^20 a map is
// four passes, each one read and one write of the vectors, plus K8.
//
// What bounds them on this card: the IMADs of the Fr products (264 an
// 8-word CIOS product, field.cuh).  A butterfly is one product, 64 bytes
// of shared memory read and written and one 32-byte twiddle read (from L2:
// the series is m/2 elements); a pass's global traffic is 64 bytes an
// element.  At 2^20 the seven transforms are 73M products against about
// 0.6 GB moved, so the multiplies bound them by about four to one.  The
// design: the stages of a pass stay in shared memory (structure of
// arrays, word w of element e at w * tile + e, so neighbouring threads hit
// neighbouring banks), every launch has thousands of blocks, and each
// element crosses device memory once a pass.  K8 is a gather (32 bytes of
// witness a term at a random column) beside its products.
//
// Every word a kernel stores is canonical (below r), so the map's output
// equals the plain version's bit for bit.  Every launcher returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

namespace esn {

constexpr int kWmThreads = 256;
// the most elements of one vector a K9 block holds: 2^kTileLog (32 KB)
constexpr int kTileLog = 10;

// K9's steps, run in this order where their bits are set
enum NttStep {
    kDifIn = 1,    // DIF stages of the range (inverse twiddles)
    kScale = 2,    // times the coset scale plane
    kDit = 4,      // DIT stages of the range (forward twiddles)
    kCombine = 8,  // three vectors (A, B, C) -> (A B - C) / R
    kDifOut = 16,  // DIF stages on the combined vector
    kUnscale = 32  // times the coset unscale plane
};

__device__ __forceinline__ fr fr_load(const uint32_t* base, long long i) {
    const uint4* p = reinterpret_cast<const uint4*>(base) + 2 * i;
    uint4 a = p[0], b = p[1];
    return fr{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

// read-only data of the whole launch (coefficients, witness, constants)
__device__ __forceinline__ fr fr_ldg(const uint32_t* base, long long i) {
    const uint4* p = reinterpret_cast<const uint4*>(base) + 2 * i;
    uint4 a = __ldg(p), b = __ldg(p + 1);
    return fr{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

__device__ __forceinline__ void fr_store(uint32_t* base, long long i,
                                         const fr& a) {
    uint4* p = reinterpret_cast<uint4*>(base) + 2 * i;
    p[0] = make_uint4(a.w[0], a.w[1], a.w[2], a.w[3]);
    p[1] = make_uint4(a.w[4], a.w[5], a.w[6], a.w[7]);
}

// ---- K8 ----

__global__ void __launch_bounds__(kWmThreads)
    k_csr_matvec_fr(const int64_t* row_ptr, const int32_t* cols,
                    const uint32_t* coeffs, const uint32_t* w, uint32_t* out,
                    int n_rows) {
    int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n_rows) return;
    fr acc = {{0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}};
    long long end = row_ptr[r + 1];
    for (long long j = row_ptr[r]; j < end; j++)
        acc = fr_add(acc,
                     fr_mul(fr_ldg(coeffs, j), fr_ldg(w, __ldg(cols + j))));
    fr_store(out, r, fr_canon(acc));
}

// ---- K9 ----

// Where a block's tile lies in its vector of m = 2^k elements.  The tile
// holds every index with the block's bits outside [lo, lo + t) and the g
// column bits, which are [0, g) when lo > 0 (so a tile reads runs of 2^g
// neighbouring elements) and [t, t + g) when lo = 0 (the tile is then
// contiguous).
struct NttShape {
    int k, lo, t, g;

    __device__ __forceinline__ long long fixed(int bx) const {
        if (lo == 0) return (long long)bx << (t + g);
        int n1 = lo - g;
        return ((long long)(bx & ((1 << n1) - 1)) << g) |
               ((long long)(bx >> n1) << (lo + t));
    }
    // index in the vector of the tile's element e
    __device__ __forceinline__ long long index(long long base, int e) const {
        if (lo == 0) return base + e;
        return base + ((long long)(e >> g) << lo) + (e & ((1 << g) - 1));
    }
    // bit of e that holds index bit lo + c
    __device__ __forceinline__ int local_bit(int c) const {
        return lo == 0 ? c : g + c;
    }
};

__device__ __forceinline__ fr sh_get(const uint32_t* s, int tile, int e) {
    fr a;
#pragma unroll
    for (int w = 0; w < 8; w++) a.w[w] = s[w * tile + e];
    return a;
}

__device__ __forceinline__ void sh_put(uint32_t* s, int tile, int e,
                                       const fr& a) {
#pragma unroll
    for (int w = 0; w < 8; w++) s[w * tile + e] = a.w[w];
}

// The stages of the pass's range on nv tiles, DIF (u, v) -> (u + v,
// (u - v) w) from the top bit down or DIT (u, v) -> (u + v w, u - v w)
// from the bottom bit up.  The twiddle of index bit b for the pair's lower
// index i is series[(i mod 2^b) << (k - 1 - b)], as ops/ntt.py's
// stage_twiddles slices it.
template <bool kDif>
__device__ void ntt_stages(uint32_t* sh, int nv, int tile_log,
                           const NttShape& s, long long base,
                           const uint32_t* series) {
    const int tile = 1 << tile_log, half = tile >> 1;
    for (int cc = 0; cc < s.t; cc++) {
        const int c = kDif ? s.t - 1 - cc : cc;
        const int pb = s.local_bit(c), b = s.lo + c;
        const long long jmask = (1LL << b) - 1;
        const int shift = s.k - 1 - b;
        for (int q = threadIdx.x; q < nv * half; q += blockDim.x) {
            int p = q & (half - 1);
            uint32_t* pl = sh + (size_t)(q >> (tile_log - 1)) * 8 * tile;
            int e = ((p >> pb) << (pb + 1)) | (p & ((1 << pb) - 1));
            int e2 = e + (1 << pb);
            fr u = sh_get(pl, tile, e), v = sh_get(pl, tile, e2);
            fr w = fr_ldg(series, (s.index(base, e) & jmask) << shift);
            if (kDif) {
                sh_put(pl, tile, e, fr_add(u, v));
                sh_put(pl, tile, e2, fr_mul(fr_sub(u, v), w));
            } else {
                fr vw = fr_mul(v, w);
                sh_put(pl, tile, e, fr_add(u, vw));
                sh_put(pl, tile, e2, fr_sub(u, vw));
            }
        }
        __syncthreads();
    }
}

// Each element of nv tiles times plane[its index].
__device__ void ntt_scale(uint32_t* sh, int nv, int tile_log,
                          const NttShape& s, long long base,
                          const uint32_t* plane) {
    const int tile = 1 << tile_log;
    for (int q = threadIdx.x; q < nv << tile_log; q += blockDim.x) {
        int e = q & (tile - 1);
        uint32_t* pl = sh + (size_t)(q >> tile_log) * 8 * tile;
        sh_put(pl, tile, e,
               fr_mul(sh_get(pl, tile, e), fr_ldg(plane, s.index(base, e))));
    }
    __syncthreads();
}

__global__ void __launch_bounds__(kWmThreads, 2)
    k_ntt_pass_fr(const uint32_t* x, uint32_t* out, const uint32_t* tw_inv,
                  const uint32_t* tw_fwd, const uint32_t* scale,
                  const uint32_t* unscale, NttShape s, int steps) {
    extern __shared__ uint32_t sh[];
    const int tile_log = s.t + s.g, tile = 1 << tile_log;
    const long long m = 1LL << s.k;
    int nv = (steps & kCombine) ? 3 : 1;
    const long long base = s.fixed(blockIdx.x);
    const long long v0 = (long long)blockIdx.y * nv;
    for (int q = threadIdx.x; q < nv << tile_log; q += blockDim.x) {
        int e = q & (tile - 1);
        sh_put(sh + (size_t)(q >> tile_log) * 8 * tile, tile, e,
               fr_load(x, (v0 + (q >> tile_log)) * m + s.index(base, e)));
    }
    __syncthreads();
    if (steps & kDifIn) ntt_stages<true>(sh, nv, tile_log, s, base, tw_inv);
    if (steps & kScale) ntt_scale(sh, nv, tile_log, s, base, scale);
    if (steps & kDit) ntt_stages<false>(sh, nv, tile_log, s, base, tw_fwd);
    if (steps & kCombine) {
        const fr one = {{1u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}};
        for (int e = threadIdx.x; e < tile; e += blockDim.x) {
            fr ab = fr_mul(sh_get(sh, tile, e), sh_get(sh + 8 * tile, tile, e));
            fr c = fr_mul(sh_get(sh + 16 * tile, tile, e), one);
            sh_put(sh, tile, e, fr_sub(ab, c));
        }
        nv = 1;
        __syncthreads();
    }
    if (steps & kDifOut) ntt_stages<true>(sh, nv, tile_log, s, base, tw_inv);
    if (steps & kUnscale) ntt_scale(sh, nv, tile_log, s, base, unscale);
    // one tile leaves the block: output vector blockIdx.y
    for (int e = threadIdx.x; e < tile; e += blockDim.x)
        fr_store(out, (long long)blockIdx.y * m + s.index(base, e),
                 fr_canon(sh_get(sh, tile, e)));
}

}  // namespace esn

extern "C" int esn_csr_matvec_fr(const void* row_ptr, const void* cols,
                                 const void* coeffs, const void* w, void* out,
                                 int n_rows, void* stream) {
    if (n_rows > 0)
        esn::k_csr_matvec_fr<<<(n_rows + esn::kWmThreads - 1) /
                                   esn::kWmThreads,
                               esn::kWmThreads, 0, (cudaStream_t)stream>>>(
            (const int64_t*)row_ptr, (const int32_t*)cols,
            (const uint32_t*)coeffs, (const uint32_t*)w, (uint32_t*)out,
            n_rows);
    return (int)cudaGetLastError();
}

// One pass over n_groups groups of vectors (a group is three vectors with
// kCombine, else one) of m = 2^k elements: 2^(k - t - g) blocks a group.
extern "C" int esn_ntt_pass_fr(const void* x, void* out, const void* tw_inv,
                               const void* tw_fwd, const void* scale,
                               const void* unscale, int k, int lo, int t,
                               int g, int n_groups, int steps, void* stream) {
    esn::NttShape s{k, lo, t, g};
    int nv = (steps & esn::kCombine) ? 3 : 1;
    size_t smem = (size_t)nv * 32 << (t + g);
    cudaFuncSetAttribute(esn::k_ntt_pass_fr,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         3 * 32 << esn::kTileLog);
    dim3 grid(1u << (k - t - g), n_groups);
    esn::k_ntt_pass_fr<<<grid, esn::kWmThreads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)out, (const uint32_t*)tw_inv,
        (const uint32_t*)tw_fwd, (const uint32_t*)scale,
        (const uint32_t*)unscale, s, steps);
    return (int)cudaGetLastError();
}
