// Hopper (sm_90a) fixed-base batch multiplication of the Groth16 setup.
//
// K4 fixed_base_mul, instantiated for G1 (Fq) and G2 (Fq2), replaces the
// Pallas add kernels that the reference's setup batch exponentiation
// (ethsnarks_tpu/ops/batch_exp.py:116-185) runs its window tree on:
//
//   K4 fixed_base_mul_g1 <- ethsnarks_tpu/ops/pallas_ops.py _g1_add_kernel (:230)
//   K4 fixed_base_mul_g2 <- ethsnarks_tpu/ops/pallas_ops.py _g2_add_kernel (:456)
//
// out[i] = s_i * base from a window table of the base: entry w*2^c + d is
// d * 2^(c*w) * base (entry w*2^c, the identity, is never read).  One
// thread per scalar walks the windows, least significant first; the first
// nonzero digit loads its table point, every later one adds its table point
// into the projective accumulator with the complete RCB15 add of
// curve.cuh.  A zero scalar gives the identity (0, 1, 0).  The plain
// version (ops/curve.py fixed_base_plain) runs the same sequence, so the two
// agree bit for bit.
//
// What bounds it: integer multiplies, as K1 (3168 IMADs per G1 add, 11088
// per G2 add, about 31 adds per uniform 254-bit scalar at c = 8), against
// 32 bytes read and 96 or 192 written per scalar.  The reference gathers
// every window's table point into a (windows x n) tensor and reduces it in
// a tree of five add launches; here the gather and the reduction are one
// launch and no intermediate point reaches device memory.  The table
// (8,192 points: 786 KB on G1, 1.5 MB on G2) stays resident in the 50 MB
// L2.  The window loop is not unrolled: one inlined add per kernel.
//
// Every launcher returns cudaGetLastError() after the launch; the Python
// wrapper raises on a non-zero value.  This file is not compiled on its
// own: msm_kernels.cu includes it, so K1-K4 are one library.

#include <cuda_runtime.h>
#include <stdint.h>

#include "curve.cuh"

namespace esn {

constexpr int kSetupThreads = 128;

// table: (n_win << c) points; scalars: (n, 8) little-endian 32-bit words.
template <class F>
__global__ void __launch_bounds__(kSetupThreads)
k_fixed_base_mul(const uint32_t* __restrict__ table,
                 const uint32_t* __restrict__ scalars,
                 uint32_t* __restrict__ out, int n, int n_win, int c) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t s[9];
    const uint4* src = reinterpret_cast<const uint4*>(scalars) + 2LL * i;
    uint4 lo = __ldg(src), hi = __ldg(src + 1);
    s[0] = lo.x; s[1] = lo.y; s[2] = lo.z; s[3] = lo.w;
    s[4] = hi.x; s[5] = hi.y; s[6] = hi.z; s[7] = hi.w;
    s[8] = 0;
    const uint32_t mask = (1u << c) - 1u;
    point<F> acc;
    set_identity(acc);
    bool started = false;
#pragma unroll 1
    for (int w = 0; w < n_win; w++) {
        int bit = w * c;
        int i0 = bit >> 5, sh = bit & 31;
        if (i0 >= 8) break;
        uint32_t d = s[i0] >> sh;
        if (sh + c > 32) d |= s[i0 + 1] << (32 - sh);
        d &= mask;
        if (d == 0) continue;
        point<F> t = load_point<point<F>>(table, ((long long)w << c) + d);
        if (started) {
            acc = rcb_add(acc, t);
        } else {
            acc = t;
            started = true;
        }
    }
    store_point(out, i, acc);
}

inline int setup_blocks(int n) { return (n + kSetupThreads - 1) / kSetupThreads; }

}  // namespace esn

using esn::fq;
using esn::fq2;

#define ESN_SETUP_LAUNCHER(SUFFIX, F)                                          \
    extern "C" int esn_fixed_base_mul_##SUFFIX(const void* table,              \
                                               const void* scalars, void* out, \
                                               int n, int n_win, int c,        \
                                               void* stream) {                 \
        if (n > 0)                                                             \
            esn::k_fixed_base_mul<F><<<esn::setup_blocks(n),                   \
                                       esn::kSetupThreads, 0,                  \
                                       (cudaStream_t)stream>>>(                \
                (const uint32_t*)table, (const uint32_t*)scalars,              \
                (uint32_t*)out, n, n_win, c);                                  \
        return (int)cudaGetLastError();                                        \
    }

ESN_SETUP_LAUNCHER(g1, fq)
ESN_SETUP_LAUNCHER(g2, fq2)
