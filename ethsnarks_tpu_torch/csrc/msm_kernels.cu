// Hopper (sm_90a) point kernels of the Pippenger MSM.
//
// Three templates, each instantiated for G1 (Fq) and G2 (Fq2), replace the
// eight Pallas kernels of the TPU's dense red-core MSM:
//
//   K1 point_add    <- ethsnarks_tpu/ops/msm_red.py _g1_add_kernel_red (:171)
//                      and _g2_add_kernel_red (:193)
//   K2 point_double <- _g1_double_kernel_red (:249), _g2_double_kernel_red (:268)
//                      (2^n P in one launch)
//   K3 horner       <- _k_horner_all_red (:412), _k_horner_all_red_g2 (:515),
//                      _k_double_n_add_red (:454), _k_double_n_add_red_g2 (:481)
//                      (2^n P + Q is horner over the two windows [Q, P], c = n)
//
// K2 and K3 are serial chains on the MSM's paths (K3 combines the windows
// of one accumulator: 255 point steps at 2^20 points; K2 doubles one
// accumulator c times a window): no batch to fill the card, so what
// bounds them is the latency of a step, not the IMADs.  Each runs on the
// team step of curve.cuh (a quarter warp on G1, a warp on G2, one Fq
// product a lane, so a step costs the latency of its 2 (G1) or 3 (G2)
// levels of products).  K2 keeps one thread a point for a batch that
// fills the card (kernels.double_team chooses).
//
// What bounds them on this card: integer multiplies.  A G1 add is 12 Fq
// products; each is 128 wide (32x32 -> 64, two IMADs) and 8 low (one IMAD)
// products, 264 IMADs, 3168 per add (G1 double 2000 with its two
// squarings at 208; G2 add 11088; G2 double 6600 counting its two Fq2
// squarings at 2 Fq products, where these kernels spend 3), against
// 96 + 96 read and 96 written bytes per G1 add: at ~16.7e12 32-bit IMAD/s
// and 3.35 TB/s the multiplies take about twice as long as the bytes.
// The design follows:
// one thread per output point keeps the whole formula in registers (no
// shared memory, no intermediate ever reaches device memory), points move
// as 16-byte vector loads, and K1 gathers its operands through optional
// index tensors so the MSM's segmented bucket sums and the pairfold never
// materialise gathered copies.  No tensor cores: the work is 32-bit
// integer carries, not a matrix product.
//
// K1 carries the MSM's bucket sums and pairfold, the dense MSM's
// halving tree and the scan carries, so its cost is the field product's
// (field.cuh: carry-chained PTX, one IMAD.WIDE per wide product, lazy
// reduction) and how many warps hide the latency of the product's carry
// chains.  Its occupancy (AddCfg) is the most blocks of 128 threads an SM
// that ptxas fits without spilling: G1 4 blocks, 128 registers, 0 bytes
// of stack and spills (5 blocks: 96 registers, 28 bytes of spills); G2 2
// blocks, 255 registers, 0 bytes of stack and spills (3 blocks: 168
// registers, 316 bytes of spills, and slower on an H100).  A G2 add holds
// both operands (96 registers) and up to six Fq2 intermediates besides
// the product's own state, so 2 blocks is as far as G2 goes.
//
// Every launcher returns cudaGetLastError() after the launch; the Python
// wrapper raises on a non-zero value.  The setup's K4 (setup_kernels.cu)
// and the fused and scan MSMs' K5 and K6 (msm_fused_kernels.cu) are
// included at the end, so every point kernel of the port is one library
// (the probe K7, probe_kernels.cu, is a second one).

#include <cuda_runtime.h>
#include <stdint.h>

#include "curve.cuh"

namespace esn {

constexpr int kThreads = 128;

// K1's occupancy: threads a block, and the most blocks an SM that ptxas
// fits without spilling (see the note at the top).
template <class F> struct AddCfg;
template <> struct AddCfg<fq> {
    static constexpr int kThreads = 128, kMinBlocks = 4;
};
template <> struct AddCfg<fq2> {
    static constexpr int kThreads = 128, kMinBlocks = 2;
};

// out[i] = P[ia[i]] + Q[ib[i]]; ia == nullptr means i, ib == nullptr means
// i; ib[i] < 0 passes P[ia[i]] through unchanged.
template <class F>
__global__ void __launch_bounds__(AddCfg<F>::kThreads, AddCfg<F>::kMinBlocks)
k_point_add(const uint32_t* __restrict__ P, const uint32_t* __restrict__ Q,
            const int64_t* __restrict__ ia, const int64_t* __restrict__ ib,
            uint32_t* __restrict__ out, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    long long a = ia ? ia[i] : i;
    long long b = ib ? ib[i] : i;
    point<F> p = load_point<point<F>>(P, a);
    if (b >= 0) p = rcb_add(p, load_point<point<F>>(Q, b));
    store_point(out, i, p);
}

// K2, one thread a point: out[i] = 2^n_dbl P[i] (the path of a large
// batch, where the card has a warp a scheduler or more without teams).
template <class F>
__global__ void __launch_bounds__(kThreads)
k_point_double(const uint32_t* __restrict__ P, uint32_t* __restrict__ out,
               int n, int n_dbl) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    point<F> p = load_point<point<F>>(P, i);
    for (int k = 0; k < n_dbl; k++) p = rcb_double(p);
    store_point(out, i, p);
}

// The team kernels: blocks of one warp, 32 / kLanes teams a block (G1 4,
// G2 1), one team a point.  A spare team of the last block repeats the
// last point and stores nothing, so every __syncwarp has the whole warp.
constexpr int kTeamThreads = 32;

template <class F> struct TeamGrid {
    static constexpr int kTeams = kTeamThreads / TeamCfg<F>::kLanes;
};

// K2 on teams: out[i] = 2^n_dbl P[i] (the path of the 1-16 lanes the MSM
// drivers give K2).
template <class F>
__global__ void __launch_bounds__(kTeamThreads)
k_point_double_team(const uint32_t* __restrict__ P, uint32_t* __restrict__ out,
                    int n, int n_dbl) {
    constexpr int T = TeamCfg<F>::kLanes, NS = TeamSlots<F>::kFq;
    __shared__ fq smem[TeamGrid<F>::kTeams * NS];
    const int t = threadIdx.x / T, j = threadIdx.x % T;
    const int i = blockIdx.x * TeamGrid<F>::kTeams + t;
    fq* s = smem + t * NS;
    team_init<F>(s, j);
    if (j < TeamSlots<F>::kVec)
        team_put<F>(s, slot::X, j, team_fetch<F>(P, min(i, n - 1), j));
    __syncwarp();
    for (int k = 0; k < n_dbl; k++) team_double<F>(s, j);
    if (i < n) team_store<F>(out, i, s, j);
}

// K3: W: (n_win, batch) points, window 0 least significant.  One team per
// accumulator: acc = W[n_win-1]; for w = n_win-2 .. 0: acc = 2^c acc +
// W[w].  Each window's point is loaded into registers before its c
// doublings and put into the team's slots for the add.
template <class F>
__global__ void __launch_bounds__(kTeamThreads)
k_horner(const uint32_t* __restrict__ W, uint32_t* __restrict__ out,
         int n_win, int batch, int c) {
    constexpr int T = TeamCfg<F>::kLanes, NS = TeamSlots<F>::kFq;
    constexpr int V = TeamSlots<F>::kVec;
    __shared__ fq smem[TeamGrid<F>::kTeams * NS];
    const int t = threadIdx.x / T, j = threadIdx.x % T;
    const int acc = blockIdx.x * TeamGrid<F>::kTeams + t;
    const long long a = min(acc, batch - 1);
    fq* s = smem + t * NS;
    team_init<F>(s, j);
    if (j < V)
        team_put<F>(s, slot::X, j,
                    team_fetch<F>(W, (long long)(n_win - 1) * batch + a, j));
    __syncwarp();
    for (int w = n_win - 2; w >= 0; w--) {
        uint4 q = make_uint4(0, 0, 0, 0);
        if (j < V) q = team_fetch<F>(W, (long long)w * batch + a, j);
        for (int k = 0; k < c; k++) team_double<F>(s, j);
        if (j < V) team_put<F>(s, slot::QX, j, q);
        __syncwarp();
        team_add<F>(s, j);
    }
    if (acc < batch) team_store<F>(out, acc, s, j);
}

inline int blocks(int n, int threads = kThreads) {
    return (n + threads - 1) / threads;
}

}  // namespace esn

using esn::fq;
using esn::fq2;

#define ESN_LAUNCHERS(SUFFIX, F)                                                \
    extern "C" int esn_point_add_##SUFFIX(const void* P, const void* Q,         \
                                          const void* ia, const void* ib,       \
                                          void* out, int n, void* stream) {     \
        if (n > 0)                                                              \
            esn::k_point_add<F><<<esn::blocks(n, esn::AddCfg<F>::kThreads),    \
                                  esn::AddCfg<F>::kThreads, 0,                  \
                                  (cudaStream_t)stream>>>(                      \
                (const uint32_t*)P, (const uint32_t*)Q, (const int64_t*)ia,     \
                (const int64_t*)ib, (uint32_t*)out, n);                         \
        return (int)cudaGetLastError();                                         \
    }                                                                           \
    extern "C" int esn_point_double_##SUFFIX(const void* P, void* out, int n,   \
                                             int n_dbl, int team,               \
                                             void* stream) {                    \
        if (n > 0 && team)                                                      \
            esn::k_point_double_team<F>                                         \
                <<<esn::blocks(n, esn::TeamGrid<F>::kTeams),                   \
                   esn::kTeamThreads, 0,                                        \
                   (cudaStream_t)stream>>>((const uint32_t*)P, (uint32_t*)out,  \
                                           n, n_dbl);                           \
        else if (n > 0)                                                         \
            esn::k_point_double<F><<<esn::blocks(n), esn::kThreads, 0,          \
                                     (cudaStream_t)stream>>>(                   \
                (const uint32_t*)P, (uint32_t*)out, n, n_dbl);                  \
        return (int)cudaGetLastError();                                         \
    }                                                                           \
    extern "C" int esn_horner_##SUFFIX(const void* W, void* out, int n_win,     \
                                       int batch, int c, void* stream) {        \
        if (batch > 0)                                                          \
            esn::k_horner<F><<<esn::blocks(batch, esn::TeamGrid<F>::kTeams),    \
                               esn::kTeamThreads, 0, (cudaStream_t)stream>>>(   \
                (const uint32_t*)W, (uint32_t*)out, n_win, batch, c);           \
        return (int)cudaGetLastError();                                         \
    }

ESN_LAUNCHERS(g1, fq)
ESN_LAUNCHERS(g2, fq2)

// K4 fixed_base_mul of the setup: its own source, built into this library.
#include "setup_kernels.cu"

// K5 bucket_fold and K6 seg_scan of the fused and scan MSMs: their own
// source, built into this library.
#include "msm_fused_kernels.cu"
