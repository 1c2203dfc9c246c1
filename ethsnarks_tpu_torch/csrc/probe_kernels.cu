// Hopper (sm_90a) throughput probe of one 32-bit operation.
//
// K7 int_probe <- tools/probe_vpu.py mk_kernel (:25): a fori_loop(ITERS)
// over a chain of CHAIN = 16 applications a <- op(a, b) on a (32, 1024)
// block in VMEM.  Here every thread runs the chain on its own element, on
// enough elements to fill every SM, and the rate is elements * iters * 16
// chain steps over the kernel's time.
//
// Ops (the seven of probe_vpu.py:44-52, and the 32x32 -> 64-bit product
// that the field core csrc/field.cuh is built on):
//   0 u32_mul        a * b
//   1 u32_add        a + b
//   2 u32_mul_add    a * b + b
//   3 u32_shr13_and  (a >> 13) & 8191
//   4 u32_cmp_sel    a > b ? a : b
//   5 i32_mul        a * b (signed, wrapping)
//   6 f32_fma        a * b + b in float32, one rounding (fma.rn)
//   7 u32_mul_wide   p = a * b as 64 bits; a = lo(p) ^ hi(p)
// Each step is inline PTX (asm volatile), so the compiler neither folds a
// chain (a product chain would be reassociated into powers of b) nor drops
// it: the card executes what the reference's kernel asks for.  The shift
// chain is 0 after two steps, and ptxas removed it even as inline PTX (on
// an H100 it ran at 6.3e14 steps/s, beyond any issue rate), so its shift
// (13) and mask (8191) are kernel arguments, values the compiler cannot
// see.
//
// What bounds it: the issue rate of the op's instructions, by design; the
// 8 bytes read and 4 written per element are negligible beside
// iters * 16 operations.
//
// K7b fq_chain: the latency of one dependent Fq product on a lone lane,
// t_fq, the unit of the latency floor of the serial chains K2 and K3
// (ethsnarks_tpu_torch/cost.py): every thread runs x <- x y (field.cuh's
// product) iters times on its own element and writes x canonical.  Timed
// on one thread, it is iters products, each waiting on the one before.
//
// The launchers return cudaGetLastError() after the launch (an unknown op
// is cudaErrorInvalidValue); the Python wrapper raises on a non-zero value.

#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

namespace esn {

constexpr int kProbeThreads = 256;
constexpr int kProbeChain = 16;

template <int OP>
__device__ __forceinline__ uint32_t probe_op(uint32_t a, uint32_t b, uint32_t sh,
                                             uint32_t mask) {
    if constexpr (OP == 0) {
        asm volatile("mul.lo.u32 %0, %0, %1;" : "+r"(a) : "r"(b));
    } else if constexpr (OP == 1) {
        asm volatile("add.u32 %0, %0, %1;" : "+r"(a) : "r"(b));
    } else if constexpr (OP == 2) {
        asm volatile("mad.lo.u32 %0, %0, %1, %1;" : "+r"(a) : "r"(b));
    } else if constexpr (OP == 3) {
        asm volatile("shr.u32 %0, %0, %1;\n\tand.b32 %0, %0, %2;"
                     : "+r"(a) : "r"(sh), "r"(mask));
    } else if constexpr (OP == 4) {
        asm volatile("{\n\t.reg .pred p;\n\tsetp.gt.u32 p, %0, %1;\n\t"
                     "selp.b32 %0, %0, %1, p;\n\t}" : "+r"(a) : "r"(b));
    } else if constexpr (OP == 5) {
        asm volatile("mul.lo.s32 %0, %0, %1;" : "+r"(a) : "r"(b));
    } else if constexpr (OP == 6) {
        float x = __uint_as_float(a);
        asm volatile("fma.rn.f32 %0, %0, %1, %1;" : "+f"(x) : "f"(__uint_as_float(b)));
        a = __float_as_uint(x);
    } else {
        asm volatile("{\n\t.reg .u64 p;\n\t.reg .u32 lo, hi;\n\t"
                     "mul.wide.u32 p, %0, %1;\n\tmov.b64 {lo, hi}, p;\n\t"
                     "xor.b32 %0, lo, hi;\n\t}" : "+r"(a) : "r"(b));
    }
    return a;
}

template <int OP>
__global__ void __launch_bounds__(kProbeThreads)
k_int_probe(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
            uint32_t* __restrict__ out, int n, int iters, uint32_t sh,
            uint32_t mask) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t a = x[i];
    const uint32_t b = y[i];
#pragma unroll 1
    for (int it = 0; it < iters; it++) {
#pragma unroll
        for (int k = 0; k < kProbeChain; k++) a = probe_op<OP>(a, b, sh, mask);
    }
    out[i] = a;
}

template <int OP>
int launch_probe(const void* x, const void* y, void* out, int n, int iters,
                 cudaStream_t stream) {
    if (n > 0)
        k_int_probe<OP><<<(n + kProbeThreads - 1) / kProbeThreads, kProbeThreads, 0,
                          stream>>>((const uint32_t*)x, (const uint32_t*)y,
                                    (uint32_t*)out, n, iters, 13u, 8191u);
    return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(kProbeThreads)
k_fq_chain(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
           uint32_t* __restrict__ out, int n, int iters) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    fq a, b;
    const uint4* xs = reinterpret_cast<const uint4*>(x) + 2 * (long long)i;
    const uint4* ys = reinterpret_cast<const uint4*>(y) + 2 * (long long)i;
    reinterpret_cast<uint4*>(&a)[0] = xs[0];
    reinterpret_cast<uint4*>(&a)[1] = xs[1];
    reinterpret_cast<uint4*>(&b)[0] = ys[0];
    reinterpret_cast<uint4*>(&b)[1] = ys[1];
#pragma unroll 1
    for (int it = 0; it < iters; it++) a = fq_mul(a, b);
    a = fq_canon(a);
    uint4* dst = reinterpret_cast<uint4*>(out) + 2 * (long long)i;
    dst[0] = reinterpret_cast<const uint4*>(&a)[0];
    dst[1] = reinterpret_cast<const uint4*>(&a)[1];
}

}  // namespace esn

extern "C" int esn_fq_chain(const void* x, const void* y, void* out, int n,
                            int iters, void* stream) {
    if (n > 0)
        esn::k_fq_chain<<<(n + esn::kProbeThreads - 1) / esn::kProbeThreads,
                          esn::kProbeThreads, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)out, n, iters);
    return (int)cudaGetLastError();
}

extern "C" int esn_int_probe(int op, const void* x, const void* y, void* out, int n,
                             int iters, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (op) {
        case 0: return esn::launch_probe<0>(x, y, out, n, iters, s);
        case 1: return esn::launch_probe<1>(x, y, out, n, iters, s);
        case 2: return esn::launch_probe<2>(x, y, out, n, iters, s);
        case 3: return esn::launch_probe<3>(x, y, out, n, iters, s);
        case 4: return esn::launch_probe<4>(x, y, out, n, iters, s);
        case 5: return esn::launch_probe<5>(x, y, out, n, iters, s);
        case 6: return esn::launch_probe<6>(x, y, out, n, iters, s);
        case 7: return esn::launch_probe<7>(x, y, out, n, iters, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
