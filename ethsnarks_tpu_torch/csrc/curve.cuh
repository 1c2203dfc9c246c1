// Complete projective BN254 G1/G2 formulas for the Hopper kernels.
//
// Renes-Costello-Batina 2015 algorithms 7 (add) and 9 (double) for a = 0,
// the same sequence as ethsnarks_tpu/ops/fp_red.py g1_add_red / g2_add_red
// (:356-503) and the plain twins in ethsnarks_tpu_torch/ops/curve.py.
// G1 coordinates are Fq with 3b = 9; G2 coordinates are Fq2 = Fq[u]/(u^2+1)
// with 3 * b_twist.  Complete: identity (0, 1, 0), P + P and P + (-P) need
// no branches.  Every field operation is inlined (each Fq operation is one
// PTX block, field.cuh), so the G2 formulas keep their values in
// registers; coordinates between the steps are lazily reduced (< 2q) and
// store_point writes them canonical.

#pragma once
#include "field.cuh"

namespace esn {

struct alignas(16) fq2 {
    fq c0, c1;
};

__device__ __forceinline__ fq f_add(const fq& a, const fq& b) { return fq_add(a, b); }
__device__ __forceinline__ fq f_sub(const fq& a, const fq& b) { return fq_sub(a, b); }
__device__ __forceinline__ fq f_mul(const fq& a, const fq& b) { return fq_mul(a, b); }
__device__ __forceinline__ fq f_mul_b3(const fq& a) {
    fq a2 = fq_add(a, a);
    fq a4 = fq_add(a2, a2);
    return fq_add(fq_add(a4, a4), a);  // 9a
}

__device__ __forceinline__ fq2 f_add(const fq2& a, const fq2& b) {
    return {fq_add(a.c0, b.c0), fq_add(a.c1, b.c1)};
}
__device__ __forceinline__ fq2 f_sub(const fq2& a, const fq2& b) {
    return {fq_sub(a.c0, b.c0), fq_sub(a.c1, b.c1)};
}
__device__ __forceinline__ fq2 f_mul(const fq2& a, const fq2& b) {
    // Karatsuba: three Fq products
    fq m0 = fq_mul(a.c0, b.c0);
    fq m1 = fq_mul(a.c1, b.c1);
    fq m2 = fq_mul(fq_add(a.c0, a.c1), fq_add(b.c0, b.c1));
    return {fq_sub(m0, m1), fq_sub(fq_sub(m2, m0), m1)};
}
// 3 * b_twist = 9 / (9 + u), Montgomery words of (c0, c1).
__device__ __forceinline__ fq2 f_mul_b3(const fq2& a) {
    const fq2 b3 = {{{0xb62e0d6au, 0x3baa927cu, 0xd1b664fdu, 0xd71e7c52u,
                      0xd95d4664u, 0x03873e63u, 0x082ab8f4u, 0x0e75b5b1u}},
                    {{0x7596fe35u, 0xaab7c666u, 0xbb6a27bau, 0x31d21a78u,
                      0x680401ffu, 0x85dd7297u, 0xdf39a7e9u, 0x03c52d6au}}};
    return f_mul(a, b3);
}

template <class F>
struct alignas(16) point {
    F x, y, z;
};

template <class F>
__device__ __forceinline__ point<F> rcb_add(const point<F>& p, const point<F>& q) {
    F t0 = f_mul(p.x, q.x);
    F t1 = f_mul(p.y, q.y);
    F t2 = f_mul(p.z, q.z);
    F t3 = f_mul(f_add(p.x, p.y), f_add(q.x, q.y));
    F t4 = f_add(t0, t1);
    t3 = f_sub(t3, t4);
    t4 = f_mul(f_add(p.y, p.z), f_add(q.y, q.z));
    F x3 = f_add(t1, t2);
    t4 = f_sub(t4, x3);
    x3 = f_mul(f_add(p.x, p.z), f_add(q.x, q.z));
    F y3 = f_add(t0, t2);
    y3 = f_sub(x3, y3);
    x3 = f_add(t0, t0);
    t0 = f_add(x3, t0);
    t2 = f_mul_b3(t2);
    F z3 = f_add(t1, t2);
    t1 = f_sub(t1, t2);
    y3 = f_mul_b3(y3);
    x3 = f_mul(t4, y3);
    t2 = f_mul(t3, t1);
    x3 = f_sub(t2, x3);
    y3 = f_mul(y3, t0);
    t1 = f_mul(t1, z3);
    y3 = f_add(t1, y3);
    t0 = f_mul(t0, t3);
    z3 = f_mul(z3, t4);
    z3 = f_add(z3, t0);
    return {x3, y3, z3};
}

template <class F>
__device__ __forceinline__ point<F> rcb_double(const point<F>& p) {
    F t0 = f_mul(p.y, p.y);
    F z3 = f_add(t0, t0);
    z3 = f_add(z3, z3);
    z3 = f_add(z3, z3);
    F t1 = f_mul(p.y, p.z);
    F t2 = f_mul(p.z, p.z);
    t2 = f_mul_b3(t2);
    F x3 = f_mul(t2, z3);
    F y3 = f_add(t0, t2);
    z3 = f_mul(t1, z3);
    t1 = f_add(t2, t2);
    t2 = f_add(t1, t2);
    t0 = f_sub(t0, t2);
    y3 = f_mul(t0, y3);
    y3 = f_add(x3, y3);
    t1 = f_mul(p.x, p.y);
    x3 = f_mul(t0, t1);
    x3 = f_add(x3, x3);
    return {x3, y3, z3};
}

// The identity (0, 1, 0) in Montgomery words.
__device__ __forceinline__ void set_identity(point<fq>& p) {
    p.x = fq{};
    p.y = fq_one();
    p.z = fq{};
}

__device__ __forceinline__ void set_identity(point<fq2>& p) {
    p.x = fq2{};
    p.y = fq2{fq_one(), fq{}};
    p.z = fq2{};
}

// Point i of a contiguous (n, 3[, 2], 8) word tensor, moved as 16-byte
// vectors (rows are 96 or 192 bytes, so every row start is 16-aligned).
template <class P>
__device__ __forceinline__ P load_point(const uint32_t* base, long long i) {
    constexpr int V = sizeof(P) / 16;
    const uint4* src = reinterpret_cast<const uint4*>(base) + i * V;
    P p;
    uint4* dst = reinterpret_cast<uint4*>(&p);
#pragma unroll
    for (int k = 0; k < V; k++) dst[k] = __ldg(src + k);
    return p;
}

__device__ __forceinline__ fq canon(const fq& a) { return fq_canon(a); }
__device__ __forceinline__ fq2 canon(const fq2& a) {
    return {fq_canon(a.c0), fq_canon(a.c1)};
}

// Writes the point with canonical coordinates (each < q).
template <class F>
__device__ __forceinline__ void store_point(uint32_t* base, long long i,
                                            const point<F>& p) {
    constexpr int V = sizeof(point<F>) / 16;
    const point<F> c = {canon(p.x), canon(p.y), canon(p.z)};
    uint4* dst = reinterpret_cast<uint4*>(base) + i * V;
    const uint4* src = reinterpret_cast<const uint4*>(&c);
#pragma unroll
    for (int k = 0; k < V; k++) dst[k] = src[k];
}

}  // namespace esn
