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
__device__ __forceinline__ fq2 fq2_b3() {
    return {{{0xb62e0d6au, 0x3baa927cu, 0xd1b664fdu, 0xd71e7c52u,
              0xd95d4664u, 0x03873e63u, 0x082ab8f4u, 0x0e75b5b1u}},
            {{0x7596fe35u, 0xaab7c666u, 0xbb6a27bau, 0x31d21a78u,
              0x680401ffu, 0x85dd7297u, 0xdf39a7e9u, 0x03c52d6au}}};
}
__device__ __forceinline__ fq2 f_mul_b3(const fq2& a) { return f_mul(a, fq2_b3()); }

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

// ---------------------------------------------------------------------------
// The team step: rcb_double and rcb_add with one point advanced by a team
// of lanes of one warp.
//
// A serial chain (K3's window combine, K2's n doublings of one point) runs
// rcb_double / rcb_add on one lane at the latency of 8 (G1 double) to 45
// (G2 add) dependent Fq products a step while the other 31 lanes idle.
// The formulas are wide: a doubling's 8 products are 2 levels of 4
// independent products (Y Y, Y Z, Z Z, X Y, then t2 z3, t1 z3, t0 y3,
// t0 xy), an add's 12 are 2 levels of 6; on G2 every Fq2 product is 3
// independent Fq products (Karatsuba) and the products by 3b are one more
// level, so a G2 step is 3 levels of at most 18 Fq products.  A team of
// TeamCfg<F>::kLanes lanes (G1 8, a quarter warp; G2 32, the warp) runs a
// level as one Fq product a lane: lane j computes product j, and as the
// lanes of a warp issue one instruction stream, the level costs the
// latency of one product, the same as one lane's.
//
// Operands live in per-team shared-memory slots of one Fq each (8 words,
// two 16-byte vectors), not in registers moved by __shfl_sync: a lane's
// operands come from any of 30 slots, chosen per lane and level, which is
// one indexed shared-memory load an operand where shuffles would take 8
// (and a select of the source lane per word); __syncwarp orders the
// levels.  Each level's slots are packed 5 bits a product into compile-time
// words, so a lane finds its slots by a shift.  The linear work between
// levels:
// - pre-adds ((X1 + Y1)(X2 + Y2), Karatsuba's (a0 + a1)(b0 + b1)) are
//   done by the loading lane on its own operand, uniformly (an absent
//   term reads the zero slot);
// - Karatsuba's recombination (c0 = m0 - m1, c1 = m2 - (m0 + m1)) by one
//   lane an Fq2 product;
// - the sums and small multiples between levels by one lane a component
//   (G1 one lane, G2 two: Fq2 additions are componentwise), whose
//   independent chains ptxas interleaves (lanes on different code would
//   serialise, so the chains stay on one lane);
// - the last sums of a step (X3, Y3, Z3) by one lane a coordinate
//   component.
// Each slot holds the same field element as the variable of rcb_double /
// rcb_add it stands for, lazily reduced (< 2q) and with the product of
// field.cuh, so team_store writes the same canonical words as the
// one-thread formulas.

template <class F> struct TeamCfg;
template <> struct TeamCfg<fq> {
    static constexpr int kNC = 1;       // Fq components of a coordinate
    static constexpr int kNP = 1;       // Fq products of a field product
    static constexpr int kLanes = 8;    // the widest level: 6 products
};
template <> struct TeamCfg<fq2> {
    static constexpr int kNC = 2, kNP = 3;
    static constexpr int kLanes = 32;   // the widest level: 18 products
};

// A team's slots, each one field element (kNC Fq).
namespace slot {
enum : int {
    X, Y, Z,                            // the point the team advances
    QX, QY, QZ,                         // the point added to it
    ZERO, K3B,                          // 0; 3b (G2)
    P0, P1, P2, P3, P4, P5, P6, P7,     // products of the first levels
    R0, R1, R2, R3, R4, R5,             // products of the last level
    L0, L1, L2, L3, L4, L5, L6, L7,     // sums between the levels
    COUNT
};
}  // namespace slot

template <class F> struct TeamSlots {
    // Fq slots: the field slots, then G2's 18 raw Karatsuba products.
    static constexpr int kRaw = slot::COUNT * TeamCfg<F>::kNC;
    static constexpr int kFq = kRaw + (TeamCfg<F>::kNP == 3 ? 18 : 0);
    static constexpr int kVec = 6 * TeamCfg<F>::kNC;  // 16-byte vectors a point
};

// Up to six slot numbers, 5 bits each; an absent one is the zero slot.
__host__ __device__ constexpr uint32_t pk(int s0, int s1 = slot::ZERO,
                                          int s2 = slot::ZERO,
                                          int s3 = slot::ZERO,
                                          int s4 = slot::ZERO,
                                          int s5 = slot::ZERO) {
    return (uint32_t)s0 | (uint32_t)s1 << 5 | (uint32_t)s2 << 10 |
           (uint32_t)s3 << 15 | (uint32_t)s4 << 20 | (uint32_t)s5 << 25;
}
__device__ __forceinline__ int pk_at(uint32_t p, int k) {
    return (int)((p >> (5 * k)) & 31u);
}

// Operand `part` of product k: slot f1 (+ f2 with PRE).  G1: the Fq.  G2,
// Karatsuba: part 0 the c0 components, 1 the c1, 2 c0 + c1.
template <class F, bool PRE>
__device__ __forceinline__ fq team_operand(const fq* s, uint32_t p1,
                                           uint32_t p2, int k, int part) {
    if constexpr (TeamCfg<F>::kNP == 1) {
        fq a = s[pk_at(p1, k)];
        if constexpr (PRE) a = fq_add(a, s[pk_at(p2, k)]);
        return a;
    } else {
        const int lo = part == 1, zero = 2 * slot::ZERO;
        const int f1 = 2 * pk_at(p1, k);
        fq a = fq_add(s[f1 + lo], s[part == 2 ? f1 + 1 : zero]);
        if constexpr (PRE) {
            const int f2 = 2 * pk_at(p2, k);
            a = fq_add(a, fq_add(s[f2 + lo], s[part == 2 ? f2 + 1 : zero]));
        }
        return a;
    }
}

// One level of K field products: out[k] = (a1[k] (+ a2[k])) (b1[k] (+
// b2[k])), lane j computing Fq product j; on G2, then lane k < K
// recombines product k from its three Fq products.
template <class F, int K, bool PRE>
__device__ __forceinline__ void team_level(fq* s, int j, uint32_t a1,
                                           uint32_t a2, uint32_t b1,
                                           uint32_t b2, uint32_t out) {
    constexpr int NP = TeamCfg<F>::kNP;
    constexpr int RAW = TeamSlots<F>::kRaw;
    if (j < K * NP) {
        const int k = j / NP, part = j - k * NP;
        const fq r = fq_mul(team_operand<F, PRE>(s, a1, a2, k, part),
                            team_operand<F, PRE>(s, b1, b2, k, part));
        if constexpr (NP == 1) s[pk_at(out, k)] = r;
        else s[RAW + j] = r;
    }
    __syncwarp();
    if constexpr (NP == 3) {
        if (j < K) {
            const fq m0 = s[RAW + 3 * j], m1 = s[RAW + 3 * j + 1];
            const fq m2 = s[RAW + 3 * j + 2];
            const int o = 2 * pk_at(out, j);
            s[o] = fq_sub(m0, m1);
            s[o + 1] = fq_sub(m2, fq_add(m0, m1));
        }
        __syncwarp();
    }
}

// The step's last sums: coordinate o (X, Y, Z) = u[o] + v[o], or u[o] -
// v[o] where bit o of `sub` is set; lane j computes component j.
template <class F>
__device__ __forceinline__ void team_combine(fq* s, int j, uint32_t u,
                                             uint32_t v, int sub) {
    constexpr int NC = TeamCfg<F>::kNC;
    if (j < 3 * NC) {
        const int o = j / NC, c = j - o * NC;
        const fq a = s[NC * pk_at(u, o) + c], b = s[NC * pk_at(v, o) + c];
        s[j] = (sub >> o) & 1 ? fq_sub(a, b) : fq_add(a, b);
    }
    __syncwarp();
}

__device__ __forceinline__ fq f_triple(const fq& a) {
    return fq_add(fq_add(a, a), a);
}

// (X, Y, Z) <- 2 (X, Y, Z), rcb_double's sequence.
template <class F>
__device__ __forceinline__ void team_double(fq* s, int j) {
    using namespace slot;
    constexpr int NC = TeamCfg<F>::kNC;
    constexpr bool G2 = TeamCfg<F>::kNP == 3;
    // t0 = Y Y, t1 = Y Z, t2 = Z Z, xy = X Y
    team_level<F, 4, false>(s, j, pk(Y, Y, Z, X), 0, pk(Y, Z, Z, Y), 0,
                            pk(P0, P1, P2, P3));
    if constexpr (G2)   // t2 = 3b t2
        team_level<F, 1, false>(s, j, pk(K3B), 0, pk(P2), 0, pk(P4));
    constexpr int T2 = G2 ? P4 : L0;
    if (j < NC) {
        const fq t0 = s[NC * P0 + j];
        fq t2;
        if constexpr (G2) {
            t2 = s[NC * P4 + j];
        } else {
            t2 = f_mul_b3(s[NC * P2 + j]);
            s[NC * L0 + j] = t2;
        }
        fq z3 = fq_add(t0, t0);
        z3 = fq_add(z3, z3);
        s[NC * L1 + j] = fq_add(z3, z3);                 // z3 = 8 t0
        s[NC * L3 + j] = fq_add(t0, t2);                 // y3 = t0 + t2
        s[NC * L2 + j] = fq_sub(t0, f_triple(t2));       // t0 = t0 - 3 t2
    }
    __syncwarp();
    // x3 = t2 z3, z3 = t1 z3, y3 = t0 y3, x3' = t0 xy
    team_level<F, 4, false>(s, j, pk(T2, P1, L2, L2), 0, pk(L1, L1, L3, P3),
                            0, pk(R0, R1, R2, R3));
    // X = x3' + x3', Y = x3 + y3, Z = z3
    team_combine<F>(s, j, pk(R3, R0, R1), pk(R3, R2, ZERO), 0);
}

// (X, Y, Z) <- (X, Y, Z) + (QX, QY, QZ), rcb_add's sequence.
template <class F>
__device__ __forceinline__ void team_add(fq* s, int j) {
    using namespace slot;
    constexpr int NC = TeamCfg<F>::kNC;
    constexpr bool G2 = TeamCfg<F>::kNP == 3;
    // t0 = X1 X2, t1 = Y1 Y2, t2 = Z1 Z2, (X1 + Y1)(X2 + Y2),
    // (Y1 + Z1)(Y2 + Z2), (X1 + Z1)(X2 + Z2)
    team_level<F, 6, true>(s, j, pk(X, Y, Z, X, Y, X),
                           pk(ZERO, ZERO, ZERO, Y, Z, Z),
                           pk(QX, QY, QZ, QX, QY, QX),
                           pk(ZERO, ZERO, ZERO, QY, QZ, QZ),
                           pk(P0, P1, P2, P3, P4, P5));
    if (j < NC) {
        const fq t0 = s[NC * P0 + j], t1 = s[NC * P1 + j];
        const fq t2 = s[NC * P2 + j];
        s[NC * L2 + j] = fq_sub(s[NC * P3 + j], fq_add(t0, t1));   // t3
        s[NC * L3 + j] = fq_sub(s[NC * P4 + j], fq_add(t1, t2));   // t4
        const fq y3 = fq_sub(s[NC * P5 + j], fq_add(t0, t2));
        s[NC * L0 + j] = f_triple(t0);                             // t0 = 3 t0
        if constexpr (G2) {
            s[NC * L6 + j] = y3;
        } else {
            const fq t2b = f_mul_b3(t2);
            s[NC * L5 + j] = fq_add(t1, t2b);                      // z3
            s[NC * L1 + j] = fq_sub(t1, t2b);                      // t1
            s[NC * L4 + j] = f_mul_b3(y3);                         // y3
        }
    }
    __syncwarp();
    if constexpr (G2) {
        // t2 = 3b t2, y3 = 3b y3
        team_level<F, 2, false>(s, j, pk(K3B, K3B), 0, pk(P2, L6), 0,
                                pk(P6, P7));
        if (j < NC) {
            const fq t1 = s[NC * P1 + j], t2 = s[NC * P6 + j];
            s[NC * L5 + j] = fq_add(t1, t2);                       // z3
            s[NC * L1 + j] = fq_sub(t1, t2);                       // t1
        }
        __syncwarp();
    }
    constexpr int Y3 = G2 ? P7 : L4;
    // t4 y3, t3 t1, y3 t0, t1 z3, t0 t3, z3 t4
    team_level<F, 6, false>(s, j, pk(L3, L2, Y3, L1, L0, L5), 0,
                            pk(Y3, L1, L0, L5, L2, L3), 0,
                            pk(R0, R1, R2, R3, R4, R5));
    // X = t3 t1 - t4 y3, Y = t1 z3 + y3 t0, Z = z3 t4 + t0 t3
    team_combine<F>(s, j, pk(R1, R3, R5), pk(R0, R2, R4), 1);
}

// The constant slots (zero; G2's 3b); then a __syncwarp before use.
template <class F>
__device__ __forceinline__ void team_init(fq* s, int j) {
    constexpr int NC = TeamCfg<F>::kNC;
    if (j < NC) {
        s[NC * slot::ZERO + j] = fq{};
        if constexpr (NC == 2) {
            const fq2 b3 = fq2_b3();
            s[NC * slot::K3B + j] = j ? b3.c1 : b3.c0;
        }
    }
}

// Vector j of point i of a (n, 3[, 2], 8) word tensor (lanes j < kVec).
template <class F>
__device__ __forceinline__ uint4 team_fetch(const uint32_t* base, long long i,
                                            int j) {
    return __ldg(reinterpret_cast<const uint4*>(base) +
                 i * TeamSlots<F>::kVec + j);
}

// Vector j of a point into the slots from f on (lanes j < kVec).
template <class F>
__device__ __forceinline__ void team_put(fq* s, int f, int j, const uint4& v) {
    reinterpret_cast<uint4*>(s + TeamCfg<F>::kNC * f)[j] = v;
}

// (X, Y, Z) as point i, canonical: lane j < 3 kNC writes one Fq.
template <class F>
__device__ __forceinline__ void team_store(uint32_t* base, long long i,
                                           const fq* s, int j) {
    if (j < 3 * TeamCfg<F>::kNC) {
        const fq v = fq_canon(s[j]);
        uint4* dst = reinterpret_cast<uint4*>(base) +
                     i * TeamSlots<F>::kVec + 2 * j;
        const uint4* src = reinterpret_cast<const uint4*>(&v);
        dst[0] = src[0];
        dst[1] = src[1];
    }
}

}  // namespace esn
