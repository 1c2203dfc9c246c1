// BN254 base field Fq for the Hopper kernels.
//
// An element is 8 little-endian 32-bit words of its Montgomery residue
// x * 2^256 mod q: the layout of the reference's binary proving key and of
// the port's point tensors (ethsnarks_tpu_torch/ops/fp.py).  Every function
// takes canonical inputs (< q) and returns canonical outputs, so results
// match the plain PyTorch twin bit for bit.
//
// Replaces the TPU field core ethsnarks_tpu/ops/fp_red.py (12-bit x 22
// signed digits, shaped by the v5e's 32-bit vector lanes).  On Hopper the
// integer pipe multiplies 32x32 -> 64 bits (IMAD.WIDE / IMAD.HI), so a
// product is 8x8 word CIOS Montgomery: 64 + 64 wide multiply-adds and 8 low
// 32-bit products.

#pragma once
#include <stdint.h>

namespace esn {

struct alignas(16) fq {
    uint32_t w[8];
};

// q = 0x30644e72...d87cfd47; -q^-1 mod 2^32; R mod q (Montgomery one).
__constant__ uint32_t FQ_Q[8] = {
    0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
    0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
constexpr uint32_t FQ_QINV = 0xe4866389u;
__constant__ uint32_t FQ_ONE[8] = {
    0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
    0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};

// t < 2q  ->  t mod q.
__device__ __forceinline__ fq fq_reduce(const uint32_t t[8]) {
    uint32_t d[8];
    uint32_t borrow = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        uint64_t s = (uint64_t)t[i] - FQ_Q[i] - borrow;
        d[i] = (uint32_t)s;
        borrow = (uint32_t)(s >> 63);
    }
    fq r;
#pragma unroll
    for (int i = 0; i < 8; i++) r.w[i] = borrow ? t[i] : d[i];
    return r;
}

__device__ __forceinline__ fq fq_add(const fq& a, const fq& b) {
    // a + b < 2q < 2^255: no carry leaves the top word
    uint32_t t[8];
    uint64_t carry = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        uint64_t s = (uint64_t)a.w[i] + b.w[i] + carry;
        t[i] = (uint32_t)s;
        carry = s >> 32;
    }
    return fq_reduce(t);
}

__device__ __forceinline__ fq fq_sub(const fq& a, const fq& b) {
    uint32_t t[8];
    uint32_t borrow = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        uint64_t s = (uint64_t)a.w[i] - b.w[i] - borrow;
        t[i] = (uint32_t)s;
        borrow = (uint32_t)(s >> 63);
    }
    // a < b: add q back (the carry out of the top word cancels the borrow)
    uint32_t mask = 0u - borrow;
    fq r;
    uint64_t carry = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        uint64_t s = (uint64_t)t[i] + (FQ_Q[i] & mask) + carry;
        r.w[i] = (uint32_t)s;
        carry = s >> 32;
    }
    return r;
}

// Montgomery product a * b / 2^256 mod q, CIOS (coarsely integrated
// operand scanning).  Intermediate t stays < 2q, so t[8] is at most 1 and
// the result needs one conditional subtraction.
__device__ __forceinline__ fq fq_mul(const fq& a, const fq& b) {
    uint32_t t[10];
#pragma unroll
    for (int i = 0; i < 10; i++) t[i] = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < 8; j++) {
            uint64_t s = (uint64_t)a.w[j] * b.w[i] + t[j] + c;
            t[j] = (uint32_t)s;
            c = s >> 32;
        }
        uint64_t s = (uint64_t)t[8] + c;
        t[8] = (uint32_t)s;
        t[9] = (uint32_t)(s >> 32);
        uint32_t m = t[0] * FQ_QINV;
        s = (uint64_t)m * FQ_Q[0] + t[0];
        c = s >> 32;
#pragma unroll
        for (int j = 1; j < 8; j++) {
            s = (uint64_t)m * FQ_Q[j] + t[j] + c;
            t[j - 1] = (uint32_t)s;
            c = s >> 32;
        }
        s = (uint64_t)t[8] + c;
        t[7] = (uint32_t)s;
        t[8] = t[9] + (uint32_t)(s >> 32);
    }
    return fq_reduce(t);
}

__device__ __forceinline__ fq fq_one() {
    fq r;
#pragma unroll
    for (int i = 0; i < 8; i++) r.w[i] = FQ_ONE[i];
    return r;
}

}  // namespace esn
