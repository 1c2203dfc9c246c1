// BN254 base field Fq and scalar field Fr for the Hopper kernels.
//
// An element is 8 little-endian 32-bit words of a residue mod q (Fq) or r
// (Fr).  Fq values are Montgomery residues x * 2^256 mod q: the layout of
// the reference's binary proving key and of the port's point tensors
// (ethsnarks_tpu_torch/ops/fp.py).  The PTX blocks below are written once
// for a modulus p and instantiated for q and for r: r < q, so every bound
// stated for q holds for r (r < 2^254 and 4r < 2^256 too).
//
// Replaces the TPU field core ethsnarks_tpu/ops/fp_red.py (12-bit x 22
// signed digits, shaped by the v5e's 32-bit vector lanes).
//
// What bounds it on this card: the integer multiply-add pipe.  An 8-word
// Montgomery product needs 64 + 64 wide (32x32 -> 64-bit) products and 8
// low ones, 264 IMADs as ethsnarks_tpu_torch/cost.py counts them, and
// every point kernel is made of these products.  The design:
//
// - Each operation is one inline PTX block, so the compiler sees a fixed
//   instruction sequence.  The product is CIOS Montgomery multiplication
//   with the even/odd split of the partial products: the products a[j]*b_i
//   of even j fill whole word pairs of one accumulator, those of odd j of
//   another one word up, so every row is one unbroken carry chain of
//   mad.lo.cc / madc.hi.cc pairs (one IMAD.WIDE with carry in and out
//   each), and the one-word shift of a CIOS round is a renaming of the two
//   accumulators instead of eight moves.
// - q < 2^254 leaves two spare top bits, so no round carries out of nine
//   words and the accumulators need no tenth word ("no-carry" CIOS); q and
//   -q^-1 mod 2^32 are immediates.
// - Lazy reduction.  Between the steps of a formula a value is any
//   representative in [0, 2q): with a, b < 2q the product's result is
//   < (4q^2 + 2^256 q) / 2^256 < 2q (as 4q < 2^256), so it needs no final
//   subtraction; a sum or difference is brought back below 2q by one
//   conditional subtraction or addition of 2q.  fq_canon reduces a value
//   below q; store_point (curve.cuh) applies it to every coordinate a
//   kernel writes to device memory.  A residue below q is unique however it
//   was computed, so every stored word matches the plain PyTorch version
//   bit for bit.  Inputs read from device memory are canonical.
//
// Every PTX block writes its outputs only after it has read all of its
// inputs, so an output may share a register with an input.

#pragma once
#include <stdint.h>

namespace esn {

struct alignas(16) fq {
    uint32_t w[8];
};

// The modulus p (or 2p) of a block sits in the registers q0..q7, whatever
// the field.  q = 0x30644e72...d87cfd47 and 2q, r = 0x30644e72...f0000001
// and 2r, as PTX moves into those words.
#define ESN_MOV_Q                                                              \
    "mov.u32 q0, 0xd87cfd47;\n\tmov.u32 q1, 0x3c208c16;\n\t"                   \
    "mov.u32 q2, 0x6871ca8d;\n\tmov.u32 q3, 0x97816a91;\n\t"                   \
    "mov.u32 q4, 0x8181585d;\n\tmov.u32 q5, 0xb85045b6;\n\t"                   \
    "mov.u32 q6, 0xe131a029;\n\tmov.u32 q7, 0x30644e72;\n\t"
#define ESN_MOV_2Q                                                             \
    "mov.u32 q0, 0xb0f9fa8e;\n\tmov.u32 q1, 0x7841182d;\n\t"                   \
    "mov.u32 q2, 0xd0e3951a;\n\tmov.u32 q3, 0x2f02d522;\n\t"                   \
    "mov.u32 q4, 0x0302b0bb;\n\tmov.u32 q5, 0x70a08b6d;\n\t"                   \
    "mov.u32 q6, 0xc2634053;\n\tmov.u32 q7, 0x60c89ce5;\n\t"
#define ESN_MOV_R                                                              \
    "mov.u32 q0, 0xf0000001;\n\tmov.u32 q1, 0x43e1f593;\n\t"                   \
    "mov.u32 q2, 0x79b97091;\n\tmov.u32 q3, 0x2833e848;\n\t"                   \
    "mov.u32 q4, 0x8181585d;\n\tmov.u32 q5, 0xb85045b6;\n\t"                   \
    "mov.u32 q6, 0xe131a029;\n\tmov.u32 q7, 0x30644e72;\n\t"
#define ESN_MOV_2R                                                             \
    "mov.u32 q0, 0xe0000002;\n\tmov.u32 q1, 0x87c3eb27;\n\t"                   \
    "mov.u32 q2, 0xf372e122;\n\tmov.u32 q3, 0x5067d090;\n\t"                   \
    "mov.u32 q4, 0x0302b0ba;\n\tmov.u32 q5, 0x70a08b6d;\n\t"                   \
    "mov.u32 q6, 0xc2634053;\n\tmov.u32 q7, 0x60c89ce5;\n\t"
// -p^-1 mod 2^32
#define ESN_NINV_Q "0xe4866389"
#define ESN_NINV_R "0xefffffff"

// Operands of the two-input blocks: %0-%7 the result, %8-%15 a, %16-%23 b.
#define ESN_OUT8(x) "=r"(x.w[0]), "=r"(x.w[1]), "=r"(x.w[2]), "=r"(x.w[3]), \
                    "=r"(x.w[4]), "=r"(x.w[5]), "=r"(x.w[6]), "=r"(x.w[7])
#define ESN_IN8(x) "r"(x.w[0]), "r"(x.w[1]), "r"(x.w[2]), "r"(x.w[3]),      \
                   "r"(x.w[4]), "r"(x.w[5]), "r"(x.w[6]), "r"(x.w[7])

// Row 0 of the product: E = sum of a[j] b_0 over even j (word pairs 0-1,
// 2-3, 4-5, 6-7), O = the same over odd j, one word up.
#define ESN_MUL_FIRST(B)                                                       \
    "mul.lo.u32 o0, %9, " B ";\n\tmul.hi.u32 o1, %9, " B ";\n\t"               \
    "mul.lo.u32 o2, %11, " B ";\n\tmul.hi.u32 o3, %11, " B ";\n\t"             \
    "mul.lo.u32 o4, %13, " B ";\n\tmul.hi.u32 o5, %13, " B ";\n\t"             \
    "mul.lo.u32 o6, %15, " B ";\n\tmul.hi.u32 o7, %15, " B ";\n\t"             \
    "mul.lo.u32 e0, %8, " B ";\n\tmul.hi.u32 e1, %8, " B ";\n\t"               \
    "mul.lo.u32 e2, %10, " B ";\n\tmul.hi.u32 e3, %10, " B ";\n\t"             \
    "mul.lo.u32 e4, %12, " B ";\n\tmul.hi.u32 e5, %12, " B ";\n\t"             \
    "mul.lo.u32 e6, %14, " B ";\n\tmul.hi.u32 e7, %14, " B ";\n\t"

// Rows 1-7.  The state divided by 2^32 is E[1..7] + O (words 0-7): O
// becomes the new E, and E[1] is added into it while E[2..7] move two
// words down as the new O (one word up from the new E), with the odd
// products of b_i added in the same chain; then the even products of b_i
// go into the new E, whose carry out lands in the new O's top word.
#define ESN_MUL_ROW(E, O, B)                                                   \
    "add.cc.u32 " #O "0, " #O "0, " #E "1;\n\t"                                \
    "madc.lo.cc.u32 " #E "0, %9, " B ", " #E "2;\n\t"                          \
    "madc.hi.cc.u32 " #E "1, %9, " B ", " #E "3;\n\t"                          \
    "madc.lo.cc.u32 " #E "2, %11, " B ", " #E "4;\n\t"                         \
    "madc.hi.cc.u32 " #E "3, %11, " B ", " #E "5;\n\t"                         \
    "madc.lo.cc.u32 " #E "4, %13, " B ", " #E "6;\n\t"                         \
    "madc.hi.cc.u32 " #E "5, %13, " B ", " #E "7;\n\t"                         \
    "madc.lo.cc.u32 " #E "6, %15, " B ", 0;\n\t"                               \
    "madc.hi.u32 " #E "7, %15, " B ", 0;\n\t"                                  \
    "mad.lo.cc.u32 " #O "0, %8, " B ", " #O "0;\n\t"                           \
    "madc.hi.cc.u32 " #O "1, %8, " B ", " #O "1;\n\t"                          \
    "madc.lo.cc.u32 " #O "2, %10, " B ", " #O "2;\n\t"                         \
    "madc.hi.cc.u32 " #O "3, %10, " B ", " #O "3;\n\t"                         \
    "madc.lo.cc.u32 " #O "4, %12, " B ", " #O "4;\n\t"                         \
    "madc.hi.cc.u32 " #O "5, %12, " B ", " #O "5;\n\t"                         \
    "madc.lo.cc.u32 " #O "6, %14, " B ", " #O "6;\n\t"                         \
    "madc.hi.cc.u32 " #O "7, %14, " B ", " #O "7;\n\t"                         \
    "addc.u32 " #E "7, " #E "7, 0;\n\t"

// The reduction of a row: m = E[0] (-p^-1) mod 2^32, then E + O 2^32 +=
// m p (odd words of p into O, even words into E), after which E[0] = 0.
// Neither chain carries out of the state's nine words: the state stays
// below 3p 2^32 + 3p < 2^288.
#define ESN_REDC(E, O, NINV)                                                   \
    "mul.lo.u32 m, " #E "0, " NINV ";\n\t"                                     \
    "mad.lo.cc.u32 " #O "0, m, q1, " #O "0;\n\t"                               \
    "madc.hi.cc.u32 " #O "1, m, q1, " #O "1;\n\t"                              \
    "madc.lo.cc.u32 " #O "2, m, q3, " #O "2;\n\t"                              \
    "madc.hi.cc.u32 " #O "3, m, q3, " #O "3;\n\t"                              \
    "madc.lo.cc.u32 " #O "4, m, q5, " #O "4;\n\t"                              \
    "madc.hi.cc.u32 " #O "5, m, q5, " #O "5;\n\t"                              \
    "madc.lo.cc.u32 " #O "6, m, q7, " #O "6;\n\t"                              \
    "madc.hi.u32 " #O "7, m, q7, " #O "7;\n\t"                                 \
    "mad.lo.cc.u32 " #E "0, m, q0, " #E "0;\n\t"                               \
    "madc.hi.cc.u32 " #E "1, m, q0, " #E "1;\n\t"                              \
    "madc.lo.cc.u32 " #E "2, m, q2, " #E "2;\n\t"                              \
    "madc.hi.cc.u32 " #E "3, m, q2, " #E "3;\n\t"                              \
    "madc.lo.cc.u32 " #E "4, m, q4, " #E "4;\n\t"                              \
    "madc.hi.cc.u32 " #E "5, m, q4, " #E "5;\n\t"                              \
    "madc.lo.cc.u32 " #E "6, m, q6, " #E "6;\n\t"                              \
    "madc.hi.cc.u32 " #E "7, m, q6, " #E "7;\n\t"                              \
    "addc.u32 " #O "7, " #O "7, 0;\n\t"

// a * b / 2^256 mod p for a, b < 2p; the result is < 2p.  After the last
// row the state divided by 2^32 is e + o[1..7].
#define ESN_MUL_PTX(MOV_P, NINV)                                               \
    "{\n\t.reg .u32 e<8>;\n\t.reg .u32 o<8>;\n\t"                            \
    ".reg .u32 q<8>;\n\t.reg .u32 m;\n\t" MOV_P                               \
    ESN_MUL_FIRST("%16") ESN_REDC(e, o, NINV)                                  \
    ESN_MUL_ROW(e, o, "%17") ESN_REDC(o, e, NINV)                              \
    ESN_MUL_ROW(o, e, "%18") ESN_REDC(e, o, NINV)                              \
    ESN_MUL_ROW(e, o, "%19") ESN_REDC(o, e, NINV)                              \
    ESN_MUL_ROW(o, e, "%20") ESN_REDC(e, o, NINV)                              \
    ESN_MUL_ROW(e, o, "%21") ESN_REDC(o, e, NINV)                              \
    ESN_MUL_ROW(o, e, "%22") ESN_REDC(e, o, NINV)                              \
    ESN_MUL_ROW(e, o, "%23") ESN_REDC(o, e, NINV)                              \
    "add.cc.u32 %0, e0, o1;\n\taddc.cc.u32 %1, e1, o2;\n\t"                    \
    "addc.cc.u32 %2, e2, o3;\n\taddc.cc.u32 %3, e3, o4;\n\t"                   \
    "addc.cc.u32 %4, e4, o5;\n\taddc.cc.u32 %5, e5, o6;\n\t"                   \
    "addc.cc.u32 %6, e6, o7;\n\taddc.u32 %7, e7, 0;\n\t}"

// a + b for a, b < 2p: t = a + b < 4p < 2^256, less 2p unless that
// borrows.
#define ESN_ADD_PTX(MOV_2P)                                                    \
    "{\n\t.reg .u32 t<8>;\n\t.reg .u32 d<8>;\n\t"                              \
    ".reg .u32 q<8>;\n\t.reg .u32 m;\n\t.reg .pred p;\n\t" MOV_2P              \
    "add.cc.u32 t0, %8, %16;\n\taddc.cc.u32 t1, %9, %17;\n\t"                  \
    "addc.cc.u32 t2, %10, %18;\n\taddc.cc.u32 t3, %11, %19;\n\t"               \
    "addc.cc.u32 t4, %12, %20;\n\taddc.cc.u32 t5, %13, %21;\n\t"               \
    "addc.cc.u32 t6, %14, %22;\n\taddc.u32 t7, %15, %23;\n\t"                  \
    ESN_SUB_SELECT

// d = t - q<8> (p or 2p); the result is t if that borrows, else d.
#define ESN_SUB_SELECT                                                         \
    "sub.cc.u32 d0, t0, q0;\n\tsubc.cc.u32 d1, t1, q1;\n\t"                    \
    "subc.cc.u32 d2, t2, q2;\n\tsubc.cc.u32 d3, t3, q3;\n\t"                   \
    "subc.cc.u32 d4, t4, q4;\n\tsubc.cc.u32 d5, t5, q5;\n\t"                   \
    "subc.cc.u32 d6, t6, q6;\n\tsubc.cc.u32 d7, t7, q7;\n\t"                   \
    "subc.u32 m, 0, 0;\n\tsetp.ne.u32 p, m, 0;\n\t"                            \
    "selp.b32 %0, t0, d0, p;\n\tselp.b32 %1, t1, d1, p;\n\t"                   \
    "selp.b32 %2, t2, d2, p;\n\tselp.b32 %3, t3, d3, p;\n\t"                   \
    "selp.b32 %4, t4, d4, p;\n\tselp.b32 %5, t5, d5, p;\n\t"                   \
    "selp.b32 %6, t6, d6, p;\n\tselp.b32 %7, t7, d7, p;\n\t}"

// a - b for a, b < 2p: t = a - b, plus 2p if that borrowed (the carry out
// of the top word cancels the borrow).
#define ESN_SUB_PTX(MOV_2P)                                                    \
    "{\n\t.reg .u32 t<8>;\n\t.reg .u32 d<8>;\n\t"                              \
    ".reg .u32 q<8>;\n\t.reg .u32 m;\n\t" MOV_2P                               \
    "sub.cc.u32 t0, %8, %16;\n\tsubc.cc.u32 t1, %9, %17;\n\t"                  \
    "subc.cc.u32 t2, %10, %18;\n\tsubc.cc.u32 t3, %11, %19;\n\t"               \
    "subc.cc.u32 t4, %12, %20;\n\tsubc.cc.u32 t5, %13, %21;\n\t"               \
    "subc.cc.u32 t6, %14, %22;\n\tsubc.cc.u32 t7, %15, %23;\n\t"               \
    "subc.u32 m, 0, 0;\n\t"                                                    \
    "and.b32 d0, m, q0;\n\tand.b32 d1, m, q1;\n\t"                             \
    "and.b32 d2, m, q2;\n\tand.b32 d3, m, q3;\n\t"                             \
    "and.b32 d4, m, q4;\n\tand.b32 d5, m, q5;\n\t"                             \
    "and.b32 d6, m, q6;\n\tand.b32 d7, m, q7;\n\t"                             \
    "add.cc.u32 %0, t0, d0;\n\taddc.cc.u32 %1, t1, d1;\n\t"                    \
    "addc.cc.u32 %2, t2, d2;\n\taddc.cc.u32 %3, t3, d3;\n\t"                   \
    "addc.cc.u32 %4, t4, d4;\n\taddc.cc.u32 %5, t5, d5;\n\t"                   \
    "addc.cc.u32 %6, t6, d6;\n\taddc.u32 %7, t7, d7;\n\t}"

// a < 2p -> a mod p (operands %0-%7 the result, %8-%15 a).
#define ESN_CANON_PTX(MOV_P)                                                   \
    "{\n\t.reg .u32 t<8>;\n\t.reg .u32 d<8>;\n\t"                              \
    ".reg .u32 q<8>;\n\t.reg .u32 m;\n\t.reg .pred p;\n\t" MOV_P               \
    "mov.u32 t0, %8;\n\tmov.u32 t1, %9;\n\tmov.u32 t2, %10;\n\t"               \
    "mov.u32 t3, %11;\n\tmov.u32 t4, %12;\n\tmov.u32 t5, %13;\n\t"             \
    "mov.u32 t6, %14;\n\tmov.u32 t7, %15;\n\t" ESN_SUB_SELECT

// The two instantiations.
#define ESN_FQ_MUL_PTX ESN_MUL_PTX(ESN_MOV_Q, ESN_NINV_Q)
#define ESN_FQ_ADD_PTX ESN_ADD_PTX(ESN_MOV_2Q)
#define ESN_FQ_SUB_PTX ESN_SUB_PTX(ESN_MOV_2Q)
#define ESN_FQ_CANON_PTX ESN_CANON_PTX(ESN_MOV_Q)
#define ESN_FR_MUL_PTX ESN_MUL_PTX(ESN_MOV_R, ESN_NINV_R)
#define ESN_FR_ADD_PTX ESN_ADD_PTX(ESN_MOV_2R)
#define ESN_FR_SUB_PTX ESN_SUB_PTX(ESN_MOV_2R)
#define ESN_FR_CANON_PTX ESN_CANON_PTX(ESN_MOV_R)

// T_mul, T_add, T_sub, T_canon for the element type T of one field F.
#define ESN_FIELD_OPS(T, F)                                                    \
    __device__ __forceinline__ T T##_mul(const T& a, const T& b) {             \
        T r;                                                                   \
        asm(ESN_##F##_MUL_PTX : ESN_OUT8(r) : ESN_IN8(a), ESN_IN8(b));         \
        return r;                                                              \
    }                                                                          \
    __device__ __forceinline__ T T##_add(const T& a, const T& b) {             \
        T r;                                                                   \
        asm(ESN_##F##_ADD_PTX : ESN_OUT8(r) : ESN_IN8(a), ESN_IN8(b));         \
        return r;                                                              \
    }                                                                          \
    __device__ __forceinline__ T T##_sub(const T& a, const T& b) {             \
        T r;                                                                   \
        asm(ESN_##F##_SUB_PTX : ESN_OUT8(r) : ESN_IN8(a), ESN_IN8(b));         \
        return r;                                                              \
    }                                                                          \
    __device__ __forceinline__ T T##_canon(const T& a) {                       \
        T r;                                                                   \
        asm(ESN_##F##_CANON_PTX : ESN_OUT8(r) : ESN_IN8(a));                   \
        return r;                                                              \
    }

// An Fr element: 8 words of a residue mod r (the witness map keeps plain
// values in them and Montgomery forms only in its constants).
struct alignas(16) fr {
    uint32_t w[8];
};

ESN_FIELD_OPS(fq, FQ)
ESN_FIELD_OPS(fr, FR)

// R mod q (Montgomery one).
__device__ __forceinline__ fq fq_one() {
    return fq{{0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
               0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u}};
}

}  // namespace esn
