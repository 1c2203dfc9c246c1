"""The operations of the throughput probe K7 ``int_probe``
(``csrc/probe_kernels.cu``) and its plain PyTorch version, and the plain
version of the latency chain K7b ``fq_chain`` beside it.

Counterpart: ``tools/probe_vpu.py`` ``OPS`` (:44-52), the seven ops its
Pallas kernel ``mk_kernel`` (:25) chains, and ``u32_mul_wide``, the
32 x 32 -> 64-bit product of the port's field core.  One probe step
applies an op ``a <- op(a, b)``; a kernel runs ``iters`` times a chain of
``CHAIN`` steps on every element.

The plain version computes the integer ops in int64, masked to 32 bits
after every step (products split into 16-bit halves, so no int64 product
overflows), so it agrees with the kernel bit for bit.  ``f32_fma`` is one
``fma.rn`` on the card; the plain version rounds a * b + b once in float64
(a * b is exact there), then to float32, which differs from one rounding
only where the float64 sum lands on a float32 tie, by one unit in the last
place: it is held to a relative tolerance (``F32_RTOL``), not bit for bit.
"""

import torch

from .fp import Fq, h16_to_words, words_to_h16

# name -> op id of esn_int_probe
OPS = {'u32_mul': 0, 'u32_add': 1, 'u32_mul_add': 2, 'u32_shr13_and': 3,
       'u32_cmp_sel': 4, 'i32_mul': 5, 'f32_fma': 6, 'u32_mul_wide': 7}
CHAIN = 16
F32_RTOL = 1e-6
_M32 = 0xFFFFFFFF


def _mul_lo(a, b):
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & _M32


def _mul_wide_xor(a, b):
    a0, a1, b0, b1 = a & 0xFFFF, a >> 16, b & 0xFFFF, b >> 16
    mid = a1 * b0 + a0 * b1
    lo = a0 * b0 + ((mid & 0xFFFF) << 16)
    hi = (a1 * b1 + (mid >> 16) + (lo >> 32)) & _M32
    return (lo & _M32) ^ hi


_STEP = {
    'u32_mul': _mul_lo,
    'u32_add': lambda a, b: (a + b) & _M32,
    'u32_mul_add': lambda a, b: (_mul_lo(a, b) + b) & _M32,
    'u32_shr13_and': lambda a, b: (a >> 13) & 8191,
    'u32_cmp_sel': lambda a, b: torch.where(a > b, a, b),
    'i32_mul': _mul_lo,             # the low 32 bits of a signed product
    'u32_mul_wide': _mul_wide_xor,
}


def check_inputs(op, x, y):
    if op not in OPS:
        raise ValueError("int_probe: unknown op %r (one of %s)"
                         % (op, ", ".join(OPS)))
    for t in (x, y):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError("int_probe: expected contiguous int32 (n,) "
                             "words, got %s %s" % (t.dtype, tuple(t.shape)))
    if x.shape != y.shape or x.device != y.device:
        raise ValueError("int_probe: x and y differ in shape or device")


def int_probe_plain(op, x, y, iters):
    """x, y: int32 (n,) words (the bits of float32 values for f32_fma) ->
    int32 (n,) words after ``iters * CHAIN`` steps of ``op``."""
    steps = iters * CHAIN
    if op == 'f32_fma':
        a = x.view(torch.float32).double()
        b = y.view(torch.float32).double()
        for _ in range(steps):
            a = (a * b + b).float().double()
        return a.float().view(torch.int32)
    a, b = x.long() & _M32, y.long() & _M32
    step = _STEP[op]
    for _ in range(steps):
        a = step(a, b)
    return torch.where(a > 0x7FFFFFFF, a - (1 << 32), a).to(torch.int32)


def check_fq_inputs(x, y):
    for t in (x, y):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != 8 or \
                not t.is_contiguous():
            raise ValueError("fq_chain: expected contiguous int32 (n, 8) "
                             "words, got %s %s" % (t.dtype, tuple(t.shape)))
    if x.shape != y.shape or x.device != y.device:
        raise ValueError("fq_chain: x and y differ in shape or device")


def fq_chain_plain(x, y, iters):
    """The plain version of K7b ``fq_chain``: x, y int32 (n, 8) Montgomery
    words of canonical Fq values -> x * y^iters (Montgomery products, each
    on the one before), canonical words."""
    a, b = words_to_h16(x), words_to_h16(y)
    for _ in range(iters):
        a = Fq.mul(a, b)
    return h16_to_words(a)
