"""Fq and Fr Montgomery arithmetic as plain PyTorch (counterparts of
``ethsnarks_tpu/ops/fp_red.py`` for Fq and ``ethsnarks_tpu/ops/fp.py`` for
Fr).

Two forms of a field element:

- **words**: ``int32`` tensor ``(..., 8)``, eight little-endian 32-bit
  words of the Montgomery residue ``x * 2^256 mod p``.  This is the layout
  of the reference's binary proving key (``serialization.py:208-247``), so
  a key loads without conversion, and the layout the CUDA kernels read.
- **h16**: ``int64`` tensor ``(16, *batch)``, sixteen 16-bit half-limbs,
  limb axis first.  torch has only signed 64-bit integer arithmetic; with
  16-bit digits every schoolbook column sum (at most 16 products of two
  16-bit digits, plus carries) stays far below 2^63.

Every operation returns canonical values (digits in [0, 2^16), value < p),
so a kernel's output and this plain version compare bit for bit.  Large
batches are processed in chunks so the (31, chunk) column temporaries
stay bounded.
"""

import numpy as np
import torch

from ..field import FIELD_MODULUS, SNARK_SCALAR_FIELD

NH = 16                       # half-limbs per element
HB = 16                       # bits per half-limb
MASK = (1 << HB) - 1
MONT_R = 1 << 256


_SKEW_OUTER_MAX = 2048


def _chunk(device):
    return 1 << 19 if device.type == 'cuda' else 1 << 12


def _ripple(t, passes=1, exact=True):
    """Exact carry normalisation of a (K, B) column stack, in place: digits
    0..K-2 end in [0, 2^16), the top row keeps the (signed) carry out.

    Whole-stack carry passes: ``passes`` unconditional ones (each shrinks
    a digit's excess by 16 bits, so a column below 2^(16 + 16 j) is in
    range but for carries of one after j), then passes until no digit is
    out of range, which takes more than one only where a carry meets a run
    of all-ones (or, borrowing, all-zero) digits.  Any input ends exact;
    K passes bound the worst case.  ``exact=False`` stops after the
    unconditional passes (same value, digits not yet canonical)."""
    for _ in range(passes):
        c = t[:-1] >> HB
        t[:-1].bitwise_and_(MASK)
        t[1:].add_(c)
    while exact:
        c = t[:-1] >> HB
        if not c.any():
            return t
        t[:-1].bitwise_and_(MASK)
        t[1:].add_(c)


def _skew(a, b):
    """Schoolbook columns of a*b: (16, B) x (16, B|1) -> (31, B), column k
    = sum_{i+j=k} a_i b_j (each below 2^36).

    Small batches (where each torch call's fixed cost dominates) form the
    outer product in one call, padded to (16, 32, B): read as (496, B) and
    reshaped to (16, 31, B) it puts entry (i, j) at column i + j, so one sum
    over the first axis forms every column.  Large batches (where memory
    traffic dominates) add 16 shifted rows instead."""
    bsz = a.shape[1]
    if bsz <= _SKEW_OUTER_MAX:
        prod = torch.zeros((NH, 2 * NH, bsz), dtype=torch.int64,
                           device=a.device)
        prod[:, :NH] = a[:, None, :] * b[None, :, :]
        return prod.reshape(2 * NH * NH, bsz)[:NH * (2 * NH - 1)].reshape(
            NH, 2 * NH - 1, bsz).sum(0)
    cols = torch.zeros((2 * NH - 1, bsz), dtype=torch.int64, device=a.device)
    for i in range(NH):
        cols[i:i + NH].add_(a[i] * b)
    return cols


def _toeplitz(value):
    """(31, 16) float64 matrix M with M[k, i] = digit k-i of value, so that
    M @ a gives the schoolbook columns of value * a.  Entries below 2^16
    and 16 terms per column keep every sum below 2^36, exact in float64."""
    d = int_to_h16(value)
    return [[float(d[k - i]) if 0 <= k - i < NH else 0.0
             for i in range(NH)] for k in range(2 * NH - 1)]


def int_to_h16(value):
    return [(value >> (HB * i)) & MASK for i in range(NH)]


class MontField(object):
    """Plain Montgomery arithmetic mod one prime, R = 2^256."""

    def __init__(self, modulus):
        self.modulus = modulus
        self.r_mod = MONT_R % modulus
        self.r2_mod = MONT_R * MONT_R % modulus
        self.r_inv = pow(MONT_R, -1, modulus)
        self.nprime = (-pow(modulus, -1, MONT_R)) % MONT_R
        self._dev_consts = {}

    # ---- constants ----

    def const(self, value, device):
        """Canonical h16 (16, 1) of a python int (taken as is, not scaled)."""
        return torch.tensor(int_to_h16(value % self.modulus),
                            dtype=torch.int64, device=device)[:, None]

    def const_mont(self, value, device):
        return self.const(value * MONT_R, device)

    def _consts(self, device):
        key = str(device)
        if key not in self._dev_consts:
            self._dev_consts[key] = (
                torch.tensor(int_to_h16(self.modulus), dtype=torch.int64,
                             device=device)[:, None],
                torch.tensor(_toeplitz(self.nprime)[:NH], dtype=torch.float64,
                             device=device),
                torch.tensor(_toeplitz(self.modulus), dtype=torch.float64,
                             device=device))
        return self._dev_consts[key]

    # ---- elementwise ops on h16 (16, *batch), broadcasting ----

    def _reduce_once(self, t, n, off=0, passes=1):
        """t (K, B) columns of u, where u's digits below ``off`` normalise
        to zero and u / 2^(16 off) < 2p -> canonical (16, B) of that
        quotient mod p.  u and u - p 2^(16 off) are normalised together in
        one pass sequence; the sign of the second picks the result."""
        bsz = t.shape[1]
        both = torch.cat([t, t], dim=1)
        both[off:off + NH, bsz:] -= n
        _ripple(both, passes)
        keep = both[-1, bsz:] < 0
        return torch.where(keep, both[off:off + NH, :bsz],
                           both[off:off + NH, bsz:])

    def _add_digits(self, s):
        """s (16, *batch) digitwise sum with value in [0, 2p) -> s mod p."""
        n = self._consts(s.device)[0]
        shape = s.shape[1:]
        flat = s.reshape(NH, -1)
        total = flat.shape[1]
        out = torch.empty((NH, total), dtype=torch.int64, device=s.device)
        ch = _chunk(s.device)
        for lo in range(0, total, ch):
            hi = min(total, lo + ch)
            t = torch.zeros((NH + 1, hi - lo), dtype=torch.int64,
                            device=s.device)
            t[:NH] = flat[:, lo:hi]
            out[:, lo:hi] = self._reduce_once(t, n)
        return out.reshape((NH,) + tuple(shape))

    def add(self, a, b):
        return self._add_digits(a + b)

    def sub(self, a, b):
        n = self._consts(a.device)[0]
        d = a - b
        return self._add_digits(d + n.reshape((NH,) + (1,) * (d.dim() - 1)))

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def _mul_flat(self, a, b, n, npr_t, n_t):
        """Separated Montgomery REDC; the products by the constants N' and
        N are matrix products with their Toeplitz matrices."""
        bsz = a.shape[1]
        t = torch.zeros((2 * NH + 1, bsz), dtype=torch.int64, device=a.device)
        t[:2 * NH - 1] = _skew(a, b)
        # T = a*b; two passes leave digits below 2^16 + 32, small enough
        # for the float64 product with N' to stay exact
        _ripple(t, 2, exact=False)
        m = (npr_t @ t[:NH].double()).long()        # (T mod R) * N' mod R
        _ripple(m, 2)
        m[NH - 1].bitwise_and_(MASK)
        t[:2 * NH - 1] += (n_t @ m.double()).long()  # U = T + m*N = 0 mod R
        return self._reduce_once(t, n, off=NH, passes=2)   # U / R < 2p

    def mul(self, a, b):
        """Montgomery product a*b/R mod p (canonical h16)."""
        consts = self._consts(a.device)
        shape = torch.broadcast_shapes(a.shape, b.shape)[1:]
        af = a.expand((NH,) + tuple(shape)).reshape(NH, -1)
        if b.shape[1:].numel() == 1:
            bf = b.reshape(NH, 1)
        else:
            bf = b.expand((NH,) + tuple(shape)).reshape(NH, -1)
        total = af.shape[1]
        ch = _chunk(a.device)
        if total <= ch:
            return self._mul_flat(af, bf, *consts).reshape((NH,) + shape)
        out = torch.empty((NH, total), dtype=torch.int64, device=a.device)
        for s in range(0, total, ch):
            e = min(total, s + ch)
            out[:, s:e] = self._mul_flat(
                af[:, s:e], bf if bf.shape[1] == 1 else bf[:, s:e], *consts)
        return out.reshape((NH,) + shape)

    def square(self, a):
        return self.mul(a, a)

    def pow_const(self, a, exponent):
        """a^exponent (Montgomery in, Montgomery out) for a python-int
        exponent >= 1: left-to-right square and multiply."""
        exponent = int(exponent)
        if exponent < 1:
            raise ValueError("exponent %d: at least 1" % exponent)
        acc = a
        for bit in bin(exponent)[3:]:
            acc = self.mul(acc, acc)
            if bit == '1':
                acc = self.mul(acc, a)
        return acc

    def sum_axis(self, a, axis):
        """Modular sum of h16 ``a`` along batch axis ``axis`` (counted in
        ``a``'s own indices, so >= 1).  The digit sums of k terms stay below
        k 2^16; carried into 18 rows they hold the value below k p, from
        which 2^j p is subtracted where it fits, j descending."""
        k = a.shape[axis]
        s = a.sum(dim=axis)
        shape = s.shape[1:]
        flat = s.reshape(NH, -1)
        t = torch.zeros((NH + 2, flat.shape[1]), dtype=torch.int64,
                        device=a.device)
        t[:NH] = flat
        _ripple(t)
        for j in range(max(0, (k - 1).bit_length() - 1), -1, -1):
            c = torch.tensor([((self.modulus << j) >> (HB * i)) & MASK
                              for i in range(NH + 2)],
                             dtype=torch.int64, device=a.device)[:, None]
            d = _ripple(t - c)
            t = torch.where(d[-1] < 0, t, d)
        return t[:NH].reshape((NH,) + tuple(shape))

    def to_mont(self, a):
        return self.mul(a, self.const(self.r2_mod, a.device))

    def from_mont(self, a):
        return self.mul(a, self.const(1, a.device))

    # ---- host conversions ----

    def ints_to_h16(self, values, device, mont=False):
        vals = [int(v) % self.modulus for v in values]
        if mont:
            vals = [v * MONT_R % self.modulus for v in vals]
        return words_to_h16(torch.from_numpy(ints_to_words_np(vals)).to(
            device))

    def h16_to_ints(self, a, mont=False):
        vals = words_to_ints(h16_to_words(a))
        if mont:
            return [v * self.r_inv % self.modulus for v in vals]
        return vals


Fq = MontField(FIELD_MODULUS)
Fr = MontField(SNARK_SCALAR_FIELD)


# ---- layout conversions ----

def words_to_h16(w):
    """int32 (..., 8) words -> int64 (16, ...) half-limbs."""
    x = w.to(torch.int64) & 0xFFFFFFFF
    h = torch.stack([x & MASK, x >> HB], dim=-1).reshape(
        tuple(w.shape[:-1]) + (NH,))
    return h.movedim(-1, 0).contiguous()


def h16_to_words(h):
    """int64 (16, ...) half-limbs -> int32 (..., 8) words."""
    h = h.movedim(0, -1)
    x = h[..., 0::2] | (h[..., 1::2] << HB)
    x = x - ((x >> 31) << 32)
    return x.to(torch.int32).contiguous()


def ints_to_words_np(values):
    """Python ints in [0, 2^256) -> (n, 8) int32 numpy words."""
    values = list(values)
    buf = b''.join(int(v).to_bytes(32, 'little') for v in values)
    return np.frombuffer(buf, dtype='<u4').reshape(
        len(values), 8).view(np.int32).copy()


def words_to_ints(w):
    """int32 (..., 8) words -> flat list of python ints."""
    arr = np.ascontiguousarray(
        w.detach().cpu().numpy().astype(np.int32).view('<u4')).reshape(-1, 8)
    raw = arr.tobytes()
    return [int.from_bytes(raw[32 * i:32 * i + 32], 'little')
            for i in range(arr.shape[0])]
