"""Radix-2 NTT over the BN254 scalar field as plain PyTorch (counterpart of
``ethsnarks_tpu/ops/ntt.py:75-239``).

Same conventions as the reference: the forward transform is
decimation-in-frequency (natural -> bit-reversed), its companion
decimation-in-time (bit-reversed -> natural); no bit-reversal permutation
is ever materialised, and pointwise constants applied while the data is in
bit-reversed order (coset powers with 1/m folded in) are stored
bit-reversed.  Both transforms accept B stacked m-vectors ``(16, B*m)``: a
butterfly span never crosses an m boundary.

Elements are canonical Montgomery h16 tensors of :mod:`.fp` (``Fr``).  The
constant planes are built on the target device by repeated doubling of
power series with the same field product.
"""

import torch

from ..field import SNARK_SCALAR_FIELD
from .fp import Fr, NH

R = SNARK_SCALAR_FIELD
MULT_GEN = 5
TWO_ADICITY = 28
_ROOT_OF_UNITY = pow(MULT_GEN, (R - 1) >> TWO_ADICITY, R)


def bitrev_indices(m, device):
    k = m.bit_length() - 1
    idx = torch.arange(m, device=device)
    out = torch.zeros_like(idx)
    for b in range(k):
        out |= ((idx >> b) & 1) << (k - 1 - b)
    return out


def pow_series(w, n, device):
    """[w^0 .. w^(n-1)] as Montgomery h16 (16, n): log2(n) doubling
    products on the device."""
    out = Fr.const_mont(1, device)
    wk = w % R
    while out.shape[1] < n:
        out = torch.cat([out, Fr.mul(out, Fr.const_mont(wk, device))], dim=1)
        wk = wk * wk % R
    return out[:, :n].contiguous()


class NttDomain(object):
    """Evaluation domain of size m = 2^k with coset support."""

    def __init__(self, m, device):
        if m < 2 or m & (m - 1):
            raise ValueError("domain size %d is not a power of two >= 2" % m)
        self.m = m
        self.k = m.bit_length() - 1
        if self.k > TWO_ADICITY:
            raise ValueError("domain 2^%d exceeds Fr's 2-adicity" % self.k)
        self.device = torch.device(device)
        self.omega = pow(_ROOT_OF_UNITY, 1 << (TWO_ADICITY - self.k), R)
        self.omega_inv = pow(self.omega, -1, R)
        self.m_inv = pow(m, -1, R)
        self.coset_gen = coset_gen = MULT_GEN
        self.bitrev = bitrev_indices(m, self.device)

        # Stage s twiddles are omega^(2^s j): stride-2^s views of one series.
        self.tw_fwd = pow_series(self.omega, m // 2, self.device)
        self.tw_inv = pow_series(self.omega_inv, m // 2, self.device)
        m_inv = Fr.const_mont(self.m_inv, self.device)
        g_pows = pow_series(coset_gen, m, self.device)[:, self.bitrev]
        g_inv_pows = pow_series(pow(coset_gen, -1, R), m,
                                self.device)[:, self.bitrev]
        # g^i / m and g^-i / m, bit-reversed: the 1/m of the inverse
        # transform fused with the coset shift
        self.coset_scale_m_inv_bitrev = Fr.mul(g_pows, m_inv)
        self.coset_unscale_m_inv_bitrev = Fr.mul(g_inv_pows, m_inv)
        z_coset = (pow(coset_gen, m, R) - 1) % R
        self.z_coset_inv = Fr.const_mont(pow(z_coset, -1, R), self.device)

    def stage_twiddles(self, series, s):
        return series[:, ::1 << s][:, :(self.m >> s) // 2]

    def dif(self, x, series):
        """Natural -> bit-reversed, butterfly (u, v) -> (u + v, (u - v) w^j).
        x: (16, B*m)."""
        for s in range(self.k):
            x = dif_stage(x, self.stage_twiddles(series, s), self.m >> s)
        return x

    def dit(self, x, series):
        """Bit-reversed -> natural, butterfly (u, v) -> (u + v w^j, u - v w^j).
        x: (16, B*m)."""
        for s in range(self.k - 1, -1, -1):
            x = dit_stage(x, self.stage_twiddles(series, s), self.m >> s)
        return x


def dif_stage(x, tw, n):
    """One DIF stage of butterfly span n on (16, B*n*j) blocks of n: (u, v)
    -> (u + v, (u - v) tw), tw the (16, n/2) twiddles of the span."""
    x = x.reshape(NH, -1, n)
    u, v = x[:, :, :n // 2], x[:, :, n // 2:]
    x = torch.cat([Fr.add(u, v), Fr.mul(Fr.sub(u, v), tw[:, None, :])],
                  dim=2)
    return x.reshape(NH, -1)


def dit_stage(x, tw, n):
    """One DIT stage of span n: (u, v) -> (u + v tw, u - v tw)."""
    x = x.reshape(NH, -1, n)
    u, v = x[:, :, :n // 2], x[:, :, n // 2:]
    t = Fr.mul(v, tw[:, None, :])
    x = torch.cat([Fr.add(u, t), Fr.sub(u, t)], dim=2)
    return x.reshape(NH, -1)
