"""Fq2 = Fq[u]/(u^2 + 1) as plain PyTorch (counterpart of
``ethsnarks_tpu/ops/fp_red.py:mk_fq2_red_ops``, :421-445).

An element is one canonical Montgomery h16 tensor ``(16, *batch, 2)``
holding ``(c0, c1)`` on its last axis, so addition is a single Fq call and
the three Karatsuba products run as one batched Fq product."""

import torch

from ..field import FIELD_MODULUS
from .fp import Fq

# 3 * b_twist = 3 * 3 / (9 + u), the G2 curve constant of the RCB15 formulas.
_B2_C = pow(9 ** 2 + 1, -1, FIELD_MODULUS)
B2_COEFFS = (3 * 9 * _B2_C % FIELD_MODULUS, (-3 * _B2_C) % FIELD_MODULUS)
B3_COEFFS = (3 * B2_COEFFS[0] % FIELD_MODULUS,
             3 * B2_COEFFS[1] % FIELD_MODULUS)


def add(a, b):
    return Fq.add(a, b)


def sub(a, b):
    return Fq.sub(a, b)


def mul(a, b):
    """(a0 + a1 u)(b0 + b1 u) = (a0 b0 - a1 b1) + ((a0 + a1)(b0 + b1)
    - a0 b0 - a1 b1) u."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a, b = a.expand(shape), b.expand(shape)
    s = Fq.add(torch.stack([a[..., 0], b[..., 0]], -1),
               torch.stack([a[..., 1], b[..., 1]], -1))
    m = Fq.mul(torch.stack([a[..., 0], a[..., 1], s[..., 0]], -1),
               torch.stack([b[..., 0], b[..., 1], s[..., 1]], -1))
    t = Fq.sub(torch.stack([m[..., 0], m[..., 2]], -1),
               torch.stack([m[..., 1], m[..., 0]], -1))
    return torch.stack([t[..., 0], Fq.sub(t[..., 1], m[..., 1])], -1)


def constant_mont(c0, c1, device, ndim=3):
    """Montgomery h16 of c0 + c1 u, shaped (16, 1, .., 1, 2) with ndim
    axes for broadcasting."""
    c = torch.stack([Fq.const_mont(c0, device)[:, 0],
                     Fq.const_mont(c1, device)[:, 0]], -1)
    return c.reshape((16,) + (1,) * (ndim - 2) + (2,))


def mul_b3(a):
    return mul(a, constant_mont(B3_COEFFS[0], B3_COEFFS[1], a.device,
                                a.dim()))
