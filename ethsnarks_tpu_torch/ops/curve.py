"""Complete projective BN254 G1/G2 point formulas as plain PyTorch: the
twins of the CUDA kernels in ``csrc/msm_kernels.cu``.

Counterparts: ``ethsnarks_tpu/ops/fp_red.py`` ``g1_add_red`` /
``g1_double_red`` (:356-416) and ``g2_add_red`` / ``g2_double_red``
(:448-503): Renes-Costello-Batina 2015 algorithms 7 and 9 for a = 0, with
3b = 9 on G1 and 3 * b_twist on G2.  Host <-> tensor conversion is the
counterpart of ``ethsnarks_tpu/ops/msm_red.py:100-165``.

Point tensors hold Montgomery words (see :mod:`.fp`):
G1 ``(n, 3, 8)`` int32 (X, Y, Z); G2 ``(n, 3, 2, 8)`` int32 (X, Y, Z, each
``(c0, c1)``).  Infinity is ``(0, 1, 0)``.  Every field result is
canonical, so these twins and the kernels agree bit for bit.
"""

import torch

from ..bn254 import Fq as HostFq, Fq2 as HostFq2
from ..field import FIELD_MODULUS
from . import fp2
from .fp import Fq, MONT_R, words_to_h16, h16_to_words, ints_to_words_np, \
    words_to_ints


class _G1Field(object):
    add = staticmethod(Fq.add)
    sub = staticmethod(Fq.sub)
    mul = staticmethod(Fq.mul)

    @staticmethod
    def mul_b3(a):
        a2 = Fq.add(a, a)
        a4 = Fq.add(a2, a2)
        return Fq.add(Fq.add(a4, a4), a)


class _G2Field(object):
    add = staticmethod(fp2.add)
    sub = staticmethod(fp2.sub)
    mul = staticmethod(fp2.mul)
    mul_b3 = staticmethod(fp2.mul_b3)


def _field(g2):
    return _G2Field if g2 else _G1Field


def _st(*xs):
    return torch.stack(xs, 1)


def rcb_add(f, p, q):
    """RCB15 algorithm 7 (complete addition, a = 0): the sequence of
    ``fp_red.g1_add_red`` and of the kernel, with its independent field
    operations batched into one call each (the values are the same)."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    t = f.mul(_st(x1, y1, z1), _st(x2, y2, z2))
    t0, t1, t2 = t[:, 0], t[:, 1], t[:, 2]
    s = f.add(_st(x1, y1, x1, x2, y2, x2), _st(y1, z1, z1, y2, z2, z2))
    u = f.mul(s[:, 0:3], s[:, 3:6])
    v = f.add(_st(t0, t1, t0), _st(t1, t2, t2))
    w = f.sub(u, v)
    t3, t4, y3 = w[:, 0], w[:, 1], w[:, 2]
    t0 = f.add(f.add(t0, t0), t0)
    b = f.mul_b3(_st(t2, y3))
    t2, y3 = b[:, 0], b[:, 1]
    z3, t1 = f.add(t1, t2), f.sub(t1, t2)
    m = f.mul(_st(t4, t3, y3, t1, t0, z3), _st(y3, t1, t0, z3, t3, t4))
    x3 = f.sub(m[:, 1], m[:, 0])
    yz = f.add(_st(m[:, 3], m[:, 5]), _st(m[:, 2], m[:, 4]))
    return x3, yz[:, 0], yz[:, 1]


def rcb_double(f, p):
    """RCB15 algorithm 9 (complete doubling, a = 0), independent field
    operations batched as in :func:`rcb_add`."""
    x, y, z = p
    t = f.mul(_st(y, y, z, x), _st(y, z, z, y))
    t0, t1, t2, xy = t[:, 0], t[:, 1], t[:, 2], t[:, 3]
    z3 = f.add(t0, t0)
    z3 = f.add(z3, z3)
    z3 = f.add(z3, z3)
    t2 = f.mul_b3(t2)
    m = f.mul(_st(t2, t1), _st(z3, z3))
    x3, z3 = m[:, 0], m[:, 1]
    y3 = f.add(t0, t2)
    t2 = f.add(f.add(t2, t2), t2)
    t0 = f.sub(t0, t2)
    m = f.mul(_st(t0, t0), _st(y3, xy))
    y3 = f.add(x3, m[:, 0])
    x3 = f.add(m[:, 1], m[:, 1])
    return x3, y3, z3


# ---- point tensors <-> h16 coordinates ----

def point_shape(g2):
    return (3, 2, 8) if g2 else (3, 8)


def unpack(points):
    """(n, 3[, 2], 8) words -> h16 coordinates X, Y, Z, each (16, n) on G1
    and (16, n, 2) on G2."""
    h = words_to_h16(points)                    # (16, n, 3[, 2])
    return tuple(h[:, :, i] for i in range(3))


def pack(coords):
    return h16_to_words(torch.stack(coords, dim=2))


def add_points(p, q, g2):
    """Plain complete add of two point tensors of one shape."""
    return pack(rcb_add(_field(g2), unpack(p), unpack(q)))


def point_double_plain(P, g2=False):
    """Plain complete doubling of a point tensor."""
    return pack(rcb_double(_field(g2), unpack(P)))


# ---- the kernels' plain versions (same signatures as ops/kernels.py) ----

def point_add_plain(P, Q, ia=None, ib=None, g2=False):
    """out[i] = P[ia[i]] + Q[ib[i]]; missing index tensors mean i; a lane
    with ib[i] = -1 passes P[ia[i]] through."""
    pa = P if ia is None else P[ia]
    if ib is None:
        return add_points(pa, Q[:pa.shape[0]], g2)
    qb = Q[ib.clamp(min=0)]
    out = add_points(pa, qb, g2)
    keep = (ib < 0).reshape((-1,) + (1,) * (P.dim() - 1))
    return torch.where(keep, pa, out)


def horner_plain(W, c, g2=False):
    """W: (n_win, batch, *point) windows, least significant first.
    acc = W[n_win-1]; for w = n_win-2 .. 0: acc = 2^c * acc + W[w]."""
    acc = W[-1]
    for w in range(W.shape[0] - 2, -1, -1):
        for _ in range(c):
            acc = point_double_plain(acc, g2)
        acc = add_points(acc, W[w], g2)
    return acc


# ---- host <-> tensor ----

def _mont_words(values):
    return ints_to_words_np([int(v) * MONT_R % FIELD_MODULUS
                             for v in values])


def identity(n, g2, device):
    """n copies of the identity (0, 1, 0) in Montgomery words."""
    out = torch.zeros((n,) + point_shape(g2), dtype=torch.int32,
                      device=device)
    one = torch.from_numpy(_mont_words([1])[0]).to(device)
    if g2:
        out[:, 1, 0] = one
    else:
        out[:, 1] = one
    return out


def g1_to_tensor(points, device):
    """Host affine G1 points (or None) -> (n, 3, 8) Montgomery words."""
    vals = []
    for p in points:
        vals += [0, 1, 0] if p is None else [p[0].n, p[1].n, 1]
    return torch.from_numpy(_mont_words(vals).reshape(-1, 3, 8)).to(device)


def g2_to_tensor(points, device):
    vals = []
    for p in points:
        if p is None:
            vals += [0, 0, 1, 0, 0, 0]
        else:
            vals += p[0].coeffs + p[1].coeffs + [1, 0]
    return torch.from_numpy(
        _mont_words(vals).reshape(-1, 3, 2, 8)).to(device)


def _unmont(words):
    rinv = pow(MONT_R, -1, FIELD_MODULUS)
    return [v * rinv % FIELD_MODULUS for v in words_to_ints(words)]


def tensor_to_g1(P):
    """(n, 3, 8) Montgomery words -> host affine points (None = inf)."""
    v = _unmont(P)
    out = []
    for i in range(0, len(v), 3):
        x, y, z = v[i:i + 3]
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, FIELD_MODULUS)
            out.append((HostFq(x * zi), HostFq(y * zi)))
    return out


def tensor_to_g2(P):
    v = _unmont(P)
    out = []
    for i in range(0, len(v), 6):
        x0, x1, y0, y1, z0, z1 = v[i:i + 6]
        if z0 == 0 and z1 == 0:
            out.append(None)
        else:
            zi = HostFq2([z0, z1]).inv()
            out.append((HostFq2([x0, x1]) * zi, HostFq2([y0, y1]) * zi))
    return out
