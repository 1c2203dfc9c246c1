"""Complete projective BN254 G1/G2 point formulas as plain PyTorch: the
twins of the CUDA kernels in ``csrc/msm_kernels.cu`` and
``csrc/setup_kernels.cu``.

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


def point_double_plain(P, g2=False, n=1):
    """Plain complete doubling of a point tensor, n times: 2^n P."""
    f, p = _field(g2), unpack(P)
    for _ in range(n):
        p = rcb_double(f, p)
    return pack(p)


# ---- the kernels' plain versions (same signatures as ops/kernels.py) ----

def point_add_plain(P, Q, ia=None, ib=None, g2=False):
    """out[i] = P[ia[i]] + Q[ib[i]]; missing index tensors mean i; a lane
    with ib[i] = -1 passes P[ia[i]] through."""
    pa = P if ia is None else P[ia]
    if ib is None:
        return add_points(pa, Q[:pa.shape[0]], g2)
    out = pa.clone()
    sel = torch.nonzero(ib >= 0).squeeze(1)      # the lanes that add
    if sel.numel():
        out[sel] = add_points(pa[sel], Q[ib[sel]], g2)
    return out


def horner_plain(W, c, g2=False):
    """W: (n_win, batch, *point) windows, least significant first.
    acc = W[n_win-1]; for w = n_win-2 .. 0: acc = 2^c * acc + W[w]."""
    acc = W[-1]
    for w in range(W.shape[0] - 2, -1, -1):
        for _ in range(c):
            acc = point_double_plain(acc, g2)
        acc = add_points(acc, W[w], g2)
    return acc


def scalar_digits(scalars, n_win, c):
    """int32 (n, 8) words of 256-bit scalars -> (n_win, n) int64 c-bit
    window digits, window 0 least significant (bits past 256 read 0)."""
    if not 1 <= c <= 32:
        raise ValueError("window width %d outside 1..32" % c)
    x = scalars.to(torch.int64) & 0xFFFFFFFF
    x = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
    mask = (1 << c) - 1
    rows = []
    for w in range(n_win):
        i0, sh = divmod(w * c, 32)
        if i0 >= 8:
            rows.append(torch.zeros_like(x[:, 0]))
            continue
        d = x[:, i0] >> sh
        if sh + c > 32:
            d = d | (x[:, i0 + 1] << (32 - sh))
        rows.append(d & mask)
    return torch.stack(rows)


def fixed_base_plain(table, scalars, n_win, c, g2=False):
    """out[i] = s_i * base from the window table (entry w*2^c + d =
    d * 2^(c*w) * base): window 0 first, the first nonzero digit loads its
    table point, each later nonzero digit adds its table point; a zero
    scalar gives the identity.  The sequence of the K4 kernel."""
    n = scalars.shape[0]
    digits = scalar_digits(scalars, n_win, c)
    acc = identity(n, g2, table.device)
    started = torch.zeros(n, dtype=torch.bool, device=table.device)
    bcast = (-1,) + (1,) * len(point_shape(g2))
    for w in range(n_win):
        d = digits[w]
        t = table[(w << c) + d]
        s = add_points(acc, t, g2)
        nz = d != 0
        acc = torch.where((nz & started).reshape(bcast), s,
                          torch.where(nz.reshape(bcast), t, acc))
        started |= nz
    return acc


# ---- host <-> tensor ----

def mont_words(values):
    """Python ints -> (n, 8) int32 words of their Montgomery residues."""
    return ints_to_words_np([int(v) * MONT_R % FIELD_MODULUS
                             for v in values])


def identity(n, g2, device):
    """n copies of the identity (0, 1, 0) in Montgomery words."""
    out = torch.zeros((n,) + point_shape(g2), dtype=torch.int32,
                      device=device)
    one = torch.from_numpy(mont_words([1])[0]).to(device)
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
    return torch.from_numpy(mont_words(vals).reshape(-1, 3, 8)).to(device)


def g2_to_tensor(points, device):
    vals = []
    for p in points:
        if p is None:
            vals += [0, 0, 1, 0, 0, 0]
        else:
            vals += p[0].coeffs + p[1].coeffs + [1, 0]
    return torch.from_numpy(
        mont_words(vals).reshape(-1, 3, 2, 8)).to(device)


def _batch_inverse(vals):
    """Inverses mod q of a list of ints by one modular inversion
    (Montgomery's trick); zeros stay zero."""
    q = FIELD_MODULUS
    prefix, acc = [], 1
    for v in vals:
        prefix.append(acc)
        if v:
            acc = acc * v % q
    inv = pow(acc, -1, q)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        v = vals[i]
        if v:
            out[i] = inv * prefix[i] % q
            inv = inv * v % q
    return out


def affine_ints(P, g2=False):
    """(n, 3[, 2], 8) projective Montgomery words -> (x, y) affine
    coordinates as plain ints (each a list of n ints on G1, of n [c0, c1]
    pairs on G2; 0 where Z = 0), and the list of Z = 0 (infinity) flags.
    One batch inversion for all n points."""
    q = FIELD_MODULUS
    rinv = pow(MONT_R, -1, q)
    v = [w * rinv % q for w in words_to_ints(P)]
    if not g2:
        xs, ys, zs = v[0::3], v[1::3], v[2::3]
        zi = _batch_inverse(zs)
        return ([x * z % q for x, z in zip(xs, zi)],
                [y * z % q for y, z in zip(ys, zi)], [z == 0 for z in zs])
    z0s, z1s = v[4::6], v[5::6]
    ni = _batch_inverse([(a * a + b * b) % q for a, b in zip(z0s, z1s)])
    out = ([], [])
    for i, (z0, z1, n) in enumerate(zip(z0s, z1s, ni)):
        zi0, zi1 = z0 * n % q, -z1 * n % q          # 1 / (z0 + z1 u)
        for k in range(2):
            a0, a1 = v[6 * i + 2 * k], v[6 * i + 2 * k + 1]
            out[k].append([(a0 * zi0 - a1 * zi1) % q,
                           (a0 * zi1 + a1 * zi0) % q])
    return out[0], out[1], [z0 == 0 and z1 == 0 for z0, z1 in zip(z0s, z1s)]


def tensor_to_g1(P):
    """(n, 3, 8) Montgomery words -> host affine points (None = inf)."""
    xs, ys, inf = affine_ints(P)
    return [None if i else (HostFq(x), HostFq(y))
            for x, y, i in zip(xs, ys, inf)]


def tensor_to_g2(P):
    xs, ys, inf = affine_ints(P, g2=True)
    return [None if i else (HostFq2(x), HostFq2(y))
            for x, y, i in zip(xs, ys, inf)]
