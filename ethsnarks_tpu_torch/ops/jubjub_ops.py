"""Batched Baby-JubJub arithmetic on tensors: extended twisted Edwards
(ETEC) point operations, scalar multiplications and the Pedersen hash
(counterpart of ``ethsnarks_tpu/ops/jubjub_ops.py:31-267``), plain
PyTorch on :data:`.fp.Fr` (JubJub's base field is the scalar field r).

A point is a tuple (X, Y, T, Z) of Montgomery h16 tensors (16, *batch).
Everything is branch-free: the HWCD unified addition is complete on this
curve (a a square, d a non-square), so a variable-base scalar
multiplication is a fixed select-and-add loop over the scalar's bits.
Window tables are built on the host from :mod:`..jubjub` and
:mod:`..pedersen`, cached, and moved to each device once.  The
reference's versions are ``jnp`` under ``lax.scan`` and reach no Pallas
kernel, so these are plain torch on the card too.

Equality cross-multiplies (no inversion); affine x takes one batched
Fermat inversion, ``Fr.pow_const(z, r - 2)``.  ``Fr``'s results are
canonical, so equality and bit extraction work on the h16 digits.
"""

from functools import lru_cache

import torch

from ..field import FQ
from ..jubjub import Point, JUBJUB_A, JUBJUB_D, JUBJUB_Q
from ..pedersen import pedersen_hash_basepoint, N_WINDOWS_PER_BASEPOINT
from .fp import NH, HB, Fr

_consts = {}
_tables = {}


def _const(value, device):
    """Montgomery form of ``value``, (16, 1), one tensor per device."""
    key = (value, str(device))
    if key not in _consts:
        _consts[key] = Fr.const_mont(value, device)
    return _consts[key]


def etec_identity(batch_shape, device):
    zero = torch.zeros((NH,) + tuple(batch_shape), dtype=torch.int64,
                       device=device)
    one = _const(1, device).reshape((NH,) + (1,) * len(batch_shape)) \
        .expand_as(zero).contiguous()
    return (zero, one, zero, one)


def etec_identity_like(p):
    return etec_identity(p[0].shape[1:], p[0].device)


def etec_select(cond, p, q):
    """cond (*batch,) bool: p where true, else q."""
    return tuple(torch.where(cond[None], a, b) for a, b in zip(p, q))


def etec_neg(p):
    return (Fr.neg(p[0]), p[1], Fr.neg(p[2]), p[3])


def etec_add(p, q):
    """add-2008-hwcd, unified (complete on this curve)."""
    x1, y1, t1, z1 = p
    x2, y2, t2, z2 = q
    dev = x1.device
    x1x2 = Fr.mul(x1, x2)
    y1y2 = Fr.mul(y1, y2)
    dt1t2 = Fr.mul(Fr.mul(t1, _const(JUBJUB_D, dev)), t2)
    z1z2 = Fr.mul(z1, z2)
    e = Fr.sub(Fr.sub(Fr.mul(Fr.add(x1, y1), Fr.add(x2, y2)), x1x2), y1y2)
    f = Fr.sub(z1z2, dt1t2)
    g = Fr.add(z1z2, dt1t2)
    h = Fr.sub(y1y2, Fr.mul(x1x2, _const(JUBJUB_A, dev)))
    return (Fr.mul(e, f), Fr.mul(g, h), Fr.mul(e, h), Fr.mul(f, g))


def etec_double(p):
    """dbl-2008-hwcd."""
    x, y, _, z = p
    aa = Fr.mul(x, x)
    bb = Fr.mul(y, y)
    zz = Fr.mul(z, z)
    cc = Fr.add(zz, zz)
    dd = Fr.mul(aa, _const(JUBJUB_A, x.device))
    xy = Fr.add(x, y)
    e = Fr.sub(Fr.sub(Fr.mul(xy, xy), aa), bb)
    g = Fr.add(dd, bb)
    f = Fr.sub(g, cc)
    h = Fr.sub(dd, bb)
    return (Fr.mul(e, f), Fr.mul(g, h), Fr.mul(e, h), Fr.mul(f, g))


def etec_equal(p, q):
    """Projective equality, x1 z2 == x2 z1 and y1 z2 == y2 z1: (*batch,)
    bool (canonical values, so digit by digit)."""
    x_ok = (Fr.mul(p[0], q[3]) == Fr.mul(q[0], p[3])).all(0)
    y_ok = (Fr.mul(p[1], q[3]) == Fr.mul(q[1], p[3])).all(0)
    return x_ok & y_ok


def _inv(z):
    return Fr.pow_const(z, Fr.modulus - 2)


def etec_to_affine_x(p):
    """Affine x = X / Z (Montgomery h16), one batched Fermat inversion."""
    return Fr.mul(p[0], _inv(p[3]))


def scalar_mult_bits(point, bits):
    """Variable-base multiple: ``bits`` (nbits, *batch) int64, LSB first.
    Each step adds the running double where the bit is set, then doubles
    it."""
    acc = etec_identity_like(point)
    base = point
    for i in range(bits.shape[0]):
        acc = etec_select(bits[i] != 0, etec_add(acc, base), acc)
        base = etec_double(base)
    return acc


def point_to_device(points, device):
    """Host affine Points -> ETEC tensors (Z = 1) on ``device``."""
    xs = [int(p.x) for p in points]
    ys = [int(p.y) for p in points]
    ts = [x * y % JUBJUB_Q for x, y in zip(xs, ys)]
    x, y, t = (Fr.ints_to_h16(v, device, mont=True) for v in (xs, ys, ts))
    return (x, y, t, _const(1, device).expand_as(x).contiguous())


def device_to_points(p):
    """ETEC tensors (16, B) -> host affine Points."""
    z_inv = _inv(p[3])
    xs = Fr.h16_to_ints(Fr.mul(p[0], z_inv), mont=True)
    ys = Fr.h16_to_ints(Fr.mul(p[1], z_inv), mont=True)
    return [Point(FQ(x), FQ(y)) for x, y in zip(xs, ys)]


def _device_table(key, rows, device):
    """(n_windows, 4, 3, 16) Montgomery h16 on ``device`` from the host
    rows (n_windows x 4 affine points), moved once a device."""
    dkey = key + (str(device),)
    if dkey not in _tables:
        n = len(rows)
        vals = [v for row in rows for pt in row
                for v in (int(pt.x), int(pt.y),
                          int(pt.x) * int(pt.y) % JUBJUB_Q)]
        _tables[dkey] = Fr.ints_to_h16(vals, device, mont=True).reshape(
            NH, n, 4, 3).permute(1, 2, 3, 0).contiguous()
    return _tables[dkey]


def _select(tbl, idx):
    """tbl (4, 3, 16), idx (B,) int64 -> the selected (x, y, t), each
    (16, B)."""
    sel = tbl[idx].permute(1, 2, 0)
    return sel[0], sel[1], sel[2]


# ---------------- Pedersen hash ----------------

@lru_cache(maxsize=None)
def _pedersen_rows(name, n_windows):
    """Per window the 4 positive multiples (affine) of its basepoint
    power; the signs are applied on the device."""
    rows = []
    current = None
    for j in range(n_windows):
        if j % N_WINDOWS_PER_BASEPOINT == 0:
            current = pedersen_hash_basepoint(
                name, j // N_WINDOWS_PER_BASEPOINT)
        else:
            current = current.double().double().double().double()
        rows.append(tuple((current * (w + 1)).as_point() for w in range(4)))
    return tuple(rows)


def _pedersen_tables(name, n_windows, device):
    name = name if isinstance(name, bytes) else name.encode('ascii')
    return _device_table(('pedersen', name, n_windows),
                         _pedersen_rows(name, n_windows), device)


def pedersen_hash_bits_device(name, bits):
    """Batched Pedersen hash: ``bits`` (nbits, B) int64, nbits % 3 == 0.
    Returns the ETEC result (see ``etec_to_affine_x``,
    ``device_to_points``)."""
    nbits, batch = bits.shape
    assert nbits % 3 == 0
    dev = bits.device
    tables = _pedersen_tables(name, nbits // 3, dev)
    one = _const(1, dev)
    acc = etec_identity((batch,), dev)
    for j in range(nbits // 3):
        x, y, t = _select(tables[j], bits[3 * j] + 2 * bits[3 * j + 1])
        neg = bits[3 * j + 2][None] != 0
        x = torch.where(neg, Fr.neg(x), x)
        t = torch.where(neg, Fr.neg(t), t)
        acc = etec_add(acc, (x, y, t, one))
    return acc


# ---------------- fixed-base scalar multiplication ----------------

@lru_cache(maxsize=None)
def _fixed_base_rows(px, py, n_windows):
    """2-bit windows of a fixed point: per window (O, P, 2P, 3P) of its
    power 4^j, entry 0 the identity (0, 1)."""
    current = Point(FQ(px), FQ(py)).as_etec()
    rows = []
    for _ in range(n_windows):
        rows.append((Point(FQ(0), FQ(1)), current.as_point(),
                     current.double().as_point(),
                     (current.double() + current).as_point()))
        current = current.double().double()
    return tuple(rows)


def _fixed_base_tables(px, py, n_windows, device):
    return _device_table(('fixed', px, py, n_windows),
                         _fixed_base_rows(px, py, n_windows), device)


def fixed_base_mult_device(base_point, bits):
    """``bits`` (nbits, B) LSB first -> their value times ``base_point``,
    by 2-bit windows."""
    nbits, batch = bits.shape
    dev = bits.device
    n_windows = (nbits + 1) // 2
    tables = _fixed_base_tables(int(base_point.x), int(base_point.y),
                                n_windows, dev)
    if nbits % 2:
        bits = torch.cat([bits, torch.zeros_like(bits[:1])])
    one = _const(1, dev)
    acc = etec_identity((batch,), dev)
    for j in range(n_windows):
        x, y, t = _select(tables[j], bits[2 * j] + 2 * bits[2 * j + 1])
        acc = etec_add(acc, (x, y, t, one))
    return acc


# ---------------- bit decomposition ----------------

def mont_to_bits(x_mont, nbits=254):
    """Montgomery h16 (16, B) -> LSB-first bits (nbits, B) int64."""
    plain = Fr.from_mont(x_mont)
    i = torch.arange(nbits, device=x_mont.device)
    return (plain[i // HB] >> (i % HB)[:, None]) & 1
