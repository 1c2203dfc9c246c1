"""Optimal-ate pairing on BN254, host and exact (own copy of
``ethsnarks_tpu/pairing.py:1-108``).

The twisted G2 point is lifted into E(Fq12) (u = w^6 - 9), the Miller loop
runs with affine line functions over Fq12, and a product of pairings
shares one final exponentiation, as the EVM precompile does.  The
precomputed-G2 loop of the processed verifying key is not ported yet.
"""

from .bn254 import (
    Fq12, FIELD_MODULUS, CURVE_ORDER, ATE_LOOP_COUNT, add, double, is_inf,
    is_on_curve, B1, B2)

_W = Fq12([0, 1] + [0] * 10)
_W2 = _W * _W
_W3 = _W2 * _W


def twist(pt):
    """Lift a G2 (Fq2) point onto E(Fq12): undo the 9 + u shift, embed
    u = w^6 - 9, then scale x by w^2 and y by w^3."""
    if is_inf(pt):
        return None
    x, y = pt
    xc = [(x.coeffs[0] - 9 * x.coeffs[1]) % FIELD_MODULUS, x.coeffs[1]]
    yc = [(y.coeffs[0] - 9 * y.coeffs[1]) % FIELD_MODULUS, y.coeffs[1]]
    nx = Fq12([xc[0]] + [0] * 5 + [xc[1]] + [0] * 5)
    ny = Fq12([yc[0]] + [0] * 5 + [yc[1]] + [0] * 5)
    return (nx * _W2, ny * _W3)


def cast_g1_to_fq12(pt):
    if is_inf(pt):
        return None
    x, y = pt
    return (Fq12([x.n] + [0] * 11), Fq12([y.n] + [0] * 11))


def _linefunc(p1, p2, t):
    """The line through p1, p2 (tangent when equal) evaluated at t."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = (y2 - y1) / (x2 - x1)
        return m * (xt - x1) - (yt - y1)
    if y1 == y2:
        m = (3 * (x1 * x1)) / (2 * y1)
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def miller_loop(q_twisted, p_cast):
    """Miller loop (no final exponentiation) for e(P, Q)."""
    if q_twisted is None or p_cast is None:
        return Fq12.one()
    r = q_twisted
    f = Fq12.one()
    for i in range(ATE_LOOP_COUNT.bit_length() - 2, -1, -1):
        f = f * f * _linefunc(r, r, p_cast)
        r = double(r)
        if ATE_LOOP_COUNT & (1 << i):
            f = f * _linefunc(r, q_twisted, p_cast)
            r = add(r, q_twisted)
    # Frobenius corrections of the optimal ate pairing for BN curves
    q1 = (q_twisted[0] ** FIELD_MODULUS, q_twisted[1] ** FIELD_MODULUS)
    nq2 = (q1[0] ** FIELD_MODULUS, -(q1[1] ** FIELD_MODULUS))
    f = f * _linefunc(r, q1, p_cast)
    r = add(r, q1)
    f = f * _linefunc(r, nq2, p_cast)
    return f


_FINAL_EXP = (FIELD_MODULUS ** 12 - 1) // CURVE_ORDER


def final_exponentiate(f):
    return f ** _FINAL_EXP


def pairing(q, p):
    """e(p in G1, q in G2) -> Fq12 (py_ecc's argument order)."""
    assert is_on_curve(q, B2), "Q not on twist"
    assert is_on_curve(p, B1), "P not on G1"
    return final_exponentiate(miller_loop(twist(q), cast_g1_to_fq12(p)))


def pairing_product_is_one(pairs):
    """prod e(p_i, q_i) == 1 over (g1_point, g2_point) pairs, with one
    shared final exponentiation."""
    acc = Fq12.one()
    for p, q in pairs:
        assert is_on_curve(p, B1), "P not on G1"
        assert is_on_curve(q, B2), "Q not on twist"
        acc = acc * miller_loop(twist(q), cast_g1_to_fq12(p))
    return final_exponentiate(acc) == Fq12.one()
