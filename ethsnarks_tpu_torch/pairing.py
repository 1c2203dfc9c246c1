"""Optimal-ate pairing on BN254, host and exact (own copy of
``ethsnarks_tpu/pairing.py``).

The twisted G2 point is lifted into E(Fq12) (u = w^6 - 9), the Miller loop
runs with affine line functions over Fq12, and a product of pairings
shares one final exponentiation, as the EVM precompile does.
:class:`G2Precomp` and :func:`miller_loop_precomp` split the loop for a
fixed G2 point (the processed verifying key's gamma and delta): the
point steps and slopes once, the line evaluations per proof.
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


# ---------------- precomputed-G2 Miller loop (processed VK) ----------------

def _line_coeffs(p1, p2):
    """The line through p1, p2 (tangent when equal) on E(Fq12) as (kind,
    m, x1, y1): it evaluates at t to m (xt - x1) - (yt - y1), or to
    xt - x1 for a vertical line (kind 'v')."""
    x1, y1 = p1
    x2, y2 = p2
    if x1 != x2:
        return ('l', (y2 - y1) / (x2 - x1), x1, y1)
    if y1 == y2:
        return ('l', (3 * (x1 * x1)) / (2 * y1), x1, y1)
    return ('v', None, x1, y1)


class G2Precomp(object):
    """The Miller loop's line coefficients for a fixed G2 point ``q``: the
    point doublings and additions of R and every slope (all the Fq12
    inversions) run once here; :func:`miller_loop_precomp` then does only
    the line evaluations and the updates of f."""

    def __init__(self, q):
        assert is_on_curve(q, B2), "Q not on twist"
        self.q = q
        qt = twist(q)
        steps = []   # ('dbl' | 'add', kind, m, x1, y1)
        r = qt
        for i in range(ATE_LOOP_COUNT.bit_length() - 2, -1, -1):
            steps.append(('dbl',) + _line_coeffs(r, r))
            r = double(r)
            if ATE_LOOP_COUNT & (1 << i):
                steps.append(('add',) + _line_coeffs(r, qt))
                r = add(r, qt)
        q1 = (qt[0] ** FIELD_MODULUS, qt[1] ** FIELD_MODULUS)
        nq2 = (q1[0] ** FIELD_MODULUS, -(q1[1] ** FIELD_MODULUS))
        steps.append(('add',) + _line_coeffs(r, q1))
        r = add(r, q1)
        steps.append(('add',) + _line_coeffs(r, nq2))
        self.steps = steps


def miller_loop_precomp(precomp, p):
    """The Miller loop of a host affine G1 point ``p`` against a
    :class:`G2Precomp`: equal to ``miller_loop(twist(q), cast_g1_to_fq12(p))``
    coefficient for coefficient."""
    if is_inf(p):
        return Fq12.one()
    xt, yt = cast_g1_to_fq12(p)
    f = Fq12.one()
    for op, kind, m, x1, y1 in precomp.steps:
        val = m * (xt - x1) - (yt - y1) if kind == 'l' else xt - x1
        f = f * f * val if op == 'dbl' else f * val
    return f
