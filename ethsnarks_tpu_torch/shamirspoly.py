"""Shamir secret-sharing polynomial and Lagrange interpolation over the
host ``FQ`` (own copy of ``ethsnarks_tpu/shamirspoly.py``).

The three entry points take and return :class:`.field.FQ` elements:
:func:`shamirs_poly` evaluates sum(a_i x^i), :func:`lagrange` the
polynomial through the points at x, :func:`inverse_lagrange` the
interpolation with the coordinates' roles swapped.  The circuit form is
``gadgets.arith.shamir_poly``.
"""

from .field import FQ


def _expect_fq(v, what):
    if not isinstance(v, FQ):
        raise TypeError("%s must be an FQ element, got %s"
                        % (what, type(v).__name__))
    return v


def shamirs_poly(x, a):
    """sum(a_i * x^i) by Horner's rule (the last coefficient first)."""
    if not isinstance(a, (list, tuple)) or len(a) < 2:
        raise ValueError("coefficient vector needs degree >= 1")
    _expect_fq(x, "evaluation point")
    for a_i in a:
        _expect_fq(a_i, "coefficient")
    acc = a[-1]
    for a_i in reversed(a[:-1]):
        acc = acc * x + a_i
    return acc


def _basis_at(xs, i, x):
    """The i-th Lagrange basis polynomial of ``xs`` at x."""
    num, den = 1, 1
    xi = xs[i]
    for j, xj in enumerate(xs):
        if j != i:
            num = (x - xj) * num
            den = (xi - xj) * den
    return num / den


def lagrange(points, x):
    """The polynomial through ``points`` ((x, y) pairs) evaluated at x."""
    for xi, yi in points:
        _expect_fq(xi, "x coordinate")
        _expect_fq(yi, "y coordinate")
    xs = [p[0] for p in points]
    acc = 0
    for i, (_, yi) in enumerate(points):
        acc = yi * _basis_at(xs, i, x) + acc
    return acc


def inverse_lagrange(points, y):
    """x(y): the same interpolation with the coordinates swapped."""
    ys = [p[1] for p in points]
    acc = 0
    for i, (xi, _) in enumerate(points):
        acc = xi * _basis_at(ys, i, y) + acc
    return acc
