"""Jacobi symbol, modular inverse and modular square roots (own copy of
``ethsnarks_tpu/numbertheory.py:11-114``).

``square_root_mod_prime`` returns the same root as the reference library
(for the BN254 scalar field, p % 8 == 1: HAC algorithm 3.39, by powers of
x modulo x^2 - b x + a), so a point recovered from one coordinate is the
same point in every implementation.
"""


class SquareRootError(ArithmeticError):
    pass


class NegativeExponentError(ArithmeticError):
    pass


def modular_exp(base, exponent, modulus):
    if exponent < 0:
        raise NegativeExponentError("negative exponent %d" % (exponent,))
    return pow(base, exponent, modulus)


def jacobi(a, n):
    """Jacobi symbol (a/n) for odd n >= 3 (HAC algorithm 2.149)."""
    assert n >= 3 and n % 2 == 1
    a = a % n
    if a == 0:
        return 0
    result = 1
    while a != 0:
        # each factor of two contributes (2/n)
        while a % 2 == 0:
            a //= 2
            if n % 8 in (3, 5):
                result = -result
        a, n = n, a
        # quadratic reciprocity for odd a, n
        if a % 4 == 3 and n % 4 == 3:
            result = -result
        a = a % n
    if n == 1:
        return result
    return 0


def inverse_mod(a, m):
    """a^-1 mod m (m need not be prime)."""
    return pow(a, -1, m)


def _poly_mul_mod_quadratic(u, v, b, a, p):
    """(u0 + u1 x)(v0 + v1 x) mod (x^2 - b x + a) over GF(p), with
    x^2 = b x - a."""
    u0, u1 = u
    v0, v1 = v
    t2 = (u1 * v1) % p
    c0 = (u0 * v0 - t2 * a) % p
    c1 = (u0 * v1 + u1 * v0 + t2 * b) % p
    return (c0, c1)


def square_root_mod_prime(a, p):
    """A square root of a modulo the prime p, the reference's choice of the
    two: HAC 3.36 (p % 4 == 3), 3.37 (p % 8 == 5) and 3.39 otherwise (the
    smallest b >= 2 with (b^2 - 4a / p) = -1, then x^((p+1)/2) mod
    (x^2 - b x + a), whose constant term is the root)."""
    assert 0 <= a < p
    assert 1 < p

    if a == 0:
        return 0
    if p == 2:
        return a

    if jacobi(a, p) == -1:
        raise SquareRootError("%d has no square root modulo %d" % (a, p))

    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)

    if p % 8 == 5:
        d = pow(a, (p - 1) // 4, p)
        if d == 1:
            return pow(a, (p + 3) // 8, p)
        assert d == p - 1
        return (2 * a * pow(4 * a, (p - 5) // 8, p)) % p

    for b in range(2, p):
        if jacobi((b * b - 4 * a) % p, p) == -1:
            exponent = (p + 1) // 2
            result = (1, 0)
            g = (0, 1)              # the polynomial x
            if exponent % 2 == 1:
                result = g
            e = exponent
            while e > 1:
                e //= 2
                g = _poly_mul_mod_quadratic(g, g, b, a, p)
                if e % 2 == 1:
                    result = _poly_mul_mod_quadratic(g, result, b, a, p)
            assert result[1] == 0
            return result[0]
    raise RuntimeError("no suitable b found for square root")
