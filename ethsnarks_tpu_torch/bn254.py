"""Exact host BN254 affine G1/G2 arithmetic (own copy of the parts of
``ethsnarks_tpu/bn254.py`` the prover needs).

Serves host finalisation (alpha + A, beta + B, H + L) and exact oracles.
Fq2 = Fq[u]/(u^2 + 1), coefficients ``[c0, c1]``; G2 lies on the twist
y^2 = x^3 + 3/(9 + u).  Points are affine tuples, ``None`` is infinity.
"""

from .field import FIELD_MODULUS, CURVE_ORDER

q = FIELD_MODULUS


class Fq(object):
    __slots__ = ('n',)

    def __init__(self, n):
        self.n = n.n if isinstance(n, Fq) else n % q

    @staticmethod
    def _v(o):
        return o.n if isinstance(o, Fq) else o

    def __add__(self, o):
        return Fq(self.n + self._v(o))

    __radd__ = __add__

    def __sub__(self, o):
        return Fq(self.n - self._v(o))

    def __rsub__(self, o):
        return Fq(self._v(o) - self.n)

    def __mul__(self, o):
        return Fq(self.n * self._v(o))

    __rmul__ = __mul__

    def __neg__(self):
        return Fq(-self.n)

    def inv(self):
        return Fq(pow(self.n, -1, q))

    def __truediv__(self, o):
        return self * Fq(self._v(o)).inv()

    def __eq__(self, o):
        return self.n == (self._v(o) % q)

    def __ne__(self, o):
        return not self == o

    def __hash__(self):
        return hash(self.n)

    def __repr__(self):
        return 'Fq(%d)' % self.n


class Fq2(object):
    __slots__ = ('coeffs',)

    def __init__(self, coeffs):
        assert len(coeffs) == 2
        self.coeffs = [c.n if isinstance(c, Fq) else c % q for c in coeffs]

    def __add__(self, o):
        return Fq2([a + b for a, b in zip(self.coeffs, o.coeffs)])

    def __sub__(self, o):
        return Fq2([a - b for a, b in zip(self.coeffs, o.coeffs)])

    def __neg__(self):
        return Fq2([-c for c in self.coeffs])

    def __mul__(self, o):
        a0, a1 = self.coeffs
        if isinstance(o, (int, Fq)):
            s = Fq._v(o)
            return Fq2([a0 * s, a1 * s])
        b0, b1 = o.coeffs
        return Fq2([a0 * b0 - a1 * b1, a0 * b1 + a1 * b0])

    __rmul__ = __mul__

    def inv(self):
        a0, a1 = self.coeffs
        d = pow(a0 * a0 + a1 * a1, -1, q)
        return Fq2([a0 * d, -a1 * d])

    def __truediv__(self, o):
        if isinstance(o, (int, Fq)):
            return self * pow(Fq._v(o), -1, q)
        return self * o.inv()

    def __eq__(self, o):
        return isinstance(o, Fq2) and self.coeffs == o.coeffs

    def __ne__(self, o):
        return not self == o

    def __hash__(self):
        return hash(tuple(self.coeffs))

    def __repr__(self):
        return 'Fq2(%r)' % (self.coeffs,)


G1_GEN = (Fq(1), Fq(2))
G2_GEN = (
    Fq2([10857046999023057135944570762232829481370756359578518086990519993285655852781,
         11559732032986387107991004021392285783925812861821192530917403151452391805634]),
    Fq2([8495653923123431417604973247489272438418190587263600148770280649306958101930,
         4082367875863433681332203403145435568316851327593401208105741076214120093531]))


def double(pt):
    if pt is None:
        return None
    x, y = pt
    m = (x * x * 3) / (y * 2)
    nx = m * m - x * 2
    return (nx, -(m * nx) + m * x - y)


def add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        return double(p1) if y1 == y2 else None
    m = (y2 - y1) / (x2 - x1)
    nx = m * m - x1 - x2
    return (nx, -(m * nx) + m * x1 - y1)


def neg(pt):
    if pt is None:
        return None
    return (pt[0], -pt[1])


def multiply(pt, n):
    if n < 0:
        return multiply(neg(pt), -n)
    result = None
    addend = pt
    while n:
        if n & 1:
            result = add(result, addend)
        addend = double(addend)
        n >>= 1
    return result
