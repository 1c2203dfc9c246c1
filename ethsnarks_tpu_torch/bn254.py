"""Exact host BN254 affine G1/G2 arithmetic (own copy of the parts of
``ethsnarks_tpu/bn254.py`` the prover, the setup and the pairing need).

Serves host finalisation (alpha + A, beta + B, H + L), the setup's header
points, the verifier and exact oracles.  Fq2 = Fq[u]/(u^2 + 1),
coefficients ``[c0, c1]``; G2 lies on the twist y^2 = x^3 + 3/(9 + u);
Fq12 = Fq[w]/(w^12 - 18 w^6 + 82) with u = w^6 - 9, as in py_ecc.  Points
are affine tuples, ``None`` is infinity.
"""

from .field import FIELD_MODULUS, CURVE_ORDER

q = FIELD_MODULUS

# BN parameter x0: q = 36x^4 + 36x^3 + 24x^2 + 6x + 1.
BN_X = 4965661367192848881
ATE_LOOP_COUNT = 6 * BN_X + 2


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


class Fq12(object):
    """Fq[w]/(w^12 - 18 w^6 + 82), coefficients of w^0 .. w^11."""
    __slots__ = ('coeffs',)
    degree = 12
    # w^12 = -sum MODULUS_COEFFS[i] w^i
    MODULUS_COEFFS = (82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0)

    def __init__(self, coeffs):
        assert len(coeffs) == self.degree
        self.coeffs = [c.n if isinstance(c, Fq) else c % q for c in coeffs]

    @classmethod
    def one(cls):
        return cls([1] + [0] * (cls.degree - 1))

    def __add__(self, o):
        return Fq12([a + b for a, b in zip(self.coeffs, o.coeffs)])

    def __sub__(self, o):
        return Fq12([a - b for a, b in zip(self.coeffs, o.coeffs)])

    def __neg__(self):
        return Fq12([-c for c in self.coeffs])

    def __mul__(self, o):
        if isinstance(o, (int, Fq)):
            s = Fq._v(o)
            return Fq12([c * s for c in self.coeffs])
        d = self.degree
        prod = [0] * (2 * d - 1)
        for i, a in enumerate(self.coeffs):
            if a:
                for j, b in enumerate(o.coeffs):
                    prod[i + j] += a * b
        for k in range(2 * d - 2, d - 1, -1):
            top = prod[k] % q
            if top:
                prod[k] = 0
                for i, c in enumerate(self.MODULUS_COEFFS):
                    if c:
                        prod[k - d + i] -= top * c
        return Fq12(prod[:d])

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, (int, Fq)):
            return self * pow(Fq._v(o), -1, q)
        return self * o.inv()

    def __pow__(self, e):
        result, base = Fq12.one(), self
        while e > 0:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def inv(self):
        """Extended Euclid over Fq[w] against the modulus polynomial."""
        d = self.degree

        def pdeg(p):
            for i in range(len(p) - 1, -1, -1):
                if p[i]:
                    return i
            return -1

        def pdivmod(a, b):
            a = list(a)
            db = pdeg(b)
            inv_lead = pow(b[db], -1, q)
            quot = [0] * max(pdeg(a) - db + 1, 1)
            for i in range(pdeg(a) - db, -1, -1):
                factor = a[i + db] * inv_lead % q
                quot[i] = factor
                if factor:
                    for j in range(db + 1):
                        a[i + j] = (a[i + j] - factor * b[j]) % q
            return quot, a

        def psub_mul(s, qpoly, t):
            """s - qpoly * t."""
            out = list(s) + [0] * max(0, pdeg(qpoly) + pdeg(t) + 1 - len(s))
            for i, qc in enumerate(qpoly):
                if qc:
                    for j, tc in enumerate(t):
                        if tc:
                            out[i + j] = (out[i + j] - qc * tc) % q
            return out

        r0 = [c % q for c in self.MODULUS_COEFFS] + [1]
        r1 = list(self.coeffs)
        s0, s1 = [0], [1]
        while pdeg(r1) > 0:
            quot, rem = pdivmod(r0, r1)
            r0, r1 = r1, rem
            s0, s1 = s1, psub_mul(s0, quot, s1)
        assert pdeg(r1) == 0, "non-invertible element"
        c = pow(r1[0], -1, q)
        out = [x * c % q for x in s1[:d]]
        return Fq12(out + [0] * (d - len(out)))

    def __eq__(self, o):
        return isinstance(o, Fq12) and self.coeffs == o.coeffs

    def __ne__(self, o):
        return not self == o

    def __hash__(self):
        return hash(tuple(self.coeffs))

    def __repr__(self):
        return 'Fq12(%r)' % (self.coeffs,)


B1 = Fq(3)
B2 = Fq2([3, 0]) / Fq2([9, 1])

G1_GEN = (Fq(1), Fq(2))
G2_GEN = (
    Fq2([10857046999023057135944570762232829481370756359578518086990519993285655852781,
         11559732032986387107991004021392285783925812861821192530917403151452391805634]),
    Fq2([8495653923123431417604973247489272438418190587263600148770280649306958101930,
         4082367875863433681332203403145435568316851327593401208105741076214120093531]))


def is_inf(pt):
    return pt is None


def is_on_curve(pt, b):
    if pt is None:
        return True
    x, y = pt
    return y * y - x * x * x == b


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
