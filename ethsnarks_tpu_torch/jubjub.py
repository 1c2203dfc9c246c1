"""Baby-JubJub, the twisted Edwards curve over the BN254 scalar field,
host oracle (own copy of ``ethsnarks_tpu/jubjub.py:24-492``).

Four coordinate systems, each a namedtuple of :class:`.field.FQ`:

 - ``Point``      affine (x, y) on  a*x^2 + y^2 = 1 + d*x^2*y^2
 - ``ProjPoint``  homogeneous (X, Y, Z), BBJLP'08 unified formulas
 - ``EtecPoint``  extended (X, Y, T, Z) with T = XY/Z, HWCD'08 formulas
 - ``MontPoint``  the birational Montgomery form  B*v^2 = u^3 + A*u^2 + u

a = 168700, d = 168696 over p = SNARK_SCALAR_FIELD, cofactor 8, prime
subgroup order ``JUBJUB_L``.  The formulas are the Explicit-Formulas
Database entries named in each docstring (add-2008-bbjlp,
dbl-2008-bbjlp, add/dbl-2008-hwcd), so every result equals the
reference's.  The batched versions on tensors are in
:mod:`.ops.jubjub_ops`.
"""

from os import urandom
from hashlib import sha256
from collections import namedtuple

from .field import FQ, SNARK_SCALAR_FIELD
from .numbertheory import SquareRootError

JUBJUB_Q = SNARK_SCALAR_FIELD
JUBJUB_E = 21888242871839275222246405745257275088614511777268538073601725287587578984328
JUBJUB_C = 8
JUBJUB_L = JUBJUB_E // JUBJUB_C
JUBJUB_A = 168700
JUBJUB_D = 168696

# Birational Montgomery form, "Twisted Edwards Curves" (BBJLP'08) thm 3.2:
#   A = 2(a+d)/(a-d),  B = 4/(a-d)  — both exact integers for this curve.
MONT_A = 168698
MONT_B = 1
MONT_A24 = (MONT_A + 2) // 4
assert MONT_A24 * 4 == MONT_A + 2
assert MONT_A == 2 * (JUBJUB_A + JUBJUB_D) // (JUBJUB_A - JUBJUB_D)
assert MONT_B * (JUBJUB_A - JUBJUB_D) == 4

_A = FQ(JUBJUB_A)
_D = FQ(JUBJUB_D)


def is_negative(v):
    """A field element is 'negative' when it exceeds its additive inverse
    (i.e. its canonical representative is in the upper half of the field)."""
    assert isinstance(v, FQ)
    return v.n < (-v).n


class AbstractCurveOps(object):
    """Operator sugar + generic scalar multiplication shared by every
    coordinate system.  Subclasses provide add/neg/infinity and the
    as_point/as_proj/as_etec/as_mont conversion set."""

    def __neg__(self):
        return self.neg()

    def __add__(self, other):
        return self.add(other)

    def __sub__(self, other):
        return self.add(other.neg())

    def __mul__(self, n):
        return self.mult(n)

    def double(self):
        return self.add(self)

    def rescale(self):
        return self

    def compress(self):
        return self.as_point().compress()

    def is_negative(self):
        return is_negative(self.as_point().x)

    def sign(self):
        return int(self.is_negative())

    def mult(self, scalar):
        """LSB-first double-and-add over the plain int value of ``scalar``."""
        if isinstance(scalar, FQ):
            if scalar.m not in (SNARK_SCALAR_FIELD, JUBJUB_E, JUBJUB_L):
                raise ValueError("Invalid field modulus")
            scalar = scalar.n
        result = self.infinity()
        addend = self
        remaining = int(scalar)
        while remaining:
            if remaining & 1:
                result = result.add(addend)
            remaining >>= 1
            if remaining:
                addend = addend.double()
        return result

    def mult_wnaf(self, scalar, window=5):
        return mult_naf_lut(self, scalar, window)

    @classmethod
    def all_loworder_points(cls):
        """The full 8-torsion: identity, the order-2 point (0, -1), two
        order-4 points on y = 0 (a*x^2 = 1), and four order-8 points whose
        doubles land on y = 0 (so d*a*x^4 - 2a*x^2 + 1 = 0), computed from
        the curve equation."""
        pts = [Point(FQ(0), FQ(1)), Point(FQ(0), FQ(-1))]
        x4 = _A.inv().sqrt()
        pts += [Point(x4, FQ(0)), Point(-x4, FQ(0))]
        root = (_A * _A - _A * _D).sqrt()
        for xsq in ((_A + root) / (_D * _A), (_A - root) / (_D * _A)):
            try:
                x8 = xsq.sqrt()
            except SquareRootError:
                continue
            y8 = (xsq * _A).sqrt()
            pts += [Point(sx * x8, sy * y8)
                    for sx in (FQ(1), FQ(-1)) for sy in (FQ(1), FQ(-1))]
        return pts

    @classmethod
    def decompress(cls, point):
        return Point.decompress(point).as_proj()


class Point(AbstractCurveOps, namedtuple('_Point', ('x', 'y'))):
    """Affine coordinates; the canonical/comparison form."""

    def __str__(self):
        return '%s %s' % self

    def __eq__(self, other):
        return self.x == other.x and self.y == other.y

    def __hash__(self):
        return hash((self.x, self.y))

    @classmethod
    def generator(cls):
        return cls(
            FQ(16540640123574156134436876038791482806971768689494387082833631921987005038935),
            FQ(20819045374670962167435360035096875258406992893633759881276124905556507972311))

    @staticmethod
    def infinity():
        return Point(FQ(0), FQ(1))

    @classmethod
    def from_y(cls, y, sign=None):
        """Solve x^2 = (y^2 - 1)/(d*y^2 - a); SquareRootError if off-curve.
        With ``sign`` given, pick the root whose low bit matches; otherwise
        normalize to the non-negative root."""
        assert isinstance(y, FQ) and y.m == JUBJUB_Q
        ysq = y * y
        x = ((ysq - 1) / (_D * ysq - _A)).sqrt()
        if sign is not None:
            return cls(x if (x.n & 1) == sign else -x, y)
        return cls(-x if is_negative(x) else x, y)

    @classmethod
    def from_x(cls, x):
        """Solve y^2 = (a*x^2 - 1)/(d*x^2 - 1)."""
        assert isinstance(x, FQ) and x.m == JUBJUB_Q
        xsq = x * x
        return cls(x, ((_A * xsq - 1) / (_D * xsq - 1)).sqrt())

    @classmethod
    def from_hash(cls, entropy):
        """Hash-to-point: y = sha256(entropy), increment until a curve
        point exists, multiply by the cofactor, and insist the result is in
        (and not the identity of) the prime-order subgroup."""
        assert isinstance(entropy, bytes)
        candidate = int.from_bytes(sha256(entropy).digest(), 'big')
        while True:
            try:
                found = cls.from_y(FQ(candidate))
            except SquareRootError:
                candidate += 1
                continue
            cleared = found * JUBJUB_C
            if cleared * JUBJUB_L != Point.infinity():
                raise RuntimeError("Point not on prime-ordered subgroup")
            return cleared

    @classmethod
    def random(cls):
        return cls.from_hash(urandom(32))

    def compress(self):
        """32 LE bytes: y with the sign of x in the top bit."""
        return ((self.x.n & 1) << 255 | self.y.n).to_bytes(32, 'little')

    @classmethod
    def decompress(cls, data):
        if len(data) != 32:
            raise ValueError("Invalid input length for decompression")
        word = int.from_bytes(data, 'little')
        return cls.from_y(FQ(word & ~(1 << 255)), sign=word >> 255)

    def valid(self):
        xsq, ysq = self.x * self.x, self.y * self.y
        return _A * xsq + ysq == 1 + _D * xsq * ysq

    def neg(self):
        return Point(-self.x, self.y)

    def add(self, other):
        """Unified affine addition (complete for this a/d)."""
        assert isinstance(other, Point)
        if self == Point(FQ(0), FQ(0)):      # legacy zero-encoded identity
            return other
        xx = self.x * other.x
        yy = self.y * other.y
        k = _D * xx * yy
        return Point((self.x * other.y + self.y * other.x) / (1 + k),
                     (yy - _A * xx) / (1 - k))

    def as_point(self):
        return self

    def as_proj(self):
        return ProjPoint(self.x, self.y, FQ(1))

    def as_etec(self):
        return EtecPoint(self.x, self.y, self.x * self.y, FQ(1))

    def as_mont(self):
        return MontPoint.from_edwards(self)


class ProjPoint(AbstractCurveOps, namedtuple('_ProjPoint', ('x', 'y', 'z'))):
    """Homogeneous projective coordinates (X : Y : Z)."""

    def __eq__(self, other):
        return (self.x, self.y, self.z) == (other.x, other.y, other.z)

    def __hash__(self):
        return hash((self.x, self.y, self.z))

    @staticmethod
    def infinity():
        return ProjPoint(FQ(0), FQ(1), FQ(1))

    def rescale(self):
        zi = self.z.inv()
        return ProjPoint(self.x * zi, self.y * zi, FQ(1))

    def valid(self):
        return self.as_point().valid()

    def neg(self):
        return ProjPoint(-self.x, self.y, self.z)

    def as_point(self):
        assert self.z != 0
        zi = self.z.inv()
        return Point(self.x * zi, self.y * zi)

    def as_proj(self):
        return self

    def as_etec(self):
        return EtecPoint(self.x, self.y, self.x * self.y, self.z)

    def as_mont(self):
        return self.as_point().as_mont()

    def add(self, other):
        """add-2008-bbjlp (strongly unified)."""
        assert isinstance(other, ProjPoint)
        if self == self.infinity():
            return other
        zz = self.z * other.z
        zz2 = zz * zz
        xx = self.x * other.x
        yy = self.y * other.y
        dxy = _D * xx * yy
        cross = (self.x + self.y) * (other.x + other.y) - xx - yy
        return ProjPoint(zz * (zz2 - dxy) * cross,
                         zz * (zz2 + dxy) * (yy - _A * xx),
                         (zz2 - dxy) * (zz2 + dxy))

    def double(self):
        """dbl-2008-bbjlp (3M + 4S)."""
        if self == self.infinity():
            return self.infinity()
        s = (self.x + self.y) * (self.x + self.y)
        xx = self.x * self.x
        yy = self.y * self.y
        axx = _A * xx
        u = axx + yy
        w = u - 2 * (self.z * self.z)
        return ProjPoint((s - xx - yy) * w, u * (axx - yy), u * w)


class MontPoint(AbstractCurveOps, namedtuple('_MontPoint', ('u', 'v'))):
    """Montgomery form; used by the Pedersen-hash gadget's add chains."""

    def __eq__(self, other):
        return (self.u, self.v) == (other.u, other.v)

    def __hash__(self):
        return hash((self.u, self.v))

    @classmethod
    def infinity(cls):
        return cls(FQ(0), FQ(1))

    @classmethod
    def from_edwards(cls, e):
        """Birational map (x, y) -> (u, v) = ((1+y)/(1-y), u/x).  The two
        exceptional points go to their conventional images: identity ->
        (0, 1), the order-2 point (0, -1) -> (0, 0)."""
        e = e.as_point()
        if e.y == 1:
            return cls(FQ(0), FQ(1))
        if e.x == 0:
            return cls(FQ(0), FQ(0))
        u = (1 + e.y) / (1 - e.y)
        return cls(u, u / e.x)

    def as_point(self):
        """Inverse map (u, v) -> (u/v, (u-1)/(u+1))."""
        return Point(self.u / self.v, (self.u - 1) / (self.u + 1))

    def as_etec(self):
        return self.as_point().as_etec()

    def as_proj(self):
        return self.as_point().as_proj()

    def as_mont(self):
        return self

    def valid(self):
        u, v = self.u, self.v
        return MONT_B * v * v == u * u * u + MONT_A * u * u + u

    def neg(self):
        return type(self)(self.u, -self.v)

    def double(self):
        if self.v == 0:
            return self.infinity()
        u, v = self.u, self.v
        slope = (3 * (u * u) + 2 * (MONT_A * u) + 1) / (2 * v)
        u3 = slope * slope - MONT_A - u - u
        return type(self)(u3, -(v + slope * (u3 - u)))

    def add(self, other):
        other = other.as_mont()
        if other == self.infinity():
            return self
        if self == self.infinity():
            return other
        if self.u == other.u:
            return self.double() if self.v == other.v else self.infinity()
        slope = (other.v - self.v) / (other.u - self.u)
        u3 = slope * slope - MONT_A - self.u - other.u
        return type(self)(u3, -(self.v + slope * (u3 - self.u)))


class EtecPoint(AbstractCurveOps,
                namedtuple('_EtecPoint', ('x', 'y', 't', 'z'))):
    """Extended twisted Edwards coordinates (X : Y : T : Z), T = XY/Z."""

    def __eq__(self, other):
        return (self.x, self.y, self.t, self.z) == \
            (other.x, other.y, other.t, other.z)

    def __hash__(self):
        return hash((self.x, self.y, self.t, self.z))

    @staticmethod
    def infinity():
        return EtecPoint(FQ(0), FQ(1), FQ(0), FQ(1))

    def valid(self):
        return self.as_point().valid()

    def neg(self):
        return EtecPoint(-self.x, self.y, -self.t, self.z)

    def as_point(self):
        zi = self.z.inv()
        return Point(self.x * zi, self.y * zi)

    def as_proj(self):
        return ProjPoint(self.x, self.y, self.z)

    def as_etec(self):
        return self

    def as_mont(self):
        return self.as_point().as_mont()

    def double(self):
        """dbl-2008-hwcd."""
        if self == self.infinity():
            return self.infinity()
        xx = self.x * self.x
        yy = self.y * self.y
        zz2 = 2 * (self.z * self.z)
        axx = _A * xx
        e = (self.x + self.y) * (self.x + self.y) - xx - yy
        g = axx + yy
        f = g - zz2
        h = axx - yy
        return EtecPoint(e * f, g * h, e * h, f * g)

    def add(self, other):
        """add-2008-hwcd (unified)."""
        assert isinstance(other, EtecPoint)
        if self == self.infinity():
            return other
        assert self.z != 0 and other.z != 0
        xx = self.x * other.x
        yy = self.y * other.y
        tt = _D * self.t * other.t
        zz = self.z * other.z
        e = (self.x + self.y) * (other.x + other.y) - xx - yy
        f = zz - tt
        g = zz + tt
        h = yy - _A * xx
        return EtecPoint(e * f, g * h, e * h, f * g)


# ---------------- wNAF scalar-mult helpers ----------------

def wNAF(k, width=2):
    """Width-w non-adjacent form, most-significant digit first: each
    nonzero digit is odd with |digit| < 2^(w-1), separated by >= w-1
    zeros."""
    k = int(k)
    modulus, half = 1 << width, 1 << (width - 1)
    digits = []
    while k > 0:
        if k & 1:
            d = k % modulus
            if d > half:
                d -= modulus
            k -= d
        else:
            d = 0
        digits.append(d)
        k >>= 1
    digits.reverse()
    return digits


def naf_window(point, nbits):
    """Table of odd multiples {±1, ±3, ...} up to 2^(nbits-1), plus the
    even helper 2P used to build them; index 0 maps to None (no-op)."""
    table = {0: None, 1: point, -1: -point}
    if nbits > 1:
        table[2] = point.double()
        table[-2] = -table[2]
    for n in range(3, 1 << (nbits - 1), 2):
        table[n] = table[n - 2] + table[2]
        table[-n] = -table[n]
    return table


def mult_naf(point, scalar):
    """Simple NAF (width 2) double-and-add."""
    acc = point.infinity()
    neg = point.neg()
    for d in wNAF(scalar):
        acc = acc.double()
        if d == 1:
            acc = acc.add(point)
        elif d == -1:
            acc = acc.add(neg)
    return acc


def mult_naf_lut(point, scalar, width=2):
    """Windowed-NAF multiplication with a precomputed odd-multiple table."""
    table = naf_window(point, width)
    acc = point.infinity()
    for d in wNAF(scalar, width):
        acc = acc.double()
        if table[d] is not None:
            acc = acc.add(table[d])
    return acc
