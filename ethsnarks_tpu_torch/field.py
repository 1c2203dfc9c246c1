"""The BN254 prime fields and the host field elements (own copy of
``ethsnarks_tpu/field.py:20-214`` and the moduli of
``ethsnarks_tpu/bn254.py``).

SNARK_SCALAR_FIELD (r) is the R1CS / witness / scalar field and the base
field of Baby-JubJub; FIELD_MODULUS (q) is the base field of the curve
coordinates.  ``FQ`` wraps a python int mod a prime (r by default) and
``FR`` one mod the full Baby-JubJub group order; they are the host
oracle of the JubJub half of the circuit library (:mod:`.jubjub`,
:mod:`.eddsa`, the gadgets' witnesses).  Bit strings are LSB-first
'0'/'1' strings.  ``FQ._COUNTS`` is the op counter (``_reset_counts``,
``_print_counts``)."""

from collections import Counter
from math import ceil, log2
from os import urandom

from .numbertheory import square_root_mod_prime

SNARK_SCALAR_FIELD = 21888242871839275222246405745257275088548364400416034343698204186575808495617
FIELD_MODULUS = 21888242871839275222246405745257275088696311157297823662689037894645226208583

CURVE_ORDER = SNARK_SCALAR_FIELD

# Full group order of the Baby-JubJub curve (cofactor 8 times the order of
# its prime subgroup).
FR_ORDER = 21888242871839275222246405745257275088614511777268538073601725287587578984328


class _OpCounter(object):
    """Operation tallies behind ``FQ._COUNTS``."""

    __slots__ = ('tallies',)

    def __init__(self):
        self.tallies = Counter()

    def bump(self, name):
        self.tallies[name] += 1

    def report(self):
        width = max((len(k) for k in self.tallies), default=0)
        return "\n".join("%-*s = %d" % (width, k, self.tallies[k])
                         for k in sorted(self.tallies))


def _modulus_of(m):
    """An int modulus, or an element whose modulus is taken."""
    return m.m if isinstance(m, FQ) else m


class FQ(object):
    """Prime-field element: value ``n`` modulo ``m``.

    An int on either side of an operator is reduced into the same field;
    an element of another field raises."""

    __slots__ = ('n', 'm')

    _COUNTS = None

    @classmethod
    def _reset_counts(cls):
        cls._COUNTS = _OpCounter()

    @classmethod
    def _disable_counting(cls):
        cls._COUNTS = None

    @classmethod
    def _count(cls, what):
        counter = cls._COUNTS
        if counter is not None:
            counter.bump(what)

    @classmethod
    def _print_counts(cls):
        print(cls._COUNTS.report() + "\n")

    def __init__(self, n, field_modulus=SNARK_SCALAR_FIELD):
        if isinstance(n, self.__class__):
            if n.m != field_modulus:
                raise ValueError(
                    "cannot wrap an element of a different field "
                    "(moduli %d != %d)" % (n.m, field_modulus))
            self.m, self.n = n.m, n.n
            return
        if not isinstance(n, int):
            raise ValueError(
                "FQ value must be an int, got %s" % type(n).__name__)
        if not isinstance(field_modulus, int):
            raise ValueError(
                "field modulus must be an int, got %s"
                % type(field_modulus).__name__)
        self.m = field_modulus
        self.n = n % field_modulus

    def _other_n(self, other):
        """The other operand as a plain int (same field only)."""
        if isinstance(other, FQ):
            if other.m != self.m:
                raise RuntimeError(
                    "mixed-field arithmetic: operand moduli differ "
                    "(%d vs %d)" % (self.m, other.m))
            return other.n
        if not isinstance(other, int):
            raise RuntimeError(
                "operand must be an int or FQ, got %s"
                % type(other).__name__)
        return other

    def __int__(self):
        return self.n

    def __hash__(self):
        return hash((self.n, self.m))

    def __eq__(self, other):
        if other == 0.:
            other = 0
        return self.n == self._other_n(other)

    def __ne__(self, other):
        return not self == other

    def __repr__(self):
        return repr(self.n)

    def __neg__(self):
        self._count('sub')
        return FQ(self.m - self.n, self.m)

    def exp(self, e):
        self._count('exp')
        return FQ(pow(self.n, self._other_n(e), self.m), self.m)

    __pow__ = exp

    def inv(self):
        self._count('inv')
        return FQ(pow(self.n, -1, self.m), self.m)

    def sqrt(self):
        self._count('sqrt')
        return FQ(square_root_mod_prime(self.n, self.m), self.m)

    def _nbytes(self):
        nbits = ceil(log2(self.m))
        return (nbits + 8 - nbits % 8) // 8

    def to_bytes(self, endian='big'):
        return self.n.to_bytes(self._nbytes(), endian)

    def bits(self):
        """LSB-first '0'/'1' string, ceil(log2(m)) characters."""
        width = ceil(log2(self.m))
        return bin(self.n)[2:][::-1].ljust(width, '0')

    @classmethod
    def random(cls, modulus=SNARK_SCALAR_FIELD):
        modulus = _modulus_of(modulus)
        nbytes = ceil(ceil(log2(modulus)) / 8) + 1
        return FQ(int.from_bytes(urandom(nbytes), 'little'), modulus)

    @classmethod
    def zero(cls, modulus=SNARK_SCALAR_FIELD):
        return FQ(0, _modulus_of(modulus))

    @classmethod
    def one(cls, modulus=SNARK_SCALAR_FIELD):
        return FQ(1, _modulus_of(modulus))


def _install_arith():
    """The binary operators from a table: (counter, int function,
    reflected).  Each unwraps the other operand, applies the function to
    the ints (swapped when reflected) and wraps the result mod m."""
    def make(counter, fn, swap):
        def op(self, other):
            self._count(counter)
            a, b = self.n, self._other_n(other)
            if swap:
                a, b = b, a
            return FQ(fn(a, b, self.m) % self.m, self.m)
        return op

    specs = {
        '__add__': ('add', lambda a, b, m: a + b, False),
        '__radd__': ('add', lambda a, b, m: a + b, False),
        '__sub__': ('sub', lambda a, b, m: a - b, False),
        '__rsub__': ('sub', lambda a, b, m: a - b, True),
        '__mul__': ('mul', lambda a, b, m: a * b, False),
        '__rmul__': ('mul', lambda a, b, m: a * b, False),
        '__truediv__': ('inv', lambda a, b, m: a * pow(b, -1, m), False),
        '__rtruediv__': ('inv', lambda a, b, m: a * pow(b, -1, m), True),
    }
    for name, (counter, fn, swap) in specs.items():
        setattr(FQ, name, make(counter, fn, swap))
    FQ.__floordiv__ = FQ.__truediv__
    FQ.__div__ = FQ.__truediv__
    FQ.__rdiv__ = FQ.__rtruediv__


_install_arith()


class FR(FQ):
    """Element of the integers mod the full Baby-JubJub group order (not a
    prime field: FR_ORDER is 8 times the prime subgroup's order)."""

    def __init__(self, n, field_modulus=FR_ORDER):
        FQ.__init__(self, n, field_modulus)
