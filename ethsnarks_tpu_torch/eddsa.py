"""EdDSA over Baby-JubJub: the pure, Pedersen-prehashed and MiMC
variants, host oracle (own copy of ``ethsnarks_tpu/eddsa.py:22-185``).

 - nonce r = sha512(k || M) read little-endian, reduced mod JUBJUB_L;
 - s = r + H(R, A, M) * k  mod JUBJUB_E;
 - PureEdDSA: H = x of the Pedersen hash (personalisation
   'EdDSA_Verify.RAM') of BITS(R.x) || BITS(A.x) || BITS(M);
 - EdDSA: M is first hashed to a point with personalisation
   'EdDSA_Verify.M';
 - MiMCEdDSA: H = the MiMC Miyaguchi-Preneel hash of the flattened
   scalars, seed 'EdDSA_Verify.RAM'.

Bit sequences are LSB-first '0'/'1' strings per field element
(:meth:`.field.FQ.bits`) and MSB-first per byte.  ``random_keypair``
draws from ``os.urandom``; a caller that needs repeatable keys passes
its own.  The batched verify on tensors is :mod:`.ops.eddsa_ops`.
"""

from collections import namedtuple
from hashlib import sha512

from .field import FQ
from .jubjub import Point, JUBJUB_L, JUBJUB_Q, JUBJUB_E
from .pedersen import pedersen_hash_bytes, pedersen_hash_bits
from .mimc import mimc_hash

P13N_EDDSA_VERIFY_M = 'EdDSA_Verify.M'
P13N_EDDSA_VERIFY_RAM = 'EdDSA_Verify.RAM'


# ---------------- message serialization ----------------

def _bytes_of(item):
    if isinstance(item, Point):
        return item.x.to_bytes('little') + item.y.to_bytes('little')
    if isinstance(item, FQ):
        return item.to_bytes('little')
    if isinstance(item, int):
        return item.to_bytes(32, 'little')
    if isinstance(item, str):
        return item.encode('ascii')
    if isinstance(item, bytes):
        return item
    if isinstance(item, (list, tuple)):
        return b''.join(_bytes_of(x) for x in item)
    raise TypeError("Bad type for M: " + str(type(item)))


def _bits_of(item):
    if isinstance(item, Point):
        return item.x.bits()
    if isinstance(item, FQ):
        return item.bits()
    if isinstance(item, bytes):
        # each byte contributes its bits MSB-first (BitArray convention)
        return ''.join(format(b, '08b') for b in item)
    if isinstance(item, str) and not set(item) - {'0', '1'}:
        return item
    if isinstance(item, (list, tuple)):
        return ''.join(_bits_of(x) for x in item)
    raise TypeError("Bad type for M: " + str(type(item)))


# ---------------- signature containers ----------------

class Signature(object):
    __slots__ = ('R', 's')

    def __init__(self, R, s):
        self.R = R if isinstance(R, Point) else Point(*R)
        self.s = s if isinstance(s, FQ) else FQ(s)
        assert self.s.m == JUBJUB_Q

    def __iter__(self):
        return iter((self.R, self.s))

    def __str__(self):
        return '%s %s %s' % (self.R.x, self.R.y, self.s)


class SignedMessage(namedtuple('_SignedMessage', ('A', 'sig', 'msg'))):
    def __str__(self):
        return '%s %s %s' % self


# ---------------- schemes ----------------

class _SignatureScheme(object):
    """Template-method base: subclasses choose the public challenge hash
    (``hash_public``) and optional message compression
    (``prehash_message``)."""

    # serialization helpers kept on the class for API parity
    @classmethod
    def to_bytes(cls, *args):
        return _bytes_of(args)

    @classmethod
    def to_bits(cls, *args):
        return _bits_of(args)

    @classmethod
    def prehash_message(cls, M):
        return M

    @classmethod
    def hash_public(cls, R, A, M):
        raise NotImplementedError()

    @classmethod
    def hash_secret(cls, k, *args):
        """Deterministic nonce r = LE(sha512(k || M)) mod L."""
        assert isinstance(k, FQ)
        digest = sha512(_bytes_of((k,) + args)).digest()
        return int.from_bytes(digest, 'little') % JUBJUB_L

    @classmethod
    def B(cls):
        return Point.generator()

    @classmethod
    def random_keypair(cls, B=None):
        B = B or cls.B()
        k = FQ.random(JUBJUB_L)
        return k, B * k

    @classmethod
    def sign(cls, msg, key, B=None):
        if not isinstance(key, FQ):
            raise TypeError("Invalid type for parameter k")
        if not 0 < key.n < JUBJUB_L:
            raise RuntimeError("Strict parsing of k failed")
        B = B or cls.B()
        A = B * key
        M = cls.prehash_message(msg)
        r = cls.hash_secret(key, M)
        R = B * r
        s = (r + key.n * cls.hash_public(R, A, M)) % JUBJUB_E
        return SignedMessage(A, Signature(R, s), msg)

    @classmethod
    def verify(cls, A, sig, msg, B=None):
        A = A if isinstance(A, Point) else Point(*A)
        sig = sig if isinstance(sig, Signature) else Signature(*sig)
        B = B or cls.B()
        M = cls.prehash_message(msg)
        t = cls.hash_public(sig.R, A, M)
        return B * sig.s == sig.R + A * t


class PureEdDSA(_SignatureScheme):
    @classmethod
    def hash_public(cls, *args, p13n=P13N_EDDSA_VERIFY_RAM):
        return pedersen_hash_bits(p13n, _bits_of(args)).x.n


class EdDSA(PureEdDSA):
    @classmethod
    def prehash_message(cls, M, p13n=P13N_EDDSA_VERIFY_M):
        return pedersen_hash_bytes(p13n, M)


def as_scalar(*args):
    """Flatten FQ/int/Point/sequence arguments into a stream of ints."""
    for x in args:
        if isinstance(x, FQ):
            yield x.n
        elif isinstance(x, int):
            yield x
        elif isinstance(x, Point):
            yield x.x.n
            yield x.y.n
        elif isinstance(x, (tuple, list)):
            yield from as_scalar(*x)
        else:
            raise TypeError("Unknown type " + str(type(x)))


class MiMCEdDSA(_SignatureScheme):
    @classmethod
    def hash_public(cls, *args, p13n=P13N_EDDSA_VERIFY_RAM):
        return mimc_hash(list(as_scalar(*args)), seed=p13n)
