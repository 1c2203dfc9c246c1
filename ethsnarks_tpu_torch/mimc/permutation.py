"""MiMC block cipher and its two hash modes, host oracle (own copy of
``ethsnarks_tpu/mimc/permutation.py``).

Round constants are the iterated Keccak-256 chain seeded with
keccak(b"mimc"), used unreduced (the rounds reduce mod p); MiMC-e7 runs
91 rounds of x <- (x + k + c_i)^7, then adds k.  ``mimc_hash`` is
Miyaguchi-Preneel (k' = k + x + E_k(x)), ``mimc_hash_md`` Merkle-Damgard
(k' = E_k(x)).  The batched version on tensors is :mod:`..ops.mimc`.
"""

from ..field import SNARK_SCALAR_FIELD
from ..keccak import keccak_256

DEFAULT_EXPONENT = 7
DEFAULT_ROUNDS = 91
DEFAULT_SEED = b'mimc'

_constants_cache = {}


def _as_bytes(value):
    if isinstance(value, str):
        return value.encode('ascii')
    if isinstance(value, bytes):
        return value
    return int(value).to_bytes(32, 'big')


def H(*args):
    digest = keccak_256(b''.join(_as_bytes(a) for a in args)).digest()
    return int.from_bytes(digest, 'big')


def mimc_constants(seed=DEFAULT_SEED, p=SNARK_SCALAR_FIELD, R=DEFAULT_ROUNDS):
    """The iterated-Keccak round constant chain (a generator)."""
    if isinstance(seed, str):
        seed = seed.encode('ascii')
    seed = H(seed) if isinstance(seed, bytes) else int(seed)
    for _ in range(R):
        seed = H(seed)
        yield seed


def _constants_list(seed, p, R):
    """The round constants as a list, cached per (seed, p, R)
    (``ethsnarks_tpu/mimc/permutation.py:53``); an unhashable seed is
    computed each time."""
    key = (bytes(seed) if isinstance(seed, (bytes, bytearray)) else seed,
           p, R)
    try:
        return _constants_cache[key]
    except (TypeError, KeyError):
        out = list(mimc_constants(seed, p, R))
        try:
            _constants_cache[key] = out
        except TypeError:
            pass
        return out


def constants_list(seed=DEFAULT_SEED, p=SNARK_SCALAR_FIELD, R=DEFAULT_ROUNDS):
    """:func:`_constants_list` with the defaults."""
    return _constants_list(seed, p, R)


def mimc(x, k, seed=DEFAULT_SEED, p=SNARK_SCALAR_FIELD, e=DEFAULT_EXPONENT,
         R=DEFAULT_ROUNDS):
    """MiMC cipher E_k(x): R rounds of x <- (x + k + c_i)^e, then + k."""
    assert R > 2
    x = int(x) % p
    k = int(k)
    for c_i in constants_list(seed, p, R):
        x = pow((x + k + c_i) % p, e, p)
    return (x + k) % p


def mimc_hash(x, k=0, seed=DEFAULT_SEED, p=SNARK_SCALAR_FIELD,
              e=DEFAULT_EXPONENT, R=DEFAULT_ROUNDS):
    """Miyaguchi-Preneel one-way compression of the blocks ``x``."""
    k = int(k)
    for x_i in x:
        x_i = int(x_i)
        k = (k + x_i + mimc(x_i, k, seed, p, e, R)) % p
    return k


def mimc_hash_md(x, k=0, seed=DEFAULT_SEED, p=SNARK_SCALAR_FIELD,
                 e=DEFAULT_EXPONENT, R=DEFAULT_ROUNDS):
    """Merkle-Damgard chaining of the blocks ``x`` through the cipher."""
    k = int(k)
    for x_i in x:
        k = mimc(int(x_i), k, seed, p, e, R)
    return k
