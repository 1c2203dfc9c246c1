"""Poseidon permutation, host oracle (own copy of
``ethsnarks_tpu/poseidon/permutation.py:33-137``).

Poseidon-pi of "Starkad and Poseidon" (iacr.org/2019/458) with the
reference library's parameters, so digests are bit-exact: round constants
from an iterated 32-byte blake2b chain (little-endian ints) seeded
``seed + b'_constants'``; a Cauchy MDS matrix 1/(c_i - c_{t+j}) over
constants from ``seed + b'_matrix_0000'``; R_F/2 full rounds, R_P partial
rounds (sbox on the first element only), R_F/2 full rounds.  The default
instance is t = 6, R_F = 8, R_P = 57, x^5 over the BN254 scalar field, at
a 126-bit security target; the parameter check enforces the paper's
interpolation and Groebner-basis bounds (section 3, figures 1, 3, 4).
"""

from math import log2, floor
from hashlib import blake2b
from collections import namedtuple

from ..field import SNARK_SCALAR_FIELD

PoseidonParamsType = namedtuple(
    '_PoseidonParams',
    ('p', 't', 'nRoundsF', 'nRoundsP', 'seed', 'e',
     'constants_C', 'constants_M'))


def H(arg):
    """One link of the constant chain: blake2b-256 of a 32-byte LE int (or
    raw bytes), read back little-endian."""
    if isinstance(arg, int):
        arg = arg.to_bytes(32, 'little')
    return int.from_bytes(blake2b(arg, digest_size=32).digest(), 'little')


def poseidon_constants(p, seed, n):
    """Yield n field constants by iterating H from the seed."""
    assert isinstance(n, int)
    for _ in range(n):
        seed = H(seed)
        yield seed % p


def poseidon_matrix(p, seed, t):
    """t x t Cauchy MDS matrix: M[i][j] = (c_i - c_{t+j})^-1 over 2t
    derived constants (iacr.org/2019/458 section 2.3)."""
    c = list(poseidon_constants(p, seed, 2 * t))
    inv = lambda v: pow(v % p, p - 2, p)
    return [[inv(c[i] - c[t + j]) for j in range(t)] for i in range(t)]


def _attack_ratios(p, e):
    """Per-sbox-degree attack-bound coefficients from the paper:
    (grobner rounds, grobner sboxes, interpolation)."""
    if p % 2 == 3:
        assert e == 3
        return 0.32, 0.18, 0.63
    if p % 5 != 1:
        assert e == 5
        return 0.21, 0.14, 0.43
    raise ValueError('Invalid p for congruency')


def poseidon_params(p, t, nRoundsF, nRoundsP, seed, e, constants_C=None,
                    constants_M=None, security_target=None):
    assert nRoundsF % 2 == 0 and nRoundsF > 0
    assert nRoundsP > 0
    assert t >= 2
    assert isinstance(seed, bytes)

    n = floor(log2(p))
    M = n if security_target is None else security_target
    assert n >= M

    g_rounds, g_sboxes, interp = _attack_ratios(p, e)
    # iacr.org/2019/458 section 3, figures 1/3/4: the round schedule must
    # clear the known interpolation and Groebner-basis attack bounds
    total = nRoundsF + nRoundsP
    assert total > interp * min(n, M) + log2(t)
    assert total > (2 + min(M, n)) * g_rounds
    assert nRoundsF + t * nRoundsP > M * g_sboxes

    if constants_C is None:
        constants_C = list(
            poseidon_constants(p, seed + b'_constants', total))
    if constants_M is None:
        constants_M = poseidon_matrix(p, seed + b'_matrix_0000', t)

    return PoseidonParamsType(p, t, nRoundsF, nRoundsP, seed, e,
                              constants_C, constants_M)


DefaultParams = poseidon_params(SNARK_SCALAR_FIELD, 6, 8, 57, b'poseidon', 5,
                                security_target=126)


def poseidon_sbox(state, i, params):
    """Hades sbox layer for round i: all elements in the outer R_F/2+R_F/2
    full rounds, only element 0 in the R_P middle rounds."""
    outer = params.nRoundsF // 2
    partial = outer <= i < outer + params.nRoundsP
    limit = 1 if partial else len(state)
    return [pow(x, params.e, params.p) if j < limit else x
            for j, x in enumerate(state)]


def poseidon_mix(state, M, p):
    """MDS layer: state <- M @ state."""
    return [sum(m_ij * x_j for m_ij, x_j in zip(row, state)) % p
            for row in M]


def poseidon(inputs, params=None, chained=False, trace=False):
    """One Poseidon permutation absorbing ``inputs`` into a zero state.

    Returns state[0], or the whole state with ``chained=True`` (sponge
    chaining feeds it back as the next call's input)."""
    params = params or DefaultParams
    assert isinstance(params, PoseidonParamsType)
    assert 0 < len(inputs), "No inputs"
    if not chained:
        assert len(inputs) < params.t, "Inputs exceed rate"
    state = [int(x) for x in inputs]
    state += [0] * (params.t - len(state))
    for i, rc in enumerate(params.constants_C):
        state = poseidon_mix(
            poseidon_sbox([x + rc for x in state], i, params),
            params.constants_M, params.p)
        if trace:
            for j, val in enumerate(state):
                print('%d %d' % (i, j), '=', val)
    return state if chained else state[0]
