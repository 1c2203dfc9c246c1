"""Shared pieces of the PyTorch/CUDA port's tests (``test_torch_*.py``).

Inputs come from ``numpy.random.default_rng`` seeds; JAX stays on the CPU
and data crosses between the two packages as python ints and numpy
arrays."""
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    """Two intra-op threads: the suite runs several test processes at once,
    and the plain field arithmetic is many small tensor operations."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def rand_ints(n, modulus, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), 'little') % modulus
            for _ in range(n)]


def affine(pt):
    """A host point of either package -> plain ints (None = infinity)."""
    if pt is None:
        return None
    if hasattr(pt[0], 'coeffs'):
        return tuple(tuple(int(c) for c in x.coeffs) for x in pt)
    return (int(pt[0].n), int(pt[1].n))


def host_points(n, g2=False):
    """(j + 1) * G for j < n, as the JAX package's host points."""
    from ethsnarks_tpu.bn254 import G1_GEN, G2_GEN, multiply
    gen = G2_GEN if g2 else G1_GEN
    return [multiply(gen, j + 1) for j in range(n)]


def rand_scalars(n, seed, modulus):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), 'little') % modulus
            for _ in range(n)]


def carry_edge_values(modulus, rng):
    """Field values whose Montgomery words reach the CUDA field core's rare
    carries: 0, 1, q - 1, q - 2^32, 2^255 mod q, and random values below q
    whose 1..7 low 32-bit words are all ones."""
    vals = [0, 1, modulus - 1, modulus - (1 << 32), (1 << 255) % modulus]
    for k in range(1, 8):
        vals.append((int.from_bytes(rng.bytes(32), 'little')
                     | ((1 << (32 * k)) - 1)) % modulus)
    return vals


def same_board(got, want):
    """Two constraint systems are equal: constraint triples, witness
    values, annotations and the public-input count."""
    a, b = want.to_coo(), got.to_coo()
    for name in 'abc':
        assert a[name][0].tolist() == b[name][0].tolist()
        assert a[name][1].tolist() == b[name][1].tolist()
        assert a[name][2] == b[name][2]
    assert got.values == want.values
    assert got.annotations == want.annotations
    assert got.num_inputs == want.num_inputs


def port_jubjub(obj):
    """A JAX-package host JubJub object (``Point``, ``ProjPoint``,
    ``EtecPoint``, ``MontPoint`` or ``Signature``) -> the port's, through
    ints."""
    from ethsnarks_tpu_torch import eddsa, jubjub
    from ethsnarks_tpu_torch.field import FQ
    if type(obj).__name__ == 'Signature':
        return eddsa.Signature(port_jubjub(obj.R), int(obj.s))
    return getattr(jubjub, type(obj).__name__)(*(FQ(int(c)) for c in obj))


def ints_of(obj):
    """A host JubJub point or signature of either package -> its
    coordinates (and s) as ints, for comparisons."""
    if type(obj).__name__ == 'Signature':
        return ints_of(obj.R) + (int(obj.s),)
    return tuple(int(c) for c in obj)


def random_constraint_system(m, num_inputs, num_variables, max_terms, seed):
    """A constraint system stand-in for :class:`ethsnarks_tpu_torch.qap.QAP`
    on the domain m: m - num_inputs - 1 rows of 0-3 random terms in each of
    A, B and C, row 0 of A with ``max_terms`` terms, coefficients and
    witness values random below r with 0, 1 and r - 1 among them.  Returns
    (system, witness ints)."""
    from types import SimpleNamespace
    from ethsnarks_tpu_torch.field import SNARK_SCALAR_FIELD as r
    rng = np.random.default_rng(seed)
    n = m - num_inputs - 1
    edge = [0, 1, r - 1]

    def values(k):
        vals = rand_ints(k, r, int(rng.integers(1 << 30)))
        for j in range(min(k, 3)):
            vals[int(rng.integers(k))] = edge[j]
        return vals

    coo = {}
    for name in 'abc':
        counts = rng.integers(0, 4, n)
        if name == 'a':
            counts[0] = max_terms
        rows = np.repeat(np.arange(n, dtype=np.int64), counts)
        cols = rng.integers(0, num_variables, rows.size).astype(np.int64)
        coo[name] = (rows, cols, values(rows.size))
    w = [1] + values(num_variables - 1)
    cs = SimpleNamespace(num_constraints=n, num_inputs=num_inputs,
                         num_variables=num_variables,
                         to_coo=lambda: {k: v for k, v in coo.items()})
    return cs, w
