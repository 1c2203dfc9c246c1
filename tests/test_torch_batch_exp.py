"""The port's fixed-base batch multiplication (ethsnarks_tpu_torch
ops.batch_exp, K4's plain version on the CPU) against the JAX package's
``_BatchExp.mul_many`` and against host double-and-add.  Exact."""
import numpy as np
import pytest
import torch

from ethsnarks_tpu import bn254 as ref
from ethsnarks_tpu.ops.batch_exp import _BatchExp

from ethsnarks_tpu_torch import bn254
from ethsnarks_tpu_torch.field import CURVE_ORDER
from ethsnarks_tpu_torch.ops import curve, kernels
from ethsnarks_tpu_torch.ops.batch_exp import BatchExp, host_table
from ethsnarks_tpu_torch.ops.fp import ints_to_words_np

from torch_port_helpers import torch_threads, rand_ints  # noqa: F401


def _port_base(pt, g2):
    if g2:
        return (bn254.Fq2(pt[0].coeffs), bn254.Fq2(pt[1].coeffs))
    return (bn254.Fq(pt[0].n), bn254.Fq(pt[1].n))


def _ints(pts, g2):
    """Affine points of either package -> comparable ints (None = inf)."""
    if g2:
        return [None if p is None else (tuple(p[0].coeffs),
                                        tuple(p[1].coeffs)) for p in pts]
    return [None if p is None else (p[0].n, p[1].n) for p in pts]


def _affine(P, g2):
    return (curve.tensor_to_g2 if g2 else curve.tensor_to_g1)(P)


# the vectors of tests/test_batch_exp.py
VECTORS = [
    ('g1', False, ref.G1_GEN, [0, 1, 2, 7, CURVE_ORDER - 1,
                               12345678901234567890, CURVE_ORDER - 2, 3]),
    ('g1_other_base', False, ref.multiply(ref.G1_GEN, 987654321),
     [5, 11, 0, 2 ** 200 + 17]),
    ('g2', True, ref.G2_GEN, [1, 3, 0, CURVE_ORDER - 1, 2 ** 170 + 5]),
]


@pytest.mark.parametrize('name,g2,base,scalars', VECTORS,
                         ids=[v[0] for v in VECTORS])
def test_matches_reference_batch_exp(name, g2, base, scalars):
    want = _BatchExp(base, 'g2' if g2 else 'g1').mul_many(scalars)
    be = BatchExp(_port_base(base, g2), g2, device='cpu')
    got = be.mul_many(scalars)
    assert got.shape == (len(scalars),) + curve.point_shape(g2)
    assert _ints(_affine(got, g2), g2) == _ints(want, g2)


@pytest.mark.parametrize('g2', [False, True], ids=['g1', 'g2'])
def test_matches_host_multiply(g2):
    scalars = [0, CURVE_ORDER - 1, 1, 255, 256, 1 << 248] + \
        rand_ints(58, CURVE_ORDER, 7 + g2)
    gen = bn254.G2_GEN if g2 else bn254.G1_GEN
    want = [bn254.multiply(gen, s) for s in scalars]
    be = BatchExp(gen, g2, device='cpu')
    got = be.mul_many(scalars)
    assert _ints(_affine(got, g2), g2) == _ints(want, g2)
    assert be.mul(scalars[-1]) == want[-1]
    # a zero scalar is the identity (0, 1, 0) in projective words
    assert torch.equal(got[0], curve.identity(1, g2, 'cpu')[0])


def test_window_table_layout():
    """Entry w*2^c + d is d * 2^(c*w) * base; entry w*2^c is None."""
    c, n_win = 3, 4
    rows = host_table(bn254.G1_GEN, c, n_win)
    assert len(rows) == n_win << c
    for w in range(n_win):
        assert rows[w << c] is None
        for d in (1, 5, 7):
            assert rows[(w << c) + d] == bn254.multiply(
                bn254.G1_GEN, d << (c * w))


@pytest.mark.parametrize('c', [4, 8, 11])
def test_plain_kernel_other_windows(c):
    """K4's plain version at window widths other than 8, including one
    whose windows straddle 32-bit words."""
    n_win = -(-254 // c)
    table = curve.g1_to_tensor(host_table(bn254.G1_GEN, c, n_win), 'cpu')
    scalars = [0, 1, CURVE_ORDER - 1] + rand_ints(5, CURVE_ORDER, c)
    words = torch.from_numpy(ints_to_words_np(scalars))
    got = kernels.fixed_base_mul(table, words, n_win, c)
    assert curve.tensor_to_g1(got) == [bn254.multiply(bn254.G1_GEN, s)
                                       for s in scalars]


def test_wrapper_checks_shapes():
    table = curve.identity(32 << 8, False, 'cpu')
    words = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.fixed_base_mul(table, words, 31, 8)
    with pytest.raises(ValueError):
        kernels.fixed_base_mul(table, words.to(torch.int64), 32, 8)
    with pytest.raises(ValueError):
        kernels.fixed_base_mul(table, words[:, :4].contiguous(), 32, 8)
    with pytest.raises(ValueError):
        kernels.fixed_base_mul(table, words, 32, 8, g2=True)
    before = kernels.FIXED_BASE_MUL[False].launches
    out = kernels.fixed_base_mul(table, words, 32, 8)
    assert kernels.FIXED_BASE_MUL[False].launches == before   # plain path
    assert torch.equal(out, curve.identity(4, False, 'cpu'))


def test_digits_match_bytes():
    scalars = rand_ints(16, CURVE_ORDER, 3)
    d = curve.scalar_digits(torch.from_numpy(ints_to_words_np(scalars)),
                            32, 8)
    want = np.array([[(s >> (8 * w)) & 0xFF for s in scalars]
                     for w in range(32)])
    assert np.array_equal(d.numpy(), want)
