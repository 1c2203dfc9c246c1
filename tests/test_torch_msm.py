"""The port's Pippenger MSM (ethsnarks_tpu_torch.ops.msm, plain path on the
CPU) against exact host sums, on the vectors of tests/test_msm_red.py:
random, edge digits, all-zero, 254-bit scalars with a narrow top window,
the ones / equal-value / shared-digit floods, and G2."""
import numpy as np
import pytest
import torch

from ethsnarks_tpu.bn254 import G1_GEN, G2_GEN, CURVE_ORDER, multiply, add
from ethsnarks_tpu.ops.msm import window_digits_host_np

from ethsnarks_tpu_torch import bn254 as port
from ethsnarks_tpu_torch.ops import curve, kernels, msm
from ethsnarks_tpu_torch.ops.fp import ints_to_words_np

from torch_port_helpers import torch_threads  # noqa: F401

C, NW = 7, 2


def _points(n, g2=False, distinct=16):
    gen = port.G2_GEN if g2 else port.G1_GEN
    base = [port.multiply(gen, j + 1) for j in range(distinct)]
    pts = (base * (n // distinct + 1))[:n]
    return (curve.g2_to_tensor if g2 else curve.g1_to_tensor)(pts, 'cpu')


def _host_msm(scalars, n, g2=False, distinct=16):
    """sum_i s_i P_(i mod distinct), P_j = (j + 1) G, by the reference."""
    gen = G2_GEN if g2 else G1_GEN
    coeffs = [0] * distinct
    for i, s in enumerate(scalars):
        coeffs[i % distinct] += s
    out = None
    for j, s in enumerate(coeffs):
        out = add(out, multiply(gen, (j + 1) * s % CURVE_ORDER))
    return out


def _affine(pt):
    if pt is None:
        return None
    if hasattr(pt[0], 'coeffs'):
        return tuple(tuple(c.coeffs) for c in pt)
    return (pt[0].n, pt[1].n)


def _digits(scalars, c=C, nw=NW):
    return torch.tensor([[(s >> (w * c)) & ((1 << c) - 1) for s in scalars]
                         for w in range(nw)], dtype=torch.int64)


def _full_digits(scalars, c):
    """The port's own decomposition of canonical scalars, checked against
    the reference's host decomposition."""
    words = torch.from_numpy(ints_to_words_np(scalars))
    d = msm.window_digits(words, c)
    assert np.array_equal(d.numpy(), window_digits_host_np(scalars, c))
    return d


def _rand_scalars(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), 'little') % CURVE_ORDER
            for _ in range(n)]


def _check(scalars, digits, c, g2=False):
    n = len(scalars)
    got = (msm.msm_g2 if g2 else msm.msm_g1)(_points(n, g2), digits, c)
    assert _affine(got) == _affine(_host_msm(scalars, n, g2))


def test_g1_random():
    rng = np.random.default_rng(5)
    s = [int(rng.integers(0, 1 << (C * NW))) for _ in range(512)]
    _check(s, _digits(s), C)


def test_g1_edge_digits():
    mx = (1 << C) - 1
    s = [0] * 512
    s[3] = mx | (mx << C)
    _check(s, _digits(s), C)


def test_g1_all_zero_is_none():
    assert msm.msm_g1(_points(512), _digits([0] * 512), C) is None


def test_g1_254bit_narrow_top():
    # c = 8: 32 windows, a 6-bit top window
    s = _rand_scalars(128, 11)
    _check(s, _full_digits(s, 8), 8)


def test_g1_ones_flood():
    s = _rand_scalars(256, 23)
    for i in range(0, 256, 2):
        s[i] = 1
    _check(s, _full_digits(s, C), C)


def test_g1_equal_value_flood():
    s = _rand_scalars(256, 29)
    for i in range(0, 256, 2):
        s[i] = 0xABCDEF0123456789FEDCBA
    _check(s, _full_digits(s, C), C)


def test_g1_shared_digit_flood():
    # distinct values sharing their low window digit
    rng = np.random.default_rng(43)
    s = _rand_scalars(256, 37)
    for i in range(150):
        hi = int.from_bytes(rng.bytes(30), 'little') << 7
        s[i] = ((hi & ~0x7f) | 5) % CURVE_ORDER
        s[i] = (s[i] & ~0x7f) | 5
    _check(s, _full_digits(s, C), C)


def test_g2_random():
    rng = np.random.default_rng(7)
    s = [int(rng.integers(0, 1 << (C * NW))) for _ in range(128)]
    _check(s, _digits(s), C, g2=True)


def test_g2_254bit():
    s = _rand_scalars(16, 16)
    _check(s, _full_digits(s, 5), 5, g2=True)


@pytest.mark.parametrize('where', ['top', 'middle', 'negative'])
def test_digit_contract_violation_raises(where):
    d = _full_digits(_rand_scalars(16, 17), 11)
    if where == 'top':
        d[-1, 0] = 5              # the top window allows 1 bit at c = 11
    elif where == 'middle':
        d[3, 0] = 1 << 11
    else:
        d[0, 0] = -1
    with pytest.raises(ValueError):
        msm.msm_g1(_points(16), d, 11)


@pytest.mark.parametrize('g2', [False, True], ids=['g1', 'g2'])
def test_horner_two_windows_is_double_n_add(g2):
    """K3 with windows [Q, P] is 2^n P + Q (the TPU's _k_double_n_add)."""
    gen = port.G2_GEN if g2 else port.G1_GEN
    p, q = port.multiply(gen, 1234567), port.multiply(gen, 89)
    conv = curve.g2_to_tensor if g2 else curve.g1_to_tensor
    back = curve.tensor_to_g2 if g2 else curve.tensor_to_g1
    W = conv([q, p], 'cpu').reshape((2, 1) + curve.point_shape(g2))
    got = back(kernels.horner(W.contiguous(), 5, g2))[0]
    assert _affine(got) == _affine(port.add(port.multiply(p, 32), q))


def test_window_digits_roundtrip_and_best_c():
    s = _rand_scalars(64, 3) + [0, 1, CURVE_ORDER - 1]
    words = torch.from_numpy(ints_to_words_np(s))
    for c in (4, 7, 13, 16, 21):
        d = msm.window_digits(words, c)
        assert d.shape == (msm.n_windows(c), len(s))
        assert [sum(int(d[w, i]) << (w * c) for w in range(d.shape[0]))
                for i in range(len(s))] == s
    assert msm.best_c(1 << 20) == 16
    assert all(4 <= msm.best_c(1 << k) <= 20 for k in range(1, 26))
