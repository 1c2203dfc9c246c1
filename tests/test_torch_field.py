"""The port's plain Fq / Fr / Fq2 Montgomery arithmetic (ethsnarks_tpu_torch
ops.fp, ops.fp2) against exact integers and against the JAX package's
redundant-digit core (fp_red, eager, engine='xla'), compared by value.

Every comparison is exact: integers mod p."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ethsnarks_tpu.bn254 import Fq2 as RefFq2
from ethsnarks_tpu.ops import fp_red
from ethsnarks_tpu.ops.fp import BN254_Q, BN254_R

from ethsnarks_tpu_torch.ops import fp2
from ethsnarks_tpu_torch.ops.fp import Fq, Fr, words_to_h16, h16_to_words

from torch_port_helpers import torch_threads, rand_ints  # noqa: F401

FIELDS = {'q': (Fq, BN254_Q), 'r': (Fr, BN254_R)}


def _specials(p):
    return [0, 1, 2, p - 1, p - 2, (1 << 254) % p,
            int('fff' * 22, 16) % p, fp_red.RMASK, 1 << 252,
            (1 << 256) % p, (1 << 128) - 1, 0xFFFF, p >> 1]


def _operands(p, seed):
    sp = _specials(p)
    a = [x for x in sp for _ in sp] + rand_ints(96, p, seed)
    b = sp * len(sp) + rand_ints(96, p, seed + 1)
    return a, b


@pytest.mark.parametrize('field', sorted(FIELDS))
@pytest.mark.parametrize('op', ['add', 'sub', 'mul', 'square', 'neg'])
def test_op_exact(field, op):
    F, p = FIELDS[field]
    av, bv = _operands(p, 3)
    a = F.ints_to_h16(av, 'cpu', mont=True)
    b = F.ints_to_h16(bv, 'cpu', mont=True)
    got = {'add': lambda: F.add(a, b), 'sub': lambda: F.sub(a, b),
           'mul': lambda: F.mul(a, b), 'square': lambda: F.square(a),
           'neg': lambda: F.neg(a)}[op]()
    want = {'add': lambda x, y: x + y, 'sub': lambda x, y: x - y,
            'mul': lambda x, y: x * y, 'square': lambda x, y: x * x,
            'neg': lambda x, y: -x}[op]
    assert F.h16_to_ints(got, mont=True) == [want(x, y) % p
                                             for x, y in zip(av, bv)]
    # canonical digits (what lets kernels compare bit for bit)
    assert int(got.min()) >= 0 and int(got.max()) <= 0xFFFF


@pytest.mark.parametrize('field', sorted(FIELDS))
def test_mont_roundtrip_and_words(field):
    F, p = FIELDS[field]
    vals = _specials(p) + rand_ints(64, p, 5)
    h = F.ints_to_h16(vals, 'cpu')
    assert F.h16_to_ints(F.from_mont(F.to_mont(h))) == vals
    assert torch.equal(words_to_h16(h16_to_words(h)), h)
    assert F.h16_to_ints(F.to_mont(h)) == [v * (1 << 256) % p for v in vals]


@pytest.mark.parametrize('field', sorted(FIELDS))
@pytest.mark.parametrize('op', ['add', 'sub', 'mul'])
def test_matches_jax_red_core(field, op):
    """Same values as fp_red's ops run eagerly at 64 lanes (the JAX core
    keeps R = 2^264 and redundant digits; both are compared as ints)."""
    F, p = FIELDS[field]
    red = fp_red.red_field(p)
    ops = fp_red.mk_red_ops(red.packed_consts(), engine='xla')
    av, bv = rand_ints(60, p, 11) + [0, 1, p - 1, p - 2], \
        rand_ints(60, p, 12) + [p - 1, 0, p - 1, 2]
    ref = red.from_mont(np.asarray(ops[op](jnp.asarray(red.to_mont(av)),
                                           jnp.asarray(red.to_mont(bv)))))
    fn = {'add': F.add, 'sub': F.sub, 'mul': F.mul}[op]
    got = F.h16_to_ints(fn(F.ints_to_h16(av, 'cpu', mont=True),
                           F.ints_to_h16(bv, 'cpu', mont=True)), mont=True)
    assert got == [int(v) for v in ref]


@pytest.mark.parametrize('field', sorted(FIELDS))
def test_adversarial_square_chain(field):
    """The digit patterns of test_fp_red.py::test_adversarial_digit_patterns
    through eight squarings."""
    F, p = FIELDS[field]
    specials = [0, 1, 2, p - 1, p - 2, (1 << 254) % p,
                int('fff' * 22, 16) % p, fp_red.RMASK, 1 << 252]
    a = F.ints_to_h16(specials, 'cpu', mont=True)
    for _ in range(8):
        a = F.mul(a, a)
    assert F.h16_to_ints(a, mont=True) == [pow(v, 2 ** 8, p)
                                           for v in specials]


@pytest.mark.parametrize('field', sorted(FIELDS))
def test_chain_stability(field):
    """The mixed chain of test_fp_red.py::test_chain_stability, exact."""
    F, p = FIELDS[field]
    av, bv = rand_ints(32, p, 21), rand_ints(32, p, 22)
    a = F.ints_to_h16(av, 'cpu', mont=True)
    b = F.ints_to_h16(bv, 'cpu', mont=True)
    nine = F.const_mont(9, 'cpu')
    for _ in range(6):
        t = F.mul(F.add(a, b), F.sub(a, b))
        u = F.add(F.add(t, t), F.mul(a, nine))
        a, b = F.mul(u, b), F.sub(t, u)
        tv = [(x + y) * (x - y) % p for x, y in zip(av, bv)]
        uv = [(2 * t_ + 9 * x) % p for t_, x in zip(tv, av)]
        av, bv = [u_ * y % p for u_, y in zip(uv, bv)], \
            [(t_ - u_) % p for t_, u_ in zip(tv, uv)]
        assert F.h16_to_ints(a, mont=True) == av
        assert F.h16_to_ints(b, mont=True) == bv


def _fq2(vals):
    """[(c0, c1)] -> (16, n, 2) Montgomery h16."""
    return torch.stack([Fq.ints_to_h16([v[0] for v in vals], 'cpu', True),
                        Fq.ints_to_h16([v[1] for v in vals], 'cpu', True)],
                       -1)


def _fq2_ints(t):
    c0 = Fq.h16_to_ints(t[..., 0], mont=True)
    c1 = Fq.h16_to_ints(t[..., 1], mont=True)
    return list(zip(c0, c1))


@pytest.mark.parametrize('op', ['add', 'sub', 'mul', 'mul_b3'])
def test_fq2(op):
    q = BN254_Q
    xs = list(zip(rand_ints(24, q, 31), rand_ints(24, q, 32))) + \
        [(0, 0), (1, 0), (0, 1), (q - 1, q - 1)]
    ys = list(zip(rand_ints(24, q, 33), rand_ints(24, q, 34))) + \
        [(q - 1, 1), (0, 0), (0, 1), (q - 1, q - 1)]
    a, b = _fq2(xs), _fq2(ys)
    got = {'add': lambda: fp2.add(a, b), 'sub': lambda: fp2.sub(a, b),
           'mul': lambda: fp2.mul(a, b), 'mul_b3': lambda: fp2.mul_b3(a)}[op]()
    b3 = RefFq2(list(fp2.B3_COEFFS))
    want = []
    for x, y in zip(xs, ys):
        X, Y = RefFq2(list(x)), RefFq2(list(y))
        r = {'add': X + Y, 'sub': X - Y, 'mul': X * Y, 'mul_b3': X * b3}[op]
        want.append(tuple(r.coeffs))
    assert _fq2_ints(got) == want


def test_b3_is_three_b_twist():
    from ethsnarks_tpu.bn254 import B2
    assert RefFq2(list(fp2.B3_COEFFS)) == B2 * 3
