"""The port's batched JubJub ops (``ops.jubjub_ops``, ``ops.eddsa_ops``) on
``device='cpu'`` against the JAX package's ``jubjub_ops`` on the same
inputs (one jitted JAX function for the shape), compared through affine
points and bits, and the whole batched verify against the host
``PureEdDSA.verify``.  Integers, so no tolerance; inputs from numpy
seeds, scalars of 12-16 bits and a 30-bit Pedersen hash to keep the plain
versions cheap."""
import numpy as np
import pytest
import torch

from ethsnarks_tpu import eddsa as ref_eddsa
from ethsnarks_tpu import field as ref_field
from ethsnarks_tpu import jubjub as ref_jubjub
from ethsnarks_tpu import pedersen as ref_pedersen

from ethsnarks_tpu_torch.eddsa import PureEdDSA
from ethsnarks_tpu_torch.field import FQ
from ethsnarks_tpu_torch.jubjub import JUBJUB_L, Point
from ethsnarks_tpu_torch.ops import eddsa_ops
from ethsnarks_tpu_torch.ops import jubjub_ops as jj
from ethsnarks_tpu_torch.ops.fp import Fr

from torch_port_helpers import ints_of, rand_ints, torch_threads  # noqa: F401

S_BITS, F_BITS, P_BITS = 12, 16, 30


def _bits(values, n):
    return np.array([[(v >> i) & 1 for v in values] for i in range(n)],
                    dtype=np.int64)


def _ref_point(p):
    return ref_jubjub.Point(ref_field.FQ(int(p.x)), ref_field.FQ(int(p.y)))


def _reference_ops(pts, others, f_bits, p_bits):
    """The JAX package's ops on the same inputs, one jitted function (its
    cold compile is most of this file's time: about 15 s for each
    ``etec_add`` it holds, so ``scalar_mult_bits``, which holds the same
    add and double, is held to the host oracle instead)."""
    import jax
    import jax.numpy as jnp
    from ethsnarks_tpu.ops import jubjub_ops as ref_jj

    g = ref_jubjub.Point.generator()

    def every_op(a, b, fb, pb):
        ax = ref_jj.etec_to_affine_x(a)
        return (ref_jj.etec_double(a), ref_jj.etec_equal(a, a),
                ref_jj.etec_equal(a, b), ref_jj.mont_to_bits(ax),
                ref_jj.fixed_base_mult_device(g, fb),
                ref_jj.pedersen_hash_bits_device(b'test', pb))

    a = ref_jj.point_to_device([_ref_point(p) for p in pts])
    b = ref_jj.point_to_device([_ref_point(p) for p in others])
    out = jax.jit(every_op)(a, b, *(jnp.asarray(x.astype(np.uint32))
                                    for x in (f_bits, p_bits)))
    pts_of = lambda p: [ints_of(q) for q in ref_jj.device_to_points(p)]
    return {'double': pts_of(out[0]),
            'eq_aa': np.asarray(out[1]).tolist(),
            'eq_ab': np.asarray(out[2]).tolist(),
            'x_bits': np.asarray(out[3]).astype(np.int64),
            'fbase': pts_of(out[4]), 'pedersen': pts_of(out[5])}


def test_ops_match_reference():
    """etec_double, etec_equal, etec_to_affine_x with mont_to_bits,
    fixed_base_mult_device (16 bits) and pedersen_hash_bits_device (30
    bits) against the JAX package's; etec_add, scalar_mult_bits (12
    bits) and the rest against its host curve.  Three lanes, one of them
    the identity."""
    g = Point.generator()
    ks = rand_ints(3, JUBJUB_L, 20)
    pts = [g * ks[0], g * ks[1], Point.infinity()]
    others = [g * ks[2], Point.infinity(), g * 2]
    s_vals = rand_ints(3, 1 << S_BITS, 21)
    f_vals = rand_ints(3, 1 << F_BITS, 22)
    p_vals = rand_ints(3, 1 << P_BITS, 23)
    s_bits, f_bits, p_bits = (_bits(s_vals, S_BITS), _bits(f_vals, F_BITS),
                              _bits(p_vals, P_BITS))
    want = _reference_ops(pts, others, f_bits, p_bits)
    host = [_ref_point(p) for p in pts]
    host_b = [_ref_point(p) for p in others]

    a = jj.point_to_device(pts, 'cpu')
    b = jj.point_to_device(others, 'cpu')
    pts_of = lambda p: [ints_of(q) for q in jj.device_to_points(p)]
    assert pts_of(a) == [ints_of(p) for p in host]
    assert pts_of(jj.etec_add(a, b)) == [ints_of(p + q)
                                         for p, q in zip(host, host_b)]
    assert pts_of(jj.etec_double(a)) == want['double'] == \
        [ints_of(p.double()) for p in host]
    assert pts_of(jj.etec_neg(a)) == [ints_of(-p) for p in host]
    assert jj.etec_equal(a, a).tolist() == want['eq_aa'] == [True] * 3
    assert jj.etec_equal(a, b).tolist() == want['eq_ab'] == [False] * 3
    # the same points in other projective coordinates compare equal
    assert jj.etec_equal(jj.etec_add(a, b), jj.etec_add(b, a)).tolist() \
        == [True] * 3
    sel = jj.etec_select(torch.tensor([True, False, True]), a, b)
    assert pts_of(sel) == [ints_of(host[0]), ints_of(host_b[1]),
                           ints_of(host[2])]
    ax = jj.etec_to_affine_x(a)
    assert Fr.h16_to_ints(ax, mont=True) == [int(p.x) for p in host]
    x_bits = jj.mont_to_bits(ax)
    assert x_bits.shape == (254, 3) and x_bits.dtype == torch.int64
    assert np.array_equal(x_bits.numpy(), want['x_bits'])
    assert pts_of(jj.scalar_mult_bits(a, torch.from_numpy(s_bits))) == \
        [ints_of(p * s) for p, s in zip(host, s_vals)]
    assert pts_of(jj.fixed_base_mult_device(g, torch.from_numpy(f_bits))) \
        == want['fbase'] == [ints_of(_ref_point(g) * f) for f in f_vals]
    got = pts_of(jj.pedersen_hash_bits_device('test', torch.from_numpy(
        p_bits)))
    assert got == want['pedersen'] == [ints_of(
        ref_pedersen.pedersen_hash_bits('test', format(v, '030b')[::-1]))
        for v in p_vals]
    # the tables are built once and kept for the device
    assert jj._pedersen_tables('test', 10, 'cpu') is \
        jj._pedersen_tables(b'test', 10, torch.device('cpu'))


def _signed(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int.from_bytes(rng.bytes(32), 'little') % (JUBJUB_L - 1) + 1
        msg = rng.bytes(32)
        sm = PureEdDSA.sign(msg, FQ(k))
        out.append((sm.A, (sm.sig.R, sm.sig.s.n), msg))
    return out


def _host_verify(A, sig, msg):
    """The JAX package's host verify."""
    return ref_eddsa.PureEdDSA.verify(_ref_point(A),
                                      (_ref_point(sig[0]), sig[1]), msg)


def test_eddsa_verify_batch_valid_and_tampered():
    """The whole slice at B = 2: one valid lane, one with s + 1."""
    (A0, sig0, m0), (A1, (R1, s1), m1) = _signed(2, 30)
    As, sigs, msgs = [A0, A1], [sig0, (R1, s1 + 1)], [m0, m1]
    got = eddsa_ops.eddsa_verify_batch(As, sigs, msgs, device='cpu')
    want = [_host_verify(*x) for x in zip(As, sigs, msgs)]
    assert got == want == [True, False]


def test_eddsa_verify_parts_match_host():
    """lhs = s B, the Pedersen hash point and rhs = R + t A against the
    host's at B = 2, one lane with a message bit flipped: its lhs still
    equals s B, its rhs is not, and the mask refuses it."""
    (A0, sig0, m0), (A1, sig1, m1) = _signed(2, 31)
    m1 = bytes([m1[0] ^ 0x80]) + m1[1:]
    As, sigs, msgs = [A0, A1], [sig0, sig1], [m0, m1]
    lhs, hash_pt, rhs = eddsa_ops.eddsa_verify_parts(
        *eddsa_ops.prepare(As, sigs, msgs, 'cpu'))
    B = PureEdDSA.B()
    got = [jj.device_to_points(p) for p in (lhs, hash_pt, rhs)]
    for i, (A, (R, s), m) in enumerate(zip(As, sigs, msgs)):
        t = PureEdDSA.hash_public(R, A, m)
        assert ints_of(got[0][i]) == ints_of(B * s)
        assert int(got[1][i].x) == t
        assert ints_of(got[2][i]) == ints_of(R + A * t)
    assert jj.etec_equal(lhs, rhs).tolist() == [True, False] == \
        [_host_verify(*x) for x in zip(As, sigs, msgs)]


def test_eddsa_verify_batch_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None means it")
    with pytest.raises(RuntimeError):
        eddsa_ops.eddsa_verify_batch([], [], [])


@pytest.mark.parametrize('n_bytes', [1, 3, 32])
def test_message_and_scalar_bits(n_bytes):
    rng = np.random.default_rng(40 + n_bytes)
    msgs = [rng.bytes(n_bytes) for _ in range(3)]
    got = eddsa_ops._msg_bits(msgs, 'cpu')
    assert got.shape == (8 * n_bytes, 3)
    assert [''.join(str(int(b)) for b in got[:, i]) for i in range(3)] == \
        [ref_eddsa.PureEdDSA.to_bits(m) for m in msgs]
    vals = rand_ints(3, JUBJUB_L, 50 + n_bytes)
    bits = eddsa_ops._scalar_bits(vals, 'cpu')
    assert bits.shape == (254, 3)
    assert [sum(int(bits[i, j]) << i for i in range(254))
            for j in range(3)] == vals
