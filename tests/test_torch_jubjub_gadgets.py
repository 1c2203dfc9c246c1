"""The port's JubJub gadgets and ``EdDSAVerify`` against the JAX
package's (after tests/test_gadgets_jubjub.py): each board is built and
its witness filled by both packages' gadgets on the same inputs, and the
constraint triples (``to_coo()``), the annotations and every witness value
must be equal (integers, so no tolerance); the results are also held to
the host curve and hashes.  Keys and messages come from numpy seeds."""
import numpy as np
import pytest

from ethsnarks_tpu import eddsa as ref_eddsa
from ethsnarks_tpu import field as ref_field
from ethsnarks_tpu import jubjub as ref_jubjub
from ethsnarks_tpu import r1cs as ref_r1cs
from ethsnarks_tpu.gadgets import jubjub as ref_gj
from ethsnarks_tpu.models import eddsa_verify as ref_model

from ethsnarks_tpu_torch import eddsa, field, jubjub, r1cs
from ethsnarks_tpu_torch.gadgets import jubjub as gj
from ethsnarks_tpu_torch.models import eddsa_verify as model
from ethsnarks_tpu_torch.pedersen import pedersen_hash_bits

from torch_port_helpers import ints_of, rand_ints, same_board

PORT = (r1cs, gj, jubjub, field)
REF = (ref_r1cs, ref_gj, ref_jubjub, ref_field)
L = jubjub.JUBJUB_L


def _point(pb, pt, name):
    v = pb.allocate(name + '.x'), pb.allocate(name + '.y')
    pb.setval(v[0], int(pt[0]))
    pb.setval(v[1], int(pt[1]))
    return v


def _bits(pb, value, n, name):
    out = pb.allocate_array(n, name)
    for i, v in enumerate(out):
        pb.setval(v, (value >> i) & 1)
    return out


def _build(mods, kind, arg):
    """A board with one gadget of ``kind`` on seeded inputs, its rows made
    and its witness filled -> (pb, gadget, the expected host result)."""
    r1cs_mod, gmod, jmod, fmod = mods
    pb = r1cs_mod.ConstraintSystem()
    g = jmod.Point.generator()
    a, b = g * 3, g * 5
    want = None
    if kind == 'PointAdder':
        gad = gmod.PointAdder(pb, gmod.VariablePoint(*_point(pb, a, 'a')),
                              gmod.VariablePoint(*_point(pb, b, 'b')), kind)
        want = a + b
    elif kind == 'PointDoubler':
        gad = gmod.PointDoubler(pb, _point(pb, b, 'p'), kind)
        want = b.double()
    elif kind == 'ConditionalPoint':
        bit = pb.allocate('bit')
        pb.setval(bit, arg)
        gad = gmod.ConditionalPoint(pb, _point(pb, a, 'p'), bit, kind)
        want = a if arg else jmod.Point.infinity()
    elif kind == 'MontgomeryAdder':
        gad = gmod.MontgomeryAdder(pb, _point(pb, a.as_mont(), 'a'),
                                   _point(pb, b.as_mont(), 'b'), kind)
        want = (a + b).as_mont()
    elif kind == 'MontgomeryToEdwards':
        gad = gmod.MontgomeryToEdwards(pb, _point(pb, a.as_mont(), 'm'), kind)
        want = a
    elif kind == 'fixed_base_mul':
        gad = gmod.fixed_base_mul(pb, b, _bits(pb, arg, 9, 's'), kind)
        want = b * arg
    elif kind == 'ScalarMult':
        gad = gmod.ScalarMult(pb, _point(pb, a, 'p'), _bits(pb, arg, 6, 's'),
                              kind)
        want = a * arg
    elif kind in ('IsOnCurve', 'NotLowOrder', 'PointValidator'):
        gad = getattr(gmod, kind)(pb, _point(pb, a, 'p'), kind)
    elif kind == 'Commitment':
        gad = gmod.Commitment(pb, [a, b], [_bits(pb, arg, 4, 's0'),
                                           _bits(pb, arg + 3, 4, 's1')],
                              kind)
        want = a * arg + b * (arg + 3)
    elif kind in ('PedersenHash', 'PedersenHashToBits'):
        bits = _bits(pb, arg, 189 if kind == 'PedersenHash' else 30, 'm')
        gad = getattr(gmod, kind)(pb, 'test', bits, kind)
        if kind == 'PedersenHash':      # 63 windows: two basepoints
            want = pedersen_hash_bits(
                'test', format(arg, '0189b')[::-1])
    elif kind == 'EdDSA_HashRAM_gadget':
        R, A = _point(pb, a, 'R'), _point(pb, b, 'A')
        gad = gmod.EdDSA_HashRAM_gadget(
            pb, gmod.VariablePoint(*R), gmod.VariablePoint(*A),
            _bits(pb, arg, 8, 'msg'), kind)
    gad.generate_r1cs_constraints()
    gad.generate_r1cs_witness()
    return pb, gad, want


GADGETS = [
    ('PointAdder', None, 7), ('PointDoubler', None, 6),
    ('ConditionalPoint', 0, 2), ('ConditionalPoint', 1, 2),
    ('MontgomeryAdder', None, 3), ('MontgomeryToEdwards', None, 2),
    ('fixed_base_mul', 0b101100111, None), ('ScalarMult', 0b110101, None),
    ('IsOnCurve', None, 3), ('NotLowOrder', None, None),
    ('PointValidator', None, None), ('Commitment', 0b1011, None),
    ('PedersenHash', (1 << 188) + 12345678987654321, None),
    ('PedersenHashToBits', 0x2BADCAFE, None),
    ('EdDSA_HashRAM_gadget', 0xA5, None),
]


@pytest.mark.parametrize('kind,arg,rows', GADGETS)
def test_gadget_matches_reference(kind, arg, rows):
    got, gad, want = _build(PORT, kind, arg)
    ref, _, _ = _build(REF, kind, arg)
    same_board(got, ref)
    assert got.is_satisfied()
    if rows is not None:
        assert got.num_constraints == rows
    if want is not None:
        res = gad.result()
        assert (got.lc_val(r1cs.LinearCombination() + res[0]),
                got.lc_val(r1cs.LinearCombination() + res[1])) == \
            ints_of(want)


def _signed(scheme, seed):
    """(A, (R, s), msg) of the port's ``scheme`` on a seeded key and a
    seeded 32-byte message."""
    rng = np.random.default_rng(seed)
    msg = rng.bytes(32)
    k = rand_ints(1, L - 1, seed)[0] + 1
    sm = getattr(eddsa, scheme).sign(msg, field.FQ(k))
    return sm.A, (sm.sig.R, sm.sig.s.n), msg


def _ref_args(A, sig, msg):
    to = lambda p: ref_jubjub.Point(ref_field.FQ(p.x.n), ref_field.FQ(p.y.n))
    return to(A), (to(sig[0]), sig[1]), msg


@pytest.mark.parametrize('gadget,scheme', [
    ('PureEdDSA_gadget', 'PureEdDSA'), ('EdDSA_gadget', 'EdDSA')])
def test_eddsa_verify_matches_reference(gadget, scheme):
    """EdDSAVerify(256): the whole constraint matrices and the witness
    vector equal the reference's, and the witness satisfies them."""
    A, sig, msg = _signed(scheme, 11)
    got = model.EdDSAVerify(256, getattr(gj, gadget))
    got.set_witness(A, sig, msg)
    want = ref_model.EdDSAVerify(256, getattr(ref_gj, gadget))
    want.set_witness(*_ref_args(A, sig, msg))
    same_board(got.pb, want.pb)
    assert got.pb.is_satisfied()
    assert got.pb.primary_input() == [A.x.n, A.y.n]
    if gadget == 'PureEdDSA_gadget':
        assert got.pb.num_constraints == 8050
    assert ref_eddsa.PureEdDSA.verify(*_ref_args(A, sig, msg)) == \
        (scheme == 'PureEdDSA')


@pytest.mark.parametrize('scheme,opener', [
    ('PureEdDSA', model.pureeddsa_open), ('EdDSA', model.hasheddsa_open)])
def test_eddsa_open(scheme, opener):
    """True on a valid signature, False with s + 1 or another message, as
    the reference's opener says."""
    A, (R, s), msg = _signed(scheme, 12)
    ref_open = getattr(ref_model, opener.__name__)
    cases = [((R, s), msg, True), ((R, s + 1), msg, False),
             ((R, s), bytes([msg[0] ^ 1]) + msg[1:], False)]
    for sig, m, ok in cases:
        assert opener(A, sig, m) is ok
        assert ref_open(*_ref_args(A, sig, m)) is ok
