"""The port's basics, arith, Poseidon and SHA-256 gadgets against the JAX
package's (after tests/test_gadgets.py:91-205 and
tests/test_sha256_gadget.py): each board is built and its witness filled
by the gadgets of both packages on the same inputs, and the constraint
triples (``to_coo()``), the annotations and every witness value must be
equal, so no tolerance; the host oracles (hashlib, the host Poseidon) and
the refusals (a flipped input bit, the bits of p) are checked on the
port's board.  Inputs come from numpy seeds."""
import hashlib

import numpy as np
import pytest

from ethsnarks_tpu import gadgets as ref_gadgets
from ethsnarks_tpu import r1cs as ref_r1cs
from ethsnarks_tpu.gadgets import sha256 as ref_sha256

from ethsnarks_tpu_torch import gadgets, r1cs
from ethsnarks_tpu_torch.field import SNARK_SCALAR_FIELD
from ethsnarks_tpu_torch.gadgets import sha256
from ethsnarks_tpu_torch.poseidon import poseidon

from torch_port_helpers import rand_ints, same_board

P = SNARK_SCALAR_FIELD
PORT = (r1cs, gadgets, sha256)
REF = (ref_r1cs, ref_gadgets, ref_sha256)


def both(build, *args):
    """build(modules, *args) -> (pb, gadget) for the port and the
    reference; the boards must be equal.  Returns the port's."""
    got, g = build(PORT, *args)
    want, _ = build(REF, *args)
    same_board(got, want)
    return got, g


def _lookup(mods, kind, idx):
    r1cs_mod, gmod, _ = mods
    pb = r1cs_mod.ConstraintSystem()
    bits = pb.allocate_array(3, 'b')
    if kind == '1bit':
        g = gmod.lookup_1bit_gadget(pb, [11, 22], bits[0], 'l1')
    elif kind == '2bit':
        g = gmod.lookup_2bit_gadget(pb, [10, 21, 32, 43], bits[0], bits[1],
                                    'l2')
    elif kind == '3bit':
        g = gmod.lookup_3bit_gadget(pb, [3, 1, 4, 1, 5, 9, 2, 6], bits, 'l3')
    else:
        g = gmod.lookup_signed_3bit_gadget(pb, [10, 21, 32, 43], bits[0],
                                           bits[1], bits[2], 'ls3')
    g.generate_r1cs_constraints()
    for i in range(3):
        pb.setval(bits[i], (idx >> i) & 1)
    g.generate_r1cs_witness()
    return pb, g


LOOKUPS = [('1bit', i, [11, 22][i & 1], 1) for i in range(2)] + \
    [('2bit', i, [10, 21, 32, 43][i & 3], 1) for i in range(4)] + \
    [('3bit', i, [3, 1, 4, 1, 5, 9, 2, 6][i], 5) for i in range(8)] + \
    [('signed3', i, [10, 21, 32, 43][i & 3] if i < 4
      else P - [10, 21, 32, 43][i & 3], 2) for i in range(8)]


@pytest.mark.parametrize('kind,idx,want,rows', LOOKUPS)
def test_lookups_match_reference(kind, idx, want, rows):
    pb, g = both(_lookup, kind, idx)
    assert pb.val(g.result()) == want
    assert pb.num_constraints == rows
    assert pb.is_satisfied()


def _one_input(mods, cls_name, v):
    r1cs_mod, gmod, _ = mods
    pb = r1cs_mod.ConstraintSystem()
    x = pb.allocate('x')
    g = getattr(gmod, cls_name)(pb, x + 0, cls_name)
    g.generate_r1cs_constraints()
    pb.setval(x, v)
    g.generate_r1cs_witness()
    return pb, g


@pytest.mark.parametrize('v', [0, 5, P - 1])
def test_isnonzero_matches_reference(v):
    pb, g = both(_one_input, 'IsNonZero', v)
    assert pb.val(g.result()) == (1 if v else 0)
    assert pb.num_constraints == 2
    assert pb.is_satisfied()


@pytest.mark.parametrize('v', [0, 1, 0xdeadbeef, P - 1] + rand_ints(1, P, 5))
def test_field2bits_strict_matches_reference(v):
    pb, g = both(_one_input, 'field2bits_strict', v)
    bits = [pb.val(b) for b in g.result()]
    assert sum(b << i for i, b in enumerate(bits)) == v
    assert pb.is_satisfied()


def test_field2bits_strict_refuses_p():
    """The bits of p pack to the field element 0 but must not satisfy."""
    pb, g = both(_one_input, 'field2bits_strict', 0)
    assert pb.is_satisfied()
    for i, b in enumerate(g.bits):
        pb.setval(b, (P >> i) & 1)
    for i in reversed(range(254)):
        if (P >> i) & 1:
            pb.setval(g.e_vars[i], 1)
    assert not pb.is_satisfied()


def _one_of_n(mods, our_v):
    r1cs_mod, gmod, _ = mods
    pb = r1cs_mod.ConstraintSystem()
    items = pb.allocate_array(4, 'items')
    our = pb.allocate('our')
    g = gmod.one_of_n(pb, our + 0, [i + 0 for i in items], '1ofn')
    g.generate_r1cs_constraints()
    for i, v in enumerate([7, 8, 9, 10]):
        pb.setval(items[i], v)
    pb.setval(our, our_v)
    g.generate_r1cs_witness()
    return pb, g


@pytest.mark.parametrize('our_v,member', [(9, True), (11, False)])
def test_one_of_n_matches_reference(our_v, member):
    pb, g = both(_one_of_n, our_v)
    assert pb.num_constraints == 2 * 4 + 1
    assert pb.is_satisfied() == member


def _packing(mods, v, from_bits):
    r1cs_mod, gmod, _ = mods
    pb = r1cs_mod.ConstraintSystem()
    x = pb.allocate('x')
    bits = pb.allocate_array(16, 'bits')
    g = gmod.packing_gadget(pb, bits, x + 0, 'pack')
    g.generate_r1cs_constraints()
    if from_bits:
        for i, b in enumerate(bits):
            pb.setval(b, (v >> i) & 1)
        g.generate_r1cs_witness_from_bits()
    else:
        pb.setval(x, v)
        g.generate_r1cs_witness_from_packed()
    return pb, g


@pytest.mark.parametrize('from_bits', [False, True])
def test_packing_matches_reference(from_bits):
    pb, g = both(_packing, 0xbeef, from_bits)
    assert pb.num_constraints == 17
    assert pb.val(g.packed) == 0xbeef
    assert pb.is_satisfied()


def _comparison(mods, a, b):
    r1cs_mod, gmod, _ = mods
    pb = r1cs_mod.ConstraintSystem()
    va, vb = pb.allocate('a'), pb.allocate('b')
    g = gmod.comparison_gadget(pb, 16, va + 0, vb + 0, 'cmp')
    g.generate_r1cs_constraints()
    pb.setval(va, a)
    pb.setval(vb, b)
    g.generate_r1cs_witness()
    return pb, g


@pytest.mark.parametrize('a,b', [(3, 9), (9, 9), (0xffff, 2)])
def test_comparison_matches_reference(a, b):
    pb, g = both(_comparison, a, b)
    assert (pb.val(g.less), pb.val(g.less_or_eq)) == (int(a < b),
                                                      int(a <= b))
    assert pb.is_satisfied()


def _subadd(mods, a, b, n):
    r1cs_mod, gmod, _ = mods
    pb = r1cs_mod.ConstraintSystem()
    va, vb, vn = pb.allocate('a'), pb.allocate('b'), pb.allocate('n')
    g = gmod.subadd_gadget(pb, 16, va + 0, vb + 0, vn + 0, 'subadd')
    g.generate_r1cs_constraints()
    for v, x in ((va, a), (vb, b), (vn, n)):
        pb.setval(v, x)
    g.generate_r1cs_witness()
    return pb, g


@pytest.mark.parametrize('a,b,n,ok', [(100, 50, 30, True),
                                      (10, 50, 30, False)])
def test_subadd_matches_reference(a, b, n, ok):
    pb, g = both(_subadd, a, b, n)
    assert (pb.val(g.X), pb.val(g.Y)) == ((a - n) % P, b + n)
    assert pb.is_satisfied() == ok


def _shamir(mods, x, coeffs):
    r1cs_mod, gmod, _ = mods
    pb = r1cs_mod.ConstraintSystem()
    vx = pb.allocate('x')
    vc = pb.allocate_array(len(coeffs), 'a')
    g = gmod.shamir_poly(pb, vx + 0, [v + 0 for v in vc], 'shamir')
    g.generate_r1cs_constraints()
    pb.setval(vx, x)
    for v, c in zip(vc, coeffs):
        pb.setval(v, c)
    g.generate_r1cs_witness()
    return pb, g


@pytest.mark.parametrize('k', [2, 5])
def test_shamir_poly_matches_reference(k):
    vals = rand_ints(k + 1, P, seed=k)
    x, coeffs = vals[0], vals[1:]
    pb, g = both(_shamir, x, coeffs)
    assert pb.num_constraints == 2 * k - 1
    assert pb.val(g.result()) == sum(c * pow(x, i, P)
                                     for i, c in enumerate(coeffs)) % P
    assert pb.is_satisfied()


def _poseidon(mods, inputs, constrain_outputs):
    r1cs_mod, gmod, _ = mods
    pb = r1cs_mod.ConstraintSystem()
    xs = pb.allocate_array(len(inputs), 'x')
    g = gmod.Poseidon_gadget(pb, [v + 0 for v in xs], 'poseidon',
                             constrain_outputs=constrain_outputs)
    g.generate_r1cs_constraints()
    for v, x in zip(xs, inputs):
        pb.setval(v, x)
    g.generate_r1cs_witness()
    return pb, g


@pytest.mark.parametrize('n_in,outs', [(1, 1), (2, 1), (5, 0), (2, 3)])
def test_poseidon_gadget_matches_reference(n_in, outs):
    inputs = rand_ints(n_in, P, seed=10 + n_in)
    pb, g = both(_poseidon, inputs, outs)
    assert pb.num_constraints == 3 * (8 * 6 + 57) + outs
    assert pb.val(g.result()) == poseidon(inputs)
    assert pb.is_satisfied()
    for sb in g.sboxes:
        assert (sb.x4.index, sb.x5.index) == (sb.x2.index + 1,
                                              sb.x2.index + 2)


def _bits_of(data):
    return [int(b) for byte in data for b in bin(byte)[2:].rjust(8, '0')]


def _digest(pb, result_bits):
    out = ''.join(str(pb.val(b) if not isinstance(b, int) else b)
                  for b in result_bits)
    return int(out, 2).to_bytes(32, 'big')


def _sha(mods, data, full_512):
    r1cs_mod, _, smod = mods
    pb = r1cs_mod.ConstraintSystem()
    in_bits = pb.allocate_array(len(data) * 8, 'in')
    cls = smod.sha256_full_gadget_512 if full_512 else smod.sha256_many
    g = cls(pb, in_bits, 'sha')
    g.generate_r1cs_constraints()
    for v, b in zip(in_bits, _bits_of(data)):
        pb.setval(v, b)
    g.generate_r1cs_witness()
    return pb, g


def test_sha256_full_512_matches_reference():
    """Two compressions: the data block and the constant padding block;
    an input bit flipped breaks satisfiability."""
    data = bytes(range(64))
    pb, g = both(_sha, data, True)
    assert _digest(pb, g.result()) == hashlib.sha256(data).digest()
    assert pb.is_satisfied()
    first_bit = r1cs.Variable(1)           # allocated right after ONE
    pb.setval(first_bit, 1 - pb.val(first_bit))
    assert not pb.is_satisfied()


@pytest.mark.parametrize('data', [b'abc', b'y' * 56],
                         ids=['1_block', '2_blocks'])
def test_sha256_many_matches_reference(data):
    pb, g = both(_sha, data, False)
    assert _digest(pb, g.result()) == hashlib.sha256(data).digest()
    assert pb.is_satisfied()


@pytest.mark.parametrize('n', [0, 55, 64, 447, 448, 512])
def test_bits2blocks_padded(n):
    assert sha256.bits2blocks_padded(n) == ref_sha256.bits2blocks_padded(n)


def test_sha256_many_digests_by_length():
    """The port's gadget alone at the padding boundaries (55 bytes: one
    block; 64: two) against hashlib; a random message."""
    rng = np.random.default_rng(3)
    for data in (b'x' * 55, rng.bytes(64)):
        pb, g = _sha(PORT, data, False)
        assert len(g.comps) == sha256.bits2blocks_padded(len(data) * 8)
        assert _digest(pb, g.result()) == hashlib.sha256(data).digest()
        assert pb.is_satisfied()
