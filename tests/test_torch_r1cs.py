"""The port's circuit DSL, MiMC gadget, MiMC cipher and Keccak-256
(ethsnarks_tpu_torch r1cs, gadgets.mimc, mimc, keccak) against the JAX
package's: the one-link MiMC-e7 chain of ``tools/bench_prove.py`` gives
equal COO triples and witnesses in both packages."""
import importlib.util
import os

import pytest

from ethsnarks_tpu.field import SNARK_SCALAR_FIELD
from ethsnarks_tpu.keccak import keccak_256 as ref_keccak
from ethsnarks_tpu.mimc import mimc as ref_mimc
from ethsnarks_tpu.mimc import mimc_constants as ref_constants
from ethsnarks_tpu.r1cs import ConstraintSystem as RefConstraintSystem, \
    dump_pb_r1cs_constraints as ref_dump, r1cs_constraint as ref_constraint

from ethsnarks_tpu_torch.keccak import keccak_256
from ethsnarks_tpu_torch.mimc import mimc, mimc_constants
from ethsnarks_tpu_torch.qap import QAP
from ethsnarks_tpu_torch.r1cs import ConstraintSystem, LinearCombination, \
    Protoboard, dump_pb_r1cs_constraints, r1cs_constraint

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _load(name, relpath):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def chains():
    want = _load("bench_prove", "tools/bench_prove.py").build_circuit(9)
    got = _load("chip_smoke", "chip_smoke.py").build_circuit(9)
    return want, got


def test_mimc_chain_matches_reference(chains):
    want, got = chains
    assert (got.num_constraints, got.num_inputs, got.num_variables) == \
        (want.num_constraints, want.num_inputs, want.num_variables) == \
        (365, 1, 368)
    assert got.values == want.values
    assert got.is_satisfied()
    a, b = want.to_coo(), got.to_coo()
    for name in 'abc':
        assert a[name][0].tolist() == b[name][0].tolist()
        assert a[name][1].tolist() == b[name][1].tolist()
        assert a[name][2] == b[name][2]


def test_chain_qap_compiles(chains):
    _, got = chains
    qap = QAP(got, 'cpu')
    assert qap.domain_size == 512
    wrong = list(got.values)
    wrong[1] += 1
    assert not got.is_satisfied(values=wrong)


def _cubic_board(cls, x, out):
    """x^3 + x + 5 = out on a protoboard of either package."""
    pb = cls()
    o = pb.allocate('out')
    pb.set_input_sizes(1)
    v = pb.allocate('x')
    sq = pb.allocate('sq')
    cube = pb.allocate('cube')
    pb.add_constraint(v, v, sq, 'square')
    pb.add_constraint(sq, v, cube, 'cube')
    pb.add_constraint(cube + v + 5, 1, o, 'sum')
    for var, val in ((v, x), (sq, x * x), (cube, x ** 3), (o, out)):
        pb.setval(var, val)
    return pb


@pytest.mark.parametrize('out', [35, 36], ids=['satisfied', 'unsatisfied'])
@pytest.mark.parametrize('verbose', [False, True],
                         ids=['quiet', 'verbose'])
def test_is_satisfied_matches_reference(out, verbose, capsys):
    """is_satisfied() and is_satisfied(True), called the reference's way,
    give the reference's bool and print the reference's lines."""
    want = _cubic_board(RefConstraintSystem, 3, out).is_satisfied(verbose)
    want_out = capsys.readouterr().out
    got = _cubic_board(ConstraintSystem, 3, out).is_satisfied(verbose)
    got_out = capsys.readouterr().out
    assert got is want is (out == 35)
    assert got_out == want_out
    assert bool(got_out) == (verbose and out != 35)


@pytest.mark.parametrize('x,k', [(0, 0), (777, 888), (1 << 250, 3)])
def test_mimc_matches_reference(x, k):
    assert mimc(x, k) == ref_mimc(x, k)


def test_mimc_constants_match_reference():
    assert list(mimc_constants()) == list(ref_constants())


@pytest.mark.parametrize('data', [b'', b'mimc', bytes(range(136)),
                                  bytes(300)],
                         ids=['empty', 'mimc', 'one_block', 'three_blocks'])
def test_keccak_matches_reference(data):
    assert keccak_256(data).hexdigest() == ref_keccak(data).hexdigest()


def test_linear_combination_arithmetic():
    cs = ConstraintSystem()
    x, y = cs.allocate('x'), cs.allocate('y')
    lc = 3 * x - y + 5
    assert isinstance(lc, LinearCombination)
    assert lc.terms == {x.index: 3, y.index: lc.terms[y.index], 0: 5}
    cs.setval(x, 2)
    cs.setval(y, 4)
    assert cs.lc_val(lc) == 7
    with pytest.raises(TypeError):
        x._lc() * y


def _array_board(cls):
    """Two public inputs from allocate_array, one aux array, a product."""
    pb = cls()
    ins = pb.allocate_array(2, 'in')
    pb.set_input_sizes(2)
    aux = pb.allocate_array(3, 'aux')
    pb.add_constraint(ins[0], ins[1], aux[0], 'prod')
    pb.add_constraint(aux[0] + 3 * aux[1] - 7, ins[0] + 1, aux[2], 'mix')
    for var, val in zip(ins + aux, (3, 5, 15, 2, (15 + 6 - 7) * 4)):
        pb.setval(var, val)
    return pb


def test_dsl_additions_match_reference(capsys):
    """allocate_array, primary_input, auxiliary_input and
    dump_pb_r1cs_constraints give the reference's variables, values and
    text; Protoboard is the constraint system."""
    assert Protoboard is ConstraintSystem
    got, want = _array_board(ConstraintSystem), \
        _array_board(RefConstraintSystem)
    assert got.annotations == want.annotations == \
        ['ONE', 'in[0]', 'in[1]', 'aux[0]', 'aux[1]', 'aux[2]']
    assert got.primary_input() == want.primary_input() == [3, 5]
    assert got.auxiliary_input() == want.auxiliary_input() == [15, 2, 56]
    assert got.is_satisfied()
    lines = []
    for limit in (None, 1):
        ref_dump(want, limit)
        want_out = capsys.readouterr().out
        dump_pb_r1cs_constraints(got, limit)
        assert capsys.readouterr().out == want_out
        lines.append(want_out.count('constraint '))
    assert lines == [2, 1]


@pytest.mark.parametrize('a,b,c', [(3, 5, 15), (3, 5, 16), (-1, -1, 1)])
def test_r1cs_constraint_matches_reference(a, b, c):
    def outcome(fn):
        try:
            fn(a, b, c)
            return True
        except RuntimeError:
            return False
    assert outcome(r1cs_constraint) == outcome(ref_constraint) == \
        ((a * b - c) % SNARK_SCALAR_FIELD == 0)
