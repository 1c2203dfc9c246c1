"""The port's Pinocchio reader (``ethsnarks_tpu_torch.pinocchio``) against
the JAX package's, with no proof: on every circuit of
``tests/test_pinocchio.py``, the jsnark harness of
``tests/test_pinocchio_golden.py``, a 3-bit table and a small instance of
``chip_smoke.py``'s generated circuit, the outputs, the constraint system
(``r1cs_to_dict``) and the filled witness equal the reference's; and the
command line's ``eval`` / ``trace`` print the same lines."""
import importlib.util
import os

import numpy as np
import pytest

from ethsnarks_tpu import pinocchio as ref_pinocchio
from ethsnarks_tpu.serialization import r1cs_to_dict as ref_r1cs_to_dict

from ethsnarks_tpu_torch import pinocchio
from ethsnarks_tpu_torch.serialization import r1cs_to_dict

import test_pinocchio as cases
from test_pinocchio_golden import TestJsnarkHarness

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

TABLE3 = ("total 5\ninput 0\ninput 1\ninput 2\noutput 3\n"
          "table 3 <5 10 15 20 25 30 35 40> in <0 1 2> out <3>\n"
          "mul in 2 <3 0> out 1 <4>\noutput 4\n")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _generated(n_blocks):
    return _chip_smoke().pinocchio_circuit(n_blocks,
                                           np.random.default_rng(12345))


CIRCUITS = [
    ("add", cases.ADD, "0=2\n1=4"),
    ("mul", cases.MUL, "0=100\n1=123"),
    ("xor", cases.XOR, "0=1\n1=1"),
    ("or", cases.OR, "0=1\n1=0"),
    ("const_mul", cases.CONST_MUL, "0=2"),
    ("const_mul_neg", cases.CONST_MUL_NEG, "0=2"),
    ("table1", cases.TABLE1, "0=1"),
    ("table2", cases.TABLE2, "0=1\n1=1"),
    ("split_pack", cases.SPLIT_PACK, "0=5"),
    ("zerop_nonzero", cases.ZEROP, "0=7"),
    ("zerop_zero", cases.ZEROP, "0=0"),
    ("nizk", cases.NIZK, "0=3\n1=5"),
    ("jsnark", TestJsnarkHarness.CIRCUIT, "0=1\n1=2\n2=3"),
    ("jsnark_zero", TestJsnarkHarness.CIRCUIT, "0=0\n1=0\n2=3"),
    ("table3_110", TABLE3, "0=0\n1=1\n2=1"),
    ("table3_011", TABLE3, "0=1\n1=1\n2=0"),
]


def _both(text, inputs):
    out = []
    for mod in (pinocchio, ref_pinocchio):
        reader = mod.CircuitReader(text)
        reader.set_inputs(inputs)
        outputs = reader.eval()
        cs, w2v = reader.build_constraint_system()
        reader.fill_witness(cs, w2v)
        out.append((reader, outputs, cs, w2v))
    return out


@pytest.mark.parametrize("text,inputs", [c[1:] for c in CIRCUITS],
                         ids=[c[0] for c in CIRCUITS])
def test_circuit_equals_reference(text, inputs):
    (reader, outputs, cs, w2v), (ref_reader, ref_outputs, ref_cs,
                                 ref_w2v) = _both(text, inputs)
    assert outputs == ref_outputs
    assert cs.is_satisfied()
    assert r1cs_to_dict(cs) == ref_r1cs_to_dict(ref_cs)
    assert cs.values == ref_cs.values
    assert cs.annotations == ref_cs.annotations
    assert {w: v.index for w, v in w2v.items()} == \
        {w: v.index for w, v in ref_w2v.items()}
    assert reader.primary_inputs() == ref_reader.primary_inputs()


def test_generated_circuit_equals_reference():
    """chip_smoke.py's phase-12 circuit at 6 blocks: every opcode, 27
    constraints a block."""
    arith, inputs = _generated(6)
    (reader, outputs, cs, _), (_, ref_outputs, ref_cs, _) = \
        _both(arith, inputs)
    ops = {i.opcode for i in reader.instructions}
    assert ops == {'add', 'mul', 'xor', 'or', 'assert', 'zerop', 'split',
                   'pack', 'const-mul', 'const-mul-neg', 'table'}
    assert {len(i.in_wires) for i in reader.instructions
            if i.opcode == 'table'} == {1, 2, 3}
    assert reader.input_wires and reader.nizk_wires and reader.output_wires
    assert cs.num_constraints == 27 * 6
    assert cs.is_satisfied()
    assert outputs == ref_outputs
    assert r1cs_to_dict(cs) == ref_r1cs_to_dict(ref_cs)
    assert cs.values == ref_cs.values


def test_unsatisfied_assert_raises():
    text = "total 3\ninput 0\ninput 1\nassert in 2 <0 1> out 1 <2>\n"
    for mod in (pinocchio, ref_pinocchio):
        reader = mod.CircuitReader(text)
        reader.set_inputs("0=2\n1=3\n2=7")
        with pytest.raises(ValueError):
            reader.eval()


@pytest.mark.parametrize("cmd", ["eval", "trace"])
def test_main_eval_trace_equal_reference(cmd, tmp_path, capsys):
    arith, inputs = _generated(2)
    circ, inp = tmp_path / "c.arith", tmp_path / "c.input"
    circ.write_text(arith)
    inp.write_text(inputs)
    argv = ["pinocchio", str(circ), cmd, str(inp)]
    assert pinocchio.main(argv) == 0
    got = capsys.readouterr().out
    assert ref_pinocchio.main(argv) == 0
    assert got == capsys.readouterr().out
    reader = pinocchio.CircuitReader(str(circ))
    reader.set_inputs(inputs)
    outputs = reader.eval()
    assert got.splitlines()[-3:] == [
        "%d=%d" % (w, outputs[w]) for w in reader.output_wires]


def test_main_usage_and_unknown(capsys):
    assert pinocchio.main(["pinocchio"]) == 1
    assert pinocchio.main(["pinocchio", "x.arith", "frobnicate"]) == 1
    got = capsys.readouterr().out
    assert ref_pinocchio.main(["pinocchio"]) == 1
    assert ref_pinocchio.main(["pinocchio", "x.arith", "frobnicate"]) == 1
    assert got == capsys.readouterr().out
