"""Pinocchio / extended-Pinocchio ``.arith`` circuits (own copy of
``ethsnarks_tpu/pinocchio.py``).

:class:`CircuitReader` parses the format (opcodes add, mul, xor, or,
assert, zerop, split, pack, const-mul[-neg]-<hex>, table with 1-3 input
bits; input / nizkinput / output wires), evaluates the wires (the
witness) and emits the R1CS rows into a :class:`.r1cs.ConstraintSystem`,
so circuits from jsnark and similar compilers reach the prover.
:func:`main` is the genkeys / prove / verify / eval / trace / test
command line; setup and proofs run on the CUDA card:

    python -m ethsnarks_tpu_torch.pinocchio c.arith genkeys pk.bin vk.json
    python -m ethsnarks_tpu_torch.pinocchio c.arith prove c.input pk.bin proof.json
    python -m ethsnarks_tpu_torch.pinocchio c.arith verify vk.json proof.json
"""

import sys

from .field import SNARK_SCALAR_FIELD
from .gadgets.basics import lookup_3bit_gadget
from .r1cs import ConstraintSystem, LinearCombination

P = SNARK_SCALAR_FIELD


class _Instruction(object):
    __slots__ = ('opcode', 'constant', 'in_wires', 'out_wires', 'table')

    def __init__(self, opcode, constant, in_wires, out_wires, table=None):
        self.opcode = opcode
        self.constant = constant
        self.in_wires = in_wires
        self.out_wires = out_wires
        self.table = table or []


def _parse_wire_list(text):
    return [int(t) for t in text.replace('<', ' ').replace('>', ' ').split()]


class CircuitReader(object):
    """Parse + evaluate + constrain a .arith circuit."""

    def __init__(self, arith_path_or_text, inputs_text=None):
        if '\n' in arith_path_or_text:
            text = arith_path_or_text
        else:
            with open(arith_path_or_text) as fh:
                text = fh.read()
        self.total = 0
        self.input_wires = []
        self.nizk_wires = []
        self.output_wires = []
        self.instructions = []
        self._parse(text)

        self.wire_values = {}
        if inputs_text is not None:
            self.set_inputs(inputs_text)

    # ---------------- parsing ----------------

    def _parse(self, text):
        for raw in text.splitlines():
            line = raw.split('#')[0].strip()
            if not line:
                continue
            parts = line.split()
            head = parts[0]
            if head == 'total':
                self.total = int(parts[1])
            elif head == 'input':
                self.input_wires.append(int(parts[1]))
            elif head == 'nizkinput':
                self.nizk_wires.append(int(parts[1]))
            elif head == 'output':
                self.output_wires.append(int(parts[1]))
            elif head == 'table':
                # table N <v...> in <w...> out <w>
                nbits = int(parts[1])
                inner = line.split('<')
                tbl = [int(t) for t in inner[1].split('>')[0].split()]
                ins = [int(t) for t in inner[2].split('>')[0].split()]
                outs = [int(t) for t in inner[3].split('>')[0].split()]
                if nbits not in (1, 2, 3):
                    raise ValueError("unsupported table size %d" % nbits)
                if len(tbl) != (1 << nbits):
                    raise ValueError("bad table entry count")
                self.instructions.append(
                    _Instruction('table', 0, ins, outs, tbl))
            else:
                # opcode in N <w...> out M <w...>
                segs = line.split('<')
                ins = _parse_wire_list(segs[1].split('>')[0])
                outs = _parse_wire_list(segs[2].split('>')[0])
                opcode = head
                constant = 0
                if head.startswith('const-mul-neg-'):
                    opcode = 'const-mul-neg'
                    constant = int(head[len('const-mul-neg-'):], 16)
                elif head.startswith('const-mul-'):
                    opcode = 'const-mul'
                    constant = int(head[len('const-mul-'):], 16)
                self.instructions.append(
                    _Instruction(opcode, constant, ins, outs))

    # ---------------- evaluation (witness) ----------------

    def set_inputs(self, inputs_text, base=16):
        """'wire=value' per line.  Values are hex by default, as the
        reference reads its input files; base=0 takes python's prefixes
        (0x, 0b, decimal)."""
        for raw in inputs_text.splitlines():
            line = raw.split('#')[0].strip()
            if not line:
                continue
            wire, value = line.split('=')
            self.wire_values[int(wire)] = int(value.strip(), base) % P

    def eval(self, trace=False):
        """Evaluate all instructions; returns {output_wire: value}.

        Input and nizk wires without an assignment read as 0, as
        unassigned protoboard variables do in the reference."""
        v = self.wire_values
        for wire in self.input_wires + self.nizk_wires:
            if wire not in v:
                v[wire] = 0
        for inst in self.instructions:
            ins = [v[w] for w in inst.in_wires]
            op = inst.opcode
            if op == 'add':
                out = sum(ins) % P
                v[inst.out_wires[0]] = out
            elif op == 'mul':
                v[inst.out_wires[0]] = (ins[0] * ins[1]) % P
            elif op == 'xor':
                v[inst.out_wires[0]] = (ins[0] + ins[1] - 2 * ins[0] * ins[1]) % P
            elif op == 'or':
                v[inst.out_wires[0]] = (ins[0] + ins[1] - ins[0] * ins[1]) % P
            elif op == 'assert':
                if (ins[0] * ins[1]) % P != v.get(inst.out_wires[0], None):
                    # assert reads its 'output' wire; it must already be set
                    raise ValueError("assert failed")
            elif op == 'zerop':
                x = ins[0]
                v[inst.out_wires[0]] = pow(x, P - 2, P) if x else 0  # aux M
                v[inst.out_wires[1]] = 0 if x == 0 else 1
            elif op == 'split':
                for i, w in enumerate(inst.out_wires):
                    v[w] = (ins[0] >> i) & 1
            elif op == 'pack':
                v[inst.out_wires[0]] = sum(
                    val << i for i, val in enumerate(ins)) % P
            elif op == 'const-mul':
                v[inst.out_wires[0]] = (inst.constant * ins[0]) % P
            elif op == 'const-mul-neg':
                v[inst.out_wires[0]] = (-inst.constant * ins[0]) % P
            elif op == 'table':
                idx = sum(bool(val) << i for i, val in enumerate(ins))
                v[inst.out_wires[0]] = inst.table[idx] % P
            else:
                raise ValueError("unknown opcode %r" % op)
            if trace:
                print("%s in %r out %r = %r" % (
                    op, ins, [v.get(w) for w in inst.out_wires],
                    [v.get(w) for w in inst.out_wires]))
        return {w: v[w] for w in self.output_wires}

    # ---------------- constraint system ----------------

    def build_constraint_system(self):
        """ConstraintSystem with inputs+outputs public, nizk private.

        Returns (cs, wire_to_var) - witness values must be evaluated first."""
        cs = ConstraintSystem()
        wire_to_var = {}
        # public: inputs then outputs (reference convention)
        for w in self.input_wires + self.output_wires:
            wire_to_var[w] = cs.allocate('wire_%d' % w)
        cs.set_input_sizes(len(self.input_wires) + len(self.output_wires))
        for w in self.nizk_wires:
            wire_to_var[w] = cs.allocate('nizk_%d' % w)

        def var(w):
            if w not in wire_to_var:
                wire_to_var[w] = cs.allocate('aux_%d' % w)
            return wire_to_var[w]

        for inst in self.instructions:
            op = inst.opcode
            ins = [var(w) for w in inst.in_wires]
            if op == 'add':
                acc = LinearCombination()
                for x in ins:
                    acc = acc + x
                cs.add_constraint(acc, 1, var(inst.out_wires[0]), 'add')
            elif op == 'mul':
                cs.add_constraint(ins[0], ins[1], var(inst.out_wires[0]), 'mul')
            elif op == 'xor':
                # 2ab = a + b - out
                cs.add_constraint(
                    ins[0] * 2, ins[1],
                    (ins[0] + ins[1]) - var(inst.out_wires[0]), 'xor')
            elif op == 'or':
                cs.add_constraint(
                    ins[0], ins[1],
                    (ins[0] + ins[1]) - var(inst.out_wires[0]), 'or')
            elif op == 'assert':
                cs.add_constraint(ins[0], ins[1], var(inst.out_wires[0]),
                                  'assert')
            elif op == 'zerop':
                m = var(inst.out_wires[0])
                y = var(inst.out_wires[1])
                cs.add_constraint(ins[0], m, y, 'zerop.XM=Y')
                cs.add_constraint(ins[0], 1 - (LinearCombination() + y), 0,
                                  'zerop.X(1-Y)=0')
            elif op == 'split':
                acc = LinearCombination()
                for i, w in enumerate(inst.out_wires):
                    b = var(w)
                    cs.add_constraint(b, 1 - (LinearCombination() + b), 0,
                                      'split.bit')
                    acc = acc + b * pow(2, i, P)
                cs.add_constraint(acc, 1, ins[0], 'split.pack')
            elif op == 'pack':
                acc = LinearCombination()
                for i, x in enumerate(ins):
                    acc = acc + x * pow(2, i, P)
                cs.add_constraint(acc, 1, var(inst.out_wires[0]), 'pack')
            elif op == 'const-mul':
                cs.add_constraint(ins[0] * inst.constant, 1,
                                  var(inst.out_wires[0]), 'const-mul')
            elif op == 'const-mul-neg':
                cs.add_constraint(ins[0] * (P - inst.constant % P), 1,
                                  var(inst.out_wires[0]), 'const-mul-neg')
            elif op == 'table':
                self._table_constraints(cs, inst, ins, var)
            else:
                raise ValueError("unknown opcode %r" % op)
        self._cs = cs
        self._wire_to_var = wire_to_var
        return cs, wire_to_var

    def _table_constraints(self, cs, inst, ins, var):
        t = [x % P for x in inst.table]
        out = var(inst.out_wires[0])
        if len(ins) == 1:
            cs.add_constraint(ins[0], t[1] - t[0],
                              (LinearCombination() + out) - t[0], 'table1')
        elif len(ins) == 2:
            b0, b1 = ins
            lhs = (LinearCombination() + b0) * ((t[3] - t[2] - t[1] + t[0]) % P) \
                + (t[2] - t[0])
            rhs = (LinearCombination() + out) - t[0] \
                - (LinearCombination() + b0) * ((t[1] - t[0]) % P)
            cs.add_constraint(b1, lhs, rhs, 'table2')
        else:
            g = lookup_3bit_gadget(cs, t, ins, 'table3')
            g.generate_r1cs_constraints()
            cs.add_constraint(g.result(), 1, out, 'table3.bind')
            self._pending_lookup3 = getattr(self, '_pending_lookup3', [])
            self._pending_lookup3.append(g)

    def fill_witness(self, cs, wire_to_var):
        """Copy evaluated wire values into the constraint system."""
        for w, var in wire_to_var.items():
            if var.index != 0:
                cs.setval(var, self.wire_values[w])
        for g in getattr(self, '_pending_lookup3', []):
            g.generate_r1cs_witness()
        return cs

    def primary_inputs(self):
        return [self.wire_values[w]
                for w in self.input_wires + self.output_wires]


def main(argv):
    if len(argv) < 3:
        print("Usage: pinocchio <circuit.arith> "
              "<genkeys|prove|verify|eval|trace|test> ...")
        return 1
    circuit_path, cmd = argv[1], argv[2]

    def load_with_inputs(path):
        reader = CircuitReader(circuit_path)
        with open(path) as fh:
            reader.set_inputs(fh.read())
        return reader

    if cmd in ('eval', 'trace'):
        reader = load_with_inputs(argv[3])
        outputs = reader.eval(trace=(cmd == 'trace'))
        for w in reader.output_wires:
            print("%d=%d" % (w, outputs[w]))
        return 0

    from .stubs import (stub_genkeys_from_pb, load_proving_key,
                        make_prover_context, prove, stub_verify)
    if cmd == 'genkeys':
        pk_file, vk_file = argv[3], argv[4]
        reader = CircuitReader(circuit_path)
        # constraints only; dummy witness not needed for key generation
        cs, _ = reader.build_constraint_system()
        stub_genkeys_from_pb(cs, pk_file, vk_file)
        print("OK")
        return 0
    if cmd == 'prove':
        inputs_file, pk_file, proof_file = argv[3], argv[4], argv[5]
        reader = load_with_inputs(inputs_file)
        reader.eval()
        cs, w2v = reader.build_constraint_system()
        reader.fill_witness(cs, w2v)
        assert cs.is_satisfied()
        pk = load_proving_key(pk_file)
        ctx = make_prover_context(pk, cs)
        proof_json = prove(ctx, cs)
        with open(proof_file, 'w') as fh:
            fh.write(proof_json)
        print("OK")
        return 0
    if cmd == 'verify':
        vk_file, proof_file = argv[3], argv[4]
        with open(vk_file) as fh:
            vk_json = fh.read()
        with open(proof_file) as fh:
            proof_json = fh.read()
        ok = stub_verify(vk_json, proof_json)
        print("OK" if ok else "FAIL")
        return 0 if ok else 1
    if cmd == 'test':
        reader = load_with_inputs(argv[3])
        reader.eval()
        cs, w2v = reader.build_constraint_system()
        reader.fill_witness(cs, w2v)
        if not cs.is_satisfied():
            print("FAIL (unsatisfied)")
            return 1
        from .stubs import stub_test_proof_verify
        ok = stub_test_proof_verify(cs)
        print("OK" if ok else "FAIL")
        return 0 if ok else 1
    print("Unknown command %r" % cmd)
    return 1


if __name__ == '__main__':
    sys.exit(main(sys.argv))
