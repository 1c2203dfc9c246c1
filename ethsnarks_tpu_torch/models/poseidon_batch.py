"""N Poseidon hashes in one circuit, with the witness made by the batched
Poseidon trace (counterpart of ``ethsnarks_tpu/models/poseidon_batch.py``).

The gadgets stamp each instance's rows; the witness of all N instances is
computed by one call of :func:`..ops.poseidon_ops.poseidon_witness_device`
on the model's device, and each instance's sbox values are written into
the variable vector by index.  An instance is 3 (R_F t + R_P) = 315
constraints for its permutation and one for its public digest: at
N = 1024, 323,584 constraints on the domain 2^19.
"""

from .. import resolve_device
from ..field import SNARK_SCALAR_FIELD
from ..gadgets import Poseidon_gadget
from ..ops.fp import NH, Fr
from ..ops.poseidon_ops import poseidon_witness_device
from ..poseidon import DefaultParams
from ..r1cs import ConstraintSystem

P = SNARK_SCALAR_FIELD


class BatchPoseidonHash(object):
    """N independent Poseidon permutations of ``n_inputs`` private inputs
    each, with public digests (state[0]).  ``device`` (None: the card) is
    where :meth:`set_witness` runs the trace."""

    def __init__(self, n_instances, n_inputs=2, params=None, device=None):
        self.params = params or DefaultParams
        self.n_instances = n_instances
        self.n_inputs = n_inputs
        self.device = resolve_device(device)
        pb = ConstraintSystem()
        self.digest_vs = [pb.allocate('digest_%d' % i)
                          for i in range(n_instances)]
        pb.set_input_sizes(n_instances)
        self.input_vs = []
        self.gadgets = []
        for i in range(n_instances):
            ins = pb.allocate_array(n_inputs, 'in_%d' % i)
            g = Poseidon_gadget(pb, [v + 0 for v in ins],
                                'poseidon_%d' % i, params=self.params,
                                constrain_outputs=0)
            g.generate_r1cs_constraints()
            pb.add_constraint(g.final_state[0], 1, self.digest_vs[i] + 0,
                              'bind_%d' % i)
            self.input_vs.append(ins)
            self.gadgets.append(g)
        self.pb = pb
        # the trace's (x2, x4, x5) of an sbox are written at x2's index
        # + 0..2, so the layout is checked here against the gadgets' own
        # variables
        for g in self.gadgets:
            for sb in g.sboxes:
                assert (sb.x4.index, sb.x5.index) == \
                    (sb.x2.index + 1, sb.x2.index + 2), \
                    "sbox variables are not contiguous"

    def set_witness(self, inputs_batch):
        """inputs_batch: n_instances tuples of n_inputs ints.  One batched
        trace on the model's device fills every sbox variable."""
        assert len(inputs_batch) == self.n_instances
        pb = self.pb
        t = self.params.t
        B = self.n_instances
        cols = []
        for j in range(t):
            cols += [row[j] if j < self.n_inputs else 0
                     for row in inputs_batch]
        for i, row in enumerate(inputs_batch):
            for j in range(self.n_inputs):
                pb.setval(self.input_vs[i][j], int(row[j]) % P)
        state = Fr.ints_to_h16(cols, self.device, mont=True).reshape(
            NH, t, B)
        final, aux = poseidon_witness_device(state, self.params)
        # one conversion: (16, n_sboxes, 3, B) -> ints in (sbox, power,
        # instance) order
        n_sb = aux.shape[0]
        flat = Fr.h16_to_ints(Fr.from_mont(
            aux.permute(2, 0, 1, 3).reshape(NH, -1)))
        values = pb.values
        for i, g in enumerate(self.gadgets):
            assert len(g.sboxes) == n_sb
            for k, sb in enumerate(g.sboxes):
                base = sb.x2.index
                at = 3 * B * k + i
                values[base:base + 3] = flat[at:at + 3 * B:B]
        for v, d in zip(self.digest_vs,
                        Fr.h16_to_ints(final[:, 0], mont=True)):
            pb.setval(v, d)
        return self

    def digests(self):
        return [self.pb.val(v) for v in self.digest_vs]
