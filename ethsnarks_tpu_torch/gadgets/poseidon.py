"""Poseidon permutation gadget (own copy of
``ethsnarks_tpu/gadgets/poseidon.py:19-100``).

Each x^5 sbox is three constraints over the variables x2, x4, x5,
allocated one after another (:class:`..models.poseidon_batch` writes a
batched trace's values there by index).  The state is carried between
rounds as linear combinations, so the round constants and the MDS mix
cost no constraint; partial rounds substitute state[0] only.  The default
instance (t = 6, R_F = 8, R_P = 57) is 3 (8 x 6 + 57) = 315 constraints,
plus one bind a constrained output.
"""

from ..r1cs import Gadget, LinearCombination
from ..poseidon.permutation import DefaultParams
from ..field import SNARK_SCALAR_FIELD

P = SNARK_SCALAR_FIELD


def _combine(lcs, coeffs):
    """sum_k coeffs[k] lcs[k] as one LC, its terms in first-seen order
    (the order of the reference's running sum of LC products).  One dict
    reduced once, where a running sum makes a new LC a term: the
    partial rounds' LCs grow to some 60 terms, and 1,024 instances build
    in about a third of the time."""
    out = {}
    for lc, c in zip(lcs, coeffs):
        for k, v in lc.terms.items():
            out[k] = out.get(k, 0) + v * c
    return LinearCombination(out)


class _FifthPower(Gadget):
    """x^5 via x2, x4, x5 variables (3 constraints)."""

    def __init__(self, pb, x_lc, annotation):
        super().__init__(pb, annotation)
        self.x = LinearCombination() + x_lc
        self.x2 = pb.allocate(self.fmt('x2'))
        self.x4 = pb.allocate(self.fmt('x4'))
        self.x5 = pb.allocate(self.fmt('x5'))

    def generate_r1cs_constraints(self):
        pb = self.pb
        pb.add_constraint(self.x, self.x, self.x2, self.fmt('x^2'))
        pb.add_constraint(self.x2, self.x2, self.x4, self.fmt('x^4'))
        pb.add_constraint(self.x4, self.x, self.x5, self.fmt('x^5'))

    def generate_r1cs_witness(self):
        pb = self.pb
        x = pb.lc_val(self.x)
        pb.setval(self.x2, x * x % P)
        pb.setval(self.x4, pb.val(self.x2) ** 2 % P)
        pb.setval(self.x5, pb.val(self.x4) * x % P)

    def result(self):
        return self.x5


class Poseidon_gadget(Gadget):
    """Poseidon permutation over ``inputs`` LCs (len < t); result() is
    state[0] after the final round (or full state via results())."""

    def __init__(self, pb, inputs, annotation, params=None,
                 constrain_outputs=1):
        super().__init__(pb, annotation)
        self.params = params or DefaultParams
        t = self.params.t
        assert len(inputs) < t
        state = [LinearCombination() + x for x in inputs]
        state += [LinearCombination() for _ in range(t - len(inputs))]

        self.sboxes = []
        half_F = self.params.nRoundsF // 2
        n_p = self.params.nRoundsP
        M = self.params.constants_M
        for i, C_i in enumerate(self.params.constants_C):
            state = [s + C_i for s in state]  # ARK (free)
            full = i < half_F or i >= (half_F + n_p)
            n_sub = t if full else 1
            new_state = []
            for j in range(t):
                if j < n_sub:
                    g = _FifthPower(pb, state[j], self.fmt('r%d_s%d' % (i, j)))
                    self.sboxes.append(g)
                    new_state.append(LinearCombination() + g.result())
                else:
                    new_state.append(state[j])
            # MDS mix (free: linear combination of LCs)
            state = [_combine(new_state, M[j]) for j in range(t)]
        self.final_state = state
        self.outputs = pb.allocate_array(constrain_outputs, self.fmt('out')) \
            if constrain_outputs else []

    def generate_r1cs_constraints(self):
        for g in self.sboxes:
            g.generate_r1cs_constraints()
        for i, out in enumerate(self.outputs):
            self.pb.add_constraint(self.final_state[i], 1, out,
                                   self.fmt('bind_%d' % i))

    def generate_r1cs_witness(self):
        for g in self.sboxes:
            g.generate_r1cs_witness()
        for i, out in enumerate(self.outputs):
            self.pb.setval(out, self.pb.lc_val(self.final_state[i]))

    def result(self):
        return self.outputs[0] if self.outputs else self.final_state[0]

    def results(self):
        return self.final_state
