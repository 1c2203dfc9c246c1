"""Rank-1 constraint system container (counterpart of the data part of
``ethsnarks_tpu/r1cs.py``; gadgets and the circuit DSL stay in the
reference).

Built from the reference's ``r1cs_to_dict`` layout by
:func:`ethsnarks_tpu_torch.serialization.r1cs_from_dict`.
"""

import numpy as np

from .field import SNARK_SCALAR_FIELD


class ConstraintSystem(object):
    """num_inputs public inputs (variables 1..num_inputs), num_variables
    including the constant ONE at index 0, and constraints as
    ``(a, b, c)`` triples of ``{variable: coefficient}`` dicts."""

    def __init__(self, num_inputs, num_variables, constraints):
        self.num_inputs = num_inputs
        self.num_variables = num_variables
        self.constraints = [
            tuple({int(k): int(v) % SNARK_SCALAR_FIELD
                   for k, v in lc.items() if int(v) % SNARK_SCALAR_FIELD}
                  for lc in row)
            for row in constraints]

    @property
    def num_constraints(self):
        return len(self.constraints)

    def to_coo(self):
        """{'a'|'b'|'c': (rows int64, cols int64, coeffs list of ints)}."""
        out = {}
        for k, name in enumerate('abc'):
            rows, cols, coeffs = [], [], []
            for r, row in enumerate(self.constraints):
                for col, coeff in row[k].items():
                    rows.append(r)
                    cols.append(col)
                    coeffs.append(coeff)
            out[name] = (np.array(rows, dtype=np.int64),
                         np.array(cols, dtype=np.int64), coeffs)
        return out

    def is_satisfied(self, values):
        p = SNARK_SCALAR_FIELD

        def ev(lc):
            return sum(values[k] * v for k, v in lc.items()) % p
        return all(ev(a) * ev(b) % p == ev(c) for a, b, c in self.constraints)
