"""Groth16 proof container with the reference's JSON layout (counterpart of
``Proof`` in ``ethsnarks_tpu/verifier.py:66-90``).

G1 points as ``["0x..", "0x.."]``, G2 points as ``[[X.c1, X.c0], [Y.c1,
Y.c0]]`` (EVM order), inputs as hex strings: ``to_json`` is byte-identical
to the reference's, so its verifiers and Verifier.sol accept the proofs.
"""

import json
from collections import namedtuple


def _dump_g1(pt):
    return [hex(pt[0].n), hex(pt[1].n)]


def _dump_g2(pt):
    x, y = pt
    return [[hex(x.coeffs[1]), hex(x.coeffs[0])],
            [hex(y.coeffs[1]), hex(y.coeffs[0])]]


class Proof(namedtuple('_ProofStruct', ('A', 'B', 'C', 'input'))):
    def to_dict(self):
        return {
            'A': _dump_g1(self.A),
            'B': _dump_g2(self.B),
            'C': _dump_g1(self.C),
            'input': [hex(_) for _ in self.input],
        }

    def to_json(self):
        return json.dumps(self.to_dict())
