"""Groth16 verifying key, proof and pairing verification with the
reference's JSON layout (counterpart of ``ethsnarks_tpu/verifier.py:1-143``).

G1 points as ``["0x..", "0x.."]``, G2 points as ``[[X.c1, X.c0], [Y.c1,
Y.c0]]`` (EVM order), inputs as hex strings: ``to_json`` is byte-identical
to the reference's, so its verifiers and Verifier.sol accept the proofs.
The check is the 4-product of Verifier.sol:

    e(A, B) * e(-vk_x, gamma) * e(-C, delta) * e(-alpha, beta) == 1

The native and processed verifiers are not ported yet.
"""

import json
from collections import namedtuple

from .bn254 import Fq, Fq2, add, multiply, neg, is_on_curve, B1, B2
from .pairing import pairing_product_is_one


def _parse_int(x):
    """Int, 0x-hex or decimal string -> int."""
    if isinstance(x, int):
        return x
    x = x.strip()
    if x.startswith('0x') or x.startswith('0X'):
        return int(x, 16)
    return int(x)


def _load_g1_point(point):
    if len(point) < 2:
        raise RuntimeError("Invalid G1 point", point)
    out = (Fq(_parse_int(point[0])), Fq(_parse_int(point[1])))
    if not is_on_curve(out, B1):
        raise ValueError("Invalid G1 point - not on curve", point)
    return out


def _load_g2_point(point):
    x, y = point
    if len(x) != 2 or len(y) != 2:
        raise RuntimeError("Invalid G2 point", point)
    # JSON order is [c1, c0] (EVM); internally [c0, c1]
    out = (Fq2([_parse_int(x[1]), _parse_int(x[0])]),
           Fq2([_parse_int(y[1]), _parse_int(y[0])]))
    if not is_on_curve(out, B2):
        raise ValueError("Invalid G2 point - not on curve", point)
    return out


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

    @classmethod
    def from_dict(cls, d):
        return cls(A=_load_g1_point(d['A'][:2]), B=_load_g2_point(d['B']),
                   C=_load_g1_point(d['C'][:2]),
                   input=[_parse_int(_) for _ in d['input']])

    @classmethod
    def from_json(cls, json_data):
        return cls.from_dict(json.loads(json_data))


class VerifyingKey(namedtuple('_VerifyingKeyStruct',
                              ('alpha', 'beta', 'gamma', 'delta',
                               'gammaABC'))):
    def to_dict(self):
        return {
            'alpha': _dump_g1(self.alpha),
            'beta': _dump_g2(self.beta),
            'gamma': _dump_g2(self.gamma),
            'delta': _dump_g2(self.delta),
            'gammaABC': [_dump_g1(p) for p in self.gammaABC],
        }

    def to_json(self):
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d):
        return cls(alpha=_load_g1_point(d['alpha']),
                   beta=_load_g2_point(d['beta']),
                   gamma=_load_g2_point(d['gamma']),
                   delta=_load_g2_point(d['delta']),
                   gammaABC=[_load_g1_point(p) for p in d['gammaABC']])

    @classmethod
    def from_json(cls, json_data):
        return cls.from_dict(json.loads(json_data))

    @classmethod
    def from_file(cls, filename):
        with open(filename, 'r') as handle:
            return cls.from_dict(json.load(handle))

    def verify(self, proof):
        """Strong input consistency: exactly one gammaABC entry per input
        plus one."""
        if not isinstance(proof, Proof):
            raise TypeError("Invalid proof type")
        if len(proof.input) + 1 != len(self.gammaABC):
            return False
        return self.verify_weak_IC(proof)

    def verify_weak_IC(self, proof):
        """Weak input consistency: accepts |input| + 1 <= |gammaABC|."""
        if len(proof.input) + 1 > len(self.gammaABC):
            return False
        vk_x = self.gammaABC[0]
        for i, x in enumerate(proof.input):
            vk_x = add(vk_x, multiply(self.gammaABC[i + 1], x))
        return pairing_product_is_one([
            (proof.A, proof.B),
            (neg(vk_x), self.gamma),
            (neg(proof.C), self.delta),
            (neg(self.alpha), self.beta)])
