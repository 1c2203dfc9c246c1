"""MiMC cipher gadgets and one-way-function modes (own copy of
``ethsnarks_tpu/gadgets/mimc.py``): MiMC-e7, 91 rounds of 4 constraints,
MiMC-e5, 110 rounds of 3, round constants from the host oracle's Keccak
chain; Miyaguchi-Preneel (one more constraint a block) and Merkle-Damgard.

Variables are allocated in the reference's order: a round's ``t2, t4,
[t6], out``, a cipher's rounds in turn, and in Miyaguchi-Preneel each
block's cipher, then its chaining value.  The batched witness of
:mod:`..ops.mimc` and :mod:`..models.merkle_batch` rely on that layout.
"""

from ..field import SNARK_SCALAR_FIELD
from ..mimc.permutation import constants_list, DEFAULT_SEED
from ..r1cs import Gadget, LinearCombination


class _MiMC_round(Gadget):
    """One MiMC round: out = (x + k + C)^e (+ k in the final round)."""

    def __init__(self, pb, x_lc, k_lc, C, e, add_k_to_result, annotation):
        super().__init__(pb, annotation)
        self.x = x_lc
        self.k = k_lc
        self.C = C % SNARK_SCALAR_FIELD
        self.e = e
        self.add_k = add_k_to_result
        self.t2 = pb.allocate(self.fmt('t2'))
        self.t4 = pb.allocate(self.fmt('t4'))
        if e == 7:
            self.t6 = pb.allocate(self.fmt('t6'))
        self.out = pb.allocate(self.fmt('out'))

    def _t(self):
        return self.x + self.k + self.C

    def generate_r1cs_constraints(self):
        t = self._t()
        pb = self.pb
        pb.add_constraint(t, t, self.t2, self.fmt('t^2'))
        pb.add_constraint(self.t2, self.t2, self.t4, self.fmt('t^4'))
        if self.e == 7:
            pb.add_constraint(self.t2, self.t4, self.t6, self.fmt('t^6'))
            high = self.t6
        else:
            high = self.t4
        out_rhs = (self.out - self.k) if self.add_k else self.out
        pb.add_constraint(high, t, out_rhs, self.fmt('t^%d' % self.e))

    def generate_r1cs_witness(self):
        pb = self.pb
        p = SNARK_SCALAR_FIELD
        t = pb.lc_val(self._t())
        pb.setval(self.t2, t * t % p)
        pb.setval(self.t4, pb.val(self.t2) ** 2 % p)
        if self.e == 7:
            pb.setval(self.t6, pb.val(self.t2) * pb.val(self.t4) % p)
            high = pb.val(self.t6)
        else:
            high = pb.val(self.t4)
        out = high * t % p
        if self.add_k:
            out = (out + pb.lc_val(self.k)) % p
        pb.setval(self.out, out)

    def result(self):
        return self.out


class _MiMC_cipher(Gadget):
    """Full R-round MiMC cipher E_k(x) as a chain of round gadgets."""

    e = None
    rounds = None

    def __init__(self, pb, x_lc, k_lc, annotation, seed=DEFAULT_SEED):
        super().__init__(pb, annotation)
        constants = constants_list(seed, SNARK_SCALAR_FIELD, self.rounds)
        self.rounds_g = []
        cur = LinearCombination() + x_lc
        for i, C in enumerate(constants):
            g = _MiMC_round(pb, cur, k_lc, C, self.e,
                            add_k_to_result=(i == self.rounds - 1),
                            annotation=self.fmt('round_%d' % i))
            self.rounds_g.append(g)
            cur = LinearCombination() + g.result()

    def generate_r1cs_constraints(self):
        for g in self.rounds_g:
            g.generate_r1cs_constraints()

    def generate_r1cs_witness(self):
        for g in self.rounds_g:
            g.generate_r1cs_witness()

    def result(self):
        return self.rounds_g[-1].result()


class MiMCe7_gadget(_MiMC_cipher):
    e = 7
    rounds = 91


class MiMCe5_gadget(_MiMC_cipher):
    e = 5
    rounds = 110


class MiyaguchiPreneel_OWF(Gadget):
    """H_i = E_{H_{i-1}}(m_i) + H_{i-1} + m_i (1 extra constraint/block)."""

    def __init__(self, pb, messages, iv_lc, annotation, cipher=MiMCe7_gadget):
        super().__init__(pb, annotation)
        self.messages = [LinearCombination() + m for m in messages]
        self.keys = []
        self.ciphers = []
        self.outputs = []
        k = LinearCombination() + iv_lc
        for i, m in enumerate(self.messages):
            self.keys.append(k)
            self.ciphers.append(cipher(pb, m, k, self.fmt('cipher_%d' % i)))
            out = pb.allocate(self.fmt('out_%d' % i))
            self.outputs.append(out)
            k = LinearCombination() + out

    def generate_r1cs_constraints(self):
        for i, (m, c) in enumerate(zip(self.messages, self.ciphers)):
            c.generate_r1cs_constraints()
            self.pb.add_constraint(
                self.keys[i] + c.result() + m, 1, self.outputs[i],
                self.fmt('mp_%d' % i))

    def generate_r1cs_witness(self):
        p = SNARK_SCALAR_FIELD
        for i, (m, c) in enumerate(zip(self.messages, self.ciphers)):
            c.generate_r1cs_witness()
            v = (self.pb.lc_val(self.keys[i]) + self.pb.val(c.result())
                 + self.pb.lc_val(m)) % p
            self.pb.setval(self.outputs[i], v)

    def result(self):
        return self.outputs[-1]


class MerkleDamgard_OWF(Gadget):
    """k_i = E_{k_{i-1}}(m_i); the output is the last cipher's result."""

    def __init__(self, pb, messages, iv_lc, annotation, cipher=MiMCe7_gadget):
        super().__init__(pb, annotation)
        self.ciphers = []
        k = LinearCombination() + iv_lc
        for i, m in enumerate(messages):
            c = cipher(pb, LinearCombination() + m, k,
                       self.fmt('cipher_%d' % i))
            self.ciphers.append(c)
            k = LinearCombination() + c.result()

    def generate_r1cs_constraints(self):
        for c in self.ciphers:
            c.generate_r1cs_constraints()

    def generate_r1cs_witness(self):
        for c in self.ciphers:
            c.generate_r1cs_witness()

    def result(self):
        return self.ciphers[-1].result()
