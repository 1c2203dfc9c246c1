"""Arithmetic and range gadgets (own copy of
``ethsnarks_tpu/gadgets/arith.py:14-160``): the n-bit comparison
(``less`` and ``less_or_eq`` by an (n + 1)-bit decomposition of
2^n + B - A), the range-checked ``subadd_gadget`` (X = A - N, Y = B + N)
and the Shamir share polynomial ``shamir_poly``.
"""

from ..r1cs import Gadget, LinearCombination
from ..field import SNARK_SCALAR_FIELD
from .basics import boolean_constrain

P = SNARK_SCALAR_FIELD


class comparison_gadget(Gadget):
    """less / less_or_eq for n-bit values A, B (libsnark semantics).

    alpha = 2^n + B - A is decomposed into n+1 bits; alpha[n] == (B >= A);
    less = alpha[n] AND (B != A), detected via the low alpha bits."""

    def __init__(self, pb, n, a_lc, b_lc, annotation):
        super().__init__(pb, annotation)
        assert n < 250
        self.n = n
        self.a = LinearCombination() + a_lc
        self.b = LinearCombination() + b_lc
        self.alpha_bits = pb.allocate_array(n + 1, self.fmt('alpha'))
        self.not_all_zeros = pb.allocate(self.fmt('naz'))
        self.inv_aux = pb.allocate(self.fmt('inv'))
        self.less = pb.allocate(self.fmt('less'))
        self.less_or_eq = pb.allocate(self.fmt('leq'))

    def generate_r1cs_constraints(self):
        pb = self.pb
        n = self.n
        for i, bit in enumerate(self.alpha_bits):
            boolean_constrain(pb, bit, self.fmt('bit_%d' % i))
        # pack: sum alpha_i 2^i == 2^n + B - A
        acc = LinearCombination()
        for i, bit in enumerate(self.alpha_bits):
            acc = acc + bit * pow(2, i, P)
        pb.add_constraint(acc, 1, self.b - self.a + pow(2, n, P),
                          self.fmt('pack'))
        # low = sum of low n bits (as value); not_all_zeros = (low != 0)
        low = LinearCombination()
        for i in range(n):
            low = low + self.alpha_bits[i] * pow(2, i, P)
        pb.add_constraint(low, self.inv_aux, self.not_all_zeros,
                          self.fmt('naz1'))
        pb.add_constraint(low, 1 - (LinearCombination() + self.not_all_zeros),
                          0, self.fmt('naz2'))
        # less_or_eq = alpha[n]; less = alpha[n] * not_all_zeros
        pb.add_constraint(self.alpha_bits[n], 1, self.less_or_eq,
                          self.fmt('leq'))
        pb.add_constraint(self.alpha_bits[n], self.not_all_zeros, self.less,
                          self.fmt('less'))

    def generate_r1cs_witness(self):
        pb = self.pb
        n = self.n
        a = pb.lc_val(self.a)
        b = pb.lc_val(self.b)
        assert a < (1 << n) and b < (1 << n)
        alpha = (1 << n) + b - a
        for i in range(n + 1):
            pb.setval(self.alpha_bits[i], (alpha >> i) & 1)
        low = alpha & ((1 << n) - 1)
        pb.setval(self.not_all_zeros, 1 if low else 0)
        pb.setval(self.inv_aux, pow(low, P - 2, P) if low else 0)
        pb.setval(self.less_or_eq, 1 if b >= a else 0)
        pb.setval(self.less, 1 if b > a else 0)


class subadd_gadget(Gadget):
    """X = A - N, Y = B + N in n-bit range, with underflow/overflow proofs
    (parity: src/gadgets/subadd.cpp).  Requires N <= A and B + N < 2^n."""

    def __init__(self, pb, n, a_lc, b_lc, n_lc, annotation):
        super().__init__(pb, annotation)
        self.n = n
        self.a = LinearCombination() + a_lc
        self.b = LinearCombination() + b_lc
        self.N = LinearCombination() + n_lc
        self.X = pb.allocate(self.fmt('X'))
        self.Y = pb.allocate(self.fmt('Y'))
        # N <= A  <=>  cmp(N, A).less_or_eq
        self.cmp_under = comparison_gadget(pb, n, self.N, self.a,
                                           self.fmt('underflow'))
        # B + N fits n bits: decompose Y into n bits
        self.y_bits = pb.allocate_array(n, self.fmt('Ybits'))

    def generate_r1cs_constraints(self):
        pb = self.pb
        pb.add_constraint(self.a - self.N, 1, self.X, self.fmt('X=A-N'))
        pb.add_constraint(self.b + self.N, 1, self.Y, self.fmt('Y=B+N'))
        self.cmp_under.generate_r1cs_constraints()
        pb.add_constraint(self.cmp_under.less_or_eq, 1, 1,
                          self.fmt('no_underflow'))
        acc = LinearCombination()
        for i, bit in enumerate(self.y_bits):
            boolean_constrain(pb, bit, self.fmt('ybit_%d' % i))
            acc = acc + bit * pow(2, i, P)
        pb.add_constraint(acc, 1, LinearCombination() + self.Y,
                          self.fmt('no_overflow'))

    def generate_r1cs_witness(self):
        pb = self.pb
        a = pb.lc_val(self.a)
        b = pb.lc_val(self.b)
        nv = pb.lc_val(self.N)
        pb.setval(self.X, (a - nv) % P)
        pb.setval(self.Y, (b + nv) % P)
        self.cmp_under.generate_r1cs_witness()
        y = (b + nv) % P
        for i in range(self.n):
            pb.setval(self.y_bits[i], (y >> i) & 1)


class shamir_poly(Gadget):
    """Shamir secret-share polynomial evaluation sum(a_i * x^i)
    (2k-1 constraints, parity: src/gadgets/shamir_poly.hpp:21-175)."""

    def __init__(self, pb, x_lc, coeffs, annotation):
        super().__init__(pb, annotation)
        assert len(coeffs) >= 2
        self.x = LinearCombination() + x_lc
        self.coeffs = [LinearCombination() + c for c in coeffs]
        k = len(coeffs)
        self.pows = pb.allocate_array(k - 1, self.fmt('xpow'))   # x^1..x^(k-1)
        self.terms = pb.allocate_array(k - 1, self.fmt('term'))  # a_i * x^i
        self.result_var = pb.allocate(self.fmt('result'))

    def generate_r1cs_constraints(self):
        pb = self.pb
        prev = LinearCombination() + 1
        for i in range(len(self.pows)):
            pb.add_constraint(prev, self.x, self.pows[i],
                              self.fmt('x^%d' % (i + 1)))
            pb.add_constraint(self.coeffs[i + 1], self.pows[i], self.terms[i],
                              self.fmt('term_%d' % (i + 1)))
            prev = LinearCombination() + self.pows[i]
        total = self.coeffs[0]
        for t in self.terms:
            total = total + t
        pb.add_constraint(total, 1, self.result_var, self.fmt('sum'))

    def generate_r1cs_witness(self):
        pb = self.pb
        x = pb.lc_val(self.x)
        xp = 1
        total = pb.lc_val(self.coeffs[0])
        for i in range(len(self.pows)):
            xp = xp * x % P
            pb.setval(self.pows[i], xp)
            term = pb.lc_val(self.coeffs[i + 1]) * xp % P
            pb.setval(self.terms[i], term)
            total = (total + term) % P
        pb.setval(self.result_var, total)

    def result(self):
        return self.result_var
