"""Small generic gadgets (own copy of
``ethsnarks_tpu/gadgets/basics.py:15-296``): booleanity and bit packing,
constant lookups by 1, 2 and 3 bits and the signed 3-bit lookup, the
zero test ``IsNonZero``, the strict 254-bit decomposition
``field2bits_strict`` and the one-hot set membership ``one_of_n``.

The rows, their order, the variables and their annotations are the
reference's, so a circuit built from them has the reference's constraint
matrices and witness.
"""

from ..r1cs import Gadget, LinearCombination, Variable
from ..field import SNARK_SCALAR_FIELD

P = SNARK_SCALAR_FIELD


def boolean_constrain(pb, var, annotation='bool'):
    """bit * (1 - bit) = 0."""
    pb.add_constraint(var, 1 - (LinearCombination() + var), 0, annotation)


class packing_gadget(Gadget):
    """Binds sum(bits[i] * 2^i) == packed (one constraint); optionally also
    constrains booleanity of the bits (libsnark packing_gadget role)."""

    def __init__(self, pb, bits, packed_lc, annotation):
        super().__init__(pb, annotation)
        self.bits = bits
        self.packed = packed_lc

    def generate_r1cs_constraints(self, enforce_bitness=True):
        if enforce_bitness:
            for i, b in enumerate(self.bits):
                boolean_constrain(self.pb, b, self.fmt('bit_%d' % i))
        acc = LinearCombination()
        for i, b in enumerate(self.bits):
            acc = acc + b * pow(2, i, P)
        self.pb.add_constraint(acc, 1, self.packed, self.fmt('pack'))

    def generate_r1cs_witness_from_packed(self):
        v = self.pb.lc_val(self.packed)
        for i, b in enumerate(self.bits):
            self.pb.setval(b, (v >> i) & 1)

    def generate_r1cs_witness_from_bits(self):
        v = 0
        for i, b in enumerate(self.bits):
            v |= self.pb.val(b) << i
        # packed may be a variable or LC over one variable
        terms = (LinearCombination() + self.packed).terms
        assert len(terms) == 1
        (idx, coeff), = terms.items()
        assert coeff == 1
        self.pb.setval(Variable(idx), v % P)


class lookup_1bit_gadget(Gadget):
    """r = c[b] for a 2-entry constant table (1 constraint)."""

    def __init__(self, pb, constants, bit, annotation):
        super().__init__(pb, annotation)
        assert len(constants) == 2
        self.c = [int(x) % P for x in constants]
        self.b = bit
        self.r = pb.allocate(self.fmt('r'))

    def generate_r1cs_constraints(self):
        self.pb.add_constraint(
            self.b, self.c[1] - self.c[0],
            (LinearCombination() + self.r) - self.c[0], self.fmt('lookup'))

    def generate_r1cs_witness(self):
        self.pb.setval(self.r, self.c[self.pb.val(self.b)])

    def result(self):
        return self.r


class lookup_2bit_gadget(Gadget):
    """r = c[b0 + 2*b1] via one bilinear constraint (1 constraint)."""

    def __init__(self, pb, constants, b0, b1, annotation):
        super().__init__(pb, annotation)
        assert len(constants) == 4
        self.c = [int(x) % P for x in constants]
        self.b0, self.b1 = b0, b1
        self.r = pb.allocate(self.fmt('r'))

    def generate_r1cs_constraints(self):
        c = self.c
        # (b1) * (b0*(c3-c2-c1+c0) + (c2-c0)) = r - c0 - b0*(c1-c0)
        lhs_b = (LinearCombination() + self.b0) * ((c[3] - c[2] - c[1] + c[0]) % P) \
            + (c[2] - c[0])
        rhs = (LinearCombination() + self.r) - c[0] \
            - (LinearCombination() + self.b0) * ((c[1] - c[0]) % P)
        self.pb.add_constraint(self.b1, lhs_b, rhs, self.fmt('lookup'))

    def generate_r1cs_witness(self):
        idx = self.pb.val(self.b0) + 2 * self.pb.val(self.b1)
        self.pb.setval(self.r, self.c[idx])

    def result(self):
        return self.r


class lookup_3bit_gadget(Gadget):
    """r = c[b0 + 2 b1 + 4 b2]; 4 product precomputations + 1 bind = 5."""

    def __init__(self, pb, constants, bits, annotation):
        super().__init__(pb, annotation)
        assert len(constants) == 8 and len(bits) == 3
        self.c = [int(x) % P for x in constants]
        self.bits = bits
        self.b01 = pb.allocate(self.fmt('b01'))
        self.b02 = pb.allocate(self.fmt('b02'))
        self.b12 = pb.allocate(self.fmt('b12'))
        self.b012 = pb.allocate(self.fmt('b012'))
        self.r = pb.allocate(self.fmt('r'))

    def _lc(self):
        c = self.c
        b0, b1, b2 = self.bits
        lc = LinearCombination() + c[0]
        lc = lc + b0 * ((c[1] - c[0]) % P)
        lc = lc + b1 * ((c[2] - c[0]) % P)
        lc = lc + b2 * ((c[4] - c[0]) % P)
        lc = lc + self.b01 * ((c[3] - c[2] - c[1] + c[0]) % P)
        lc = lc + self.b02 * ((c[5] - c[4] - c[1] + c[0]) % P)
        lc = lc + self.b12 * ((c[6] - c[4] - c[2] + c[0]) % P)
        lc = lc + self.b012 * ((c[7] - c[6] - c[5] + c[4]
                                - c[3] + c[2] + c[1] - c[0]) % P)
        return lc

    def generate_r1cs_constraints(self):
        b0, b1, b2 = self.bits
        pb = self.pb
        pb.add_constraint(b0, b1, self.b01, self.fmt('b0*b1'))
        pb.add_constraint(b0, b2, self.b02, self.fmt('b0*b2'))
        pb.add_constraint(b1, b2, self.b12, self.fmt('b1*b2'))
        pb.add_constraint(self.b01, b2, self.b012, self.fmt('b01*b2'))
        pb.add_constraint(self._lc(), 1, self.r, self.fmt('bind'))

    def generate_r1cs_witness(self):
        pb = self.pb
        b = [pb.val(x) for x in self.bits]
        pb.setval(self.b01, b[0] & b[1])
        pb.setval(self.b02, b[0] & b[2])
        pb.setval(self.b12, b[1] & b[2])
        pb.setval(self.b012, b[0] & b[1] & b[2])
        pb.setval(self.r, self.c[b[0] + 2 * b[1] + 4 * b[2]])

    def result(self):
        return self.r


class lookup_signed_3bit_gadget(Gadget):
    """r = (-1)^b2 * c[b0 + 2 b1]: 2-bit magnitude lookup + sign (2
    constraints, parity with src/gadgets/lookup_signed_3bit.cpp:13-33)."""

    def __init__(self, pb, constants, b0, b1, b2, annotation):
        super().__init__(pb, annotation)
        assert len(constants) == 4
        self.c = [int(x) % P for x in constants]
        self.b0, self.b1, self.b2 = b0, b1, b2
        self.y = pb.allocate(self.fmt('y'))
        self.r = pb.allocate(self.fmt('r'))

    def generate_r1cs_constraints(self):
        c = self.c
        lhs_b = (LinearCombination() + self.b0) * ((c[3] - c[2] - c[1] + c[0]) % P) \
            + (c[2] - c[0])
        rhs = (LinearCombination() + self.y) - c[0] \
            - (LinearCombination() + self.b0) * ((c[1] - c[0]) % P)
        self.pb.add_constraint(self.b1, lhs_b, rhs, self.fmt('magnitude'))
        # (y + y) * b2 = y - r  (b2=0 -> r=y; b2=1 -> r=-y)
        self.pb.add_constraint(
            (LinearCombination() + self.y) * 2, self.b2,
            (LinearCombination() + self.y) - self.r, self.fmt('sign'))

    def generate_r1cs_witness(self):
        pb = self.pb
        idx = pb.val(self.b0) + 2 * pb.val(self.b1)
        y = self.c[idx]
        pb.setval(self.y, y)
        pb.setval(self.r, (P - y) % P if pb.val(self.b2) else y)

    def result(self):
        return self.r


class IsNonZero(Gadget):
    """Y = (X != 0) via inverse witness: X*M = Y, X*(1-Y) = 0 (2)."""

    def __init__(self, pb, x_lc, annotation):
        super().__init__(pb, annotation)
        self.x = LinearCombination() + x_lc
        self.m = pb.allocate(self.fmt('M'))
        self.y = pb.allocate(self.fmt('Y'))

    def generate_r1cs_constraints(self):
        self.pb.add_constraint(self.x, self.m, self.y, self.fmt('X*M=Y'))
        self.pb.add_constraint(self.x, 1 - (LinearCombination() + self.y), 0,
                               self.fmt('X*(1-Y)=0'))

    def generate_r1cs_witness(self):
        x = self.pb.lc_val(self.x)
        self.pb.setval(self.m, pow(x, P - 2, P) if x else 0)
        self.pb.setval(self.y, 1 if x else 0)

    def result(self):
        return self.y


class field2bits_strict(Gadget):
    """Unpack a field element into 254 bits with a strict x < p comparison so
    the decomposition is unique (role of src/gadgets/field2bits_strict.cpp).

    Formulation: booleanity + packing, then a prefix-equality chain against
    the fixed binary expansion of p: scanning from the MSB, e_j = 1 while the
    bits equal p's bits on all 1-positions seen so far; wherever p's bit is 0
    we force e*bit = 0, and finally e = 0 (x != p)."""

    N_BITS = 254

    def __init__(self, pb, x_lc, annotation):
        super().__init__(pb, annotation)
        self.x = LinearCombination() + x_lc
        self.bits = pb.allocate_array(self.N_BITS, self.fmt('bits'))
        p_bits = [(P >> i) & 1 for i in range(self.N_BITS)]  # LSB-first
        # the equality-chain variables, one a 1-bit of p, MSB down
        self.e_vars = {}
        for i in reversed(range(self.N_BITS)):
            if p_bits[i] == 1:
                self.e_vars[i] = pb.allocate(self.fmt('eq_%d' % i))
        self.p_bits = p_bits

    def generate_r1cs_constraints(self):
        pb = self.pb
        packer = packing_gadget(pb, self.bits, self.x, self.fmt('pack'))
        packer.generate_r1cs_constraints(enforce_bitness=True)
        e = LinearCombination() + 1
        for i in reversed(range(self.N_BITS)):
            if self.p_bits[i] == 1:
                nxt = self.e_vars[i]
                pb.add_constraint(e, self.bits[i], nxt, self.fmt('eq_%d' % i))
                e = LinearCombination() + nxt
            else:
                pb.add_constraint(e, self.bits[i], 0, self.fmt('lt_%d' % i))
        pb.add_constraint(e, 1, 0, self.fmt('neq_p'))

    def generate_r1cs_witness(self):
        pb = self.pb
        v = pb.lc_val(self.x)
        for i, b in enumerate(self.bits):
            pb.setval(b, (v >> i) & 1)
        e = 1
        for i in reversed(range(self.N_BITS)):
            if self.p_bits[i] == 1:
                e = e & ((v >> i) & 1)
                pb.setval(self.e_vars[i], e)

    def result(self):
        """LSB-first bit variables."""
        return self.bits


class one_of_n(Gadget):
    """Set membership via one-hot toggles (2n+1 constraints, parity with
    src/gadgets/one_of_n.hpp:45-130)."""

    def __init__(self, pb, our_item_lc, items_lcs, annotation):
        super().__init__(pb, annotation)
        self.our = LinearCombination() + our_item_lc
        self.items = [LinearCombination() + x for x in items_lcs]
        self.toggles = pb.allocate_array(len(self.items), self.fmt('toggle'))

    def generate_r1cs_constraints(self):
        pb = self.pb
        total = LinearCombination()
        for i, t in enumerate(self.toggles):
            boolean_constrain(pb, t, self.fmt('bool_%d' % i))
            total = total + t
        pb.add_constraint(total, 1, 1, self.fmt('sum=1'))
        for i, (t, item) in enumerate(zip(self.toggles, self.items)):
            # (item_i - our_item) * toggle_i = 0: a toggle may only select a
            # matching item (equivalent to the reference's
            # items[i]*t[i] = t[i]*our_item form).
            pb.add_constraint(item - self.our, t, 0, self.fmt('match_%d' % i))

    def generate_r1cs_witness(self):
        pb = self.pb
        our = pb.lc_val(self.our)
        for t, item in zip(self.toggles, self.items):
            pb.setval(t, 1 if pb.lc_val(item) == our else 0)

    def result(self):
        return self.toggles
