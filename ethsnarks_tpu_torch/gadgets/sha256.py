"""SHA-256 circuit gadgets (own copy of
``ethsnarks_tpu/gadgets/sha256.py:23-422``): one compression, the full
hash of 512 input bits, and the hash of any number of bits with the
padding as constants.

A 32-bit word is 32 bit-wires, bit 0 the least significant (a constant
bit is a python int folded into the linear combinations).  Ch costs one
constraint a bit (g + e (f - g)), Maj two (t = a b; t + c (a + b - 2 t)),
the Sigma and sigma functions are xor chains (rotations are rewiring), and
a modular addition is one packing constraint over 32 result bits and
the carry bits, each constrained boolean.  A compression lists its
sub-gadgets in ``gadgets`` in construction order, the order of the
batched trace's word stream (:mod:`..ops.sha256_ops`).
"""

from ..r1cs import Gadget, LinearCombination
from ..field import SNARK_SCALAR_FIELD
from .basics import boolean_constrain

P = SNARK_SCALAR_FIELD

SHA256_K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5,
    0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3,
    0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5,
    0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
]

SHA256_IV = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
             0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]


class _Word(object):
    """A 32-bit word: `bits` (LSB-first wires/None-for-constant) or pure
    constant.  Constant bits are python ints folded into LCs for free."""

    __slots__ = ('bits',)

    def __init__(self, bits):
        assert len(bits) == 32
        self.bits = list(bits)

    @classmethod
    def constant(cls, value):
        return cls([(value >> i) & 1 for i in range(32)])

    def rotr(self, n):
        return _Word([self.bits[(i + n) % 32] for i in range(32)])

    def shr(self, n):
        return _Word([self.bits[i + n] if i + n < 32 else 0
                      for i in range(32)])

    def lc(self):
        acc = LinearCombination()
        for i, b in enumerate(self.bits):
            if isinstance(b, int):
                acc = acc + (b << i)
            else:
                acc = acc + b * pow(2, i, P)
        return acc

    def value(self, pb):
        v = 0
        for i, b in enumerate(self.bits):
            bit = b if isinstance(b, int) else pb.val(b)
            v |= bit << i
        return v


def _bit_val(pb, b):
    return b if isinstance(b, int) else pb.val(b)


class _XorWords(Gadget):
    """w = a ^ b ^ c (c optional); 1-2 constraints per non-constant bit."""

    def __init__(self, pb, a, b, c, annotation):
        super().__init__(pb, annotation)
        self.a, self.b, self.c = a, b, c
        self.out_bits = []
        self.steps = []  # (kind, ...) for witness generation
        for i in range(32):
            ba, bb = a.bits[i], b.bits[i]
            bc = c.bits[i] if c is not None else None
            bits = [x for x in (ba, bb, bc) if x is not None]
            const = sum(x for x in bits if isinstance(x, int)) & 1
            wires = [x for x in bits if not isinstance(x, int)]
            if not wires:
                self.out_bits.append(const)
                self.steps.append(None)
            elif len(wires) == 1 and const == 0:
                self.out_bits.append(wires[0])
                self.steps.append(None)
            else:
                out = pb.allocate(self.fmt('x%d' % i))
                self.out_bits.append(out)
                t = pb.allocate(self.fmt('t%d' % i)) if len(wires) == 3 else None
                self.steps.append((wires, const, out, i, t))

    def generate_r1cs_constraints(self):
        pb = self.pb
        for step in self.steps:
            if step is None:
                continue
            wires, const, out, i, t = step
            if len(wires) == 1:
                # out = w ^ 1 = 1 - w
                pb.add_constraint(1 - (LinearCombination() + wires[0]), 1,
                                  out, self.fmt('not%d' % i))
            elif len(wires) == 2:
                # x = a^b (then ^const folded): 2ab = a+b-x'
                x_lc = (LinearCombination() + out) if const == 0 \
                    else (1 - (LinearCombination() + out))
                pb.add_constraint(
                    (LinearCombination() + wires[0]) * 2, wires[1],
                    (LinearCombination() + wires[0]) + wires[1] - x_lc,
                    self.fmt('xor2_%d' % i))
            else:
                # t = a^b (aux), out = t^c
                pb.add_constraint(
                    (LinearCombination() + wires[0]) * 2, wires[1],
                    (LinearCombination() + wires[0]) + wires[1] - t,
                    self.fmt('xor3a_%d' % i))
                x_lc = (LinearCombination() + out) if const == 0 \
                    else (1 - (LinearCombination() + out))
                pb.add_constraint(
                    (LinearCombination() + t) * 2, wires[2],
                    (LinearCombination() + t) + wires[2] - x_lc,
                    self.fmt('xor3b_%d' % i))

    def generate_r1cs_witness(self):
        pb = self.pb
        for step in self.steps:
            if step is None:
                continue
            wires, const, out, i, t = step
            vals = [pb.val(w) for w in wires]
            x = const
            for v in vals:
                x ^= v
            if len(wires) == 3:
                pb.setval(t, vals[0] ^ vals[1])
            pb.setval(out, x)

    def result(self):
        return _Word(self.out_bits)


class _ModAdd(Gadget):
    """out = (sum of words) mod 2^32; words may include constants.

    One packing constraint + booleanity on 32 result bits + carry bits."""

    def __init__(self, pb, words, annotation):
        super().__init__(pb, annotation)
        self.words = words
        n_carry = max(1, (len(words) - 1).bit_length())
        self.out_bits = pb.allocate_array(32, self.fmt('out'))
        self.carry_bits = pb.allocate_array(n_carry, self.fmt('carry'))

    def generate_r1cs_constraints(self):
        pb = self.pb
        total = LinearCombination()
        for w in self.words:
            total = total + w.lc()
        rhs = LinearCombination()
        for i, b in enumerate(self.out_bits):
            boolean_constrain(pb, b, self.fmt('ob%d' % i))
            rhs = rhs + b * pow(2, i, P)
        for j, b in enumerate(self.carry_bits):
            boolean_constrain(pb, b, self.fmt('cb%d' % j))
            rhs = rhs + b * pow(2, 32 + j, P)
        pb.add_constraint(total, 1, rhs, self.fmt('sum'))

    def generate_r1cs_witness(self):
        pb = self.pb
        total = sum(w.value(pb) for w in self.words)
        for i in range(32):
            pb.setval(self.out_bits[i], (total >> i) & 1)
        for j in range(len(self.carry_bits)):
            pb.setval(self.carry_bits[j], (total >> (32 + j)) & 1)

    def result(self):
        return _Word(self.out_bits)


class _Ch(Gadget):
    """ch = (e & f) ^ (~e & g) = g + e*(f - g): 1 constraint/bit."""

    def __init__(self, pb, e, f, g, annotation):
        super().__init__(pb, annotation)
        self.e, self.f, self.g = e, f, g
        self.out_bits = pb.allocate_array(32, self.fmt('ch'))

    def generate_r1cs_constraints(self):
        pb = self.pb
        for i in range(32):
            be = LinearCombination() + self.e.bits[i]
            bf = LinearCombination() + self.f.bits[i]
            bg = LinearCombination() + self.g.bits[i]
            pb.add_constraint(be, bf - bg,
                              (LinearCombination() + self.out_bits[i]) - bg,
                              self.fmt('ch%d' % i))

    def generate_r1cs_witness(self):
        pb = self.pb
        for i in range(32):
            e = _bit_val(pb, self.e.bits[i])
            f = _bit_val(pb, self.f.bits[i])
            g = _bit_val(pb, self.g.bits[i])
            pb.setval(self.out_bits[i], (e & f) ^ ((1 - e) & g))

    def result(self):
        return _Word(self.out_bits)


class _Maj(Gadget):
    """maj = ab + c*(a + b - 2ab): 2 constraints/bit."""

    def __init__(self, pb, a, b, c, annotation):
        super().__init__(pb, annotation)
        self.a, self.b, self.c = a, b, c
        self.t_bits = pb.allocate_array(32, self.fmt('ab'))
        self.out_bits = pb.allocate_array(32, self.fmt('maj'))

    def generate_r1cs_constraints(self):
        pb = self.pb
        for i in range(32):
            ba = LinearCombination() + self.a.bits[i]
            bb = LinearCombination() + self.b.bits[i]
            bc = LinearCombination() + self.c.bits[i]
            t = self.t_bits[i]
            pb.add_constraint(ba, bb, t, self.fmt('ab%d' % i))
            pb.add_constraint(
                bc, ba + bb - (LinearCombination() + t) * 2,
                (LinearCombination() + self.out_bits[i]) - t,
                self.fmt('maj%d' % i))

    def generate_r1cs_witness(self):
        pb = self.pb
        for i in range(32):
            a = _bit_val(pb, self.a.bits[i])
            b = _bit_val(pb, self.b.bits[i])
            c = _bit_val(pb, self.c.bits[i])
            pb.setval(self.t_bits[i], a & b)
            pb.setval(self.out_bits[i], (a & b) ^ (a & c) ^ (b & c))

    def result(self):
        return _Word(self.out_bits)


class sha256_compression(Gadget):
    """One SHA-256 compression: state (8 words) x block (16 words) -> 8 words.

    Words here are _Word objects; use `words_from_bits` to build them from
    bit wires (MSB-first byte order as in the SHA-256 spec)."""

    def __init__(self, pb, state_words, block_words, annotation):
        super().__init__(pb, annotation)
        assert len(state_words) == 8 and len(block_words) == 16
        self.gadgets = []
        g = self.gadgets

        # message schedule
        w = list(block_words)
        for t in range(16, 64):
            s0a = w[t - 15].rotr(7)
            s0b = w[t - 15].rotr(18)
            s0c = w[t - 15].shr(3)
            x0 = _XorWords(pb, s0a, s0b, s0c, self.fmt('s0_%d' % t))
            s1a = w[t - 2].rotr(17)
            s1b = w[t - 2].rotr(19)
            s1c = w[t - 2].shr(10)
            x1 = _XorWords(pb, s1a, s1b, s1c, self.fmt('s1_%d' % t))
            add = _ModAdd(pb, [w[t - 16], x0.result(), w[t - 7], x1.result()],
                          self.fmt('w_%d' % t))
            g += [x0, x1, add]
            w.append(add.result())

        a, b, c, d, e, f, g2, h = state_words
        for t in range(64):
            S1 = _XorWords(pb, e.rotr(6), e.rotr(11), e.rotr(25),
                           self.fmt('S1_%d' % t))
            ch = _Ch(pb, e, f, g2, self.fmt('ch_%d' % t))
            t1 = _ModAdd(pb, [h, S1.result(), ch.result(),
                              _Word.constant(SHA256_K[t]), w[t]],
                         self.fmt('t1_%d' % t))
            S0 = _XorWords(pb, a.rotr(2), a.rotr(13), a.rotr(22),
                           self.fmt('S0_%d' % t))
            maj = _Maj(pb, a, b, c, self.fmt('maj_%d' % t))
            t2 = _ModAdd(pb, [S0.result(), maj.result()], self.fmt('t2_%d' % t))
            new_e = _ModAdd(pb, [d, t1.result()], self.fmt('e_%d' % t))
            new_a = _ModAdd(pb, [t1.result(), t2.result()],
                            self.fmt('a_%d' % t))
            g += [S1, ch, t1, S0, maj, t2, new_e, new_a]
            a, b, c, d, e, f, g2, h = (new_a.result(), a, b, c,
                                       new_e.result(), e, f, g2)

        # final feed-forward additions
        self.out_adds = []
        for i, word in enumerate([a, b, c, d, e, f, g2, h]):
            add = _ModAdd(pb, [state_words[i], word], self.fmt('h_%d' % i))
            self.gadgets.append(add)
            self.out_adds.append(add)

    def generate_r1cs_constraints(self):
        for gg in self.gadgets:
            gg.generate_r1cs_constraints()

    def generate_r1cs_witness(self):
        for gg in self.gadgets:
            gg.generate_r1cs_witness()

    def result(self):
        return [add.result() for add in self.out_adds]


def words_from_bits(bit_wires):
    """512 (or 256) bit wires, MSB-first within the overall byte stream,
    -> list of _Word (internally LSB-first)."""
    assert len(bit_wires) % 32 == 0
    words = []
    for off in range(0, len(bit_wires), 32):
        chunk = bit_wires[off:off + 32]       # MSB first
        words.append(_Word(list(reversed(chunk))))
    return words


def words_to_bits(words):
    """Inverse of words_from_bits (MSB-first bit list)."""
    out = []
    for word in words:
        out.extend(list(reversed(word.bits)))
    return out


class sha256_full_gadget_512(Gadget):
    """Full SHA-256 of exactly 512 input bits (2 compressions: data block +
    the constant Ethereum-compatible padding block).  Parity:
    src/gadgets/sha256_full.hpp:69-160."""

    def __init__(self, pb, input_bits, annotation):
        super().__init__(pb, annotation)
        assert len(input_bits) == 512
        iv = [_Word.constant(v) for v in SHA256_IV]
        block1 = words_from_bits(input_bits)
        self.comp1 = sha256_compression(pb, iv, block1, self.fmt('block1'))
        # padding block: 0x80 then zeros then bit length 512
        pad = [0x80000000] + [0] * 14 + [512]
        block2 = [_Word.constant(v) for v in pad]
        self.comp2 = sha256_compression(pb, self.comp1.result(), block2,
                                        self.fmt('block2'))

    def generate_r1cs_constraints(self):
        self.comp1.generate_r1cs_constraints()
        self.comp2.generate_r1cs_constraints()

    def generate_r1cs_witness(self):
        self.comp1.generate_r1cs_witness()
        self.comp2.generate_r1cs_witness()

    def result(self):
        """256 output bit wires, MSB-first."""
        return words_to_bits(self.comp2.result())


def bits2blocks_padded(bit_len):
    """Number of 512-bit blocks after SHA-256 padding of bit_len bits
    (parity: src/utils.cpp bits2blocks_padded)."""
    return (bit_len + 1 + 64 + 511) // 512


class sha256_many(Gadget):
    """Arbitrary-length SHA-256 over input bit wires with in-circuit padding
    (pad bits are constants).  Parity: src/gadgets/sha256_many.{hpp,cpp}."""

    def __init__(self, pb, input_bits, annotation):
        super().__init__(pb, annotation)
        n = len(input_bits)
        n_blocks = bits2blocks_padded(n)
        padded = list(input_bits) + [1]
        total = n_blocks * 512
        while len(padded) < total - 64:
            padded.append(0)
        length_bits = [(n >> (63 - i)) & 1 for i in range(64)]
        padded += length_bits
        assert len(padded) == total

        self.comps = []
        state = [_Word.constant(v) for v in SHA256_IV]
        for blk in range(n_blocks):
            block = words_from_bits(padded[blk * 512:(blk + 1) * 512])
            comp = sha256_compression(pb, state, block,
                                      self.fmt('block%d' % blk))
            self.comps.append(comp)
            state = comp.result()

    def generate_r1cs_constraints(self):
        for c in self.comps:
            c.generate_r1cs_constraints()

    def generate_r1cs_witness(self):
        for c in self.comps:
            c.generate_r1cs_witness()

    def result(self):
        return words_to_bits(self.comps[-1].result())
