"""Baby-JubJub circuit gadgets: point operations, scalar multiplications,
the Pedersen hash and EdDSA verification (own copy of
``ethsnarks_tpu/gadgets/jubjub.py:22-643``).

The rows, their order, the variables and their annotations are the
reference's, so a circuit built from them has the reference's constraint
matrices and witness.  Witnesses are computed with the host oracle
(:mod:`..jubjub`); the basepoints are :mod:`..pedersen`'s.
"""

from collections import namedtuple

from ..r1cs import Gadget, LinearCombination
from ..field import FQ, SNARK_SCALAR_FIELD
from ..jubjub import (
    Point, EtecPoint, JUBJUB_A, JUBJUB_D, MONT_A)
from ..pedersen import pedersen_hash_basepoint, N_WINDOWS_PER_BASEPOINT
from .basics import (
    lookup_2bit_gadget, lookup_signed_3bit_gadget, IsNonZero, field2bits_strict)

P = SNARK_SCALAR_FIELD


class VariablePoint(namedtuple('_VariablePoint', ('x', 'y'))):
    """A pair of wires/LCs representing an affine Edwards point."""

    @classmethod
    def allocate(cls, pb, annotation):
        return cls(pb.allocate(annotation + '.x'), pb.allocate(annotation + '.y'))


def _lc(x):
    return LinearCombination() + x


class PointAdder(Gadget):
    """Unified twisted-Edwards addition (7 constraints, adder.cpp:38-66)."""

    def __init__(self, pb, p1, p2, annotation):
        super().__init__(pb, annotation)
        self.p1, self.p2 = p1, p2
        self.t_x1y2 = pb.allocate(self.fmt('x1y2'))
        self.t_y1x2 = pb.allocate(self.fmt('y1x2'))
        self.t_x1x2 = pb.allocate(self.fmt('x1x2'))
        self.t_y1y2 = pb.allocate(self.fmt('y1y2'))
        self.t_prod = pb.allocate(self.fmt('x1x2y1y2'))
        self.x3 = pb.allocate(self.fmt('x3'))
        self.y3 = pb.allocate(self.fmt('y3'))

    def generate_r1cs_constraints(self):
        pb = self.pb
        (x1, y1), (x2, y2) = self.p1, self.p2
        pb.add_constraint(x1, y2, self.t_x1y2, self.fmt('x1*y2'))
        pb.add_constraint(y1, x2, self.t_y1x2, self.fmt('y1*x2'))
        pb.add_constraint(x1, x2, self.t_x1x2, self.fmt('x1*x2'))
        pb.add_constraint(y1, y2, self.t_y1y2, self.fmt('y1*y2'))
        pb.add_constraint(self.t_x1y2, self.t_y1x2, self.t_prod,
                          self.fmt('x1x2y1y2'))
        # x3 * (1 + d*prod) = x1y2 + y1x2
        pb.add_constraint(self.x3, 1 + _lc(self.t_prod) * JUBJUB_D,
                          _lc(self.t_x1y2) + self.t_y1x2, self.fmt('x3'))
        # y3 * (1 - d*prod) = y1y2 - a*x1x2
        pb.add_constraint(self.y3, 1 - _lc(self.t_prod) * JUBJUB_D,
                          _lc(self.t_y1y2) - _lc(self.t_x1x2) * JUBJUB_A,
                          self.fmt('y3'))

    def generate_r1cs_witness(self):
        pb = self.pb
        (x1, y1), (x2, y2) = self.p1, self.p2
        a = Point(FQ(pb.lc_val(_lc(x1))), FQ(pb.lc_val(_lc(y1))))
        b = Point(FQ(pb.lc_val(_lc(x2))), FQ(pb.lc_val(_lc(y2))))
        pb.setval(self.t_x1y2, (a.x * b.y).n)
        pb.setval(self.t_y1x2, (a.y * b.x).n)
        pb.setval(self.t_x1x2, (a.x * b.x).n)
        pb.setval(self.t_y1y2, (a.y * b.y).n)
        pb.setval(self.t_prod, (a.x * b.y * a.y * b.x).n)
        r = a.add(b) if not (a.x == 0 and a.y == 0) else b
        pb.setval(self.x3, r.x.n)
        pb.setval(self.y3, r.y.n)

    def result(self):
        return VariablePoint(self.x3, self.y3)


class PointDoubler(Gadget):
    """Edwards doubling (6 constraints, doubler.hpp:41-54)."""

    def __init__(self, pb, p1, annotation):
        super().__init__(pb, annotation)
        self.p1 = p1
        self.t_xy = pb.allocate(self.fmt('xy'))
        self.t_xx = pb.allocate(self.fmt('xx'))
        self.t_yy = pb.allocate(self.fmt('yy'))
        self.t_sq = pb.allocate(self.fmt('xxyy'))
        self.x3 = pb.allocate(self.fmt('x3'))
        self.y3 = pb.allocate(self.fmt('y3'))

    def generate_r1cs_constraints(self):
        pb = self.pb
        x1, y1 = self.p1
        pb.add_constraint(x1, y1, self.t_xy, self.fmt('x*y'))
        pb.add_constraint(x1, x1, self.t_xx, self.fmt('x*x'))
        pb.add_constraint(y1, y1, self.t_yy, self.fmt('y*y'))
        pb.add_constraint(self.t_xy, self.t_xy, self.t_sq, self.fmt('(xy)^2'))
        pb.add_constraint(self.x3, 1 + _lc(self.t_sq) * JUBJUB_D,
                          _lc(self.t_xy) * 2, self.fmt('x3'))
        pb.add_constraint(self.y3, 1 - _lc(self.t_sq) * JUBJUB_D,
                          _lc(self.t_yy) - _lc(self.t_xx) * JUBJUB_A,
                          self.fmt('y3'))

    def generate_r1cs_witness(self):
        pb = self.pb
        x1, y1 = self.p1
        a = Point(FQ(pb.lc_val(_lc(x1))), FQ(pb.lc_val(_lc(y1))))
        pb.setval(self.t_xy, (a.x * a.y).n)
        pb.setval(self.t_xx, (a.x * a.x).n)
        pb.setval(self.t_yy, (a.y * a.y).n)
        pb.setval(self.t_sq, (a.x * a.y * a.x * a.y).n)
        r = a.as_etec().double().as_point()
        pb.setval(self.x3, r.x.n)
        pb.setval(self.y3, r.y.n)

    def result(self):
        return VariablePoint(self.x3, self.y3)


class ConditionalPoint(Gadget):
    """bit ? P : identity(0,1)  (2 constraints, conditional_point.cpp:41-49)."""

    def __init__(self, pb, point, bit, annotation):
        super().__init__(pb, annotation)
        self.point = point
        self.bit = bit
        self.x2 = pb.allocate(self.fmt('x2'))
        self.y2 = pb.allocate(self.fmt('y2'))

    def generate_r1cs_constraints(self):
        pb = self.pb
        x1, y1 = self.point
        pb.add_constraint(x1, self.bit, self.x2, self.fmt('x2'))
        # y1*bit = y2 - 1 + bit
        pb.add_constraint(y1, self.bit,
                          _lc(self.y2) - 1 + self.bit, self.fmt('y2'))

    def generate_r1cs_witness(self):
        pb = self.pb
        x1, y1 = self.point
        b = pb.val(self.bit)
        pb.setval(self.x2, pb.lc_val(_lc(x1)) if b else 0)
        pb.setval(self.y2, pb.lc_val(_lc(y1)) if b else 1)

    def result(self):
        return VariablePoint(self.x2, self.y2)


class MontgomeryAdder(Gadget):
    """Montgomery affine addition (3 constraints, montgomery.cpp:31-42).
    Inputs may be LinearCombinations (zero-cost chaining)."""

    def __init__(self, pb, p1, p2, annotation):
        super().__init__(pb, annotation)
        self.p1, self.p2 = p1, p2
        self.lam = pb.allocate(self.fmt('lambda'))
        self.x3 = pb.allocate(self.fmt('x3'))
        self.y3 = pb.allocate(self.fmt('y3'))

    def generate_r1cs_constraints(self):
        pb = self.pb
        (x1, y1), (x2, y2) = self.p1, self.p2
        pb.add_constraint(self.lam, _lc(x2) - x1, _lc(y2) - y1,
                          self.fmt('lambda'))
        pb.add_constraint(self.lam, self.lam,
                          MONT_A + _lc(x1) + x2 + self.x3, self.fmt('x3'))
        pb.add_constraint(self.lam, _lc(x1) - self.x3,
                          _lc(y1) + self.y3, self.fmt('y3'))

    def generate_r1cs_witness(self):
        pb = self.pb
        (x1, y1), (x2, y2) = self.p1, self.p2
        u1, v1 = FQ(pb.lc_val(_lc(x1))), FQ(pb.lc_val(_lc(y1)))
        u2, v2 = FQ(pb.lc_val(_lc(x2))), FQ(pb.lc_val(_lc(y2)))
        lam = (v2 - v1) / (u2 - u1)
        u3 = lam * lam - MONT_A - u1 - u2
        v3 = lam * (u1 - u3) - v1
        pb.setval(self.lam, lam.n)
        pb.setval(self.x3, u3.n)
        pb.setval(self.y3, v3.n)

    def result(self):
        return VariablePoint(self.x3, self.y3)


class MontgomeryToEdwards(Gadget):
    """Birational map (u,v) -> (u/v, (u-1)/(u+1)) (2 constraints)."""

    def __init__(self, pb, p, annotation):
        super().__init__(pb, annotation)
        self.p = p
        self.x = pb.allocate(self.fmt('x'))
        self.y = pb.allocate(self.fmt('y'))

    def generate_r1cs_constraints(self):
        pb = self.pb
        u, v = self.p
        pb.add_constraint(self.x, v, u, self.fmt('x*v=u'))
        pb.add_constraint(self.y, _lc(u) + 1, _lc(u) - 1, self.fmt('y*(u+1)=u-1'))

    def generate_r1cs_witness(self):
        pb = self.pb
        u, v = self.p
        uv = FQ(pb.lc_val(_lc(u)))
        vv = FQ(pb.lc_val(_lc(v)))
        pb.setval(self.x, (uv / vv).n)
        pb.setval(self.y, ((uv - 1) / (uv + 1)).n)

    def result(self):
        return VariablePoint(self.x, self.y)


class fixed_base_mul(Gadget):
    """Fixed-base scalar mul with 2-bit windows (fixed_base_mul.cpp:11-135):
    two lookup_2bit per window (x and y, incl. the identity entry (0,1)) +
    chained PointAdder."""

    def __init__(self, pb, base_point, scalar_bits, annotation):
        super().__init__(pb, annotation)
        assert isinstance(base_point, Point)
        self.bits = scalar_bits
        n_windows = (len(scalar_bits) + 1) // 2
        self.lookups_x = []
        self.lookups_y = []
        self.adders = []
        current = base_point.as_etec()
        result = None
        for w in range(n_windows):
            table = [EtecPoint.infinity(), current, current.double(),
                     current.double() + current]
            tx = [p.as_point().x.n for p in table]
            ty = [p.as_point().y.n for p in table]
            b0 = scalar_bits[2 * w]
            b1 = scalar_bits[2 * w + 1] if 2 * w + 1 < len(scalar_bits) else None
            if b1 is None:
                # odd tail: 1-bit window via 2-bit lookup with b1 = 0 constant
                b1 = pb.allocate(self.fmt('pad_%d' % w))
                self._pad_var = b1
            lx = lookup_2bit_gadget(pb, tx, b0, b1, self.fmt('lx_%d' % w))
            ly = lookup_2bit_gadget(pb, ty, b0, b1, self.fmt('ly_%d' % w))
            self.lookups_x.append(lx)
            self.lookups_y.append(ly)
            pt = VariablePoint(lx.result(), ly.result())
            if result is None:
                result = pt
            else:
                adder = PointAdder(pb, result, pt, self.fmt('add_%d' % w))
                self.adders.append(adder)
                result = adder.result()
            current = current.double().double()
        self._result = result

    def generate_r1cs_constraints(self):
        if hasattr(self, '_pad_var'):
            self.pb.add_constraint(self._pad_var, 1, 0, self.fmt('pad=0'))
        for lx, ly in zip(self.lookups_x, self.lookups_y):
            lx.generate_r1cs_constraints()
            ly.generate_r1cs_constraints()
        for a in self.adders:
            a.generate_r1cs_constraints()

    def generate_r1cs_witness(self):
        if hasattr(self, '_pad_var'):
            self.pb.setval(self._pad_var, 0)
        for lx, ly in zip(self.lookups_x, self.lookups_y):
            lx.generate_r1cs_witness()
            ly.generate_r1cs_witness()
        for a in self.adders:
            a.generate_r1cs_witness()

    def result(self):
        return self._result


class ScalarMult(Gadget):
    """Variable-point x variable-scalar double-and-add
    (scalarmult.{hpp,cpp}): per bit one doubler + conditional + adder."""

    def __init__(self, pb, point, scalar_bits, annotation):
        super().__init__(pb, annotation)
        self.gadgets = []
        doubled = point
        result = None
        for i, bit in enumerate(scalar_bits):
            cond = ConditionalPoint(pb, doubled, bit, self.fmt('cond_%d' % i))
            self.gadgets.append(cond)
            if result is None:
                result = cond.result()
            else:
                adder = PointAdder(pb, result, cond.result(),
                                   self.fmt('add_%d' % i))
                self.gadgets.append(adder)
                result = adder.result()
            if i != len(scalar_bits) - 1:
                dbl = PointDoubler(pb, doubled, self.fmt('dbl_%d' % i))
                self.gadgets.append(dbl)
                doubled = dbl.result()
        self._result = result

    def generate_r1cs_constraints(self):
        for g in self.gadgets:
            g.generate_r1cs_constraints()

    def generate_r1cs_witness(self):
        for g in self.gadgets:
            g.generate_r1cs_witness()

    def result(self):
        return self._result


class IsOnCurve(Gadget):
    """a*x^2 + y^2 == 1 + d*x^2*y^2 (3 constraints, isoncurve.cpp:31-46)."""

    def __init__(self, pb, point, annotation):
        super().__init__(pb, annotation)
        self.point = point
        self.xx = pb.allocate(self.fmt('xx'))
        self.yy = pb.allocate(self.fmt('yy'))

    def generate_r1cs_constraints(self):
        pb = self.pb
        x, y = self.point
        pb.add_constraint(x, x, self.xx, self.fmt('x*x'))
        pb.add_constraint(y, y, self.yy, self.fmt('y*y'))
        pb.add_constraint(_lc(self.xx) * JUBJUB_D, self.yy,
                          _lc(self.xx) * JUBJUB_A + self.yy - 1,
                          self.fmt('curve'))

    def generate_r1cs_witness(self):
        pb = self.pb
        x, y = self.point
        pb.setval(self.xx, pb.lc_val(_lc(x)) ** 2 % P)
        pb.setval(self.yy, pb.lc_val(_lc(y)) ** 2 % P)

    def result(self):
        return self.point


class NotLowOrder(Gadget):
    """Cofactor-clear: three doublings then IsNonZero(x)==1
    (notloworder.{hpp,cpp})."""

    def __init__(self, pb, point, annotation):
        super().__init__(pb, annotation)
        self.d1 = PointDoubler(pb, point, self.fmt('d1'))
        self.d2 = PointDoubler(pb, self.d1.result(), self.fmt('d2'))
        self.d3 = PointDoubler(pb, self.d2.result(), self.fmt('d3'))
        self.nz = IsNonZero(pb, _lc(self.d3.result().x), self.fmt('nz'))

    def generate_r1cs_constraints(self):
        for g in (self.d1, self.d2, self.d3, self.nz):
            g.generate_r1cs_constraints()
        self.pb.add_constraint(self.nz.result(), 1, 1, self.fmt('nonzero'))

    def generate_r1cs_witness(self):
        for g in (self.d1, self.d2, self.d3, self.nz):
            g.generate_r1cs_witness()


class PointValidator(Gadget):
    """IsOnCurve and NotLowOrder (validator.{hpp,cpp}:11-44)."""

    def __init__(self, pb, point, annotation):
        super().__init__(pb, annotation)
        self.on_curve = IsOnCurve(pb, point, self.fmt('oncurve'))
        self.not_low = NotLowOrder(pb, point, self.fmt('notlow'))

    def generate_r1cs_constraints(self):
        self.on_curve.generate_r1cs_constraints()
        self.not_low.generate_r1cs_constraints()

    def generate_r1cs_witness(self):
        self.on_curve.generate_r1cs_witness()
        self.not_low.generate_r1cs_witness()


class Commitment(Gadget):
    """Multi-base commitment sum(s_i * B_i) (commitment.{hpp,cpp})."""

    def __init__(self, pb, base_points, scalars_bits, annotation):
        super().__init__(pb, annotation)
        assert len(base_points) == len(scalars_bits)
        self.muls = []
        self.adders = []
        result = None
        for i, (bp, bits) in enumerate(zip(base_points, scalars_bits)):
            m = fixed_base_mul(pb, bp, bits, self.fmt('mul_%d' % i))
            self.muls.append(m)
            if result is None:
                result = m.result()
            else:
                a = PointAdder(pb, result, m.result(), self.fmt('add_%d' % i))
                self.adders.append(a)
                result = a.result()
        self._result = result

    def generate_r1cs_constraints(self):
        for g in self.muls + self.adders:
            g.generate_r1cs_constraints()

    def generate_r1cs_witness(self):
        for g in self.muls + self.adders:
            g.generate_r1cs_witness()

    def result(self):
        return self._result


def basepoints_required(n_bits):
    """Parity: fixed_base_mul_zcash.cpp:17-20."""
    windows = (n_bits + 2) // 3
    return (windows + N_WINDOWS_PER_BASEPOINT - 1) // N_WINDOWS_PER_BASEPOINT


class fixed_base_mul_zcash(Gadget):
    """ZCash-Sapling windowed Pedersen multiplication
    (fixed_base_mul_zcash.cpp:12-180): 3-bit signed windows, 62 windows per
    basepoint; per window a signed lookup for the Montgomery v coordinate, a
    free-LC 2-bit lookup for u (reusing the sign lookup's b0*b1 product),
    MontgomeryAdder chains within a segment, segment tails converted to
    Edwards and combined with PointAdder."""

    def __init__(self, pb, base_points, bits, annotation):
        super().__init__(pb, annotation)
        assert len(bits) % 3 == 0
        n_windows = len(bits) // 3
        assert len(base_points) >= basepoints_required(len(bits))
        self.lookups = []
        self.mont_adders = []
        self.converters = []
        self.edwards_adders = []

        segments = []  # list of final mont-point LCs per segment
        current = None
        seg_acc = None
        for j in range(n_windows):
            if j % N_WINDOWS_PER_BASEPOINT == 0:
                if seg_acc is not None:
                    segments.append(seg_acc)
                seg_acc = None
                current = base_points[j // N_WINDOWS_PER_BASEPOINT].as_etec()
            else:
                current = current.double().double().double().double()
            # Montgomery-form table of [1, 2, 3, 4] * current.
            table = [(current * w).as_mont() for w in (1, 2, 3, 4)]
            tu = [int(p.u) for p in table]
            tv = [int(p.v) for p in table]
            b0, b1, b2 = bits[3 * j], bits[3 * j + 1], bits[3 * j + 2]
            lv = lookup_signed_3bit_gadget(pb, tv, b0, b1, b2,
                                           self.fmt('lv_%d' % j))
            self.lookups.append(lv)
            # u as a free linear combination using lv's magnitude vars is not
            # directly available; use an explicit 2-bit lookup sharing bits.
            lu = lookup_2bit_gadget(pb, tu, b0, b1, self.fmt('lu_%d' % j))
            self.lookups.append(lu)
            pt = VariablePoint(lu.result(), lv.result())
            if seg_acc is None:
                seg_acc = pt
            else:
                adder = MontgomeryAdder(pb, seg_acc, pt,
                                        self.fmt('madd_%d' % j))
                self.mont_adders.append(adder)
                seg_acc = adder.result()
        segments.append(seg_acc)

        result = None
        for i, seg in enumerate(segments):
            conv = MontgomeryToEdwards(pb, seg, self.fmt('conv_%d' % i))
            self.converters.append(conv)
            if result is None:
                result = conv.result()
            else:
                adder = PointAdder(pb, result, conv.result(),
                                   self.fmt('eadd_%d' % i))
                self.edwards_adders.append(adder)
                result = adder.result()
        self._result = result

    def generate_r1cs_constraints(self):
        for g in (self.lookups + self.mont_adders + self.converters
                  + self.edwards_adders):
            g.generate_r1cs_constraints()

    def generate_r1cs_witness(self):
        for g in (self.lookups + self.mont_adders + self.converters
                  + self.edwards_adders):
            g.generate_r1cs_witness()

    def result(self):
        return self._result


class PedersenHash(Gadget):
    """Personalized windowed Pedersen hash over bit wires
    (pedersen_hash.{hpp,cpp}); matches pedersen.pedersen_hash_bits."""

    def __init__(self, pb, name, bits, annotation):
        super().__init__(pb, annotation)
        n_base = basepoints_required(len(bits))
        base_points = [pedersen_hash_basepoint(name, i).as_point()
                       for i in range(n_base)]
        self.mul = fixed_base_mul_zcash(pb, base_points, bits,
                                        self.fmt('mul'))

    def generate_r1cs_constraints(self):
        self.mul.generate_r1cs_constraints()

    def generate_r1cs_witness(self):
        self.mul.generate_r1cs_witness()

    def result(self):
        return self.mul.result()


class PedersenHashToBits(Gadget):
    """Pedersen hash followed by strict bit decomposition of result.x."""

    def __init__(self, pb, name, bits, annotation):
        super().__init__(pb, annotation)
        self.hash = PedersenHash(pb, name, bits, self.fmt('hash'))
        self.tobits = field2bits_strict(pb, _lc(self.hash.result().x),
                                        self.fmt('bits'))

    def generate_r1cs_constraints(self):
        self.hash.generate_r1cs_constraints()
        self.tobits.generate_r1cs_constraints()

    def generate_r1cs_witness(self):
        self.hash.generate_r1cs_witness()
        self.tobits.generate_r1cs_witness()

    def result(self):
        """LSB-first 254 bit wires of hash.x."""
        return self.tobits.result()


class EdDSA_HashRAM_gadget(Gadget):
    """t = PedersenHashToBits('EdDSA_Verify.RAM', BITS(R.x)||BITS(A.x)||M)
    (eddsa.cpp:11-56)."""

    def __init__(self, pb, R, A, msg_bits, annotation):
        super().__init__(pb, annotation)
        self.r_bits = field2bits_strict(pb, _lc(R.x), self.fmt('R.x'))
        self.a_bits = field2bits_strict(pb, _lc(A.x), self.fmt('A.x'))
        all_bits = (list(self.r_bits.result()) + list(self.a_bits.result())
                    + list(msg_bits))
        # pad to a multiple of 3 with constant-zero wires
        self.pad = []
        while len(all_bits) % 3 != 0:
            v = pb.allocate(self.fmt('pad_%d' % len(self.pad)))
            self.pad.append(v)
            all_bits.append(v)
        self.hash = PedersenHashToBits(pb, 'EdDSA_Verify.RAM', all_bits,
                                       self.fmt('pedersen'))

    def generate_r1cs_constraints(self):
        self.r_bits.generate_r1cs_constraints()
        self.a_bits.generate_r1cs_constraints()
        for v in self.pad:
            self.pb.add_constraint(v, 1, 0, self.fmt('pad=0'))
        self.hash.generate_r1cs_constraints()

    def generate_r1cs_witness(self):
        self.r_bits.generate_r1cs_witness()
        self.a_bits.generate_r1cs_witness()
        for v in self.pad:
            self.pb.setval(v, 0)
        self.hash.generate_r1cs_witness()

    def result(self):
        return self.hash.result()


class PureEdDSA_gadget(Gadget):
    """In-circuit PureEdDSA verify (eddsa.cpp:62-117):
    validate R; lhs = s*B (fixed base); t = HashRAM(R, A, M);
    rhs = R + t*A; require lhs == rhs."""

    def __init__(self, pb, B, A, R, s_bits, msg_bits, annotation):
        super().__init__(pb, annotation)
        self.validator = PointValidator(pb, R, self.fmt('validate_R'))
        self.lhs = fixed_base_mul(pb, B, s_bits, self.fmt('lhs'))
        self.hash_ram = EdDSA_HashRAM_gadget(pb, R, A, msg_bits,
                                             self.fmt('hashRAM'))
        self.At = ScalarMult(pb, A, self.hash_ram.result(), self.fmt('At'))
        self.rhs = PointAdder(pb, R, self.At.result(), self.fmt('rhs'))

    def generate_r1cs_constraints(self):
        self.validator.generate_r1cs_constraints()
        self.lhs.generate_r1cs_constraints()
        self.hash_ram.generate_r1cs_constraints()
        self.At.generate_r1cs_constraints()
        self.rhs.generate_r1cs_constraints()
        lhs, rhs = self.lhs.result(), self.rhs.result()
        self.pb.add_constraint(_lc(lhs.x), 1, _lc(rhs.x), self.fmt('x_match'))
        self.pb.add_constraint(_lc(lhs.y), 1, _lc(rhs.y), self.fmt('y_match'))

    def generate_r1cs_witness(self):
        self.validator.generate_r1cs_witness()
        self.lhs.generate_r1cs_witness()
        self.hash_ram.generate_r1cs_witness()
        self.At.generate_r1cs_witness()
        self.rhs.generate_r1cs_witness()


class EdDSA_gadget(PureEdDSA_gadget):
    """EdDSA with Pedersen message prehash (eddsa.cpp:123-147).

    The message bit length is padded to a multiple of 3 with constant-zero
    wires (the host ``pedersen_hash_bits`` implicitly zero-pads the tail
    window, pedersen.py:59-63)."""

    def __init__(self, pb, B, A, R, s_bits, msg_bits, annotation):
        self.pb = pb
        self.annotation_prefix = annotation
        msg_bits = list(msg_bits)
        self.msg_pad = []
        while len(msg_bits) % 3 != 0:
            v = pb.allocate(self.fmt('msg_pad_%d' % len(self.msg_pad)))
            self.msg_pad.append(v)
            msg_bits.append(v)
        self.msg_hashed = PedersenHashToBits(pb, 'EdDSA_Verify.M', msg_bits,
                                             self.fmt('M'))
        super().__init__(pb, B, A, R, s_bits, self.msg_hashed.result(),
                         annotation)

    def generate_r1cs_constraints(self):
        for v in self.msg_pad:
            self.pb.add_constraint(v, 1, 0, self.fmt('msg_pad=0'))
        self.msg_hashed.generate_r1cs_constraints()
        super().generate_r1cs_constraints()

    def generate_r1cs_witness(self):
        for v in self.msg_pad:
            self.pb.setval(v, 0)
        self.msg_hashed.generate_r1cs_witness()
        super().generate_r1cs_witness()
