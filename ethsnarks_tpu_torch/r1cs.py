"""R1CS constraint system and circuit DSL (own copy of
``ethsnarks_tpu/r1cs.py:26-263``).

Variables are wire indices (0 is the constant ONE), linear combinations
are sparse ``{variable: coefficient}`` dicts over the scalar field, and a
:class:`ConstraintSystem` holds the variables' values, the public-input
count and the constraint list.  :meth:`ConstraintSystem.to_coo` exports
the three COO matrices that :class:`ethsnarks_tpu_torch.qap.QAP` compiles.
Gadgets wire variables in their constructor, then emit constraints
(``generate_r1cs_constraints``) and fill values (``generate_r1cs_witness``).
"""

import sys
from itertools import chain

import numpy as np

from .field import SNARK_SCALAR_FIELD

P = SNARK_SCALAR_FIELD


def r1cs_constraint(a, b, c):
    """Host sanity check of one product: raises unless a * b == c mod r."""
    if (int(a) * int(b)) % P != int(c) % P:
        raise RuntimeError("R1CS Constraint Failed!")


class Variable(object):
    """A wire index.  Index 0 is the constant ONE."""

    __slots__ = ('index',)

    def __init__(self, index):
        self.index = index

    def __repr__(self):
        return 'Variable(%d)' % self.index

    def _lc(self):
        return LinearCombination({self.index: 1})

    def __add__(self, other):
        return self._lc() + other

    __radd__ = __add__

    def __sub__(self, other):
        return self._lc() - other

    def __rsub__(self, other):
        return (-self._lc()) + other

    def __mul__(self, coeff):
        return self._lc() * coeff

    __rmul__ = __mul__

    def __neg__(self):
        return self._lc() * (P - 1)


ONE = Variable(0)


def _term_dict(x):
    if isinstance(x, LinearCombination):
        return dict(x.terms)
    if isinstance(x, Variable):
        return {x.index: 1}
    if isinstance(x, int):
        return {0: x % P} if x % P else {}
    raise TypeError("Cannot interpret %r as linear combination" % (x,))


class LinearCombination(object):
    """Sparse sum of coeff * variable terms over the scalar field."""

    __slots__ = ('terms',)

    def __init__(self, terms=None):
        self.terms = {k: v % P for k, v in (terms or {}).items() if v % P}

    def __add__(self, other):
        out = dict(self.terms)
        for k, v in _term_dict(other).items():
            out[k] = (out.get(k, 0) + v) % P
        return LinearCombination(out)

    __radd__ = __add__

    def __sub__(self, other):
        out = dict(self.terms)
        for k, v in _term_dict(other).items():
            out[k] = (out.get(k, 0) - v) % P
        return LinearCombination(out)

    def __rsub__(self, other):
        return LinearCombination(_term_dict(other)) - self

    def __mul__(self, coeff):
        if isinstance(coeff, (Variable, LinearCombination)):
            raise TypeError("LC*LC is not linear; use a constraint")
        c = int(coeff) % P
        return LinearCombination({k: v * c % P for k, v in self.terms.items()})

    __rmul__ = __mul__

    def __neg__(self):
        return self * (P - 1)

    def evaluate(self, values):
        return sum(values[k] * v for k, v in self.terms.items()) % P

    def __repr__(self):
        return 'LC(%r)' % (self.terms,)


class Constraint(object):
    __slots__ = ('a', 'b', 'c', 'annotation')

    def __init__(self, a, b, c, annotation=''):
        self.a = LinearCombination(_term_dict(a))
        self.b = LinearCombination(_term_dict(b))
        self.c = LinearCombination(_term_dict(c))
        self.annotation = annotation


class ConstraintSystem(object):
    """Protoboard: variable allocation, witness values, constraint list."""

    def __init__(self):
        self.annotations = ['ONE']
        self.values = [1]
        self.constraints = []
        self.num_inputs = 0  # public inputs are variables 1..num_inputs

    @property
    def num_variables(self):
        return len(self.values)  # includes ONE

    @property
    def num_constraints(self):
        return len(self.constraints)

    def allocate(self, annotation=''):
        self.annotations.append(annotation)
        self.values.append(0)
        return Variable(len(self.values) - 1)

    def allocate_array(self, n, annotation=''):
        """n fresh variables annotated ``annotation[i]``."""
        return [self.allocate('%s[%d]' % (annotation, i)) for i in range(n)]

    def set_input_sizes(self, n):
        """The first n variables allocated after ONE are the public
        inputs."""
        self.num_inputs = n

    def val(self, var):
        if isinstance(var, Variable):
            return self.values[var.index]
        if isinstance(var, LinearCombination):
            return var.evaluate(self.values)
        return int(var) % P

    def setval(self, var, value):
        assert isinstance(var, Variable) and var.index != 0
        self.values[var.index] = int(value) % P

    def lc_val(self, lc):
        return LinearCombination(_term_dict(lc)).evaluate(self.values)

    def add_constraint(self, a, b, c, annotation=''):
        self.constraints.append(Constraint(a, b, c, annotation))

    def is_satisfied(self, verbose=False, values=None):
        """Every constraint holds for ``values`` (default: the system's
        own).  With ``verbose``, the first constraint that fails is
        printed as the reference prints it (``ethsnarks_tpu/r1cs.py``
        :190-201)."""
        values = self.values if values is None else values
        for i, cons in enumerate(self.constraints):
            av = cons.a.evaluate(values)
            bv = cons.b.evaluate(values)
            cv = cons.c.evaluate(values)
            if av * bv % P != cv:
                if verbose:
                    print("Constraint %d unsatisfied: %s"
                          % (i, cons.annotation))
                    print("  a=%d b=%d a*b=%d c=%d"
                          % (av, bv, av * bv % P, cv))
                return False
        return True

    def primary_input(self):
        return list(self.values[1:1 + self.num_inputs])

    def auxiliary_input(self):
        return list(self.values[1 + self.num_inputs:])

    def to_coo(self):
        """{'a'|'b'|'c': (rows int64, cols int64, coeffs list of ints)}."""
        out = {}
        for name in ('a', 'b', 'c'):
            term_dicts = [getattr(cons, name).terms
                          for cons in self.constraints]
            counts = np.fromiter((len(t) for t in term_dicts),
                                 dtype=np.int64, count=len(term_dicts))
            rows = np.repeat(np.arange(len(term_dicts), dtype=np.int64),
                             counts)
            cols = np.fromiter(chain.from_iterable(term_dicts),
                               dtype=np.int64, count=int(counts.sum()))
            coeffs = list(chain.from_iterable(
                t.values() for t in term_dicts))
            out[name] = (rows, cols, coeffs)
        return out


def dump_pb_r1cs_constraints(cs, limit=None, out=None):
    """Write the first ``limit`` constraints (all by default) with their
    annotations and annotated terms to ``out`` (default stdout), in the
    reference's format."""
    out = out or sys.stdout
    for i, cons in enumerate(cs.constraints[:limit]):
        out.write("constraint %d (%s):\n" % (i, cons.annotation))
        for name, lc in (('A', cons.a), ('B', cons.b), ('C', cons.c)):
            terms = ' + '.join(
                '%s*%s' % (v, cs.annotations[k] if k < len(cs.annotations)
                           else 'v%d' % k)
                for k, v in sorted(lc.terms.items()))
            out.write("  %s: %s\n" % (name, terms or '0'))


Protoboard = ConstraintSystem


class Gadget(object):
    """Base gadget: the constructor wires variables,
    generate_r1cs_constraints() emits rows, generate_r1cs_witness() fills
    values."""

    def __init__(self, pb, annotation_prefix=''):
        self.pb = pb
        self.annotation_prefix = annotation_prefix

    def fmt(self, *parts):
        return '.'.join([self.annotation_prefix] + [str(p) for p in parts])

    def generate_r1cs_constraints(self):
        raise NotImplementedError

    def generate_r1cs_witness(self):
        raise NotImplementedError
