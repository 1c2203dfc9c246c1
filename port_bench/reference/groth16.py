"""The expected nozk Groth16 proof of an assignment, worked out from the
setup's secrets instead of from the proving key.

The setup draws t, alpha, beta, gamma and delta from a seeded
``random.Random``: t until t^m != 1, then the four others, each uniform in
[1, r).  With them a nozk proof is three scalar multiples of the
generators:

    A = (alpha + A(t)) G1
    B = (beta + B(t)) G2
    C = (beta A_aux(t) + alpha B_aux(t) + C_aux(t) + A(t) B(t) - C(t))
        / delta G1

where A(t) = sum_j L_j(t) a_j over the rows of the QAP (each constraint's
left value a_j, then one row a = w_i for the constant and each public
input), L_j the Lagrange basis of the domain {w^j} of size m, and X_aux
the same sum with each row's part from the constant and the public inputs
taken out.  A(t) B(t) - C(t) = H(t) Z(t) when every row holds, which is
what the prover's quotient and H query compute.

No MSM, no transform and no proving key: an independent route to the
proof the program computes by the QAP witness map and four MSMs.
"""

import random

from .bn254 import R, g1_mul, g2_mul

MULT_GEN = 5
TWO_ADICITY = 28


def domain_size(num_constraints, num_inputs):
    """next power of two of num_constraints + num_inputs + 1."""
    n = num_constraints + num_inputs + 1
    return 1 << (n - 1).bit_length()


def omega(m):
    k = m.bit_length() - 1
    root = pow(MULT_GEN, (R - 1) >> TWO_ADICITY, R)
    return pow(root, 1 << (TWO_ADICITY - k), R)


class Secrets(object):
    """t, alpha, beta, gamma, delta as the setup draws them from
    ``key_seed`` for a domain of size m."""

    def __init__(self, key_seed, m):
        rng = random.Random(key_seed)
        draw = lambda: rng.randrange(1, R)
        while True:
            t = draw()
            if pow(t, m, R) != 1:
                break
        self.t = t
        self.alpha, self.beta, self.gamma, self.delta = (
            draw(), draw(), draw(), draw())
        self.m = m


def lagrange_at(t, m):
    """[L_j(t) for j < m] = Z(t) / m * w^j / (t - w^j), one batch
    inversion."""
    w = omega(m)
    zt_m = (pow(t, m, R) - 1) * pow(m, -1, R) % R
    pows = [1] * m
    for j in range(1, m):
        pows[j] = pows[j - 1] * w % R
    diffs = [(t - p) % R for p in pows]
    prefix = [1] * (m + 1)
    for j in range(m):
        prefix[j + 1] = prefix[j] * diffs[j] % R
    inv = pow(prefix[m], -1, R)
    out = [0] * m
    for j in range(m - 1, -1, -1):
        out[j] = zt_m * pows[j] % R * (inv * prefix[j] % R) % R
        inv = inv * diffs[j] % R
    return out


class RowSums(object):
    """Running sums over the rows: A(t), B(t), C(t) and the parts from the
    constant and the public inputs, and the count of rows where a b != c."""

    def __init__(self, lagrange):
        self.u = lagrange
        self.j = 0
        self.a = self.b = self.c = 0
        self.a_in = self.b_in = self.c_in = 0
        self.unsatisfied = 0

    def row(self, a, b, c, a_in=0, b_in=0, c_in=0):
        u = self.u[self.j]
        self.j += 1
        if (a * b - c) % R:
            self.unsatisfied += 1
        self.a += u * a
        self.b += u * b
        self.c += u * c
        if a_in:
            self.a_in += u * a_in
        if b_in:
            self.b_in += u * b_in
        if c_in:
            self.c_in += u * c_in

    def input_rows(self, inputs):
        """The QAP's rows pinning the constant and each public input: a =
        w_i, all of it from the inputs."""
        for v in [1] + list(inputs):
            self.row(v, 0, 0, v, 0, 0)


def expected_proof(secrets, sums, inputs, drop_quotient=False):
    """-> the proof as {'A': (x, y), 'B': ((x0, x1), (y0, y1)), 'C': (x,
    y), 'input': [...]}.  ``drop_quotient`` leaves H(t) Z(t) out of C: the
    control, a prover that skips the witness map."""
    s = secrets
    A, B, C = sums.a % R, sums.b % R, sums.c % R
    aux = (s.beta * (A - sums.a_in) + s.alpha * (B - sums.b_in)
           + (C - sums.c_in)) % R
    hz = 0 if drop_quotient else (A * B - C) % R
    c = (aux + hz) * pow(s.delta, -1, R) % R
    return {'A': g1_mul(s.alpha + A), 'B': g2_mul(s.beta + B),
            'C': g1_mul(c), 'input': [int(v) % R for v in inputs]}
