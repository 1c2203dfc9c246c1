"""Plain reference of N Poseidon hashes proved in one circuit: the
permutation of ethsnarks' ``poseidon.hpp`` (t = 6, R_F = 8, R_P = 57,
x^5 over the BN254 scalar field), the circuit's assignment and its rows.

Parameters: round constants iterate 32-byte blake2b from seed +
b'_constants' (each digest read little-endian, fed back as 32 LE bytes,
used mod r); the MDS matrix is the Cauchy matrix 1 / (c_i - c_{t+j}) over
2t constants from seed + b'_matrix_0000'.  A round adds its constant to
every element, applies x^5 to every element (the R_F / 2 first and last
rounds) or to the first (the R_P middle rounds), then mixes by the
matrix.  The digest is state[0] of the permutation of (inputs, 0, ...).

The circuit, in variable order: the constant 1, the N digests (public),
then for each hash its inputs and, for each x^5 in round order, x^2, x^4,
x^5.  Rows for each hash: (x, x, x^2), (x^2, x^2, x^4), (x^4, x, x^5) for
each x^5, where x is a linear combination of earlier variables and the
constant; then (state[0], 1, digest).
"""

from hashlib import blake2b

from .bn254 import R


def _chain(seed, n):
    out = []
    for _ in range(n):
        if isinstance(seed, int):
            seed = seed.to_bytes(32, 'little')
        seed = int.from_bytes(blake2b(seed, digest_size=32).digest(),
                              'little')
        out.append(seed % R)
    return out


class Params(object):
    def __init__(self, t=6, rounds_f=8, rounds_p=57, seed=b'poseidon'):
        self.t, self.rounds_f, self.rounds_p = t, rounds_f, rounds_p
        self.c = _chain(seed + b'_constants', rounds_f + rounds_p)
        m = _chain(seed + b'_matrix_0000', 2 * t)
        self.mds = [[pow((m[i] - m[t + j]) % R, -1, R) for j in range(t)]
                    for i in range(t)]

    def full(self, r):
        half = self.rounds_f // 2
        return r < half or r >= half + self.rounds_p

    def sboxes(self):
        return sum(self.t if self.full(r) else 1
                   for r in range(len(self.c)))

    def mix(self, state):
        return [sum(m * x for m, x in zip(row, state)) % R
                for row in self.mds]

    def constant_parts(self):
        """The constant's coefficient in each x^5's input and in the final
        state[0]: the same for every hash."""
        const = [0] * self.t
        per_sbox = []
        for r, c in enumerate(self.c):
            const = [(x + c) % R for x in const]
            for j in range(self.t if self.full(r) else 1):
                per_sbox.append(const[j])
                const[j] = 0
            const = self.mix(const)
        return per_sbox, const[0]

    def permute(self, inputs, trace=None):
        """state[0] of the permutation; with ``trace`` a list, appends
        each x^5's (x, x^2, x^4, x^5)."""
        state = [int(v) % R for v in inputs] + [0] * (self.t - len(inputs))
        for r, c in enumerate(self.c):
            state = [(x + c) % R for x in state]
            for j in range(self.t if self.full(r) else 1):
                x = state[j]
                x2 = x * x % R
                x4 = x2 * x2 % R
                x5 = x4 * x % R
                state[j] = x5
                if trace is not None:
                    trace.append((x, x2, x4, x5))
            state = self.mix(state)
        return state[0]


def shape(args, params=None):
    n, k = args['n_instances'], args['n_inputs']
    s = (params or Params()).sboxes()
    return dict(constraints=n * (3 * s + 1), inputs=n,
                variables=1 + n + n * (k + 3 * s))


class Statement(object):
    """One batch: the digests of its tuples, the full assignment in the
    circuit's variable order, and its rows."""

    def __init__(self, args, request, params=None):
        pairs = request['tuples']
        self.p = params or Params()
        self.n, self.k = args['n_instances'], args['n_inputs']
        if len(pairs) != self.n or any(len(x) != self.k for x in pairs):
            raise ValueError("a batch is %d tuples of %d inputs"
                             % (self.n, self.k))
        self.traces = []
        digests = []
        for row in pairs:
            trace = []
            digests.append(self.p.permute(row, trace))
            self.traces.append(trace)
        self.digests = digests
        vals = [1] + digests
        for row, trace in zip(pairs, self.traces):
            vals += [int(v) % R for v in row]
            for _, x2, x4, x5 in trace:
                vals += [x2, x4, x5]
        self.values = vals

    def inputs(self):
        return list(self.digests)

    def rows(self, sums):
        row = sums.row
        per_sbox, final_const = self.p.constant_parts()
        for digest, trace in zip(self.digests, self.traces):
            for (x, x2, x4, x5), cx in zip(trace, per_sbox):
                row(x, x, x2, cx, cx, 0)
                row(x2, x2, x4)
                row(x4, x, x5, 0, cx, 0)
            # the last round substitutes every element, so state[0] is
            # the mix of the last x^5 outputs (plus its constant part)
            row(digest, 1, digest, final_const, 1, digest)
        sums.input_rows(self.inputs())
