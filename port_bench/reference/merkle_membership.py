"""Plain reference of N Merkle membership statements under one public
root: the MiMC-e7 Miyaguchi-Preneel tree of the upstream MerkleTree.sol,
the assignment of the membership circuit and its rows.

The circuit (libsnark style, as ethsnarks' ``merkle_path_authenticator``
builds it) has, in variable order: the constant 1, the public root, then
for each statement its leaf, ``depth`` address bits, ``depth`` siblings
and, for each level, the selector's left and right and the node hash's
two MiMC-e7 ciphers (91 rounds of t^2, t^4, t^6, out) each followed by
its chaining value.  Rows, in order, for each statement and level: the
address bit is boolean, left = v + b (p - v), right = p + b (v - p); each
round (t, t, t^2), (t^2, t^2, t^4), (t^2, t^4, t^6), (t^6, t, out [- k]);
each block (k + E_k(m) + m, 1, out); then one row (node, 1, root) a
statement.  t = x + k + c_r, where k is the level's IV (a constant) in
the first block and the first block's output in the second.

Node hashes: H = IV_d, then H <- E_H(m) + H + m for m = left, right, with
E_k(x) 91 rounds of x <- (x + k + c_r)^7 and a final + k; c_r the
iterated Keccak-256 chain from keccak(b'mimc'); IV_d a running sha256 of
'MerkleTree-' || LE16(d).  An absent node at (d, i) reads sha256(BE16(d)
|| BE240(i)) mod r.
"""

import hashlib

from .bn254 import R
from .keccak import keccak256

ROUNDS = 91
VARS_PER_LEVEL = 2 + 2 * (4 * ROUNDS + 1)
ROWS_PER_LEVEL = 3 + 2 * (4 * ROUNDS + 1)


def _h(v):
    return int.from_bytes(keccak256(v), 'big')


def round_constants(n=ROUNDS):
    seed = _h(b'mimc')
    out = []
    for _ in range(n):
        seed = _h(seed.to_bytes(32, 'big'))
        out.append(seed % R)
    return out


def level_ivs(depth):
    h = hashlib.sha256()
    out = []
    for d in range(depth):
        h.update(b'MerkleTree-' + d.to_bytes(2, 'little'))
        out.append(int.from_bytes(h.digest(), 'big') % R)
    return out


def absent(d, i):
    tag = d.to_bytes(2, 'big') + i.to_bytes(30, 'big')
    return int.from_bytes(hashlib.sha256(tag).digest(), 'big') % R


class MiMC(object):
    def __init__(self, depth):
        self.c = round_constants()
        self.ivs = level_ivs(depth)

    def cipher(self, x, k, trace=None):
        """E_k(x); with ``trace`` a list, appends each round's (t, t2, t4,
        t6, out)."""
        for r, c in enumerate(self.c):
            t = (x + k + c) % R
            t2 = t * t % R
            t4 = t2 * t2 % R
            t6 = t2 * t4 % R
            x = t6 * t % R
            if r == ROUNDS - 1:
                x = (x + k) % R
            if trace is not None:
                trace.append((t, t2, t4, t6, x))
        return x

    def node(self, d, left, right):
        k = self.ivs[d]
        for m in (left, right):
            k = (k + m + self.cipher(m, k)) % R
        return k


def shape(args):
    depth, n = args['depth'], args['n_proofs']
    return dict(constraints=n * (depth * ROWS_PER_LEVEL + 1), inputs=1,
                variables=2 + n * (1 + 2 * depth + depth * VARS_PER_LEVEL))


class Statement(object):
    """The reference's view of one request: the tree over ``leaves``, the
    membership of the leaves at ``indices``, the full assignment in the
    circuit's variable order, and its rows."""

    def __init__(self, args, request, hasher=None):
        leaves, indices = request['leaves'], request['indices']
        self.depth = depth = args['depth']
        self.n = args['n_proofs']
        if len(indices) != self.n:
            raise ValueError("%d indices for %d statements"
                             % (len(indices), self.n))
        self.h = hasher or MiMC(depth)
        levels = [dict(enumerate(leaves))]
        lo, hi = 0, len(leaves) - 1
        for d in range(depth):
            lo, hi = lo // 2, hi // 2
            nodes = levels[d]
            get = lambda i: nodes[i] if i in nodes else absent(d, i)
            levels.append({i: self.h.node(d, get(2 * i), get(2 * i + 1))
                           for i in range(lo, hi + 1)})
        self.root = levels[depth][0]
        self.values = self._assign(levels, indices)

    def _assign(self, levels, indices):
        depth, h = self.depth, self.h
        vals = [1, self.root]
        for ix in indices:
            leaf = levels[0][ix]
            bits = [(ix >> d) & 1 for d in range(depth)]
            sibs = []
            for d in range(depth):
                j = (ix >> d) ^ 1
                sibs.append(levels[d][j] if j in levels[d] else absent(d, j))
            vals.append(leaf)
            vals += bits
            vals += sibs
            cur = leaf
            for d in range(depth):
                left, right = (sibs[d], cur) if bits[d] else (cur, sibs[d])
                vals += [left, right]
                k = h.ivs[d]
                for m in (left, right):
                    trace = []
                    e = h.cipher(m, k, trace)
                    for t, t2, t4, t6, out in trace:
                        vals += [t2, t4, t6, out]
                    k = (k + m + e) % R
                    vals.append(k)
                cur = k
            if cur != self.root:
                raise AssertionError("statement at %d does not reach the "
                                     "root" % ix)
        return vals

    def inputs(self):
        return [self.root]

    def rows(self, sums):
        """Feed every constraint row, in the circuit's order, to
        ``sums`` (:class:`.groth16.RowSums`)."""
        v, depth, c = self.values, self.depth, self.h.c
        row = sums.row
        per = 1 + 2 * depth + depth * VARS_PER_LEVEL
        for i in range(self.n):
            base = 2 + i * per
            cur = v[base]
            for d in range(depth):
                b, p = v[base + 1 + d], v[base + 1 + depth + d]
                at = base + 1 + 2 * depth + d * VARS_PER_LEVEL
                left, right = v[at], v[at + 1]
                row(b, (1 - b) % R, 0, 0, 1, 0)
                row(b, (p - cur) % R, (left - cur) % R)
                row(b, (cur - p) % R, (right - p) % R)
                at += 2
                k, k_const = self.h.ivs[d], self.h.ivs[d]
                for m in (left, right):
                    x = m
                    for r in range(ROUNDS):
                        t2, t4, t6, out = v[at:at + 4]
                        at += 4
                        ct = (k_const + c[r]) % R
                        t = (x + k + c[r]) % R
                        row(t, t, t2, ct, ct, 0)
                        row(t2, t2, t4)
                        row(t2, t4, t6)
                        if r == ROUNDS - 1:
                            row(t6, t, (out - k) % R, 0, ct, -k_const % R)
                        else:
                            row(t6, t, out, 0, ct, 0)
                        x = out
                    chained = v[at]
                    at += 1
                    row((k + x + m) % R, 1, chained, k_const, 1, 0)
                    k, k_const = chained, 0
                cur = k
            row(cur, 1, self.root, 0, 1, self.root)
        sums.input_rows(self.inputs())
