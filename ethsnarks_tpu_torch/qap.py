"""R1CS -> QAP: the witness map as plain PyTorch and the setup's host
instance map (counterparts of ``ethsnarks_tpu/qap.py:34-126`` and
``:312-350``).

The domain has size next_pow2(num_constraints + num_inputs + 1); rows
n .. n + num_inputs of A pin the inputs (aA[n + j] = w_j, w_0 = 1).  The
map is three sparse mat-vecs (scatter-add of 16-bit digit columns, then a
modular reduction), one batched 3-in-1 inverse transform, the coset scale,
one batched forward transform, (A*B - C) / Z on the coset, and one more
inverse transform: the H coefficients come out in bit-reversed order,
which is how the proving key stores its H query.
"""

import numpy as np
import torch

from .field import SNARK_SCALAR_FIELD
from .ops.fp import Fr, NH, _ripple, words_to_h16, h16_to_words
from .ops.ntt import NttDomain

P = SNARK_SCALAR_FIELD


def next_pow2(n):
    m = 1
    while m < n:
        m *= 2
    return m


def reduce_sums(t, max_terms):
    """(K, B) normalised digits of a value below max_terms * r -> canonical
    (16, B): subtract 2^j r where it fits, j descending."""
    for j in range(max(0, max_terms.bit_length() - 1), -1, -1):
        c = (P << j)
        cd = torch.tensor([(c >> (16 * i)) & 0xFFFF for i in range(t.shape[0])],
                          dtype=torch.int64, device=t.device)[:, None]
        d = _ripple(t - cd)
        t = torch.where(d[-1] < 0, t, d)
    return t[:NH]


def matvec(rows, cols, coeffs, max_terms, w_mont, width):
    """COO rows (< width), columns and (16, nnz) Montgomery coefficients
    times the (16, nv) Montgomery witness -> (16, width) Montgomery,
    canonical; no row sums more than max_terms terms."""
    sums = torch.zeros((NH + 2, width), dtype=torch.int64,
                       device=w_mont.device)
    if rows.numel():
        vals = Fr.mul(coeffs, w_mont[:, cols])
        sums[:NH].index_add_(1, rows, vals)
    return reduce_sums(_ripple(sums), max_terms)


def h_coefficients(domain, abc):
    """abc: (16, 3, m) Montgomery evaluations of A, B, C on the domain ->
    (16, m) Montgomery coefficients of H = (A B - C) / Z, bit-reversed."""
    m = domain.m
    c3 = domain.dif(abc.reshape(NH, 3 * m), domain.tw_inv)
    c3 = Fr.mul(c3.reshape(NH, 3, m),
                domain.coset_scale_m_inv_bitrev[:, None, :])
    e3 = domain.dit(c3.reshape(NH, 3 * m), domain.tw_fwd).reshape(NH, 3, m)
    h_evals = Fr.mul(Fr.sub(Fr.mul(e3[:, 0], e3[:, 1]), e3[:, 2]),
                     domain.z_coset_inv)
    y = domain.dif(h_evals, domain.tw_inv)
    return Fr.mul(y, domain.coset_unscale_m_inv_bitrev)


class QAP(object):
    """Compiled form of a constraint system on one device: COO matrices
    (Montgomery coefficients) and the NTT domain."""

    def __init__(self, cs, device):
        self.device = torch.device(device)
        self.num_constraints = cs.num_constraints
        self.num_inputs = cs.num_inputs
        self.num_variables = cs.num_variables
        self.domain_size = next_pow2(self.num_constraints + self.num_inputs
                                     + 1)
        self.domain = NttDomain(self.domain_size, self.device)
        self.coo_host = cs.to_coo()
        self.coo = {}
        for name, (rows, cols, coeffs) in self.coo_host.items():
            max_terms = int(np.bincount(rows).max()) if len(rows) else 1
            self.coo[name] = (
                torch.from_numpy(rows).to(self.device),
                torch.from_numpy(cols).to(self.device),
                Fr.ints_to_h16(coeffs, self.device, mont=True), max_terms)

    def _matvec(self, name, w_mont):
        """Sparse rows . witness -> (16, m) Montgomery, canonical."""
        return matvec(*self.coo[name], w_mont, self.domain_size)

    def witness_map(self, w_words):
        """Canonical witness words (num_variables, 8) -> canonical H
        coefficient words (m, 8), bit-reversed order."""
        w_mont = Fr.to_mont(words_to_h16(w_words))
        aA = self._matvec('a', w_mont)
        n = self.num_constraints
        aA[:, n:n + self.num_inputs + 1] = w_mont[:, :self.num_inputs + 1]
        abc = torch.stack([aA, self._matvec('b', w_mont),
                           self._matvec('c', w_mont)], dim=1)
        h = h_coefficients(self.domain, abc)
        return h16_to_words(Fr.from_mont(h))

    def instance_map(self, t):
        """A_i(t), B_i(t), C_i(t) for every variable i, and Z(t), as python
        ints (host, exact): the Lagrange values at t by one batch
        inversion, L_j(t) = Z(t) / m * w^j / (t - w^j), summed through the
        sparse matrices, plus the input-consistency rows of A."""
        m = self.domain_size
        omega = self.domain.omega
        zt = (pow(t, m, P) - 1) % P
        zt_over_m = zt * pow(m, -1, P) % P
        omega_pows = [1] * m
        for i in range(1, m):
            omega_pows[i] = omega_pows[i - 1] * omega % P
        diffs = [(t - w) % P for w in omega_pows]
        if not all(diffs):
            raise ValueError("t is in the domain; resample")
        prefix = [1] * (m + 1)
        for i in range(m):
            prefix[i + 1] = prefix[i] * diffs[i] % P
        inv_all = pow(prefix[m], -1, P)
        u = [0] * m
        for i in range(m - 1, -1, -1):
            u[i] = zt_over_m * omega_pows[i] % P * (inv_all * prefix[i] % P) \
                % P
            inv_all = inv_all * diffs[i] % P
        nv = self.num_variables
        out = []
        for name in 'abc':
            rows, cols, coeffs = self.coo_host[name]
            target = [0] * nv
            for r, c, v in zip(rows.tolist(), cols.tolist(), coeffs):
                target[c] = (target[c] + v * u[r]) % P
            out.append(target)
        at = out[0]
        n = self.num_constraints
        for j in range(self.num_inputs + 1):
            at[j] = (at[j] + u[n + j]) % P
        return out[0], out[1], out[2], zt
