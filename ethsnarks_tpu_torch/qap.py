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

On a CUDA device the map runs in two hand-written kernels on 8 x 32-bit
words instead (:class:`WordWitnessMap`, ``csrc/witness_kernels.cu``): a
QAP compiled for a card dispatches to them by its device type.  The plain
map stays for every other device and is what the tests hold them to.
"""

import numpy as np
import torch

from .field import SNARK_SCALAR_FIELD
from .ops import kernels
from .ops.fp import Fr, MONT_R, NH, _ripple, words_to_h16, h16_to_words
from .ops.ntt import NttDomain
from .ops.witness_words import TILE_LOG, csr_layout, pass_plan

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


class WordDomain(object):
    """An :class:`.ops.ntt.NttDomain`'s twiddle series and coset planes as
    Fr words, and the K9 passes of the H chain on them
    (:func:`.ops.witness_words.pass_plan`)."""

    def __init__(self, dom, tile_log=TILE_LOG):
        self.k = dom.k
        self.tw_inv = h16_to_words(dom.tw_inv)
        self.tw_fwd = h16_to_words(dom.tw_fwd)
        self.scale = h16_to_words(dom.coset_scale_m_inv_bitrev)
        # g^-i / m times R / Z(coset): A B / R - C / R in, H out
        z_coset = (pow(dom.coset_gen, dom.m, P) - 1) % P
        self.unscale = h16_to_words(Fr.mul(
            dom.coset_unscale_m_inv_bitrev,
            Fr.const_mont(pow(z_coset, -1, P) * MONT_R, dom.device)))
        self.plan = pass_plan(self.k, tile_log)

    def h_coefficients(self, abc):
        """abc: (3m, 8) plain canonical words of A, B, C on the domain
        (stacked) -> (m, 8) plain canonical words of H's coefficients,
        bit-reversed: :func:`h_coefficients` on words."""
        for (lo, t, g), steps in self.plan:
            abc = kernels.ntt_pass(abc, self.tw_inv, self.tw_fwd, self.scale,
                                   self.unscale, self.k, lo, t, g, steps)
        return abc


class WordWitnessMap(object):
    """The witness map of one :class:`QAP` through K8 (the three mat-vecs
    on the stacked CSR matrices) and K9 (:class:`WordDomain`), built
    once."""

    def __init__(self, qap, tile_log=TILE_LOG):
        dev, ni = qap.device, qap.num_inputs
        row_ptr, cols, order = csr_layout(qap.coo_host, qap.domain_size,
                                          qap.num_constraints, ni)
        coeffs = torch.cat(
            [h16_to_words(qap.coo['a'][2]),
             h16_to_words(Fr.const_mont(1, dev)).expand(ni + 1, 8),
             h16_to_words(qap.coo['b'][2]), h16_to_words(qap.coo['c'][2])])
        self.row_ptr = torch.from_numpy(row_ptr).to(dev)
        self.cols = torch.from_numpy(cols.astype(np.int32)).to(dev)
        self.coeffs = coeffs[torch.from_numpy(order).to(dev)]
        self.num_variables = qap.num_variables
        self.domain = WordDomain(qap.domain, tile_log)

    def matvecs(self, w_words):
        """[A w with the input rows; B w; C w]: (3m, 8) plain words."""
        if w_words.shape[0] != self.num_variables:
            # K8 reads w[cols[j]] unchecked
            raise ValueError("witness of %d values for %d variables"
                             % (w_words.shape[0], self.num_variables))
        return kernels.csr_matvec(self.row_ptr, self.cols, self.coeffs,
                                  w_words)

    def __call__(self, w_words):
        """Canonical witness words (num_variables, 8) -> canonical H
        coefficient words (m, 8), bit-reversed."""
        return self.domain.h_coefficients(self.matvecs(w_words))


class QAP(object):
    """Compiled form of a constraint system on one device: COO matrices
    (Montgomery coefficients) and the NTT domain; on a CUDA device also the
    kernels' :class:`WordWitnessMap`."""

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
        self.word_map = WordWitnessMap(self) \
            if self.device.type == 'cuda' else None

    def _matvec(self, name, w_mont):
        """Sparse rows . witness -> (16, m) Montgomery, canonical."""
        return matvec(*self.coo[name], w_mont, self.domain_size)

    def witness_map(self, w_words):
        """Canonical witness words (num_variables, 8) -> canonical H
        coefficient words (m, 8), bit-reversed order: the kernels on a
        CUDA device, :meth:`witness_map_plain` elsewhere."""
        if self.word_map is not None:
            return self.word_map(w_words)
        return self.witness_map_plain(w_words)

    def witness_map_plain(self, w_words):
        """The witness map in plain torch on 16-bit half-limbs, on any
        device."""
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
