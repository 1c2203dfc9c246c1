"""nozk Groth16 prover on the card (counterpart of the device branch of
``ethsnarks_tpu/groth16.py`` ``ProverContext.prove``, :697-790).

One proof: one witness upload, the witness map (:mod:`.qap`), window digits
of H and of the witness columns of the A, B and L queries, four Pippenger
MSMs (:mod:`.ops.msm`: H, A and L in G1, B in G2) on the hand-written
kernels, and host finalisation (alpha + A, beta + B, H + L).  nozk proofs
carry no blinding and are deterministic: the same witness gives the
reference host prover's exact proof.
"""

import time

import torch

from . import resolve_device
from .bn254 import add
from .field import SNARK_SCALAR_FIELD
from .ops.fp import ints_to_words_np
from .ops.msm import best_c, msm_g1, msm_g2, window_digits
from .qap import QAP
from .verifier import Proof

P = SNARK_SCALAR_FIELD


class ProvingKey(object):
    """nozk proving key.  Header points are host affine; the queries are
    point tensors (Montgomery words, infinity = (0, 1, 0)): sparse A (G1)
    and B (G2) with their variable indices, the dense H query in
    bit-reversed order, and the L query over the aux variables."""

    def __init__(self, alpha_g1, beta_g2, delta_g2, a_idx, a_pts, b_idx,
                 b_pts, h_pts, l_pts, num_inputs):
        self.alpha_g1 = alpha_g1
        self.beta_g2 = beta_g2
        self.delta_g2 = delta_g2
        self.a_idx, self.a_pts = a_idx, a_pts
        self.b_idx, self.b_pts = b_idx, b_pts
        self.h_pts = h_pts
        self.l_pts = l_pts
        self.num_inputs = num_inputs

    def to(self, device):
        """The same key with every query tensor on ``device``."""
        return ProvingKey(
            self.alpha_g1, self.beta_g2, self.delta_g2,
            self.a_idx.to(device), self.a_pts.to(device),
            self.b_idx.to(device), self.b_pts.to(device),
            self.h_pts.to(device), self.l_pts.to(device), self.num_inputs)


class ProverContext(object):
    """Per-circuit proving state: the key's query points stay on the device
    across proofs, with the QAP's COO matrices and NTT constants."""

    def __init__(self, pk, cs, device=None):
        self.device = resolve_device(device)
        self.pk = pk.to(self.device)
        self.qap = QAP(cs, self.device)
        if self.pk.h_pts.shape[0] != self.qap.domain_size:
            raise ValueError("H query of %d points for a domain of %d"
                             % (self.pk.h_pts.shape[0], self.qap.domain_size))
        ni, nv = pk.num_inputs, self.qap.num_variables
        self.l_idx = torch.arange(ni + 1, nv, device=self.device)
        self.c = dict(h=best_c(self.qap.domain_size),
                      a=best_c(self.pk.a_idx.shape[0]),
                      b=best_c(self.pk.b_idx.shape[0]),
                      l=best_c(nv - ni - 1))
        self.last_profile = None

    def _mark(self, marks, name):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        marks.append((name, time.perf_counter()))

    def prove(self, witness_values, blind=False):
        """witness_values: the full assignment [1, inputs.., aux..] as ints.
        Returns a :class:`Proof`; per-phase wall seconds are left in
        ``self.last_profile``."""
        if blind:
            raise NotImplementedError(
                "r/s blinding is not ported: this prover makes nozk proofs")
        pk, c = self.pk, self.c
        ni = pk.num_inputs
        w = [int(v) % P for v in witness_values]
        if len(w) != self.qap.num_variables or w[0] != 1:
            raise ValueError("witness must hold %d values starting with 1"
                             % self.qap.num_variables)
        marks = []
        self._mark(marks, 'start')
        w_words = torch.from_numpy(ints_to_words_np(w)).to(self.device)
        self._mark(marks, 'witness_upload')
        h = self.qap.witness_map(w_words)
        self._mark(marks, 'witness_map')
        h_d = window_digits(h, c['h'])
        a_d = window_digits(w_words[pk.a_idx], c['a'])
        b_d = window_digits(w_words[pk.b_idx], c['b'])
        l_d = window_digits(w_words[self.l_idx], c['l'])
        self._mark(marks, 'digits')
        h_eval = msm_g1(pk.h_pts, h_d, c['h'])
        self._mark(marks, 'h_msm')
        a_eval = msm_g1(pk.a_pts, a_d, c['a'])
        self._mark(marks, 'a_msm')
        b_eval = msm_g2(pk.b_pts, b_d, c['b'])
        self._mark(marks, 'b_msm_g2')
        l_eval = msm_g1(pk.l_pts, l_d, c['l'])
        self._mark(marks, 'l_msm')
        proof = Proof(A=add(pk.alpha_g1, a_eval), B=add(pk.beta_g2, b_eval),
                      C=add(h_eval, l_eval), input=w[1:1 + ni])
        self._mark(marks, 'finalise')
        self.last_profile = {name: t - marks[i][1]
                             for i, (name, t) in enumerate(marks[1:])}
        return proof
