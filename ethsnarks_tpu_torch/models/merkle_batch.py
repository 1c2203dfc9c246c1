"""N Merkle membership proofs under one public root in one circuit, with
the witness made by the batched MiMC trace (counterpart of
``ethsnarks_tpu/models/merkle_batch.py``).

The gadgets stamp each proof's rows; the witness of all N proofs is
computed one tree level at a time by one call of
:func:`..ops.mimc.mimc_mp_witness_device` on the model's device, and the
values are written into the variable vector by index.  At depth 29, N = 48
is 1,020,384 constraints on the domain 2^20: the flagship workload.
"""

import time

import torch

from .. import resolve_device
from ..gadgets import merkle_path_authenticator
from ..gadgets.merkle import merkle_tree_IVs
from ..mimc.permutation import DEFAULT_ROUNDS
from ..ops.fp import NH, Fr
from ..ops.mimc import mimc_mp_witness_device
from ..r1cs import ConstraintSystem
from ._prove import prove

N_AUX = 8 * DEFAULT_ROUNDS + 2      # variables of one MiMC-e7 MP hash


def mp_aux_indices(hasher):
    """Variable indices of a two-block MiMC-e7 Miyaguchi-Preneel gadget in
    the order of the trace's aux rows: each cipher's rounds (t2, t4, t6,
    out), then that block's chaining value."""
    idx = []
    for cipher, out in zip(hasher.ciphers, hasher.outputs):
        for g in cipher.rounds_g:
            idx += [g.t2.index, g.t4.index, g.t6.index, g.out.index]
        idx.append(out.index)
    return idx


class BatchMerkleMembership(object):
    """N Merkle membership proofs (shared public root) in one circuit:
    depth * 733 + 1 constraints a proof.  ``device`` (None: the card) is
    where :meth:`set_witness` runs the trace."""

    def __init__(self, depth=29, n_proofs=1, device=None):
        self.depth = depth
        self.n_proofs = n_proofs
        self.device = resolve_device(device)
        pb = ConstraintSystem()
        self.root_v = pb.allocate('root')
        pb.set_input_sizes(1)
        self.leaf_vs = []
        self.addr_vs = []
        self.path_vs = []
        self.auths = []
        for i in range(n_proofs):
            leaf = pb.allocate('leaf_%d' % i)
            addr = pb.allocate_array(depth, 'addr_%d' % i)
            path = pb.allocate_array(depth, 'path_%d' % i)
            auth = merkle_path_authenticator(
                pb, depth, addr, self.root_v + 0, leaf + 0, path,
                'm_%d' % i)
            auth.generate_r1cs_constraints()
            self.leaf_vs.append(leaf)
            self.addr_vs.append(addr)
            self.path_vs.append(path)
            self.auths.append(auth)
        self.pb = pb
        self._ivs = merkle_tree_IVs(depth)
        # aux_base[d][i]: first variable of proof i's level-d hasher; the
        # trace's aux rows are written there by index, so the layout is
        # checked here against the gadgets' own variables
        self.aux_base = []
        for d in range(depth):
            row = []
            for auth in self.auths:
                idx = mp_aux_indices(auth.hashers[d])
                assert idx == list(range(idx[0], idx[0] + N_AUX)), \
                    "MiMC MP variables are not contiguous"
                row.append(idx[0])
            self.aux_base.append(row)
        self.trace_seconds = None

    def set_witness(self, tree, indices):
        """Fill all N witnesses from one host MerkleTree: the path values
        on the host, every hash variable from one batched trace a level on
        the model's device.  ``trace_seconds`` is left as the traces' time,
        synchronised."""
        assert len(indices) == self.n_proofs
        pb = self.pb
        dev = self.device
        pb.setval(self.root_v, tree.root)
        proofs = [tree.proof(ix) for ix in indices]
        cur = []
        for i, (ix, proof) in enumerate(zip(indices, proofs)):
            pb.setval(self.leaf_vs[i], tree[ix])
            cur.append(tree[ix])
            for d in range(self.depth):
                pb.setval(self.addr_vs[i][d], proof.address[d])
                pb.setval(self.path_vs[i][d], proof.path[d])

        levels = []
        self.trace_seconds = 0.0
        for d in range(self.depth):
            lefts, rights = [], []
            for i, proof in enumerate(proofs):
                bit, sibling = proof.address[d], proof.path[d]
                left, right = (sibling, cur[i]) if bit else (cur[i], sibling)
                sel = self.auths[i].selectors[d]
                pb.setval(sel.left, left)
                pb.setval(sel.right, right)
                lefts.append(left)
                rights.append(right)
            lm = Fr.ints_to_h16(lefts, dev, mont=True)
            rm = Fr.ints_to_h16(rights, dev, mont=True)
            t0 = time.perf_counter()
            out, aux = mimc_mp_witness_device(lm, rm, self._ivs[d])
            if dev.type == 'cuda':
                torch.cuda.synchronize(dev)
            self.trace_seconds += time.perf_counter() - t0
            cur = Fr.h16_to_ints(out, mont=True)
            levels.append(aux)
        # one conversion of every level: (16, depth, N_AUX, N) -> ints in
        # (level, aux row, proof) order
        flat = Fr.h16_to_ints(Fr.from_mont(
            torch.stack(levels, dim=1).reshape(NH, -1)))
        n = self.n_proofs
        for d, bases in enumerate(self.aux_base):
            level = flat[d * N_AUX * n:(d + 1) * N_AUX * n]
            for i, base in enumerate(bases):
                pb.values[base:base + N_AUX] = level[i::n]
        assert all(c == tree.root for c in cur), "root mismatch"
        return self

    def prove(self, keypair=None, context=None, device=None, rng=None,
              msm_impl='auto'):
        """-> (proof, keypair, context) on ``device`` (None: the model's
        device); see :func:`._prove.prove`."""
        return prove(self.pb, keypair, context,
                     self.device if device is None else device, rng,
                     msm_impl)
