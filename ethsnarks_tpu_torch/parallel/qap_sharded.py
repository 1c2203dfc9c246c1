"""The witness map on row chunks (counterpart of
``ethsnarks_tpu/parallel/qap_sharded.py``).

The evaluation domain is split contiguously over the mesh, as
:mod:`.ntt_sharded` splits it:

- **Sparse mat-vecs.**  The COO entries of A, B and C are partitioned by
  destination row chunk (row // chunk) with one stable numpy argsort, and
  A gets the input rows (n + j, j, 1) appended (rows n .. n + num_inputs
  hold no constraint entry, so this pins aA[n + j] = w_j as the
  single-device map's overwrite does).  Each shard runs the port's mat-vec
  (:func:`..qap.matvec`) on its rows made local, against the witness
  replicated onto its device: no communication.
- **Transforms.**  The chain of :func:`..qap.h_coefficients` on the
  sharded domain: one 3-vector DIF, the coset scale with 1/m, one
  3-vector DIT, (A B - C) / Z, one DIF, the unscale with 1/m.

The H coefficients come out as bit-reversed shards, each on its device
(the H query is split the same way, so the H MSM never gathers them).
"""

import numpy as np
import torch

from ..ops.fp import Fr, NH, h16_to_words, words_to_h16
from ..qap import matvec
from .mesh import normalise, on
from .ntt_sharded import ShardedNttDomain


def partition_rows(rows, chunk, n_dev):
    """Entry indices grouped by row chunk (stable within a chunk) ->
    (order, bounds): shard d's entries are order[bounds[d]:bounds[d+1]]."""
    owner = np.asarray(rows, dtype=np.int64) // chunk
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner, minlength=n_dev)
    if counts.shape[0] > n_dev:
        raise ValueError("COO row beyond the domain")
    return order, np.concatenate([[0], np.cumsum(counts)])


class ShardedWitnessMap(object):
    """The witness map of one port :class:`..qap.QAP` over a mesh.  The
    QAP's domain is the sharded domain's base when it lies on the mesh's
    first device."""

    def __init__(self, qap, mesh):
        m, devices = qap.domain_size, mesh.devices
        n_dev = len(devices)
        self.qap, self.mesh = qap, mesh
        base = qap.domain if normalise(qap.device) == devices[0] else None
        self.dom = ShardedNttDomain(m, mesh, base)
        self.chunk = chunk = self.dom.chunk
        n, ni = qap.num_constraints, qap.num_inputs
        self.parts = {}
        for name in ("a", "b", "c"):
            rows_h, cols_h, _ = qap.coo_host[name]
            coeffs = qap.coo[name][2]
            max_terms = qap.coo[name][3]
            if name == "a":
                extra = np.arange(ni + 1, dtype=np.int64)
                rows_h = np.concatenate([rows_h, n + extra])
                cols_h = np.concatenate([cols_h, extra])
                one = Fr.const_mont(1, coeffs.device)
                coeffs = torch.cat([coeffs, one.expand(NH, ni + 1)], dim=1)
            order, bounds = partition_rows(rows_h, chunk, n_dev)
            order_t = torch.from_numpy(order).to(coeffs.device)
            parts = []
            for d, dev in enumerate(devices):
                idx = order[bounds[d]:bounds[d + 1]]
                parts.append((
                    torch.from_numpy(rows_h[idx] - d * chunk).to(dev),
                    torch.from_numpy(cols_h[idx]).to(dev),
                    coeffs[:, order_t[bounds[d]:bounds[d + 1]]].to(dev)
                    .contiguous(),
                    max_terms))
            self.parts[name] = parts

    def h_shards(self, w_mont):
        """w_mont: {device: (16, nv) Montgomery witness} -> the H
        coefficient shards, (16, chunk) Montgomery, bit-reversed."""
        dom, chunk = self.dom, self.chunk
        abc = []
        for d, dev in enumerate(self.mesh.devices):
            with on(dev):
                abc.append(torch.stack(
                    [matvec(*self.parts[name][d], w_mont[dev], chunk)
                     for name in ("a", "b", "c")], dim=1).reshape(NH, -1))
        c3 = dom.scale(dom.dif(abc, "inv"), dom.coset_scale_m_inv_bitrev)
        e3 = dom.dit(c3, "fwd")
        h = []
        for x, z in zip(e3, dom.z_coset_inv):
            with on(x.device):
                e = x.reshape(NH, 3, chunk)
                h.append(Fr.mul(Fr.sub(Fr.mul(e[:, 0], e[:, 1]), e[:, 2]), z))
        return dom.scale(dom.dif(h, "inv"), dom.coset_unscale_m_inv_bitrev)

    def __call__(self, w_words):
        """Canonical witness words, (num_variables, 8) on any device, or
        {device: words} already on the mesh's devices -> the canonical H
        coefficient words as shards, (chunk, 8) each on its device,
        bit-reversed: shard d holds H positions [d chunk, (d + 1) chunk)."""
        if torch.is_tensor(w_words):
            w_words = {dev: w_words.to(dev) for dev in self.mesh.distinct()}
        w_mont = {}
        for dev, w in w_words.items():
            with on(dev):
                w_mont[dev] = Fr.to_mont(words_to_h16(w))
        out = []
        for h in self.h_shards(w_mont):
            with on(h.device):
                out.append(h16_to_words(Fr.from_mont(h)))
        return out
