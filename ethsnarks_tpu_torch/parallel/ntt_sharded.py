"""The binary-exchange NTT over a mesh (counterpart of
``ethsnarks_tpu/parallel/ntt_sharded.py``).

The domain vector is split contiguously: shard d holds elements
[d * chunk, (d + 1) * chunk), chunk = m / n_dev, as a (16, B*chunk)
Montgomery h16 tensor on its device (B stacked vectors, each chunk
contiguous).  A DIF stage of butterfly span n pairs elements n/2 apart:

- while n/2 >= chunk, the partner of shard d's elements is shard
  d XOR (n/2 / chunk).  The stage is a cross stage: the low shard's chunk
  moves to the high shard's device (``.to()``, the reference's
  ``ppermute``), which computes (u - v) w^j with its slice of the stage's
  twiddles, and the low side gets the high shard's chunk and computes
  u + v.  In DIT the high side computes t = v w^j once and sends it, the
  low side takes u + t, the high side u - t;
- once n/2 < chunk, the remaining stages are local: the port's own stage
  code (:func:`..ops.ntt.dif_stage`, :func:`..ops.ntt.dit_stage`) on the
  chunk.

log2(n_dev) cross stages a transform.  Orders are the single-device
domain's: DIF natural -> bit-reversed, DIT bit-reversed -> natural, and the
pointwise planes (the port's ``coset_scale_m_inv_bitrev``,
``coset_unscale_m_inv_bitrev``, ``z_coset_inv``) are sliced per shard.
The seconds spent in cross stages, synchronised, add up in
``exchange_seconds``.
"""

import time

import torch

from ..ops.fp import Fr, NH
from ..ops.ntt import NttDomain, dif_stage, dit_stage
from .mesh import normalise, on


class ShardedNttDomain(object):
    """Transforms of size m over a mesh's shards.  ``base``: an
    :class:`..ops.ntt.NttDomain` of size m on the mesh's first device (built
    here when None); every per-shard plane is a slice of its planes."""

    def __init__(self, m, mesh, base=None):
        devices = mesh.devices
        n_dev = len(devices)
        if m % n_dev:
            raise ValueError("domain %d over %d shards" % (m, n_dev))
        if base is None:
            base = NttDomain(m, devices[0])
        if base.m != m or normalise(base.device) != devices[0]:
            raise ValueError("base domain of %d on %s, not %d on %s"
                             % (base.m, base.device, m, devices[0]))
        self.m, self.k, self.mesh = m, base.k, mesh
        self.devices, self.n_dev = devices, n_dev
        self.chunk = chunk = m // n_dev
        self.base = base
        self.exchange_seconds = 0.0

        def per_shard(plane):
            return [plane[:, d * chunk:(d + 1) * chunk].to(dev).contiguous()
                    for d, dev in enumerate(devices)]

        def local(series):
            # span n <= chunk takes omega_n^j = series[j m / n]: strides of
            # the span-chunk stage's (16, chunk/2) twiddles
            half = max(chunk // 2, 1)
            plane = series[:, ::m // chunk][:, :half] if chunk > 1 \
                else series[:, :1]
            return {dev: plane.to(dev).contiguous() for dev in
                    mesh.distinct()}

        def cross(series):
            # stage s (half >= chunk): the high shard's slice of
            # series[2^s j], j from (d chunk) mod half
            out = {}
            for s in range(self.k):
                half = (m >> s) // 2
                if half < chunk:
                    break
                stage = base.stage_twiddles(series, s)
                po = half // chunk
                out[s] = {}
                for d in range(n_dev):
                    if (d // po) % 2:
                        off = (d * chunk) % half
                        out[s][d] = stage[:, off:off + chunk].to(
                            devices[d]).contiguous()
            return out

        self._local = {"fwd": local(base.tw_fwd), "inv": local(base.tw_inv)}
        self._cross = {"fwd": cross(base.tw_fwd), "inv": cross(base.tw_inv)}
        self.coset_scale_m_inv_bitrev = per_shard(
            base.coset_scale_m_inv_bitrev)
        self.coset_unscale_m_inv_bitrev = per_shard(
            base.coset_unscale_m_inv_bitrev)
        m_mont = Fr.const_mont(m, devices[0])
        # g^i (bit-reversed) for the lone coset transform: g^i / m times m
        self.coset_scale_bitrev = [
            Fr.mul(p, m_mont.to(p.device))
            for p in self.coset_scale_m_inv_bitrev]
        self.z_coset_inv = [base.z_coset_inv.to(dev) for dev in devices]
        self.m_inv = [Fr.const_mont(base.m_inv, dev) for dev in devices]

    # ---- layout ----

    def shard(self, x):
        """(16, B*m) on any device -> the shards' (16, B*chunk) tensors."""
        b = x.shape[1] // self.m
        x = x.reshape(NH, b, self.m)
        c = self.chunk
        return [x[:, :, d * c:(d + 1) * c].reshape(NH, -1).to(dev)
                .contiguous() for d, dev in enumerate(self.devices)]

    def gather(self, shards, device=None):
        """The inverse of :meth:`shard`, on ``device`` (the first shard's)."""
        device = device or self.devices[0]
        b = shards[0].shape[1] // self.chunk
        return torch.cat([s.to(device).reshape(NH, b, self.chunk)
                          for s in shards], dim=2).reshape(NH, -1)

    # ---- stages ----

    def _cross_stage(self, shards, s, which, dit):
        half = (self.m >> s) // 2
        po = half // self.chunk
        tws = self._cross[which][s]
        if self.devices[0].type == "cuda":
            self.mesh.synchronize()
        t0 = time.perf_counter()
        out = list(shards)
        for lo in range(self.n_dev):
            if (lo // po) % 2:
                continue
            hi = lo ^ po
            d_lo, d_hi = self.devices[lo], self.devices[hi]
            x_lo, x_hi = shards[lo], shards[hi]
            b = x_lo.shape[1] // self.chunk
            tw = tws[hi][:, None, :]
            with on(d_hi):
                u = x_lo.to(d_hi).reshape(NH, b, self.chunk)
                v = x_hi.reshape(NH, b, self.chunk)
                if dit:
                    t = Fr.mul(v, tw)
                    out[hi] = Fr.sub(u, t).reshape(NH, -1)
                    send = t.to(d_lo)
                else:
                    out[hi] = Fr.mul(Fr.sub(u, v), tw).reshape(NH, -1)
                    send = x_hi.to(d_lo).reshape(NH, b, self.chunk)
            with on(d_lo):
                out[lo] = Fr.add(x_lo.reshape(NH, b, self.chunk),
                                 send).reshape(NH, -1)
        if self.devices[0].type == "cuda":
            self.mesh.synchronize()
        self.exchange_seconds += time.perf_counter() - t0
        return out

    def _local_stage(self, shards, s, which, dit):
        n = self.m >> s
        stage = dit_stage if dit else dif_stage
        out = []
        for x, dev in zip(shards, self.devices):
            tw = self._local[which][dev][:, ::self.chunk // n][:, :n // 2]
            with on(dev):
                out.append(stage(x, tw, n))
        return out

    def _stage(self, shards, s, which, dit):
        if (self.m >> s) // 2 >= self.chunk:
            return self._cross_stage(shards, s, which, dit)
        return self._local_stage(shards, s, which, dit)

    def dif(self, shards, which="inv"):
        """Natural -> bit-reversed over the shards; ``which``: the 'fwd'
        or 'inv' twiddle series."""
        for s in range(self.k):
            shards = self._stage(shards, s, which, False)
        return shards

    def dit(self, shards, which="fwd"):
        """Bit-reversed -> natural over the shards."""
        for s in range(self.k - 1, -1, -1):
            shards = self._stage(shards, s, which, True)
        return shards

    def scale(self, shards, planes):
        """Each shard times its plane (16, chunk) (or constant (16, 1)),
        every stacked vector alike."""
        out = []
        for x, p in zip(shards, planes):
            with on(x.device):
                b = x.shape[1] // self.chunk
                out.append(Fr.mul(x.reshape(NH, b, self.chunk),
                                  p[:, None, :]).reshape(NH, -1))
        return out

    # ---- the reference's public transforms (shards -> shards) ----

    def fft_coeffs_bitrev_to_evals_sharded(self):
        return lambda shards: self.dit(shards, "fwd")

    def ifft_evals_to_coeffs_bitrev_sharded(self):
        return lambda shards: self.scale(self.dif(shards, "inv"),
                                         self.m_inv)

    def coset_fft_coeffs_bitrev_to_evals_sharded(self):
        return lambda shards: self.dit(
            self.scale(shards, self.coset_scale_bitrev), "fwd")

    def icoset_fft_evals_to_coeffs_bitrev_sharded(self):
        return lambda shards: self.scale(self.dif(shards, "inv"),
                                         self.coset_unscale_m_inv_bitrev)

    def divide_by_z_on_coset_sharded(self):
        return lambda shards: self.scale(shards, self.z_coset_inv)
