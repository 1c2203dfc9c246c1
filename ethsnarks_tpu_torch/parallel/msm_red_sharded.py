"""The red MSM with its points split over a mesh (counterpart of
``ethsnarks_tpu/parallel/msm_red_sharded.py``).

An MSM is additive over a partition of its points: each shard runs the
port's red MSM (:func:`..ops.msm.msm_tensor`: sort, K1 bucket sums, the
pairfold, K3) on its points and digit columns, the partial projective
points move to the first shard's device (the reference's ``all_gather``)
and are tree-added there by K1 (:func:`combine_partials`).  A shard whose
digits are all zero gives no partial.

Points and digits are split with ``torch.tensor_split``, so shards may be
uneven.  The reference's TPU workarounds have no counterpart here: the
static per-shard capacity plan with its overflow flag and replan (the
port's red MSM sums runs of any length), the ``'host'`` combine (it dodges
XLA:CPU's rendezvous timeout) and ``scan_mode`` (it saves XLA:CPU compile
time).
"""

import torch

from ..ops import kernels, msm
from ..ops.msm_scan import to_host
from .mesh import on


def shard_points(mesh, points):
    """A (b, *point) tensor, or a list of shards -> one contiguous shard a
    device, split by ``torch.tensor_split`` (call once; reuse across
    proofs)."""
    if not torch.is_tensor(points):
        if len(points) != len(mesh):
            raise ValueError("%d point shards for %d devices"
                             % (len(points), len(mesh)))
        return [p.to(dev).contiguous() for p, dev in zip(points, mesh)]
    return [p.to(dev).contiguous() for p, dev in
            zip(torch.tensor_split(points, len(mesh)), mesh)]


def shard_digits(mesh, digits):
    """(n_windows, b) digits, or a list of per-shard digit tensors -> one
    (n_windows, b_d) tensor a device, split as :func:`shard_points`."""
    if not torch.is_tensor(digits):
        if len(digits) != len(mesh):
            raise ValueError("%d digit shards for %d devices"
                             % (len(digits), len(mesh)))
        return [d.to(dev) for d, dev in zip(digits, mesh)]
    return [d.to(dev) for d, dev in
            zip(torch.tensor_split(digits, len(mesh), dim=1), mesh)]


def combine_partials(partials, device, g2):
    """(1, *point) partial results (None for none) -> their sum as a (1,
    *point) tensor on ``device`` (None when there are none): K1 adds halves
    pairwise until one point is left."""
    parts = [p.to(device) for p in partials if p is not None]
    if not parts:
        return None
    cur = torch.cat(parts).contiguous()
    with on(device):
        while cur.shape[0] > 1:
            n = cur.shape[0]
            half = n // 2
            ia = torch.arange(half, device=device)
            merged = kernels.point_add(cur, cur, ia, ia + half, g2)
            cur = torch.cat([merged, cur[2 * half:]]) if n % 2 else merged
    return cur


def sharded_msm(mesh, points, digits, run, g2):
    """``run(points_d, digits_d)`` on every shard, then
    :func:`combine_partials` on the first device."""
    pts = shard_points(mesh, points)
    digs = shard_digits(mesh, digits)
    partials = []
    for p, d, dev in zip(pts, digs, mesh):
        if p.shape[0] != d.shape[1]:
            raise ValueError("shard on %s: %d points, %d digit columns"
                             % (dev, p.shape[0], d.shape[1]))
        if p.shape[0]:
            with on(dev):
                partials.append(run(p, d))
    return combine_partials(partials, mesh.devices[0], g2)


class ShardedRedMSM(object):
    """The red MSM over a mesh, for b points in total and window bits c.
    ``__call__`` takes the points as shards (:meth:`shard_points`) or one
    tensor and the digits as one (n_windows, b) tensor or per-shard tensors
    (the prover takes each shard's digits on its device) and returns a host
    affine point (None for infinity)."""

    def __init__(self, mesh, b, c, g2=False):
        self.mesh, self.b, self.c, self.g2 = mesh, int(b), int(c), bool(g2)
        self.sizes = [int(t.numel()) for t in
                      torch.tensor_split(torch.arange(self.b), len(mesh))]

    def shard_points(self, points):
        out = shard_points(self.mesh, points)
        if [p.shape[0] for p in out] != self.sizes:
            raise ValueError("point shards of %s, expected %s"
                             % ([p.shape[0] for p in out], self.sizes))
        return out

    def __call__(self, points, digits):
        c, g2 = self.c, self.g2
        return to_host(sharded_msm(
            self.mesh, points, digits,
            lambda p, d: msm.msm_tensor(p, d, c, g2), g2), g2)


_CACHE = {}


def get_sharded_msm(mesh, b, c, g2=False):
    """The :class:`ShardedRedMSM` of (mesh, b, c, group), made once."""
    key = (mesh, int(b), int(c), bool(g2))
    if key not in _CACHE:
        _CACHE[key] = ShardedRedMSM(mesh, b, c, g2)
    return _CACHE[key]
