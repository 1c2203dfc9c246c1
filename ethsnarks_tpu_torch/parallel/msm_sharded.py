"""The scan MSM with its points split over a mesh (counterpart of
``ethsnarks_tpu/parallel/msm_sharded.py``).

Each shard runs the port's scan MSM (:func:`..ops.msm_scan.msm_tensor`:
K6 segmented scan, K5 fold, and the generic window step, K2 then K1, as
the reference's ``_msm_core``), and the partial points are tree-added by
K1 on the first shard's device (:func:`.msm_red_sharded.combine_partials`;
EC addition is no ``psum`` over raw words, so the combine is explicit).
"""

from ..ops import msm_scan
from .msm_red_sharded import sharded_msm


def make_sharded_msm(mesh, field_kind='g1', c=13):
    """fn(points, digits) -> the MSM as a projective (1, *point) tensor on
    the mesh's first device (None when every digit is zero).  ``points``:
    one (b, *point) tensor or its shards (:func:`.msm_red_sharded.
    shard_points`); ``digits``: (ceil(254/c), b) or per-shard."""
    if field_kind not in ('g1', 'g2'):
        raise ValueError("field_kind %r: 'g1' or 'g2'" % (field_kind,))
    g2 = field_kind == 'g2'

    def fn(points, digits):
        return sharded_msm(
            mesh, points, digits,
            lambda p, d: msm_scan.msm_tensor(p, d, c, g2), g2)
    return fn
