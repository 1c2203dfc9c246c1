"""The dense all-windows MSM (counterpart of ``ethsnarks_tpu/ops/
pallas_msm.py`` ``msm_g1_dense_allwin`` (:758-826) and
``msm_g2_dense_allwin`` (:667-727) with their device pipelines
``_jit_msm_dense_allwin`` / ``_g2``, :396-480 and :596-665).

The windows are taken in contiguous groups that share a per-window bucket
capacity k (:func:`window_ks`: each window's largest bucket plus slack, a
power of two, so the narrow top window of 254-bit scalars gets its own
group) and are sized so a group's dense matrix of (windows * 2^c) slots x
k lanes stays under ``max_lanes``.  For each group:

1. composite keys ``(w << c) | digit`` of the group's windows, one sort;
   the run of slot s is [starts[s], ends[s]) of the sorted keys;
2. the slots' points are summed by a halving tree of K1 launches over the
   (slots, k) matrix, lane j with lane j + k/2 at each level, through index
   tensors: the first level reads the points themselves, so the matrix is
   never gathered, and a lane whose partner lies past its slot's count
   passes through (empty lanes hold the identity);
3. K5 folds every window of the group (sum_b b * S_b), K3 combines them.

The group results are combined on the host, most significant group first,
with c * (gap between group starts) host doublings.  All-zero windows are
skipped.

Fallbacks to the scan MSM (:mod:`.msm_scan`), as the reference's: at most
``min_points`` points (small MSMs: one pass where this driver makes one per
group), a window whose capacity exceeds max(64 * mean bucket,
``max_lanes`` / 2^c) (skew), or a bucket above its group's capacity
(overflow; not reached when the capacities come from the digits).  G1
falls back to the fused scan driver (its windows combined by K3), G2 to
the generic MSM (K2 doubles and K1 adds).  Every call returns the route it
took.

Not ported (TPU workarounds): the 128-lane ballast, the power-of-two
padding of the window count, the ``(1 << c) >= 128`` precondition.
"""

import math

import torch

from ..bn254 import add as host_add, double as host_double
from . import curve, kernels, msm_scan
from .msm import check_digit_contract

MAX_LANES = {False: 1 << 23, True: 1 << 22}
MIN_POINTS = {False: 1 << 13, True: 1 << 11}


def nice_k(need):
    """Smallest power of two >= need (``pallas_msm.py:730-736``)."""
    k = 1
    while k < need:
        k *= 2
    return k


def window_ks(b, c, digits):
    """Per-window dense capacity (``pallas_msm.py:739-755``): the smallest
    nice capacity covering the window's largest bucket count plus slack,
    or the floor mean + 4 sqrt(mean) + 8 where that is larger.  digits:
    (nw, b) integer tensor; bucket 0 counts, as in the reference."""
    nw = digits.shape[0]
    n_buckets = 1 << c
    comp = digits.to(torch.int64) + (torch.arange(
        nw, device=digits.device)[:, None] << c)
    counts = torch.bincount(comp.reshape(-1), minlength=nw << c)
    maxes = counts.reshape(nw, n_buckets).max(1).values.tolist()
    mean = max(1, b >> c)
    floor = mean + 4 * math.isqrt(mean) + 8
    return [nice_k(max(mx + 4 * math.isqrt(mx) + 8, floor)
                   if mx > floor else floor) for mx in maxes]


def plan_groups(digits, c, g2, k=None, max_lanes=None):
    """[(first window, windows, capacity)] of the groups, or None when a
    window's capacity means skew."""
    nw, b = digits.shape
    max_lanes = max_lanes or MAX_LANES[g2]
    zero_win = (digits.max(1).values == 0).tolist()
    ks = [k] * nw if k is not None else window_ks(b, c, digits)
    mean = max(1, b >> c)
    groups = []
    g0 = 0
    while g0 < nw:
        if zero_win[g0]:
            g0 += 1
            continue
        kg = ks[g0]
        if kg > max(64 * mean, max_lanes // (1 << c)):
            return None
        cap = max(1, max_lanes // ((1 << c) * kg))
        g1 = g0 + 1
        while g1 < nw and not zero_win[g1] and ks[g1] == kg and \
                g1 - g0 < cap:
            g1 += 1
        groups.append((g0, g1 - g0, kg))
        g0 = g1
    return groups


def bucket_matrix_sums(points, digits, c, k, g2):
    """The group's (nw * 2^c, *point) bucket sums by the halving tree over
    its (slots, k) matrix, or None when a bucket holds more than k points.
    ``points`` carries one identity point after the b real ones."""
    nw, b = digits.shape
    dev = digits.device
    ident = points.shape[0] - 1
    n_slots = nw << c
    comp = (digits.to(torch.int64)
            + (torch.arange(nw, device=dev)[:, None] << c)).reshape(-1)
    sk, order = torch.sort(comp)
    orig = order % b
    slots = torch.arange(n_slots, device=dev)
    starts = torch.searchsorted(sk, slots)
    count = torch.searchsorted(sk, slots, right=True) - starts
    if int(count.max()) > k:
        return None
    cur, per = points, k
    while per > 1:
        half = per // 2
        j = torch.arange(half, device=dev)
        right = (j + half)[None] < count[:, None]        # (slots, half)
        if cur is points:
            left = j[None] < count[:, None]
            src = starts[:, None] + j[None]
            ia = torch.where(left, orig[torch.clamp(src, max=sk.numel() - 1)],
                             ident)
            ib = torch.where(right, orig[torch.clamp(src + half,
                                                     max=sk.numel() - 1)], -1)
        else:
            row = (slots * per)[:, None] + j[None]
            ia = row
            ib = torch.where(right, row + half, -1)
        cur = kernels.point_add(cur, cur, ia.reshape(-1), ib.reshape(-1), g2)
        per = half
    if cur is points:                                  # k == 1
        ia = torch.where(count > 0, orig[torch.clamp(starts, max=sk.numel()
                                                     - 1)], ident)
        cur = kernels.point_add(points, points, ia,
                                torch.full_like(ia, -1), g2)
    return cur


def _horner_host(group_results, c):
    """sum_g 2^(c * start_g) R_g, most significant group first
    (``pallas_msm.py:814-825``)."""
    acc, prev = None, None
    for g0, pt in reversed(group_results):
        if acc is not None:
            for _ in range(c * (prev - g0)):
                acc = host_double(acc)
        acc = host_add(acc, pt)
        prev = g0
    for _ in range(c * prev):
        acc = host_double(acc)
    return acc


def msm(points, digits, c, g2=False, k=None, max_lanes=None,
        min_points=None):
    """Dense all-windows MSM -> (host affine point or None, route).

    points: (b, *point); digits: (nw, b) window digits on the same device.
    ``route``: 'dense', or 'scan:small', 'scan:skew' or 'scan:overflow'
    where the driver fell back to the scan MSM."""
    nw, b = digits.shape
    if points.shape[0] != b or tuple(points.shape[1:]) != \
            curve.point_shape(g2):
        raise ValueError("MSM: %d digit columns for points of shape %s"
                         % (b, tuple(points.shape)))
    if digits.device != points.device:
        raise ValueError("MSM: digits and points on different devices")
    check_digit_contract(digits, c)
    combine = 'double_add' if g2 else 'horner'
    to_host = curve.tensor_to_g2 if g2 else curve.tensor_to_g1

    def fallback(why):
        res = msm_scan.msm_tensor(points, digits, c, g2, combine)
        return (None if res is None else to_host(res)[0]), 'scan:' + why

    if b <= (MIN_POINTS[g2] if min_points is None else min_points):
        return fallback('small')
    groups = plan_groups(digits, c, g2, k, max_lanes)
    if groups is None:
        return fallback('skew')
    if not groups:
        return None, 'dense'
    ext = torch.cat([points, curve.identity(1, g2, points.device)])
    results = []
    for g0, n_win, kg in groups:
        sums = bucket_matrix_sums(ext, digits[g0:g0 + n_win], c, kg, g2)
        if sums is None:
            return fallback('overflow')
        wins = kernels.bucket_fold(sums, n_win, c, g2)
        res = kernels.horner(wins.reshape((n_win, 1) + tuple(wins.shape[1:])),
                             c, g2)
        results.append((g0, to_host(res)[0]))
    return _horner_host(results, c), 'dense'
