"""The scan MSM: sort, K6 segmented scan, last-of-run extract, K5 fold,
window combine (counterpart of the generic MSM ``ethsnarks_tpu/ops/msm.py``
``_msm_core`` (:118-143) and of the fused scan driver
``ethsnarks_tpu/ops/pallas_msm.py`` ``msm_g1_fused_onejit`` (:219-292),
with the reference's host helpers, :37-55 and :192-269).

1. every nonzero window digit becomes a key ``(window << 32) | digit``
   pointing at its point, and one ``torch.sort`` groups equal keys into
   runs (the reference sorts one window at a time and keeps digit 0, whose
   bucket has weight 0; here all windows are sorted together and digit 0
   is dropped);
2. :func:`seg_scan` (K6, then K1 for the carries between tiles) gives each
   key the sum of its run up to it, and the last element of every run is
   its bucket's sum, scattered into a dense (windows, 2^c) table;
3. K5 ``bucket_fold`` gives every window's sum_b b * S_b;
4. the windows are combined, most significant first, in one of two ways:
   ``'double_add'``, the generic MSM's step (2^c acc by one K2 launch,
   then one K1 add, ``msm.py:138-140``), or ``'horner'``, one K3 launch
   over the windows (the fused scan driver's ``_k_horner`` steps).

The pipeline is device-agnostic: on CPU tensors the kernel wrappers run
their plain twins.
"""

import math

import numpy as np
import torch

from .. import resolve_device
from ..bn254 import add as host_add
from . import curve, kernels, msm
from .fold import scan_schedule

COMBINES = ('double_add', 'horner')


def default_window_bits(n):
    """Pippenger window size heuristic of the reference's generic MSM
    (``msm.py:37-42``)."""
    if n <= 32:
        return 4
    c = int(math.log2(n)) - 3
    return max(4, min(13, c))


def window_digits_host_np(scalars, c):
    """Scalars as Python ints -> (ceil(254/c), B) uint32 window digits,
    window 0 least significant (``msm.py:192-204``)."""
    arr = np.asarray(scalars, dtype=object)
    n_windows = (254 + c - 1) // c
    mask = (1 << c) - 1
    out = np.zeros((n_windows, arr.shape[0]), dtype=np.uint32)
    cur = arr
    for w in range(n_windows):
        out[w] = (cur & mask).astype(np.uint32)
        cur = cur >> c
    return out


def seg_scan(P, keys, idx=None, g2=False, schedule=None,
             tiles=kernels.seg_scan_tiles, add=kernels.point_add):
    """out[j] = sum of P[idx[j]] over i <= j in j's run of equal sorted
    keys (a negative key never merges): one K6 launch (``tiles``) per level
    of tiles, the tiles' last elements scanned again, each tile's carry
    added into its leading run by K1 (``add``)."""
    log_t, items = scan_schedule(g2, *(schedule or (None, None)))
    out = tiles(P, keys, idx, g2, (log_t, items))
    n = keys.shape[0]
    tile = items << log_t
    if n <= tile:
        return out
    dev = keys.device
    last = torch.clamp(torch.arange(tile - 1, n + tile - 1, tile,
                                    device=dev), max=n - 1)
    agg_keys = keys[last].contiguous()
    agg = seg_scan(out[last].contiguous(), agg_keys, None, g2,
                   (log_t, items), tiles, add)
    # tile b >= 1 takes agg[b - 1] into its leading elements of key
    # agg_keys[b - 1]: a prefix of the tile, as the keys are sorted
    ck = agg_keys[:-1]
    first = torch.arange(1, last.shape[0], device=dev) * tile
    stop = torch.minimum(torch.searchsorted(keys, ck, right=True),
                         first + tile)
    cnt = torch.where(ck >= 0, (stop - first).clamp(min=0), 0)
    prev = torch.repeat_interleave(torch.arange(ck.shape[0], device=dev),
                                   cnt)
    if prev.numel():
        carried = torch.arange(prev.shape[0], device=dev) + \
            (first - (torch.cumsum(cnt, 0) - cnt))[prev]
        out[carried] = add(agg, out, prev, carried, g2)
    return out


def window_buckets(points, keys, src, nw, c, g2, schedule=None):
    """Sorted keys ``(window << 32) | digit`` with the point index of each
    -> (nw * 2^c, *point) dense bucket sums (identity where empty)."""
    scanned = seg_scan(points, keys, src, g2, schedule)
    is_last = torch.ones_like(keys, dtype=torch.bool)
    is_last[:-1] = keys[1:] != keys[:-1]
    run_keys = keys[is_last]
    dense = curve.identity(nw << c, g2, points.device)
    dense[(run_keys >> 32) * (1 << c) + (run_keys & 0xFFFFFFFF)] = \
        scanned[is_last]
    return dense


def combine_windows(wins, c, g2, combine):
    """(nw, *point) window sums -> (1, *point) sum_w 2^(c w) W_w."""
    if combine == 'horner':
        return msm.combine_windows(wins, c, g2)
    acc = wins[-1:]
    for w in range(wins.shape[0] - 2, -1, -1):
        acc = kernels.point_add(kernels.point_double(acc, g2, c),
                                wins[w:w + 1].contiguous(), g2=g2)
    return acc


def msm_tensor(points, digits, c, g2=False, combine='double_add',
               schedule=None):
    """sum_i (sum_w digits[w, i] 2^(c w)) * points[i] as a (1, *point)
    projective tensor, or None when every digit is zero."""
    if combine not in COMBINES:
        raise ValueError("unknown window combine %r" % (combine,))
    nw, b = digits.shape
    if points.shape[0] != b or tuple(points.shape[1:]) != \
            curve.point_shape(g2):
        raise ValueError("MSM: %d digit columns for points of shape %s"
                         % (b, tuple(points.shape)))
    if digits.device != points.device:
        raise ValueError("MSM: digits and points on different devices")
    msm.check_digit_contract(digits, c)
    ks = msm.sorted_keys(digits.to(torch.int64))
    if ks is None:
        return None
    dense = window_buckets(points.contiguous(), *ks, nw, c, g2, schedule)
    wins = kernels.bucket_fold(dense, nw, c, g2)
    return combine_windows(wins, c, g2, combine)


def to_host(res, g2):
    """(1, *point) tensor or None -> host affine point or None."""
    if res is None:
        return None
    return (curve.tensor_to_g2 if g2 else curve.tensor_to_g1)(res)[0]


def msm_g1(points, digits, c, combine='double_add'):
    """G1 scan MSM -> host affine point (None = infinity)."""
    return to_host(msm_tensor(points, digits, c, False, combine), False)


def msm_g2(points, digits, c, combine='double_add'):
    """G2 scan MSM -> host affine (Fq2, Fq2) point or None."""
    return to_host(msm_tensor(points, digits, c, True, combine), True)


def msm_g1_chunked(points, digits, c, chunk=512):
    """The scan MSM on every ``chunk`` points, the partial results added on
    the host (``msm.py:248-269``); b must be a multiple of ``chunk``."""
    b = points.shape[0]
    if b % chunk:
        raise ValueError("msm_g1_chunked: %d points, chunk %d" % (b, chunk))
    acc = None
    for off in range(0, b, chunk):
        acc = host_add(acc, msm_g1(points[off:off + chunk].contiguous(),
                                   digits[:, off:off + chunk], c))
    return acc


def _host_api(scalars, points, c, g2, device):
    if len(scalars) == 0:
        return None
    dev = resolve_device(device)
    c = c or default_window_bits(len(scalars))
    digits = torch.from_numpy(
        window_digits_host_np(scalars, c).astype(np.int64)).to(dev)
    pts = (curve.g2_to_tensor if g2 else curve.g1_to_tensor)(points, dev)
    return (msm_g2 if g2 else msm_g1)(pts, digits, c)


def msm_g1_host_api(scalars, points, c=None, device=None):
    """scalars: Python ints; points: host affine G1 points (or None) ->
    host affine point (``msm.py:148-158``).  ``device=None`` is the card."""
    return _host_api(scalars, points, c, False, device)


def msm_g2_host_api(scalars, points, c=None, device=None):
    return _host_api(scalars, points, c, True, device)
