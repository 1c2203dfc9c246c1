"""Pippenger MSM over the hand-written point kernels (counterpart of
``ethsnarks_tpu/ops/msm.py:193-245`` for the window digits and of the
dense red-core pipeline ``ethsnarks_tpu/ops/msm_red.py:1477-1654``).

Sort, then segmented reduction:

1. every nonzero window digit becomes a key ``(window << 32) | digit``
   pointing at its point; ``torch.sort`` groups equal keys into runs;
2. each run (one bucket of one window) is summed by K1 ``point_add`` in
   ceil(log2(longest run)) rounds of index-pair adds (element 2j with
   2j+1 of the same run; an unpaired element passes through).  Runs may
   be of any length, so no capacity plan, overflow replan, ones filter,
   heavy-group filter or spill is needed;
3. the bucket sums are scattered into a dense (n_windows, 2^c) table and
   the weighted sum sum_b b * S_b of every window is built by the pairfold
   recursion of ``msm_red.py:337-376``: K1 at shrinking widths, then one
   K3 ``horner`` launch (c = 1) over its c totals, every window at once;
4. K3 ``horner`` combines the windows, most significant first.

The pipeline is device-agnostic: on CPU tensors the kernel wrappers run
their plain twins.
"""

import torch

from . import curve, kernels


def n_windows(c):
    return -(-254 // c)


def best_c(n):
    """Window bits for n scalars on this design: minimises the point adds,
    ceil(254/c) * (n + 2^(c+1)) (segmented sums about n per window, the
    pairfold about 2^(c+1)).  No cap at 13: digits come from 32-bit words
    and the dense table is ceil(254/c) * 2^c points."""
    return min(range(4, 21), key=lambda c: n_windows(c) * (n + (2 << c)))


def window_digits(scalars, c):
    """Canonical scalars, int32 words (b, 8) -> (ceil(254/c), b) int64
    window digits, window 0 least significant."""
    return curve.scalar_digits(scalars, n_windows(c), c)


def check_digit_contract(digits, c):
    """Raise ValueError unless every row holds digits in [0, 2^c) and the
    top row stays below 2^min(c, 254 - (n_windows-1)*c), so the implied
    scalar is below 2^254."""
    nw = digits.shape[0]
    lo = int(digits.min())
    if lo < 0:
        raise ValueError("MSM digit contract violation: negative digit %d"
                         % lo)
    row_max = digits.max(dim=1).values.tolist()
    for w, m in enumerate(row_max[:-1]):
        if m >> c:
            raise ValueError("MSM digit contract violation: window %d max "
                             "digit %d >= 2^%d" % (w, m, c))
    top_bits = min(c, max(1, 254 - (nw - 1) * c))
    if row_max[-1] >> top_bits:
        raise ValueError("MSM digit contract violation: top window max "
                         "digit %d spans more than %d bits (scalar >= "
                         "2^254)" % (row_max[-1], top_bits))


def _run_starts(run_id):
    new = torch.ones_like(run_id, dtype=torch.bool)
    new[1:] = run_id[1:] != run_id[:-1]
    return new


def bucket_sums(points, keys, src, g2):
    """Sum the points of every run of equal sorted keys.

    keys: sorted int64 (n,); src: int64 (n,) point index of each key.
    Returns (run keys (R,), run sums (R, *point))."""
    new = _run_starts(keys)
    run_keys = keys[new]
    run_id = torch.cumsum(new, 0) - 1
    n_runs = run_keys.shape[0]
    cur, idx = points, src
    while run_id.shape[0] > n_runs:
        n = run_id.shape[0]
        starts = torch.nonzero(new).squeeze(1)
        rank = torch.arange(n, device=keys.device) - starts[run_id]
        left = torch.nonzero(rank % 2 == 0).squeeze(1)
        right = torch.clamp(left + 1, max=n - 1)
        paired = (left + 1 < n) & (run_id[right] == run_id[left])
        ia = left if idx is None else idx[left]
        ib = right if idx is None else idx[right]
        ib = torch.where(paired, ib, torch.full_like(ib, -1))
        cur = kernels.point_add(cur, cur, ia, ib, g2)
        idx = None
        run_id = run_id[left]
        new = _run_starts(run_id)
    if idx is not None:
        cur = cur[idx]
    return run_keys, cur


def pairfold(dense, nw, c, g2):
    """dense: (nw * 2^c, *point) window-major buckets -> (nw, *point)
    sum_b b * S_b per window, via W(S over B) = W(S_lo + S_hi over B/2)
    + (B/2) * total(S_hi)."""
    dev = dense.device
    cur, width, totals = dense, 1 << c, []
    for _ in range(c):
        half = width // 2
        rows = torch.arange(nw, device=dev)[:, None] * width
        lo = (rows + torch.arange(half, device=dev)).reshape(-1)
        hi = lo + half
        t, tw, tbase = cur, half, rows + half       # halving tree over S_hi
        while tw > 1:
            h2 = tw // 2
            ia = (tbase + torch.arange(h2, device=dev)).reshape(-1)
            t = kernels.point_add(t, t, ia, ia + h2, g2)
            tw = h2
            tbase = torch.arange(nw, device=dev)[:, None] * tw
        totals.append(t[tbase.reshape(-1)] if t is cur else t)
        cur = kernels.point_add(cur, cur, lo, hi, g2)
        width = half
    # acc = 2 acc + t over the totals, totals[0] the most significant (the
    # reference's _padded_dbl / _padded_add loop): horner with c = 1 over
    # the totals as windows, least significant first, one lane a window
    return kernels.horner(torch.stack(totals[::-1]), 1, g2)


def sorted_keys(digits):
    """Nonzero digits as keys (window << 32) | digit, sorted, with the
    point index of each; None when every digit is zero."""
    b = digits.shape[1]
    flat = digits.reshape(-1)
    nz = torch.nonzero(flat).squeeze(1)
    if nz.numel() == 0:
        return None
    keys = (nz // b) * (1 << 32) + flat[nz]
    keys, order = torch.sort(keys)
    return keys, (nz % b)[order]


def window_sums(run_keys, sums, nw, c, g2):
    """Bucket sums of every (window, bucket) run -> (nw, *point) weighted
    window sums sum_b b * S_b."""
    dense = curve.identity(nw << c, g2, sums.device)
    dense[(run_keys >> 32) * (1 << c) + (run_keys & 0xFFFFFFFF)] = sums
    return pairfold(dense, nw, c, g2)


def combine_windows(wins, c, g2):
    """(nw, *point) window sums -> (1, *point) sum_w 2^(c w) W_w (K3)."""
    return kernels.horner(wins.reshape((wins.shape[0], 1)
                                       + tuple(wins.shape[1:])), c, g2)


def msm_tensor(points, digits, c, g2=False):
    """sum_i (sum_w digits[w, i] 2^(c w)) * points[i] as a (1, *point)
    projective tensor, or None when every digit is zero."""
    nw, b = digits.shape
    if points.shape[0] != b or tuple(points.shape[1:]) != \
            curve.point_shape(g2):
        raise ValueError("MSM: %d digit columns for points of shape %s"
                         % (b, tuple(points.shape)))
    if digits.device != points.device:
        raise ValueError("MSM: digits and points on different devices")
    check_digit_contract(digits, c)
    ks = sorted_keys(digits.to(torch.int64))
    if ks is None:
        return None
    run_keys, sums = bucket_sums(points.contiguous(), *ks, g2)
    return combine_windows(window_sums(run_keys, sums, nw, c, g2), c, g2)


def msm_g1(points, digits, c):
    """G1 MSM -> host affine point (None = infinity or all-zero scalars).
    points: (b, 3, 8) Montgomery words; digits: (n_windows, b)."""
    res = msm_tensor(points, digits, c, g2=False)
    return None if res is None else curve.tensor_to_g1(res)[0]


def msm_g2(points, digits, c):
    """G2 MSM -> host affine (Fq2, Fq2) point or None."""
    res = msm_tensor(points, digits, c, g2=True)
    return None if res is None else curve.tensor_to_g2(res)[0]
