"""Plain PyTorch versions of K5 ``bucket_fold`` and K6 ``seg_scan``
(``csrc/msm_fused_kernels.cu``), with the schedules the kernels run.

Counterparts: ``ethsnarks_tpu/ops/msm.py`` ``_weighted_bucket_fold``
(:70-90) and ``_segmented_bucket_sums`` (:43-67), which the Pallas kernels
``pallas_msm._k_fold`` / ``_k_fold_grid`` / ``_k_fold_grid_g2`` and
``_k_scan`` implement on the TPU.

Each function repeats its kernel's additions in the kernel's order, lane
for lane (a lane here is a thread there), so the two agree word for word;
every lane computes each step and ``torch.where`` keeps what the kernel's
branch would have kept.
"""

import torch

from . import curve

# threads per block of the kernels (FusedCfg in msm_fused_kernels.cu)
MAX_LOG_THREADS = {False: 7, True: 6}
FOLD_LOG_CHUNK = 4          # buckets a thread walks, log2, by default
SCAN_ITEMS = 64             # elements a thread walks


def _add(p, q, g2):
    """Plain complete add of two point tensors of any equal batch shape."""
    shape = curve.point_shape(g2)
    lead = p.shape[:p.dim() - len(shape)]
    return curve.add_points(p.reshape((-1,) + shape),
                            q.reshape((-1,) + shape), g2).reshape(
                                lead + shape)


def _double(p, g2):
    shape = curve.point_shape(g2)
    lead = p.shape[:p.dim() - len(shape)]
    return curve.point_double_plain(p.reshape((-1,) + shape), g2).reshape(
        lead + shape)


def _where(mask, a, b):
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim())),
                       a, b)


def _add_where(mask, p, q, other, g2):
    """p + q where mask, other elsewhere; adds only the lanes it keeps."""
    out = other.clone()
    sel = mask.nonzero(as_tuple=True)
    if sel[0].numel():
        out[sel] = _add(p[sel], q[sel], g2)
    return out


# ---------------------------------------------------------------- K5

def fold_schedule(c, g2, log_t=None, log_m=None):
    """(log_t, log_m, log_g) of K5 for 2^c buckets a window: 2^log_t
    threads a block, 2^log_m buckets a thread, 2^log_g blocks a window,
    log_t + log_m + log_g = c, and 2^log_g <= 2^log_t (the last block of a
    window combines the blocks' pairs with its threads).  Default: chunks
    of 2^FOLD_LOG_CHUNK buckets (fewer at small c), the widest block that
    leaves, longer chunks where the blocks would outnumber a block's
    threads."""
    if log_t is None:
        log_t = min(c - min(c, FOLD_LOG_CHUNK), MAX_LOG_THREADS[g2])
    if not 0 <= log_t <= min(c, MAX_LOG_THREADS[g2]):
        raise ValueError("bucket_fold: 2^%d threads a block for 2^%d "
                         "buckets" % (log_t, c))
    rest = c - log_t
    if log_m is None:
        log_m = rest - min(max(rest - FOLD_LOG_CHUNK, 0), log_t)
    log_g = rest - log_m
    if not 0 <= log_g <= log_t or log_m < 0:
        raise ValueError("bucket_fold: no schedule with 2^%d threads, 2^%d "
                         "buckets a thread for c = %d" % (log_t, log_m, c))
    return log_t, log_m, log_g


def _fold_combine(R, W, s, g2):
    """The kernel's fold_combine on (blocks, n, *point) pairs: per block
    (sum_i R_i, sum_i W_i + 2^s sum_i i R_i)."""
    n = R.shape[1]
    d = 1
    while d < n:
        R = torch.cat([_add(R[:, :n - d], R[:, d:], g2), R[:, n - d:]], 1)
        d <<= 1
    r = R[:, 0]
    R = torch.cat([curve.identity(R.shape[0], g2, R.device)[:, None],
                   R[:, 1:]], 1)
    h = n >> 1
    while h >= 1:
        R = _add(R[:, :h], R[:, h:2 * h], g2)
        W = _add(W[:, :h], W[:, h:2 * h], g2)
        h >>= 1
    x = R[:, 0]
    for _ in range(s):
        x = _double(x, g2)
    return r, _add(W[:, 0], x, g2)


def bucket_fold_plain(buckets, n_win, c, g2=False, schedule=None):
    """(n_win * 2^c, *point) window-major buckets -> (n_win, *point)
    sum_b b * S_b per window, in the order of the K5 kernel run with
    ``schedule`` (:func:`fold_schedule`)."""
    log_t, log_m, log_g = schedule or fold_schedule(c, g2)
    shape = curve.point_shape(g2)
    m = 1 << log_m
    B = buckets.reshape((-1, m) + shape)      # lane (w, g, t), its buckets
    run = B[:, m - 1]
    acc = curve.identity(B.shape[0], g2, B.device) if m == 1 else run
    for i in range(m - 2, -1, -1):
        run = _add(run, B[:, i], g2)
        if i > 0:
            acc = _add(acc, run, g2)
    blk = (n_win << log_g, 1 << log_t) + shape
    r, w = _fold_combine(run.reshape(blk), acc.reshape(blk), log_m, g2)
    if log_g == 0:
        return w.contiguous()
    win = (n_win, 1 << log_g) + shape
    _, w = _fold_combine(r.reshape(win), w.reshape(win), log_t + log_m, g2)
    return w.contiguous()


# ---------------------------------------------------------------- K6

def scan_schedule(g2, log_t=None, items=None):
    """(log_t, items) of K6: 2^log_t threads a block, ``items`` elements a
    thread, a tile of 2^log_t * items >= 2 elements a block (each level of
    tiles shrinks the next)."""
    log_t = MAX_LOG_THREADS[g2] if log_t is None else log_t
    items = SCAN_ITEMS if items is None else items
    if not 0 <= log_t <= MAX_LOG_THREADS[g2] or items < 1 or \
            items << log_t < 2:
        raise ValueError("seg_scan: 2^%d threads of %d elements"
                         % (log_t, items))
    return log_t, items


def seg_scan_tile_plain(P, keys, idx=None, g2=False, schedule=None):
    """One K6 launch: per tile of 2^log_t * items elements, out[j] = sum of
    P[idx[j]] over the elements i <= j of the tile in j's run of equal
    keys; a negative key never merges.

    The kernel's schedule: each thread (a lane here) sums its trailing run
    from its last element backwards; the lanes' (key, sum) pairs are
    scanned by a segmented Hillis-Steele scan within each warp of
    min(2^log_t, 32) lanes, then serially over the warps of the tile, each
    warp's lanes taking the sum of the warps before them; each lane then
    walks its elements forwards from the inclusive sum of the lane before
    it, merged into its first element where the key continues."""
    log_t, v = schedule or scan_schedule(g2)
    shape = curve.point_shape(g2)
    dev = keys.device
    n = keys.shape[0]
    T = 1 << log_t
    tile = T * v
    n_tiles = -(-n // tile)
    lanes = n_tiles * T
    pad = lanes * v - n
    pts = P if idx is None else P[idx]
    K = torch.cat([keys, torch.full((pad,), -1, dtype=keys.dtype,
                                    device=dev)]).reshape(lanes, v)
    X = torch.cat([pts, curve.identity(pad, g2, dev)]).reshape(
        (lanes, v) + shape)
    cnt = (n - torch.arange(lanes, device=dev) * v).clamp(0, v)
    last = (cnt - 1).clamp(min=0)
    rows = torch.arange(lanes, device=dev)
    k = torch.where(cnt > 0, K[rows, last], -1)
    # pass 1: the trailing runs, from the back
    acc = _where(cnt > 0, X[rows, last], curve.identity(lanes, g2, dev))
    run = k >= 0
    for i in range(v - 2, -1, -1):
        inside = i < last
        run = run & (~inside | (K[:, i] == k))
        acc = _add_where(run & inside, acc, X[:, i], acc, g2)
    # the warps' segmented scans
    W = min(T, 32)
    S = acc.reshape((lanes // W, W) + shape)
    Kw = k.reshape(-1, W)
    d = 1
    while d < W:
        merge = (Kw[:, d:] == Kw[:, :-d]) & (Kw[:, d:] >= 0)
        S = torch.cat([S[:, :d], _add_where(merge, S[:, :-d], S[:, d:],
                                            S[:, d:], g2)], 1)
        d <<= 1
    # the warps of each tile, serially; then each warp's lanes take the
    # inclusive sum of the warp before them where their key continues
    nw = T // W
    S = S.reshape((n_tiles, nw, W) + shape)
    Kw = Kw.reshape(n_tiles, nw, W)
    Y, KY = S[:, :, W - 1].clone(), Kw[:, :, W - 1]
    for w in range(1, nw):
        m = (KY[:, w] == KY[:, w - 1]) & (KY[:, w] >= 0)
        Y[:, w] = _add_where(m, Y[:, w - 1], Y[:, w], Y[:, w], g2)
    if nw > 1:
        m = (Kw[:, 1:] == KY[:, :-1, None]) & (Kw[:, 1:] >= 0)
        S = torch.cat([S[:, :1], _add_where(
            m, Y[:, :-1, None].expand_as(S[:, 1:]), S[:, 1:], S[:, 1:],
            g2)], 1)
    # pass 2: each lane from the inclusive sum of the lane before it
    S = S.reshape((n_tiles, T) + shape)
    Kt = k.reshape(n_tiles, T)
    acc = torch.cat([S[:, :1], S[:, :-1]], 1).reshape((lanes,) + shape)
    kl = torch.cat([torch.full((n_tiles, 1), -1, dtype=Kt.dtype,
                               device=dev), Kt[:, :-1]], 1).reshape(-1)
    outs = []
    for i in range(v):
        kj = K[:, i]
        acc = _add_where((kj == kl) & (kj >= 0), acc, X[:, i], X[:, i], g2)
        outs.append(acc)
        kl = kj
    out = torch.stack(outs, 1).reshape((lanes * v,) + shape)
    return out[:n].contiguous()
