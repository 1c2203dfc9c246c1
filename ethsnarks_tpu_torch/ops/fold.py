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
FOLD_THREADS = {g2: 1 << t for g2, t in MAX_LOG_THREADS.items()}
# the most K5 blocks an SM its default schedule fills: on an H100 G1 ran
# slower at its occupancy of 3 than at 2 (PERF.md); G2 fills its 4
FOLD_MAX_BLOCKS = {False: 2, True: 4}
# K5's (SMs, blocks an SM) where no card is asked (the plain version on
# the CPU): an H100's SMs at two blocks each
PLAIN_CARD = (132, 2)
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

def fold_schedule(n_win, c, g2, sms, blocks_per_sm, threads=None):
    """(threads, m, blocks) of K5 for n_win windows of 2^c buckets on a
    card of ``sms`` SMs that holds ``blocks_per_sm`` K5 blocks each: blocks
    of ``threads`` (default FOLD_THREADS), m buckets a thread, ``blocks``
    blocks a window.  The windows share one wave of sms * blocks_per_sm
    blocks; m is the fewest buckets a thread that lets a window's share
    cover its 2^c buckets (any count, not only a power of two), and the
    window takes only the blocks its ceil(2^c / m) parts fill."""
    if n_win < 1 or not 0 <= c <= 30 or sms < 1 or blocks_per_sm < 1:
        raise ValueError("bucket_fold: no schedule for n_win=%d, c=%d on "
                         "%d SMs x %d blocks" % (n_win, c, sms,
                                                 blocks_per_sm))
    T = FOLD_THREADS[g2] if threads is None else threads
    n = 1 << c
    per_win = max(1, sms * blocks_per_sm // n_win)
    m = -(-n // (per_win * T))
    return check_schedule(c, g2, (T, m, -(-(-(-n // m)) // T)))


def check_schedule(c, g2, schedule):
    """The schedule as ints; raises unless its blocks are of 32, 64 or 128
    threads (at most FOLD_THREADS) and cover 2^c buckets."""
    T, m, blocks = (int(v) for v in schedule)
    if T not in (32, 64, 128) or T > FOLD_THREADS[g2] or m < 1 or \
            blocks < 1 or blocks * T * m < 1 << c or m >= 1 << 31 or \
            blocks >= 1 << 31:
        raise ValueError("bucket_fold: schedule %r for 2^%d buckets"
                         % (tuple(schedule), c))
    return T, m, blocks


def tail_threads(n_blk, T):
    """Threads of K5's tail launch over a window's n_blk partials: q =
    ceil(n_blk / T) partials a thread, and the fewest warps, a power of two
    of them, that give each of its ceil(n_blk / q) threads one lane."""
    q = -(-n_blk // T)
    warps = -(-(-(-n_blk // q)) // 32)
    return 32 << (warps - 1).bit_length()


def _scale(p, k, g2):
    """k p for k >= 1, double-and-add from the top bit (the kernel's
    scale)."""
    x = p
    for b in range(k.bit_length() - 2, -1, -1):
        x = _double(x, g2)
        if (k >> b) & 1:
            x = _add(x, p, g2)
    return x


def _warp_fold(r, a, width, g2):
    """The kernel's warp_fold on (batch, lanes >= width, *point) pairs:
    per batch row (sum_l r_l, sum_l (a_l + l r_l)) over lanes l < width."""
    if width > 1:
        d = 1
        while d < width:
            r = torch.cat([_add(r[:, :width - d], r[:, d:width], g2),
                           r[:, width - d:]], 1)
            d <<= 1
        a = torch.cat([a[:, :1], _add(a[:, 1:width], r[:, 1:width], g2),
                       a[:, width:]], 1)
        d = width >> 1
        while d >= 1:
            a = torch.cat([_add(a[:, :d], a[:, d:2 * d], g2), a[:, d:]], 1)
            d >>= 1
    return r[:, 0], a[:, 0]


def _walk(items, weights, g2):
    """The kernel's walk of each lane's items (lanes, n, *point), item 0
    first, from the top: (run, acc) = (sum r_i, sum_i (a_i + i r_i)); a_i
    from ``weights`` (pass 1), or none (pass 0: buckets)."""
    n = items.shape[1]
    run = items[:, n - 1]
    tail = weights is not None
    acc = weights[:, n - 1] if tail else curve.identity(
        items.shape[0], g2, items.device)
    S = 3 if tail else 2
    k = 0
    if not tail and n > 1:
        acc, k = run, 1
    for k in range(k, (n - 1) * S):
        i, s = n - 2 - k // S, k % S
        if s == 0:
            acc = _add(acc, run, g2)
        elif s == 1:
            run = _add(run, items[:, i], g2)
        else:
            acc = _add(acc, weights[:, i], g2)
    return run, acc


def _block_fold(run, acc, span, T, partial, g2):
    """The kernel's levels on (blocks, T, *point) walks, each a scale of r
    to the lanes' span and a warp fold: the lanes of each warp, then (T >
    32) the warps of each block; a partial's r is then scaled to the
    block's span."""
    shape = curve.point_shape(g2)
    nw = T // 32
    r, a = _warp_fold(_scale(run, span, g2).reshape((-1, 32) + shape),
                      acc.reshape((-1, 32) + shape), 32, g2)
    k = 32
    if nw > 1:
        r, a = _warp_fold(_scale(r, 32, g2).reshape((-1, nw) + shape),
                          a.reshape((-1, nw) + shape), nw, g2)
        k = nw
    return (_scale(r, k, g2) if partial else r), a


def _pad(P, count, g2):
    """(rows, n, *point) -> (rows, count, *point), identities appended."""
    extra = count - P.shape[1]
    if extra == 0:
        return P
    ident = curve.identity(P.shape[0] * extra, g2, P.device).reshape(
        (P.shape[0], extra) + P.shape[2:])
    return torch.cat([P, ident], 1)


def _lane_walks(P, A, n_items, limit, T, g2):
    """The walks of (n_win, lanes * n_items, *point) items P (weights A in
    pass 1, else None), n_items a lane; a lane whose first item lies at or
    past ``limit`` is the identity.  Returns (run, acc) as (blocks, T,
    *point)."""
    n_win, lanes = P.shape[0], P.shape[1] // n_items
    shape = curve.point_shape(g2)
    rows = (n_win * lanes, n_items) + shape
    run, acc = _walk(P.reshape(rows), None if A is None else A.reshape(rows),
                     g2)
    empty = (torch.arange(lanes, device=P.device) * n_items >= limit).repeat(
        n_win)
    ident = curve.identity(n_win * lanes, g2, P.device)
    blk = (-1, T) + shape
    return (_where(empty, ident, run).reshape(blk),
            _where(empty, ident, acc).reshape(blk))


def fold_tail_plain(r, a, T, g2=False):
    """K5's tail launch on (n_win, blocks, *point) partials, r_g the
    block's span times its sum and a_g its weighted sum: per window
    sum_g (a_g + g r_g), by T threads of ceil(blocks / T) partials each."""
    n_blk = r.shape[1]
    q = -(-n_blk // T)
    run, acc = _lane_walks(_pad(r, T * q, g2), _pad(a, T * q, g2), q, n_blk,
                           T, g2)
    return _block_fold(run, acc, q, T, False, g2)[1]


def bucket_fold_plain(buckets, n_win, c, g2=False, schedule=None):
    """(n_win * 2^c, *point) window-major buckets -> (n_win, *point)
    sum_b b * S_b per window, in the order of the K5 kernel run with
    ``schedule`` (:func:`fold_schedule`; default: that of PLAIN_CARD)."""
    T, m, n_blk = check_schedule(c, g2, schedule or fold_schedule(
        n_win, c, g2, *PLAIN_CARD))
    shape = curve.point_shape(g2)
    n = 1 << c
    B = _pad(buckets.reshape((n_win, n) + shape), n_blk * T * m, g2)
    run, acc = _lane_walks(B, None, m, n, T, g2)
    r, a = _block_fold(run, acc, m, T, n_blk > 1, g2)
    if n_blk == 1:
        return a.contiguous()
    blk = (n_win, n_blk) + shape
    return fold_tail_plain(r.reshape(blk), a.reshape(blk),
                           tail_threads(n_blk, T), g2).contiguous()


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
