"""One wrapper per CUDA kernel: K1-K3 of ``csrc/msm_kernels.cu``, K4 of
``csrc/setup_kernels.cu``, K5-K6 of ``csrc/msm_fused_kernels.cu``, K7,
K7b of ``csrc/probe_kernels.cu`` and K8, K9 of ``csrc/witness_kernels.cu``.

A wrapper checks dtype, shape and contiguity, then dispatches on where the
tensors lie: on the CPU it runs the kernel's plain PyTorch twin
(:mod:`.curve`, :mod:`.fold`, :mod:`.int_probe`, :mod:`.witness_words`),
on a CUDA device it
launches the kernel on the current stream, raising if the launch reports
an error.  There is no fallback from the card to the twin.  Each kernel
keeps a launch count (``.launches``), raised by one per launch on the card
and nowhere else.
"""

import torch

from . import curve, fold, int_probe as probe_ops, witness_words
from ._build import function

MSM_SOURCE = "ethsnarks_tpu_torch/csrc/msm_kernels.cu"
SETUP_SOURCE = "ethsnarks_tpu_torch/csrc/setup_kernels.cu"
FUSED_SOURCE = "ethsnarks_tpu_torch/csrc/msm_fused_kernels.cu"
PROBE_SOURCE = "ethsnarks_tpu_torch/csrc/probe_kernels.cu"
WITNESS_SOURCE = "ethsnarks_tpu_torch/csrc/witness_kernels.cu"


class Kernel(object):
    """Record of one kernel instantiation: its C entry point, its source,
    the Pallas kernel(s) it replaces, and its launch count."""

    def __init__(self, name, entry, replaces, source=MSM_SOURCE):
        self.name = name
        self.entry = entry
        self.replaces = replaces
        self.route = "cuda"
        self.source = source
        self.launches = 0

    def launch(self, *args):
        rc = function(self.entry)(*args)
        if rc != 0:
            raise RuntimeError("%s: CUDA error %d at launch" % (self.name, rc))
        self.launches += 1


_MSM_RED = "ethsnarks_tpu/ops/msm_red.py"
_PALLAS_OPS = "ethsnarks_tpu/ops/pallas_ops.py"
_PALLAS_MSM = "ethsnarks_tpu/ops/pallas_msm.py"


def _at(path, *lines):
    return ", ".join("%s:%d" % (path, n) for n in lines)


# K1 also replaces the v1 adds of the dense halving tree and the scan
# carries (pallas_ops :230, :456); K2 the v1 doubles of the generic MSM's
# window step (:390, :482); K3 the fused MSM's window Horner kernels.
POINT_ADD = {
    False: Kernel("point_add_g1", "esn_point_add_g1",
                  _at(_MSM_RED, 171) + ", " + _at(_PALLAS_OPS, 230)),
    True: Kernel("point_add_g2", "esn_point_add_g2",
                 _at(_MSM_RED, 193) + ", " + _at(_PALLAS_OPS, 456)),
}
POINT_DOUBLE = {
    False: Kernel("point_double_g1", "esn_point_double_g1",
                  _at(_MSM_RED, 249) + ", " + _at(_PALLAS_OPS, 390)),
    True: Kernel("point_double_g2", "esn_point_double_g2",
                 _at(_MSM_RED, 268) + ", " + _at(_PALLAS_OPS, 482)),
}
# K3 also replaces _k_double_n_add_red (:454) and its G2 form (:481): 2^n P
# + Q is horner over the two windows [Q, P].
HORNER = {
    False: Kernel("horner_g1", "esn_horner_g1",
                  _at(_MSM_RED, 412, 454) + ", "
                  + _at(_PALLAS_MSM, 190, 348)),
    True: Kernel("horner_g2", "esn_horner_g2",
                 _at(_MSM_RED, 481, 515) + ", " + _at(_PALLAS_MSM, 547)),
}
FIXED_BASE_MUL = {
    False: Kernel("fixed_base_mul_g1", "esn_fixed_base_mul_g1",
                  _at(_PALLAS_OPS, 230), SETUP_SOURCE),
    True: Kernel("fixed_base_mul_g2", "esn_fixed_base_mul_g2",
                 _at(_PALLAS_OPS, 456), SETUP_SOURCE),
}
BUCKET_FOLD = {
    False: Kernel("bucket_fold_g1", "esn_bucket_fold_g1",
                  _at(_PALLAS_MSM, 130, 295), FUSED_SOURCE),
    True: Kernel("bucket_fold_g2", "esn_bucket_fold_g2",
                 _at(_PALLAS_MSM, 484), FUSED_SOURCE),
}
# K5's occupancy query (blocks an SM for a block of the given threads)
BLOCKS_PER_SM = {False: "esn_bucket_fold_blocks_g1",
                 True: "esn_bucket_fold_blocks_g2"}
# The reference scans G1 only (_k_scan); its G2 generic MSM scans with the
# same monoid in XLA.  K6 G2 is that scan on the card.
SEG_SCAN = {
    False: Kernel("seg_scan_g1", "esn_seg_scan_g1", _at(_PALLAS_MSM, 56),
                  FUSED_SOURCE),
    True: Kernel("seg_scan_g2", "esn_seg_scan_g2", _at(_PALLAS_MSM, 56),
                 FUSED_SOURCE),
}
INT_PROBE = Kernel("int_probe", "esn_int_probe", "tools/probe_vpu.py:25",
                   PROBE_SOURCE)
# K7b: the probe's latency chain of the Fq product (the reference's probe
# measures throughput only; this is the unit of K2's and K3's floor)
FQ_CHAIN = Kernel("fq_chain", "esn_fq_chain", "tools/probe_vpu.py:25",
                  PROBE_SOURCE)
# K8 and K9: the witness map, which the reference runs in XLA (no Pallas
# kernel): its mat-vecs and its transforms' stages
CSR_MATVEC = Kernel("csr_matvec_fr", "esn_csr_matvec_fr",
                    "none (XLA: ethsnarks_tpu/qap.py:82 _matvec)",
                    WITNESS_SOURCE)
NTT_PASS = Kernel("ntt_pass_fr", "esn_ntt_pass_fr",
                  "none (XLA: ethsnarks_tpu/ops/ntt.py:137 _dif, :171 _dit; "
                  "ethsnarks_tpu/qap.py:98 _witness_map_params)",
                  WITNESS_SOURCE)
MSM = [POINT_ADD[False], POINT_ADD[True], POINT_DOUBLE[False],
       POINT_DOUBLE[True], HORNER[False], HORNER[True]]
SETUP = [FIXED_BASE_MUL[False], FIXED_BASE_MUL[True]]
FUSED = [BUCKET_FOLD[False], BUCKET_FOLD[True], SEG_SCAN[False],
         SEG_SCAN[True]]
PROBE = [INT_PROBE, FQ_CHAIN]
WITNESS = [CSR_MATVEC, NTT_PASS]
ALL = MSM + SETUP + FUSED + PROBE + WITNESS

# K2 and K3 run a team of lanes a point (csrc/curve.cuh): G1 a quarter
# warp, G2 a warp
TEAM_LANES = {False: 8, True: 32}


def reset_counts():
    for k in ALL:
        k.launches = 0


def _check_points(P, g2, what):
    shape = curve.point_shape(g2)
    if P.dtype != torch.int32 or tuple(P.shape[1:]) != shape:
        raise ValueError("%s: expected int32 (n, %s) points, got %s %s"
                         % (what, ", ".join(map(str, shape)), P.dtype,
                            tuple(P.shape)))
    if not P.is_contiguous():
        raise ValueError("%s: points must be contiguous" % what)


def _check_index(idx, n, device, what):
    if idx is None:
        return
    if idx.dtype != torch.int64 or idx.dim() != 1 or idx.shape[0] != n:
        raise ValueError("%s: expected int64 (%d,) indices, got %s %s"
                         % (what, n, idx.dtype, tuple(idx.shape)))
    if not idx.is_contiguous() or idx.device != device:
        raise ValueError("%s: indices must be contiguous on %s"
                         % (what, device))


def _on_card(P):
    if P.device.type == "cpu":
        return False
    if P.device.type == "cuda":
        return True
    raise ValueError("unsupported device %s" % P.device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def point_add(P, Q, ia=None, ib=None, g2=False):
    """K1: out[i] = P[ia[i]] + Q[ib[i]] (complete projective add).

    ``ia``/``ib`` are optional int64 index vectors (absent = i); a lane
    with ``ib[i] = -1`` passes ``P[ia[i]]`` through.  Indices must lie in
    range: the kernel does not check them."""
    _check_points(P, g2, "point_add P")
    _check_points(Q, g2, "point_add Q")
    n = (ia.shape[0] if ia is not None
         else ib.shape[0] if ib is not None else P.shape[0])
    _check_index(ia, n, P.device, "point_add ia")
    _check_index(ib, n, P.device, "point_add ib")
    if Q.device != P.device:
        raise ValueError("point_add: P and Q on different devices")
    if (ia is None and P.shape[0] < n) or (ib is None and Q.shape[0] < n):
        raise ValueError("point_add: fewer points than lanes")
    if n >= 1 << 31:
        raise ValueError("point_add: %d lanes exceed int32" % n)
    if not _on_card(P):
        return curve.point_add_plain(P, Q, ia, ib, g2)
    out = torch.empty((n,) + curve.point_shape(g2), dtype=torch.int32,
                      device=P.device)
    POINT_ADD[g2].launch(P.data_ptr(), Q.data_ptr(), _ptr(ia), _ptr(ib),
                         out.data_ptr(), n, _stream(P.device))
    return out


def double_team(batch, g2, sms):
    """Whether K2 runs its team path (a team of ``TEAM_LANES[g2]`` lanes a
    point) for ``batch`` points on a card of ``sms`` SMs: while the teams
    fit in one warp a scheduler (4 an SM), a point's chain of doublings is
    the time and a team cuts it to 2 (G1) or 3 (G2) product latencies a
    step; past that the card is busy and one thread a point issues fewer
    instructions a doubling."""
    return batch * TEAM_LANES[g2] <= sms * 4 * 32


_sms = {}


def card_sms(device):
    """The SM count of a CUDA device, read once."""
    key = device.index if device.index is not None \
        else torch.cuda.current_device()
    if key not in _sms:
        _sms[key] = torch.cuda.get_device_properties(key).multi_processor_count
    return _sms[key]


def point_double(P, g2=False, n=1):
    """K2: out[i] = 2^n P[i] (n complete projective doublings), one
    launch; on the team path or one thread a point, by
    :func:`double_team`."""
    _check_points(P, g2, "point_double")
    b = P.shape[0]
    if b >= 1 << 31 or not 1 <= n < 1 << 31:
        raise ValueError("point_double: %d lanes, n=%d" % (b, n))
    if not _on_card(P):
        return curve.point_double_plain(P, g2, n)
    out = torch.empty_like(P)
    team = double_team(b, g2, card_sms(P.device))
    POINT_DOUBLE[g2].launch(P.data_ptr(), out.data_ptr(), b, int(n),
                            int(team), _stream(P.device))
    return out


def horner(W, c, g2=False):
    """K3: W (n_win, batch, *point), window 0 least significant ->
    (batch, *point) sum_w 2^(c*w) W[w], evaluated MSB first, a team of
    lanes an accumulator.  With two windows [Q, P] it is 2^c * P + Q."""
    if W.dim() < 2 or not W.is_contiguous():
        raise ValueError("horner: expected contiguous (n_win, batch, *point)"
                         " windows")
    n_win, batch = W.shape[0], W.shape[1]
    _check_points(W.reshape((n_win * batch,) + tuple(W.shape[2:])), g2,
                  "horner")
    if n_win < 1 or c < 0 or n_win * batch >= 1 << 31:
        raise ValueError("horner: bad shape (n_win=%d, batch=%d, c=%d)"
                         % (n_win, batch, c))
    if not _on_card(W):
        return curve.horner_plain(W, c, g2)
    out = torch.empty((batch,) + curve.point_shape(g2), dtype=torch.int32,
                      device=W.device)
    HORNER[g2].launch(W.data_ptr(), out.data_ptr(), n_win, batch, int(c),
                      _stream(W.device))
    return out


def fixed_base_mul(table, scalars, n_win, c, g2=False):
    """K4: out[i] = s_i * base, from the window table of the base.

    table: (n_win * 2^c, *point), entry w*2^c + d = d * 2^(c*w) * base;
    scalars: int32 (n, 8) words of 256-bit values (read c bits per window,
    least significant first).  Returns (n, *point) projective points; a
    zero scalar gives the identity (0, 1, 0)."""
    _check_points(table, g2, "fixed_base_mul table")
    if not 1 <= c <= 16 or n_win < 1 or table.shape[0] != n_win << c:
        raise ValueError("fixed_base_mul: a table of %d points for n_win=%d,"
                         " c=%d" % (table.shape[0], n_win, c))
    if scalars.dtype != torch.int32 or scalars.dim() != 2 or \
            scalars.shape[1] != 8 or not scalars.is_contiguous():
        raise ValueError("fixed_base_mul: expected contiguous int32 (n, 8) "
                         "scalars, got %s %s" % (scalars.dtype,
                                                 tuple(scalars.shape)))
    if scalars.device != table.device:
        raise ValueError("fixed_base_mul: table and scalars on different "
                         "devices")
    n = scalars.shape[0]
    if n >= 1 << 31:
        raise ValueError("fixed_base_mul: %d scalars exceed int32" % n)
    if not _on_card(table):
        return curve.fixed_base_plain(table, scalars, n_win, c, g2)
    out = torch.empty((n,) + curve.point_shape(g2), dtype=torch.int32,
                      device=table.device)
    if n == 0:
        return out
    FIXED_BASE_MUL[g2].launch(table.data_ptr(), scalars.data_ptr(),
                              out.data_ptr(), n, n_win, int(c),
                              _stream(table.device))
    return out


_occupancy = {}


def fold_occupancy(device, g2):
    """(SMs, resident K5 blocks of ``fold.FOLD_THREADS`` threads an SM) of
    a CUDA device, read once: the SM count from the device's properties,
    the blocks from CUDA's occupancy query on the built kernel."""
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), g2)
    if key not in _occupancy:
        with torch.cuda.device(key[0]):
            sms = card_sms(device)
            blocks = function(BLOCKS_PER_SM[g2])(fold.FOLD_THREADS[g2])
        if blocks < 1:
            raise RuntimeError("bucket_fold: occupancy query failed (%d)"
                               % blocks)
        _occupancy[key] = (sms, blocks)
    return _occupancy[key]


def card_shape(device, g2):
    """(SMs, K5 blocks an SM) that K5's default schedule fills on a CUDA
    device: its occupancy (:func:`fold_occupancy`), at most
    ``fold.FOLD_MAX_BLOCKS``."""
    sms, blocks = fold_occupancy(device, g2)
    return sms, min(blocks, fold.FOLD_MAX_BLOCKS[g2])


def bucket_fold(buckets, n_win, c, g2=False, schedule=None):
    """K5: (n_win * 2^c, *point) window-major buckets -> (n_win, *point)
    sum_b b * S_b per window.  ``schedule``: (threads, m, blocks) of
    :func:`.fold.fold_schedule`; default: one wave on this card
    (:func:`card_shape`), or on ``fold.PLAIN_CARD`` for CPU tensors.
    One call is one launch of K5's grid and, where a window has more than
    one block, one of its tail."""
    _check_points(buckets, g2, "bucket_fold")
    if n_win < 1 or not 0 <= c <= 24 or buckets.shape[0] != n_win << c:
        raise ValueError("bucket_fold: %d buckets for n_win=%d, c=%d"
                         % (buckets.shape[0], n_win, c))
    if n_win >= 1 << 16:
        raise ValueError("bucket_fold: %d windows exceed the grid" % n_win)
    if not _on_card(buckets):
        return fold.bucket_fold_plain(buckets, n_win, c, g2, schedule)
    dev = buckets.device
    if schedule is None:
        schedule = fold.fold_schedule(n_win, c, g2, *card_shape(dev, g2))
    T, m, n_blk = fold.check_schedule(c, g2, schedule)
    shape = curve.point_shape(g2)
    out = torch.empty((n_win,) + shape, dtype=torch.int32, device=dev)
    part = torch.empty(((2 * n_win) * n_blk,) + shape, dtype=torch.int32,
                       device=dev)
    BUCKET_FOLD[g2].launch(buckets.data_ptr(), out.data_ptr(),
                           part.data_ptr(), n_win, int(c), T, m, n_blk,
                           fold.tail_threads(n_blk, T), _stream(dev))
    return out


def seg_scan_tiles(P, keys, idx=None, g2=False, schedule=None):
    """K6, one launch: per tile of 2^log_t * items elements, out[j] = the
    sum of P[idx[j]] (P[j] without ``idx``) over the tile's elements i <= j
    in j's run of equal keys.  keys: sorted int64 (n,); a negative key
    never merges.  Runs crossing tiles are finished by
    :func:`.msm_scan.seg_scan`."""
    _check_points(P, g2, "seg_scan P")
    n = keys.shape[0]
    if keys.dtype != torch.int64 or keys.dim() != 1 or \
            not keys.is_contiguous() or keys.device != P.device:
        raise ValueError("seg_scan: expected contiguous int64 (n,) keys on "
                         "%s, got %s %s" % (P.device, keys.dtype,
                                            tuple(keys.shape)))
    _check_index(idx, n, P.device, "seg_scan idx")
    if idx is None and P.shape[0] < n:
        raise ValueError("seg_scan: fewer points than keys")
    if n >= 1 << 31:
        raise ValueError("seg_scan: %d elements exceed int32" % n)
    log_t, items = fold.scan_schedule(g2, *(schedule or (None, None)))
    if not _on_card(P):
        return fold.seg_scan_tile_plain(P, keys, idx, g2, (log_t, items))
    out = torch.empty((n,) + curve.point_shape(g2), dtype=torch.int32,
                      device=P.device)
    SEG_SCAN[g2].launch(P.data_ptr(), _ptr(idx), keys.data_ptr(),
                        out.data_ptr(), n, log_t, items, _stream(P.device))
    return out


def int_probe(op, x, y, iters):
    """K7: every element a <- op(a, b) for ``iters`` chains of
    :data:`.int_probe.CHAIN` steps; x, y int32 (n,) words (float32 bits
    for f32_fma)."""
    probe_ops.check_inputs(op, x, y)
    if iters < 0:
        raise ValueError("int_probe: negative iters")
    if not _on_card(x):
        return probe_ops.int_probe_plain(op, x, y, iters)
    out = torch.empty_like(x)
    INT_PROBE.launch(probe_ops.OPS[op], x.data_ptr(), y.data_ptr(),
                     out.data_ptr(), x.shape[0], int(iters), _stream(x.device))
    return out


def fq_chain(x, y, iters):
    """K7b: x * y^iters in Montgomery form (each product waits on the one
    before), every element on its own thread; x, y int32 (n, 8) words of
    canonical Fq values."""
    probe_ops.check_fq_inputs(x, y)
    if not 0 <= iters < 1 << 31:
        raise ValueError("fq_chain: iters=%d" % iters)
    if not _on_card(x):
        return probe_ops.fq_chain_plain(x, y, iters)
    out = torch.empty_like(x)
    FQ_CHAIN.launch(x.data_ptr(), y.data_ptr(), out.data_ptr(), x.shape[0],
                    int(iters), _stream(x.device))
    return out


def _check_words(x, what, device=None):
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != 8 or \
            not x.is_contiguous():
        raise ValueError("%s: expected contiguous int32 (n, 8) words, got "
                         "%s %s" % (what, x.dtype, tuple(x.shape)))
    if device is not None and x.device != device:
        raise ValueError("%s: on %s, expected %s" % (what, x.device, device))


def csr_matvec(row_ptr, cols, coeffs, w):
    """K8: out[r] = sum of the Montgomery products coeffs[j] w[cols[j]]
    over j in [row_ptr[r], row_ptr[r + 1]), canonical (n_rows, 8) words.
    row_ptr: int64 (n_rows + 1,); cols: int32 (nnz,), each below len(w)
    (the kernel does not check them); coeffs: (nnz, 8) canonical words; w:
    (nv, 8) canonical words."""
    _check_words(w, "csr_matvec w")
    dev = w.device
    _check_words(coeffs, "csr_matvec coeffs", dev)
    nnz = coeffs.shape[0]
    if row_ptr.dtype != torch.int64 or row_ptr.dim() != 1 or \
            not row_ptr.is_contiguous() or row_ptr.device != dev:
        raise ValueError("csr_matvec: expected contiguous int64 row "
                         "pointers on %s" % dev)
    if cols.dtype != torch.int32 or tuple(cols.shape) != (nnz,) or \
            not cols.is_contiguous() or cols.device != dev:
        raise ValueError("csr_matvec: expected contiguous int32 (%d,) "
                         "columns on %s" % (nnz, dev))
    n_rows = row_ptr.shape[0] - 1
    if not 0 <= n_rows < 1 << 31:
        raise ValueError("csr_matvec: %d rows" % n_rows)
    if not _on_card(w):
        return witness_words.csr_matvec_plain(row_ptr, cols, coeffs, w)
    out = torch.empty((n_rows, 8), dtype=torch.int32, device=dev)
    CSR_MATVEC.launch(row_ptr.data_ptr(), cols.data_ptr(), coeffs.data_ptr(),
                      w.data_ptr(), out.data_ptr(), n_rows, _stream(dev))
    return out


def ntt_pass(x, tw_inv, tw_fwd, scale, unscale, k, lo, t, g, steps):
    """K9: one pass of the witness map's transforms over the (B * 2^k, 8)
    words ``x`` of B stacked vectors (B = 3 with ``COMBINE``, which leaves
    one): the ``steps`` of :mod:`.witness_words` on index bits [lo, lo +
    t), in tiles of 2^(t + g) elements (:func:`.witness_words.ntt_ranges`).
    tw_inv, tw_fwd: (2^(k-1), 8) Montgomery twiddle series; scale, unscale:
    (2^k, 8) Montgomery planes.  Returns new canonical words."""
    ww = witness_words
    _check_words(x, "ntt_pass x")
    dev, m = x.device, 1 << k
    for p, n, what in ((tw_inv, m // 2, "tw_inv"), (tw_fwd, m // 2, "tw_fwd"),
                       (scale, m, "scale"), (unscale, m, "unscale")):
        _check_words(p, "ntt_pass " + what, dev)
        if p.shape[0] != n:
            raise ValueError("ntt_pass: %s of %d elements, expected %d"
                             % (what, p.shape[0], n))
    b = 3 if steps & ww.COMBINE else 1
    if not 1 <= k <= 28 or x.shape[0] % m or x.shape[0] // m not in (b, 3):
        raise ValueError("ntt_pass: %d words for m = 2^%d and steps %d"
                         % (x.shape[0], k, steps))
    if not (1 <= t and t + g <= ww.TILE_LOG and lo + t <= k and g >= 0
            and (g <= lo if lo else t + g <= k)):
        raise ValueError("ntt_pass: bad range lo=%d t=%d g=%d for k=%d"
                         % (lo, t, g, k))
    if not 0 < steps < 64:
        raise ValueError("ntt_pass: steps %d" % steps)
    if not _on_card(x):
        return ww.ntt_pass_plain(x, tw_inv, tw_fwd, scale, unscale, k, lo, t,
                                 steps)
    groups = x.shape[0] // m // b
    out = torch.empty((groups * m, 8), dtype=torch.int32, device=dev)
    NTT_PASS.launch(x.data_ptr(), out.data_ptr(), tw_inv.data_ptr(),
                    tw_fwd.data_ptr(), scale.data_ptr(), unscale.data_ptr(),
                    k, lo, t, g, groups, steps, _stream(dev))
    return out
