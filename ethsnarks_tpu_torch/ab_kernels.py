"""Times this checkout's K1 ``point_add``, K5 ``bucket_fold`` and K6
``seg_scan`` against the same kernels built from another checkout, in
turns, on one CUDA card.

    python -m ethsnarks_tpu_torch.ab_kernels OTHER_ROOT

OTHER_ROOT is another checkout of the repository, for example the parent
commit unpacked with ``git archive``. Its ``csrc/msm_kernels.cu`` is
compiled with this checkout's ``nvcc`` flags into
``OTHER_ROOT/build/ab_kernels/`` and loaded with ``ctypes``; its K1, K5
and K6 entry points must take the arguments this checkout's take. The
shapes are those of the kernel table in ``PERF.md``, made as
``chip_smoke.py`` makes them: K1 on 2^21 lanes gathered from 2^20 points;
K5 on 16 windows of 2^16 buckets, in this checkout's schedule; K6 over the
sorted nonzero window digits of 2^20 uniform scalars at c = 16, one launch
with each checkout's own tile schedule (read from its ``ops/fold.py``),
and the whole segmented scan (every level of tiles and the K1 carries,
with this checkout's ``msm_scan.seg_scan``). After a warm-up of the card,
each time is the mean of REPS launches (CUDA events), taken in the order
other, this, this, other. K1's and K5's outputs must agree word for word;
the scans' outputs must agree by value at 4,096 sampled elements. Prints
one JSON line, then the card's name and power limit.
"""

import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from .bench import scalars_np
from .bn254 import G1_GEN, G2_GEN, multiply
from .cost import OP_IMAD, bound_ms, point_bytes
from .ops import _build, curve, fold, kernels, msm, msm_scan
from .ops.fp import ints_to_words_np

SEED = 12345
LOG_N = 20
K1_LANES = 1 << 21
SAMPLE = 4096
REPS = 20


def build_other(root):
    """Compile OTHER_ROOT's msm_kernels.cu; returns the ctypes library."""
    src = os.path.join(root, "ethsnarks_tpu_torch", "csrc",
                       "msm_kernels.cu")
    out_dir = os.path.join(root, "build", "ab_kernels")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "msm_kernels.so")
    if not os.path.exists(lib):
        subprocess.run([_build._nvcc()] + _build.NVCC_FLAGS + ["-o", lib, src],
                       check=True, stdout=subprocess.DEVNULL)
    handle = ctypes.CDLL(lib)
    for fn, argtypes in _build.LIBRARIES["msm_kernels"].items():
        getattr(handle, fn).argtypes = argtypes
        getattr(handle, fn).restype = ctypes.c_int
    return handle


def scan_schedule_of(root, g2):
    """(log_t, items) of K6 by default in OTHER_ROOT's ops/fold.py."""
    with open(os.path.join(root, "ethsnarks_tpu_torch", "ops",
                           "fold.py")) as fh:
        text = fh.read()
    items = int(re.search(r"^SCAN_ITEMS = (\d+)", text, re.M).group(1))
    log_t = re.search(r"^MAX_LOG_THREADS = \{False: (\d+), True: (\d+)\}",
                      text, re.M).group(2 if g2 else 1)
    return int(log_t), items


def other_point_add(lib):
    def add(P, Q, ia=None, ib=None, g2=False):
        n = (ia if ia is not None else ib).shape[0]
        out = torch.empty((n,) + curve.point_shape(g2), dtype=torch.int32,
                          device=P.device)
        fn = lib.esn_point_add_g2 if g2 else lib.esn_point_add_g1
        rc = fn(P.data_ptr(), Q.data_ptr(),
                None if ia is None else ia.data_ptr(),
                None if ib is None else ib.data_ptr(), out.data_ptr(), n,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError("other point_add: CUDA error %d" % rc)
        return out
    return add


def other_bucket_fold(lib):
    def fold_(buckets, n_win, c, g2=False):
        log_t, log_m, log_g = fold.fold_schedule(c, g2)
        shape = curve.point_shape(g2)
        out = torch.empty((n_win,) + shape, dtype=torch.int32,
                          device=buckets.device)
        part = torch.empty(((2 * n_win) << log_g,) + shape,
                           dtype=torch.int32, device=buckets.device)
        tickets = torch.zeros(n_win, dtype=torch.int32, device=buckets.device)
        fn = lib.esn_bucket_fold_g2 if g2 else lib.esn_bucket_fold_g1
        rc = fn(buckets.data_ptr(), out.data_ptr(), part.data_ptr(),
                tickets.data_ptr(), n_win, c, log_t, log_m, log_g,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError("other bucket_fold: CUDA error %d" % rc)
        return out
    return fold_


def other_seg_scan_tiles(lib):
    def tiles(P, keys, idx=None, g2=False, schedule=None):
        log_t, items = schedule
        out = torch.empty((keys.shape[0],) + curve.point_shape(g2),
                          dtype=torch.int32, device=P.device)
        fn = lib.esn_seg_scan_g2 if g2 else lib.esn_seg_scan_g1
        rc = fn(P.data_ptr(), None if idx is None else idx.data_ptr(),
                keys.data_ptr(), out.data_ptr(), keys.shape[0], log_t, items,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError("other seg_scan: CUDA error %d" % rc)
        return out
    return tiles


def cuda_ms(fn, reps=REPS):
    """(mean ms of reps calls, the first warm-up call's output); the second
    warm-up's output is freed at once, so the timed calls reuse its block
    and no cudaMalloc falls inside the timed window."""
    out = fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def in_turns(name, fns, check):
    """Times fns['other'] and fns['this'] as other, this, this, other;
    check(a, b) must hold between the outputs."""
    ms = {"other": [], "this": []}
    outs = {}
    for who in ("other", "this", "this", "other"):
        t, outs[who] = cuda_ms(fns[who])
        ms[who].append(t)
    check(name, outs["other"], outs["this"])
    del outs
    torch.cuda.empty_cache()
    print("  %-22s other %s ms, this %s ms" % (name, ms["other"],
                                               ms["this"]), flush=True)
    return ms


def same_words(name, a, b):
    if not torch.equal(a, b):
        raise SystemExit("FAIL: %s: the two kernels' words differ" % name)


def same_values(rows, g2):
    def check(name, a, b):
        if curve.affine_ints(a[rows], g2) != curve.affine_ints(b[rows], g2):
            raise SystemExit("FAIL: %s: the two scans differ by value" % name)
    return check


def main(argv):
    if len(argv) != 1:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels: no CUDA device")
    other_root = os.path.abspath(argv[0])
    dev = torch.device("cuda")
    _build.build()
    lib = build_other(other_root)
    o_add, o_tiles = other_point_add(lib), other_seg_scan_tiles(lib)
    o_fold = other_bucket_fold(lib)
    rng = np.random.default_rng(SEED)
    rec = {}
    c = msm.best_c(1 << LOG_N)
    nw = msm.n_windows(c)
    warm = torch.randn(1 << 24, device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 2.0:      # bring the clocks up
        for _ in range(100):
            warm.mul_(1.0)
        torch.cuda.synchronize()
    for g2 in (False, True):
        tag = "g2" if g2 else "g1"
        gen = G2_GEN if g2 else G1_GEN
        base = (curve.g2_to_tensor if g2 else curve.g1_to_tensor)(
            [multiply(gen, j + 1) for j in range(256)], dev)
        table = base[torch.from_numpy(rng.integers(0, 256, 1 << LOG_N)).to(
            dev)].contiguous()
        ia = torch.from_numpy(rng.integers(0, 1 << LOG_N, K1_LANES)).to(dev)
        ib = torch.from_numpy(rng.integers(0, 1 << LOG_N, K1_LANES)).to(dev)
        ms = in_turns("point_add_" + tag, {
            "other": lambda: o_add(table, table, ia, ib, g2),
            "this": lambda: kernels.point_add(table, table, ia, ib, g2)},
            same_words)
        pb = point_bytes(g2)
        b1 = bound_ms(table.numel() * 4 + 16 * K1_LANES + pb * K1_LANES,
                      K1_LANES * OP_IMAD[("add", g2)])
        rec["point_add_" + tag] = dict(ms, bound_ms=b1[0], bound_by=b1[1])
        dense = table[:nw << c].contiguous()
        ms = in_turns("bucket_fold_" + tag, {
            "other": lambda: o_fold(dense, nw, c, g2),
            "this": lambda: kernels.bucket_fold(dense, nw, c, g2)},
            same_words)
        b5 = bound_ms(dense.numel() * 4 + nw * pb,
                      nw * (2 * (1 << c) - 3) * OP_IMAD[("add", g2)])
        rec["bucket_fold_" + tag] = dict(ms, bound_ms=b5[0], bound_by=b5[1])
        del table, ia, ib, dense

        points = base.repeat((1 << LOG_N) // 256,
                             *([1] * (base.dim() - 1))).contiguous()
        words = torch.from_numpy(ints_to_words_np(
            scalars_np(1 << LOG_N, SEED + g2))).to(dev)
        keys, src = msm.sorted_keys(msm.window_digits(words, c))
        n = keys.shape[0]
        rows = torch.from_numpy(np.sort(rng.choice(n, SAMPLE, replace=False)
                                        )).to(dev)
        merges = int((keys[1:] == keys[:-1]).sum())
        b6 = bound_ms(n * (16 + 2 * pb), merges * OP_IMAD[("add", g2)])
        o_sched = scan_schedule_of(other_root, g2)
        t_sched = fold.scan_schedule(g2)
        one = in_turns("seg_scan_%s one launch" % tag, {
            "other": lambda: o_tiles(points, keys, src, g2, o_sched),
            "this": lambda: kernels.seg_scan_tiles(points, keys, src, g2,
                                                   t_sched)},
            lambda *a: None)
        full = in_turns("seg_scan_%s all levels" % tag, {
            "other": lambda: msm_scan.seg_scan(points, keys, src, g2,
                                               o_sched, o_tiles, o_add),
            "this": lambda: msm_scan.seg_scan(points, keys, src, g2)},
            same_values(rows, g2))
        rec["seg_scan_" + tag] = dict(
            one_launch=one, all_levels=full, keys=n, merges=merges,
            schedule={"other": o_sched, "this": t_sched}, bound_ms=b6[0],
            bound_by=b6[1])
        del points, words, keys, src
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"ab_kernels": rec, "other": other_root,
                      "device": torch.cuda.get_device_name(0)}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
