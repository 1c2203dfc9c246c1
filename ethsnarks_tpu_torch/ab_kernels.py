"""Times this checkout's K1 ``point_add``, K2 ``point_double``, K3
``horner``, K5 ``bucket_fold`` and K6 ``seg_scan`` against the same
kernels of another checkout, in turns, on one CUDA card.

    python -m ethsnarks_tpu_torch.ab_kernels OTHER_ROOT

OTHER_ROOT is another checkout of the repository, for example the parent
commit unpacked with ``git archive``. Its ``ethsnarks_tpu_torch`` package
is imported as ``other_port`` and builds its own kernels into
``OTHER_ROOT/build/`` (the two checkouts' builds run together), so each
kernel runs through its own checkout's wrapper, launch arguments and
default schedule. The shapes are those of the kernel table in
``PERF.md``, made as ``chip_smoke.py`` makes them: K1 on 2^21 lanes
gathered from 2^20 points; K2 at the scan MSM's window step (one lane,
2^16 P: one launch here, where the other checkout's K2 takes no n, 16
launches of one doubling as its scan MSM made them) and on 16 lanes at
n = 1; K3 on one accumulator of 16 windows at c = 16 (the window
combine) and on 16 windows of 16 lanes at c = 1 (the red pairfold's
tail); K5 on 16 windows and on 2 windows of 2^16
buckets (this checkout's K5 also in the schedules of the other block
counts an SM up to its occupancy); K6 over the sorted nonzero window
digits of 2^20 uniform scalars at c = 16, one launch and the whole
segmented scan (every level of tiles and the K1 carries). After a warm-up
of the card, each time is the mean of REPS launches (CUDA events), taken
in the order other, this, this, other; this checkout's K5 variants after
that, once each. K2 and K3 are given their latency floors
(:func:`.cost.latency_floor_ms`) from t_fq, measured once on this card by
K7b. K1's, K2's and K3's outputs must agree word for word; K5's (every
window) and the scans' (4,096 sampled elements) by value, since their
association orders may differ. Prints one JSON line, then the card's name
and power limit.
"""

import concurrent.futures
import importlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import probe
from .bench import scalars_np
from .bn254 import G1_GEN, G2_GEN, multiply
from .cost import OP_IMAD, bound_ms, horner_steps, latency_floor_ms, \
    point_bytes
from .ops import _build, curve, fold, kernels, msm, msm_scan
from .ops.fp import ints_to_words_np

SEED = 12345
LOG_N = 20
K1_LANES = 1 << 21
K5_WINDOWS = (16, 2)        # the scan MSM's and the dense driver's groups
SAMPLE = 4096
REPS = 20


def load_other(root):
    """OTHER_ROOT's package as ``other_port``: {module name: module} of its
    ops._build, ops.kernels and ops.msm_scan."""
    pkg = os.path.join(root, "ethsnarks_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "other_port", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_port"] = mod
    spec.loader.exec_module(mod)
    return {name: importlib.import_module("other_port.ops." + name)
            for name in ("_build", "kernels", "msm_scan")}


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
            raise SystemExit("FAIL: %s: the two outputs differ by value"
                             % name)
    return check


def other_double(o_kernels, g2):
    """The other checkout's 2^n P: one K2 launch where its K2 takes n,
    else n launches of one doubling."""
    if "n" in inspect.signature(o_kernels.point_double).parameters:
        return lambda P, n: o_kernels.point_double(P, g2, n)

    def loop(P, n):
        for _ in range(n):
            P = o_kernels.point_double(P, g2)
        return P
    return loop


def chain_kernels(rec, o_kernels, table, c, nw, g2, t_fq):
    """K2 and K3 at the MSM drivers' shapes, in turns, word for word, with
    their IMAD bounds and latency floors."""
    tag = "g2" if g2 else "g1"
    pb = point_bytes(g2)
    dbl, add = OP_IMAD[("double", g2)], OP_IMAD[("add", g2)]
    o_dbl = other_double(o_kernels, g2)
    for lanes, n in ((1, c), (16, 1)):
        acc = table[:lanes].contiguous()
        name = "point_double_%s %d lane%s n=%d" % (
            tag, lanes, "s" if lanes > 1 else "", n)
        ms = in_turns(name, {
            "other": lambda: o_dbl(acc, n),
            "this": lambda: kernels.point_double(acc, g2, n)}, same_words)
        b = bound_ms(2 * pb * lanes, lanes * n * dbl)
        rec[name] = dict(ms, bound_ms=b[0], bound_by=b[1],
                         latency_floor_ms=latency_floor_ms(n, g2, t_fq))
    wins = table[:nw].reshape((nw, 1) + table.shape[1:]).contiguous()
    tail = table[:c * nw].reshape((c, nw) + table.shape[1:]).contiguous()
    for W, cw, name, n_imad in (
            (wins, c, "horner_%s %dx1 c=%d" % (tag, nw, c),
             (nw - 1) * (c * dbl + add)),
            (tail, 1, "horner_%s %dx%d c=1" % (tag, c, nw),
             nw * (c - 1) * (dbl + add))):
        ms = in_turns(name, {
            "other": lambda: o_kernels.horner(W, cw, g2),
            "this": lambda: kernels.horner(W, cw, g2)}, same_words)
        b = bound_ms(pb * (W.shape[0] + 1) * W.shape[1], n_imad)
        rec[name] = dict(ms, bound_ms=b[0], bound_by=b[1],
                         latency_floor_ms=latency_floor_ms(
                             horner_steps(W.shape[0], cw), g2, t_fq))


def fold_variants(dense, nw, c, g2, dev):
    """This checkout's K5 in the schedules of 1 .. occupancy blocks an SM,
    but for its default's."""
    sms, occ = kernels.fold_occupancy(dev, g2)
    default = kernels.card_shape(dev, g2)[1]
    out = {}
    for b in range(1, occ + 1):
        if b != default:
            sched = fold.fold_schedule(nw, c, g2, sms, b)
            out["%d blocks an SM %s" % (b, sched)] = (
                lambda s=sched: kernels.bucket_fold(dense, nw, c, g2, s))
    return out


def main(argv):
    if len(argv) != 1:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels: no CUDA device")
    other_root = os.path.abspath(argv[0])
    dev = torch.device("cuda")
    other = load_other(other_root)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for job in [pool.submit(_build.build),
                    pool.submit(other["_build"].build)]:
            job.result()
    o_kernels, o_scan = other["kernels"], other["msm_scan"]
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
    t_fq = probe.t_fq_ms()[0]
    rec["t_fq_us"] = t_fq * 1e3
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
            "other": lambda: o_kernels.point_add(table, table, ia, ib, g2),
            "this": lambda: kernels.point_add(table, table, ia, ib, g2)},
            same_words)
        pb = point_bytes(g2)
        b1 = bound_ms(table.numel() * 4 + 16 * K1_LANES + pb * K1_LANES,
                      K1_LANES * OP_IMAD[("add", g2)])
        rec["point_add_" + tag] = dict(ms, bound_ms=b1[0], bound_by=b1[1])
        chain_kernels(rec, o_kernels, table, c, nw, g2, t_fq)
        for n_win in K5_WINDOWS:
            dense = table[:n_win << c].contiguous()
            name = "bucket_fold_%s_%dx2^%d" % (tag, n_win, c)
            every = torch.arange(n_win, device=dev)
            check = same_values(every, g2)
            ms = in_turns(name, {
                "other": lambda: o_kernels.bucket_fold(dense, n_win, c, g2),
                "this": lambda: kernels.bucket_fold(dense, n_win, c, g2)},
                check)
            want = kernels.bucket_fold(dense, n_win, c, g2)
            for label, fn in fold_variants(dense, n_win, c, g2,
                                           dev).items():
                t, got = cuda_ms(fn)
                check(name + " " + label, want, got)
                ms[label] = t
                print("  %-22s %s: %s ms" % (name, label, t), flush=True)
            b5 = bound_ms(dense.numel() * 4 + n_win * pb,
                          n_win * (2 * (1 << c) - 3) * OP_IMAD[("add", g2)])
            rec[name] = dict(ms, bound_ms=b5[0], bound_by=b5[1])
            del dense, want
        del table, ia, ib

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
        one = in_turns("seg_scan_%s one launch" % tag, {
            "other": lambda: o_kernels.seg_scan_tiles(points, keys, src, g2),
            "this": lambda: kernels.seg_scan_tiles(points, keys, src, g2)},
            same_values(rows, g2))
        full = in_turns("seg_scan_%s all levels" % tag, {
            "other": lambda: o_scan.seg_scan(points, keys, src, g2),
            "this": lambda: msm_scan.seg_scan(points, keys, src, g2)},
            same_values(rows, g2))
        rec["seg_scan_" + tag] = dict(
            one_launch=one, all_levels=full, keys=n, merges=merges,
            bound_ms=b6[0], bound_by=b6[1])
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
