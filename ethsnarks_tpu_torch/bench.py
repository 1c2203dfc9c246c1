"""MSM G1 points/s on the card, the repo's north-star metric (counterpart
of the root ``bench.py``).

    python -m ethsnarks_tpu_torch.bench

Prints ONE JSON line whose first keys are ``metric``, ``value`` and
``unit``; exits 1 unless the result equals the exact host oracle.  The
points are 256 distinct multiples of the generator tiled across the
2^BENCH_MSM_SIZE lanes and the scalars uniform in [0, r) from
``numpy.random.default_rng(12345)``, as in the reference, so the result
is exactly checkable: sum_i s_i P_(i mod 256) = sum_j c_j P_j with c_j the
sum of residue class j's scalars.

Env knobs:
  BENCH_MSM_SIZE  log2 number of points (default 20)
  BENCH_MSM_C     window bits (default "auto" = ops.msm.best_c)
  BENCH_REPS      timed repetitions (default 3; the best is reported)
  BENCH_MSM_MODE  red (default; ops.msm, the prover's default MSM),
                  fused (ops.msm_dense, the dense all-windows driver),
                  monolithic (ops.msm_scan, the generic scan MSM in one
                  pass), chunked (the scan MSM per 512 points, partial
                  results added on the host)

The reference's v5e VPU utilisation model is replaced by the H100 bound
of :mod:`.cost`: the IMADs of the point operations the MSM needs at least
(``model_imad_per_s``) and their share of the card's IMAD rate
(``imad_bound_pct``).  There is no subprocess probing: the reference's
was a remote-compile workaround.
"""

import json
import os
import sys
import time

import numpy as np
import torch

from . import cost, resolve_device
from .bn254 import G1_GEN, CURVE_ORDER, add, multiply
from .ops import curve, msm, msm_dense, msm_scan

BASELINE_POINTS_PER_SEC = 1.0e6
MODES = ('red', 'fused', 'monolithic', 'chunked')
N_BASE = 256
CHUNK = 512


def scalars_np(n, seed=12345):
    """n scalars uniform in [0, r): 256-bit draws reduced mod r, as an
    object array (the reference's draw, word 0 most significant)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    vals = np.zeros(n, dtype=object)
    for k in range(8):
        vals = (vals << 32) | words[:, k].astype(object)
    return vals % CURVE_ORDER


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def run(log_n=20, c=None, reps=3, mode='red', device=None):
    """One benchmark -> the JSON record (a dict); ``device=None`` is the
    card."""
    if mode not in MODES:
        raise ValueError("BENCH_MSM_MODE %r: one of %s" % (mode,
                                                          ", ".join(MODES)))
    dev = resolve_device(device)
    n = 1 << log_n
    c = c or msm.best_c(n)
    n_base = min(N_BASE, n)
    base_pts = [multiply(G1_GEN, j + 1) for j in range(n_base)]
    base = curve.g1_to_tensor(base_pts, dev)
    points = base.repeat((n // n_base, 1, 1)).contiguous()
    scalars = scalars_np(n)
    digits = torch.from_numpy(msm_scan.window_digits_host_np(
        scalars, c).astype(np.int64)).to(dev)
    class_sums = [int(scalars[j::n_base].sum()) % CURVE_ORDER
                  for j in range(n_base)]
    route = []

    def fused():
        res, r = msm_dense.msm(points, digits, c)
        route.append(r)
        return res

    fn, used = {
        'red': (lambda: msm.msm_g1(points, digits, c), 'red-sort-segmented'),
        'fused': (fused, 'fused-dense'),
        'monolithic': (lambda: msm_scan.msm_g1(points, digits, c),
                       'monolithic-scan'),
        'chunked': (lambda: msm_scan.msm_g1_chunked(
            points, digits, c, min(CHUNK, n)), 'chunked%d' % min(CHUNK, n)),
    }[mode]
    got = fn()                                  # warm-up
    times = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        got = fn()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    if route:
        used += "/" + route[-1]
    want = None
    for j in range(n_base):
        want = add(want, multiply(base_pts[j], class_sums[j]))
    ok = got == want
    dt = min(times)
    pps = n / dt
    model = cost.msm_imad(n, msm.n_windows(c), c)
    kind = (torch.cuda.get_device_name(dev) if dev.type == 'cuda'
            else dev.type)
    return {
        "metric": "msm_g1_points_per_sec_per_chip",
        "value": round(pps, 1),
        "unit": "points/s (2^%d points, c=%d, %s, %s, correct=%s)" % (
            log_n, c, used, kind, ok),
        "vs_baseline": round(pps / BASELINE_POINTS_PER_SEC, 4),
        "model_imad_per_s": round(model / dt, 1),
        "imad_bound_pct": round(100 * model / dt / cost.IMAD_PER_S, 3),
        "seconds": times,
        "correct": ok,
    }


def main():
    c_env = os.environ.get("BENCH_MSM_C", "auto")
    out = run(log_n=int(os.environ.get("BENCH_MSM_SIZE", "20")),
              c=None if c_env == "auto" else int(c_env),
              reps=int(os.environ.get("BENCH_REPS", "3")),
              mode=os.environ.get("BENCH_MSM_MODE", "red"))
    print(json.dumps(out))
    return 0 if out["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
