"""Throughput of 32-bit operations on the card (counterpart of
``tools/probe_vpu.py``).

    python -m ethsnarks_tpu_torch.probe

For every op of :data:`.ops.int_probe.OPS` one K7 ``int_probe`` launch
runs ``ITERS`` chains of 16 steps ``a <- op(a, b)`` on every one of ``N``
elements (2^22: enough to fill every SM several times over, where the
reference probed one (32, 1024) block).  Each op is timed with CUDA events
(mean of ``REPS`` launches after a warm-up) and reported in Gop/s, with
its cost relative to ``u32_add``.  ``u32_mul_wide`` (the 32 x 32 -> 64-bit
product of the field core) is also reported as IMADs/s, two per product,
against the data-sheet rate :data:`.cost.IMAD_PER_S` that every bound of
the port divides by.  Then K7b ``fq_chain`` on one thread, ``FQ_ITERS``
dependent Fq products, gives t_fq, the latency of one product, the unit
of the latency floor of K2 and K3 (:func:`.cost.latency_floor_ms`).
Prints one JSON line last.  Needs the card.
"""

import json
import sys

import numpy as np
import torch

from . import cost, resolve_device
from .ops import int_probe as probe_ops, kernels

N = 1 << 22
ITERS = 256
REPS = 5
FQ_ITERS = 1 << 14


def inputs(op, n, device, seed=0):
    """(x, y) int32 words, as the reference's probe draws them: integers in
    [1, 8191), or for f32_fma float32 bits of values in [0, 1) (y below
    0.5, so the chain a <- a b + b contracts)."""
    rng = np.random.default_rng(seed)
    if op == 'f32_fma':
        x = rng.random(n, dtype=np.float32)
        y = (rng.random(n, dtype=np.float32) * 0.5).astype(np.float32)
        x, y = x.view(np.int32), y.view(np.int32)
    else:
        x = rng.integers(1, 8191, n).astype(np.int32)
        y = rng.integers(1, 8191, n).astype(np.int32)
    return (torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))


def _cuda_ms(launch, reps):
    """(ms per launch, the warm-up launch's output): CUDA events around
    reps launches after one."""
    out = launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def measure(op, x, y, iters=ITERS, reps=REPS):
    """(ms per launch, the warm-up launch's output) on the card."""
    return _cuda_ms(lambda: kernels.int_probe(op, x, y, iters), reps)


def fq_inputs(n, device, seed=0):
    """(x, y) int32 (n, 8) words of random Fq values below 2^252 < q."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=(2, n, 8), dtype=np.uint64).astype(
        np.uint32)
    w[:, :, 7] &= 0x0FFFFFFF
    x, y = (torch.from_numpy(v.view(np.int32).copy()).to(device) for v in w)
    return x, y


def t_fq_ms(iters=FQ_ITERS, reps=REPS, device=None):
    """(ms of one dependent Fq product on a lone lane, the warm-up
    launch's output): K7b on one thread, iters products, CUDA events."""
    dev = resolve_device(device)
    if dev.type != 'cuda':
        raise RuntimeError("t_fq is a time on the card: it needs a CUDA "
                           "device")
    x, y = fq_inputs(1, dev)
    ms, out = _cuda_ms(lambda: kernels.fq_chain(x, y, iters), reps)
    return ms / iters, out


def run(n=N, iters=ITERS, reps=REPS, device=None):
    """{op: Gop/s} of every probe op on the card."""
    dev = resolve_device(device)
    if dev.type != 'cuda':
        raise RuntimeError("the probe measures the card: it needs a CUDA "
                           "device")
    rates = {}
    for op in probe_ops.OPS:
        x, y = inputs(op, n, dev)
        ms, _ = measure(op, x, y, iters, reps)
        rates[op] = n * iters * probe_ops.CHAIN / (ms * 1e-3) / 1e9
    return rates


def main():
    rates = run()
    base = rates['u32_add']
    for op, v in rates.items():
        print("%-16s %10.1f Gop/s  %6.2fx cost vs u32_add" % (op, v,
                                                             base / v))
    wide = 2 * rates['u32_mul_wide'] * 1e9
    print("u32_mul_wide: %.4g IMAD/s (2 per product) = %.3f of the %.4g "
          "IMAD/s the bounds assume" % (wide, wide / cost.IMAD_PER_S,
                                        cost.IMAD_PER_S))
    t_fq = t_fq_ms()[0]
    print("t_fq: %.4f us a dependent Fq product on one lane (%d in a chain)"
          % (t_fq * 1e3, FQ_ITERS))
    print(json.dumps({"gops": rates, "imad_per_s_wide": wide,
                      "imad_per_s_model": cost.IMAD_PER_S,
                      "t_fq_us": t_fq * 1e3,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
