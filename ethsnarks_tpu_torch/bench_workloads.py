"""The BASELINE.md configuration workloads on the card (counterpart of
``benchmarks/bench_workloads.py:58-110,175-248``).

    python -m ethsnarks_tpu_torch.bench_workloads [name ...]

Rows (all five by default):

- ``poseidon1k``: the Poseidon permutation (t = 6) of 1,024 random states;
- ``mimc64k``: the MiMC-e7 Miyaguchi-Preneel hash of 65,536 two-block
  messages;
- ``ntt20``: the round trip through the inverse (with 1/m) and forward
  transforms at m = 2^20, the witness map's building block;
- ``merkle``: the batched MiMC MP node trace of a Merkle level, 1,024
  nodes;
- ``sha256_preimage``: a Groth16 proof of a 512-bit SHA-256 preimage
  (``BatchSha256(1, 512)``, 60,131 constraints, m = 2^16), its key made
  in the run from a seeded rng.

Inputs are the reference's: uniform values below 2^62 from
``numpy.random.default_rng`` with its seeds, ``bytes(range(64))`` for the
preimage.  A row is timed as the reference times it, one warm-up call and
then the best of 5 (of 3 for ``sha256_preimage``), with
``torch.cuda.synchronize()`` inside each timed call.  Each row prints one
JSON line with the reference's metric name and unit, ``correct`` and
``device`` (the card's name and power limit by ``nvidia-smi``).
``correct`` is 16 lanes against the host oracle (``poseidon``,
``mimc_hash``, the MP hash), the round trip returning its input exactly,
or ``vk.verify`` of the proof.  The exit code is 1 unless every row is
correct.  The reference's ``eddsa16k`` row waits for the JubJub slice.
"""

import json
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from . import resolve_device
from .bench_merkle import seeded_rng
from .groth16 import ProverContext, generator
from .mimc import mimc_hash
from .models import BatchSha256
from .ops.fp import NH, Fr
from .ops.mimc import mimc_hash_batch, mimc_mp_witness_device
from .ops.ntt import NttDomain
from .ops.poseidon_ops import poseidon_permutation
from .poseidon import poseidon

POSEIDON_BATCH = 1024
MIMC_BATCH = 65536
NTT_LOG = 20
MERKLE_BATCH = 1024
SHA_MESSAGE = bytes(range(64))
REPS = 5
SHA_REPS = 3
CHECK_LANES = 16


def card_line(dev):
    """The card's name and power limit as nvidia-smi prints them."""
    if dev.type != 'cuda':
        return dev.type
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=%d" % (dev.index or 0)],
        capture_output=True, text=True, check=True).stdout.strip()


def _kind(dev):
    return torch.cuda.get_device_name(dev) if dev.type == 'cuda' \
        else dev.type


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def _rand(shape, seed, dev):
    """(ints, Montgomery h16 (16, *shape)): the reference's draws, uniform
    below 2^62, laid out row-major over ``shape``."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << 62, size=int(np.prod(shape)),
                        dtype=np.int64).tolist()
    return vals, Fr.ints_to_h16(vals, dev, mont=True).reshape(
        (NH,) + tuple(shape))


def _time(fn, dev, reps):
    """(best seconds, every timed run's seconds, the warm-up's result)."""
    out = fn()
    _sync(dev)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return min(times), times, out


def _row(metric, value, unit, vs_baseline, ok, times, dev):
    return {"metric": metric, "value": value, "unit": unit,
            "vs_baseline": vs_baseline, "correct": bool(ok),
            "seconds": times, "device": card_line(dev)}


def bench_poseidon1k(device=None):
    dev = resolve_device(device)
    B = POSEIDON_BATCH
    vals, state = _rand((6, B), 1, dev)
    dt, times, out = _time(lambda: poseidon_permutation(state), dev, REPS)
    got = Fr.h16_to_ints(out[:, :, :CHECK_LANES].reshape(NH, -1), mont=True)
    ok = all([got[j * CHECK_LANES + b] for j in range(6)] ==
             poseidon([vals[j * B + b] for j in range(6)], chained=True)
             for b in range(CHECK_LANES))
    return _row("poseidon_perms_per_sec", B / dt,
                "perm/s (t=6, batch %d, %s)" % (B, _kind(dev)),
                (B / dt) / 20000.0, ok, times, dev)


def bench_mimc64k(device=None):
    dev = resolve_device(device)
    B = MIMC_BATCH
    xv, xs = _rand((2, B), 2, dev)
    kv, k = _rand((B,), 3, dev)
    dt, times, out = _time(lambda: mimc_hash_batch(xs, k), dev, REPS)
    got = Fr.h16_to_ints(out[:, :CHECK_LANES], mont=True)
    ok = got == [mimc_hash([xv[b], xv[B + b]], kv[b])
                 for b in range(CHECK_LANES)]
    return _row("mimc_mp_hashes_per_sec", B / dt,
                "hash/s (e7 2-block MP, batch %d, %s)" % (B, _kind(dev)),
                (B / dt) / 100000.0, ok, times, dev)


def bench_ntt20(device=None):
    dev = resolve_device(device)
    m = 1 << NTT_LOG
    dom = NttDomain(m, dev)
    m_inv = Fr.const_mont(dom.m_inv, dev)
    _, x = _rand((m,), 4, dev)

    def round_trip():
        coeffs = Fr.mul(dom.dif(x, dom.tw_inv), m_inv)
        return dom.dit(coeffs, dom.tw_fwd)

    dt, times, out = _time(round_trip, dev, REPS)
    ok = torch.equal(out, x)
    butterflies = 2 * (m // 2) * NTT_LOG
    return _row("ntt_butterflies_per_sec", butterflies / dt,
                "butterfly/s (2x 2^%d radix-2, %s)" % (NTT_LOG, _kind(dev)),
                (butterflies / dt) / 1e8, ok, times, dev)


def bench_merkle(device=None):
    dev = resolve_device(device)
    B = MERKLE_BATCH
    lv, left = _rand((B,), 5, dev)
    rv, right = _rand((B,), 6, dev)
    iv, ivm = _rand((B,), 7, dev)
    dt, times, (out, _) = _time(
        lambda: mimc_mp_witness_device(left, right, ivm), dev, REPS)
    got = Fr.h16_to_ints(out[:, :CHECK_LANES], mont=True)
    ok = got == [mimc_hash([lv[b], rv[b]], iv[b])
                 for b in range(CHECK_LANES)]
    return _row("merkle_node_traces_per_sec", B / dt,
                "node/s (MiMC-MP witness trace, batch %d, %s)" % (
                    B, _kind(dev)),
                (B / dt) / 50000.0, ok, times, dev)


def bench_sha256_preimage(device=None):
    dev = resolve_device(device)
    model = BatchSha256(1, n_bits=8 * len(SHA_MESSAGE), device=dev)
    model.set_witness([SHA_MESSAGE])
    pb = model.pb
    satisfied = pb.is_satisfied()
    n = pb.num_constraints
    kp = generator(pb, rng=seeded_rng(), device=dev)
    ctx = ProverContext(kp.pk, pb, dev, qap=kp.qap)
    dt, times, proof = _time(lambda: ctx.prove(pb.values), dev, SHA_REPS)
    ok = satisfied and kp.vk.verify(proof)
    return _row("sha256_preimage_prove_sec", dt,
                "s (%d constraints, verified, %s)" % (n, _kind(dev)),
                (n / dt) / 1e5, ok, times, dev)


WORKLOADS = {
    'poseidon1k': bench_poseidon1k,
    'mimc64k': bench_mimc64k,
    'ntt20': bench_ntt20,
    'merkle': bench_merkle,
    'sha256_preimage': bench_sha256_preimage,
}


def main(argv=None):
    names = (sys.argv[1:] if argv is None else argv) or list(WORKLOADS)
    unknown = [name for name in names if name not in WORKLOADS]
    if unknown:
        raise SystemExit("unknown workload %s: one of %s" % (
            ", ".join(unknown), ", ".join(WORKLOADS)))
    ok = True
    for name in names:
        try:
            row = WORKLOADS[name]()
        except Exception as exc:        # one row's failure ends no other
            traceback.print_exc()
            row = {"metric": name, "error": repr(exc), "correct": False}
        ok = ok and row["correct"]
        print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
