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
  in the run from a seeded rng;
- ``eddsa16k``: the PureEdDSA verify (fixed-base s B, the Pedersen RAM
  hash, t A, the projective compare) of 16,384 signatures in one batch:
  256 distinct ones, tiled 64 times.

Inputs are the reference's: uniform values below 2^62 from
``numpy.random.default_rng`` with its seeds, ``bytes(range(64))`` for the
preimage.  A row is timed as the reference times it, one warm-up call and
then the best of 5 (of 3 for ``sha256_preimage``), with
``torch.cuda.synchronize()`` inside each timed call.  ``eddsa16k`` signs
its 256 signatures on the host with keys below JUBJUB_L and 32-byte
messages from ``numpy.random.default_rng(99)`` (cached in
``.bench_cache/`` by seed; the host preparation is not timed), makes one
untimed pass on the valid batch and one on a tampered copy, then
``EDDSA_REPS`` timed passes, each the whole verify with the mask back on
the host.  Each row prints one
JSON line with the reference's metric name and unit, ``correct`` and
``device`` (the card's name and power limit by ``nvidia-smi``).
``correct`` is 16 lanes against the host oracle (``poseidon``,
``mimc_hash``, the MP hash), the round trip returning its input exactly,
or ``vk.verify`` of the proof; for ``eddsa16k`` every valid lane
accepting, the tampered copy refused on exactly its tampered lanes (s + 1
on lanes i % 64 = 1, one message bit flipped on i % 64 = 2, the next
signature's R on i % 64 = 3), and 16 lanes agreeing with the host
``PureEdDSA.verify``.  The exit code is 1 unless every row is correct.
"""

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from . import resolve_device
from .bench_merkle import seeded_rng
from .eddsa import PureEdDSA
from .field import FQ
from .jubjub import JUBJUB_L, Point
from .groth16 import ProverContext, generator
from .mimc import mimc_hash
from .models import BatchSha256
from .ops.eddsa_ops import eddsa_verify_device, prepare
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
EDDSA_BATCH = 16384
EDDSA_DISTINCT = 256
EDDSA_SEED = 99
EDDSA_REPS = 1
EDDSA_TAMPER = 64           # lanes i % 64 = 1, 2, 3 are tampered
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                     ".bench_cache")


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
    ctx = ProverContext(kp.pk, pb, device=dev, qap=kp.qap)
    dt, times, proof = _time(lambda: ctx.prove(pb.values), dev, SHA_REPS)
    ok = satisfied and kp.vk.verify(proof)
    return _row("sha256_preimage_prove_sec", dt,
                "s (%d constraints, verified, %s)" % (n, _kind(dev)),
                (n / dt) / 1e5, ok, times, dev)


def eddsa_signatures(n, seed=EDDSA_SEED):
    """n (A, (R, s), msg) signed by the host ``PureEdDSA.sign``: for each,
    a key in [1, JUBJUB_L) from 32 bytes of ``default_rng(seed)``, then a
    32-byte message from it (so n signatures are the first n of any
    longer run).  The row's 256 are kept in ``.bench_cache/`` by seed."""
    path = os.path.join(CACHE, "eddsa_port_seed%d_%d.json" % (seed, n))
    if n == EDDSA_DISTINCT and os.path.exists(path):
        with open(path) as fh:
            rows = json.load(fh)
        return [(Point(FQ(ax), FQ(ay)), (Point(FQ(rx), FQ(ry)), s),
                 bytes.fromhex(m)) for ax, ay, rx, ry, s, m in rows]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int.from_bytes(rng.bytes(32), 'little') % (JUBJUB_L - 1) + 1
        msg = bytes(int(x) for x in rng.integers(0, 256, 32))
        sm = PureEdDSA.sign(msg, FQ(k))
        out.append((sm.A, (sm.sig.R, sm.sig.s.n), msg))
    if n == EDDSA_DISTINCT:
        os.makedirs(CACHE, exist_ok=True)
        with open(path, "w") as fh:
            json.dump([(A.x.n, A.y.n, R.x.n, R.y.n, s, m.hex())
                       for A, (R, s), m in out], fh)
    return out


def eddsa_tampered(batch):
    """The batch with s + 1 on lanes i % 64 = 1, the first message bit
    flipped on i % 64 = 2 and the next signature's R on i % 64 = 3 ->
    (the tampered batch, the mask a verify must give)."""
    out, want = [], []
    for i, (A, (R, s), m) in enumerate(batch):
        kind = i % EDDSA_TAMPER
        if kind == 1:
            s += 1
        elif kind == 2:
            m = bytes([m[0] ^ 0x80]) + m[1:]
        elif kind == 3:
            R = batch[(i + 1) % len(batch)][1][0]
        out.append((A, (R, s), m))
        want.append(kind not in (1, 2, 3))
    return out, want


def eddsa_columns(batch):
    """(A, (R, s), msg) rows -> the keys, the signatures, the messages."""
    return [b[0] for b in batch], [b[1] for b in batch], [b[2] for b in batch]


def bench_eddsa16k(device=None):
    dev = resolve_device(device)
    B = EDDSA_BATCH
    batch = eddsa_signatures(EDDSA_DISTINCT) * (B // EDDSA_DISTINCT)
    bad, want_bad = eddsa_tampered(batch)
    valid_in = prepare(*eddsa_columns(batch), dev)
    bad_in = prepare(*eddsa_columns(bad), dev)
    verify = lambda inputs: eddsa_verify_device(*inputs).cpu()
    ok_valid = bool(verify(valid_in).all())
    got_bad = verify(bad_in).tolist()
    host = [PureEdDSA.verify(*bad[i]) for i in range(CHECK_LANES)]
    times = []
    for _ in range(EDDSA_REPS):
        _sync(dev)
        t0 = time.perf_counter()
        verify(valid_in)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    dt = min(times)
    ok = ok_valid and got_bad == want_bad and \
        got_bad[:CHECK_LANES] == host
    return _row("eddsa_verifies_per_sec", B / dt,
                "verify/s (PureEdDSA+Pedersen, batch %d, %s)" % (
                    B, _kind(dev)),
                (B / dt) / 2000.0, ok, times, dev)


WORKLOADS = {
    'poseidon1k': bench_poseidon1k,
    'mimc64k': bench_mimc64k,
    'ntt20': bench_ntt20,
    'merkle': bench_merkle,
    'sha256_preimage': bench_sha256_preimage,
    'eddsa16k': bench_eddsa16k,
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
