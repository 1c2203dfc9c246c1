#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any mismatch fails the run with a non-zero exit):

1. device: the card's name and power limit; build the CUDA kernels (two
   libraries, one nvcc each, started together: ``msm_kernels`` with every
   point kernel K1-K6, ``probe_kernels`` with K7 and K7b); each kernel's
   registers, stack frame and spills from the ptxas report, and its SASS
   op mix (cuobjdump, where the toolkit has it).
2. t_fq: K7b fq_chain against its plain version, then one lone lane's
   dependent Fq product timed, the unit of the latency floors of K2 and
   K3.  Kernels vs twins: every MSM kernel (K1 point_add with and without
   index tensors, K2 point_double, K3 horner; G1 and G2) against its plain
   PyTorch version on the same card tensors, bit for bit: at 2^14 points
   with identity, P + P and P + (-P) lanes, K1 and K2 also on raw
   coordinates off the curve chosen for the field core's rare carries
   (K2 there on its one-thread path), K2 on its team path at n = 1 and
   n = c on 1 and 16 lanes (identities, P + (-P), carry edges), K3 at the
   red pairfold's tail (c windows of n_windows lanes, c = 1), at the K2/K3
   shapes of the fixture prove, and at the shapes a 2^20 MSM gives each
   kernel, where both are also timed (CUDA events; K2 and K3 with their
   latency floors).  Then K4
   fixed_base_mul (G1, G2)
   against its plain version at 2^14 scalars (0, 1, r - 1, scalars with
   zero bytes, every single-nonzero-byte position and value) and against
   host double-and-add on a sample, and at 2^20 uniform scalars, timed.
2c. K5 bucket_fold and K6 seg_scan (G1, G2) against their plain versions,
   bit for bit, at 2^14 buckets or elements with identity, P + P and
   P + (-P) steps, empty buckets, never-merging negative keys and (K6) one
   run over 16 tiles, every prefix of which must equal its host sum, in
   several schedules (K5: this card's, and those of other card sizes that
   split a window over blocks, into parts of 6 buckets, or give it one
   block); then at the shapes of a 2^20 MSM, timed (K5 at the scan MSM's
   16 windows and the dense driver's 2 and 1 windows of 2^16 buckets, each with
   its bound, schedule, registers and frame; K6 also with all its levels
   of tiles; its plain version at 2^20 of its 2^24 elements), and K5 timed
   against the red MSM's pairfold on the same buckets, which it must equal
   by value.  K5's calls are also counted by window count over every run
   of phases 5b (each MSM three times) and 6b.  K2 at the scan MSM's
   window step (one lane, n = c), timed.  K7 int_probe, every op, against
   its plain version (bit for bit; f32_fma to a relative 1e-6), with the
   measured rates.
3. setup of the fixture: the port's generator on the committed fixture's
   constraint system with the fixture's seeded rng reproduces the
   committed pk.bin and vk.json byte for byte; K4 must launch.
3b. zk on the fixture: ``generator(zk=True)`` with the same seed must
   still write the committed pk.bin and vk.json (the zk extras are not
   part of them) and launch K4 G1 for the B query in G1; an unblinded
   proof from its key must equal the committed proof.json; two blinded
   proofs (``blind=True``, a seeded rng) must verify and differ;
   ``blind=True`` on the nozk fixture key must raise ValueError.
4. prove the fixture: two proofs from one ProverContext (the key stays on
   the card); each proof's JSON must equal the reference prover's; they
   must launch K1 and K3 of both groups and no other kernel.  One proof
   each with msm_impl 'fused' and 'generic' must equal it too.
5. full size: G1 and G2 MSMs of 2^20 points (exact class-sum oracle,
   points/s; each MSM must launch K1 and K3 (twice: the pairfold's tail
   and the window combine) of its group and no other) and the witness-map
   transform chain at m = 2^20 (spot evaluations against host Horner
   sums).
5b. the same 2^20 G1 and G2 MSMs through the dense all-windows driver
   (msm_impl 'fused': must take the dense route and launch K1, K5 and K3
   of its group and no other) and the scan MSM (msm_impl 'generic': K6,
   K5, K2 (once a window, n = c) and K1), against the same oracle, timed.
5c. the same 2^20 G1 MSM on a mesh of MESH_SHARDS virtual shards of the
   card (``make_mesh(devices=[DEV] * 4)``): through ``ShardedRedMSM``
   (each shard's red MSM, the partials added by K1: K1 and K3 G1 only)
   and ``make_sharded_msm`` (each shard's scan MSM: K6, K5, K2 (once a
   window a shard) and K1 G1), each equal to the oracle, timed.
6. setup -> prove -> verify: the 261,353-constraint MiMC-e7 chain of
   tools/bench_prove.py:build_circuit(18) (m = 2^18; CHAIN_LOG, cut from
   2^20 so that the script stays inside its time limit with phases 8b and
   12: the flagship still proves at 2^20, and phase 5 keeps the 2^20
   transform chain) goes through the port's generator on the card (both
   K4 instances must launch), a ProverContext on the resulting key and two
   proofs (K1 and K3 of both groups must launch, and nothing else); each
   proof must pass vk.verify, and the proof with its input changed by one
   must fail it.
6b. one proof each from ProverContexts with msm_impl 'fused' and
   'generic' on the same key and QAP: each proof's JSON must equal the
   'red' proof's, and each must pass vk.verify.
7. the new entry points: ``python -m ethsnarks_tpu_torch.bench`` at
   BENCH_MSM_SIZE=16 in each of its four modes (each must print
   correct=True), ``python -m ethsnarks_tpu_torch.bench_workloads`` (the
   six BASELINE rows, eddsa16k's 16,384 signatures included; exit 0,
   every row correct), and the probe's main
   (``python -m ethsnarks_tpu_torch.probe``), run in this process so its
   K7 and K7b launches count.
8. the flagship at full size, on the data of ``python -m
   ethsnarks_tpu_torch.bench_merkle`` and through its functions:
   BatchMerkleMembership(29, 48) must have 48 x (29 x 733 + 1) =
   1,020,384 constraints (domain 2^20); the tree, the witness (the batched
   MiMC trace on the card, timed alone), ``is_satisfied()``, the setup
   (both K4 instances), two 'red' proofs (equal JSON, K1 and K3 of both
   groups and nothing else) and one 'fused' and one 'generic' proof, each
   equal to the 'red' proof; every proof must pass vk.verify and the one
   with its public root changed must fail it; the 'red' proof must be
   accepted by the Verifier.sol bytecode twin (``evm_verifier``) and
   refused with the root changed.  Phase 6's circuit, key and context are
   freed first; the host's peak RSS is printed.
8b. the flagship through the entry points, before phase 8 frees its
   circuit and key: ``vk2json_file`` and ``write_pk_binary`` to a
   temporary directory, ``stubs.load_proving_key`` (onto the card),
   ``stubs.make_prover_context`` and ``stubs.prove``, whose JSON must
   equal the 'red' proof's (K1 and K3 of both groups and nothing else);
   then ``stub_verify``, ``stub_main_verify``, the processed key's strong
   and weak checks, ``affine_verify_weak_IC``, ``NativeVerifier`` and
   ``NativeProcessedVK`` (strong and weak; the C++ library built by
   ``make -C native``) and ``python -m ethsnarks_tpu_torch.cli.verify``
   must each accept the proof and refuse it with the root changed;
   ``vk_to_sol`` and ``proof_to_sol`` must give Solidity.
8c. the flagship on a mesh, before phase 8 frees it: ``make_mesh(devices=
   [DEV] * 4)`` and ``ProverContext(kp.pk, cs, mesh=..., qap=kp.qap)``
   (setup seconds), one proof equal to the 'red' proof's JSON, launching
   K1 and K3 of both groups and no other kernel, passing vk.verify (its
   spans printed, the NTT's cross-stage seconds among them).  With more
   than one card, once more on a mesh of the cards (a power of two of
   them).  Then ``evm_merkle.verify_path_evm`` (the MerkleTree.sol
   VerifyPath twin at depth 29) must give the root for one of the 48
   paths and another root with one sibling changed.
9. the SHA-256 preimage (bench_workloads' sha256_preimage row):
   BatchSha256(1, 512) of bytes(range(64)) must have 60,131 constraints
   (domain 2^16); the witness (the batched SHA-256 trace on the card, which
   asserts hashlib's digest), ``is_satisfied()``, the setup (both K4
   instances), two 'red' proofs and one 'fused' and one 'generic' proof,
   all equal; every proof must pass vk.verify with [digest_hi, digest_lo]
   and fail it with digest_lo + 1; the Verifier.sol twin must accept the
   'red' proof and refuse the changed one.  Every A, B and L scalar is a
   bit: the skewed MSMs of the port at their harshest.
10. the batched Poseidon hash: BatchPoseidonHash(1024, 2) must have
   323,584 constraints (domain 2^19) on inputs uniform below r; the
   witness (the batched Poseidon trace on the card), every digest equal
   to the host poseidon, ``is_satisfied()``, the setup, the four proofs
   as in phase 9, and vk.verify once each way (the 'red' proof accepted,
   refused with one digest changed).
11. the EdDSA verify circuit: EdDSAVerify(256, PureEdDSA_gadget) must have
   8,050 constraints (domain 2^13); it takes the first signature of
   bench_workloads' eddsa16k seed (a 32-byte message); the witness (host
   curve), ``is_satisfied()``, the setup, two proofs from the default
   ('auto') context and one each with msm_impl 'red', 'fused' and
   'generic', all equal; vk.verify and the Verifier.sol twin must accept
   [A.x, A.y] and refuse the proof with the next signature's key.  Then
   the batched verify ops on that seed's first 4 signatures: the affine
   lhs = s B, the Pedersen hash's x and rhs = R + t A, read back with
   ``device_to_points``, must equal the host's, and every lane accept.
   Last, ``evm_jubjub.eddsa_verify_evm`` (the EdDSA.sol twin: t =
   sha256(R, A, M) masked to 250 bits, s B == t A) must accept the first
   signature's key, R and message signed under the contract's rule with
   that key's secret (from the same seeded draws), and refuse it with the
   next signature's key.
12. a Pinocchio circuit through its command line: a generated ``.arith``
   circuit (``pinocchio_circuit``, seeded from SEED: 2,048 blocks of every
   opcode the reader knows, tables of 1, 2 and 3 bits, input, nizkinput
   and output wires; 55,296 constraints, m = 2^16) and its ``.input``
   file, then ``python -m ethsnarks_tpu_torch.pinocchio`` as subprocesses:
   ``eval`` must print the outputs of ``CircuitReader.eval()`` in this
   process; ``genkeys`` (K4 G1 and G2 must launch), ``prove`` (must end
   with OK and launch K1 and K3 of both groups and nothing else),
   ``verify`` (rc 0), ``verify`` of the proof with its first output
   changed (rc 1) and ``test`` (setup, proof and verify in one process on
   the card; K4, K1 and K3 must launch).  The launching subprocesses run
   the module as ``__main__`` under a wrapper that prints the launch
   counts at exit; they, and phase 8b's stubs.prove, are the ``entry``
   path of the kernels line, and phases 5c and 8c its ``mesh`` path.

Launch counts are reset just before and read just after each path.  The
last lines are a JSON ``kernels`` record, the nvidia-smi line, and
``{"ok": true, "device": {...}}``.  Without CUDA the script fails.
"""

import gc
import hashlib
import json
import os
import random
import re
import resource
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ethsnarks_tpu_torch import bench, bench_merkle, bench_workloads, bn254, \
    evm_jubjub, evm_merkle, probe, stubs
from ethsnarks_tpu_torch.cli.proof2sol import proof_to_sol
from ethsnarks_tpu_torch.cli.vk2sol import vk_to_sol
from ethsnarks_tpu_torch.cost import FQ_MUL_IMAD, IMAD_PER_S, OP_IMAD, \
    bound_ms, horner_steps, latency_floor_ms, point_bytes
from ethsnarks_tpu_torch.field import CURVE_ORDER, FIELD_MODULUS, \
    SNARK_SCALAR_FIELD
from ethsnarks_tpu_torch.gadgets import MiMCe7_gadget
from ethsnarks_tpu_torch.groth16 import ProverContext, generator
from ethsnarks_tpu_torch.mimc import mimc
from ethsnarks_tpu_torch.eddsa import PureEdDSA
from ethsnarks_tpu_torch.gadgets.jubjub import PureEdDSA_gadget
from ethsnarks_tpu_torch.models import BatchMerkleMembership, \
    BatchPoseidonHash, BatchSha256, EdDSAVerify
from ethsnarks_tpu_torch.ops import _build, curve, eddsa_ops, fold, \
    int_probe, jubjub_ops, kernels, msm, msm_dense, msm_scan, witness_words
from ethsnarks_tpu_torch.ops.batch_exp import BatchExp, C, N_WIN
from ethsnarks_tpu_torch.ops.fp import Fq, Fr, words_to_h16, \
    ints_to_words_np, words_to_ints, h16_to_words
from ethsnarks_tpu_torch.ops.ntt import NttDomain
from ethsnarks_tpu_torch.jubjub import JUBJUB_L
from ethsnarks_tpu_torch.parallel import make_mesh
from ethsnarks_tpu_torch.parallel.msm_red_sharded import get_sharded_msm
from ethsnarks_tpu_torch.parallel.msm_sharded import make_sharded_msm
from ethsnarks_tpu_torch.pinocchio import CircuitReader
from ethsnarks_tpu_torch.poseidon import poseidon
from ethsnarks_tpu_torch.qap import WordWitnessMap, h_coefficients
from ethsnarks_tpu_torch.r1cs import ConstraintSystem
from ethsnarks_tpu_torch.serialization import read_pk_binary, \
    r1cs_from_dict, vk2json_file, witness_from_json, write_pk_binary
from ethsnarks_tpu_torch.verifier import NativeVerifier, Proof, \
    VerifyingKey, affine_verify_weak_IC

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "ethsnarks_tpu_torch", "fixtures",
                       "mimc_chain_10")
SEED = 12345
SETUP_SEED = 20261016           # the fixture's setup rng seed
DEV = torch.device("cuda")
CHECK_POINTS = 1 << 14          # points per kernel-vs-twin comparison
TIME_LANES = 1 << 21            # K1 timing lanes (gathers from 2^20 points)
FULL_LOG = 20                   # MSM points, transform domain, flagship
CHAIN_LOG = 18                  # phase 6's MiMC chain (cut from 2^20)
SCAN_PLAIN_LOG = 20             # K6's plain version is timed on 2^20 elements
MERKLE_PROOFS = 48              # the flagship: 48 depth-29 proofs, m = 2^20
MERKLE_DEPTH = bench_merkle.DEPTH
SHA_MESSAGE = bench_workloads.SHA_MESSAGE
SHA_CONSTRAINTS = 60131         # BatchSha256(1, 512), domain 2^16
POSEIDON_INSTANCES = 1024       # 1,024 x 316 = 323,584 constraints
POSEIDON_LOG = 19
EDDSA_MSG_BITS = 256            # EdDSAVerify(256): 8,050 constraints
EDDSA_CONSTRAINTS = 8050
EDDSA_LOG = 13
EDDSA_LANES = 4                 # the batched verify's intermediates
PINOCCHIO_BLOCKS = 2048         # 27 constraints a block: 55,296, m = 2^16
PINOCCHIO_LOG = 16
MESH_SHARDS = 4                 # phases 5c and 8c: virtual shards on DEV


def log(*args):
    print(*args, flush=True)


def card_state(where):
    """Log the card's SM clock, its maximum, power draw and temperature."""
    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    log("  card state %s: %s (SM clock, max SM clock, power, temperature)"
        % (where, q))


def fail(msg):
    raise SystemExit("FAIL: " + msg)


def cuda_ms(fn, reps=5, warm=True):
    """(mean CUDA-event ms of reps calls after a warm-up, the warm-up's
    result); warm=False times one call, the one whose result it returns.
    A second warm-up call, whose output is freed at once, leaves the
    allocator a block for the timed calls' outputs, which are freed as
    they come: no cudaMalloc falls inside the timed window."""
    if not warm:
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        res = fn()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1), res
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


# ---------------------------------------------------------------- build

def compiler_report(text):
    """ptxas -v report -> {function: {registers, stack_frame, spill_stores,
    spill_loads}} (registers for kernels only)."""
    out, entry, prop = {}, None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            out.setdefault(entry, {})
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            prop = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and prop:
            out.setdefault(prop, {}).update(
                stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
            prop = None
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry]["registers"] = int(m.group(1))
    return out


def kernel_symbol(k, names, suffix=""):
    """The mangled name of kernel k's __global__ function (``k_<name>`` and
    ``suffix``, with its length prefix) among names."""
    base = "k_" + re.sub(r"_g[12]$", "", k.name) + suffix
    base = "%d%s" % (len(base), base)
    tag = {"_g1": "INS_2fqE", "_g2": "INS_3fq2E"}.get(k.name[-3:], "")
    return next((name for name in names if base in name and tag in name),
                None)


def sass_mix(lib, symbols):
    """{symbol: {instructions, IMAD (all forms), IMAD_WIDE, IADD3, LDL,
    STL}} from cuobjdump -sass of a built library (None where the toolkit
    has no cuobjdump)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), dict(
                instructions=0, IMAD=0, IMAD_WIDE=0, IADD3=0, LDL=0,
                STL=0)) if m.group(1) in symbols else None
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if m and cur is not None:
            op = m.group(1)
            cur["instructions"] += 1
            if op.split(".")[0] in cur:
                cur[op.split(".")[0]] += 1
            if op.startswith("IMAD.WIDE"):
                cur["IMAD_WIDE"] += 1
    return out


# ---------------------------------------------------------------- inputs

def base_points(g2, count=256):
    gen = bn254.G2_GEN if g2 else bn254.G1_GEN
    pts = [bn254.multiply(gen, j + 1) for j in range(count)]
    conv = curve.g2_to_tensor if g2 else curve.g1_to_tensor
    return pts, conv(pts, DEV)


def random_fq(n, rng):
    w = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64).astype(
        np.uint32)
    w[:, 7] &= 0x0FFFFFFF                      # < 2^252 < q
    return words_to_h16(torch.from_numpy(w.view(np.int32)).to(DEV))


def rescale(P, lam, g2):
    """(X, Y, Z) -> (lam X, lam Y, lam Z): the same points, other
    projective coordinates."""
    lam = lam[..., None] if g2 else lam
    return curve.pack([Fq.mul(c, lam) for c in curve.unpack(P)])


def negate(P):
    x, y, z = curve.unpack(P)
    return curve.pack([x, Fq.neg(y), z])


def test_points(base, n, rng, g2):
    """n projective points: random multiples of the generator with random
    Z, and lanes that stress completeness: Q = P (same coordinates),
    Q = P (other coordinates), Q = -P, identities on either side."""
    P = rescale(base[torch.from_numpy(rng.integers(0, len(base), n)).to(DEV)],
                random_fq(n, rng), g2)
    Q = rescale(base[torch.from_numpy(rng.integers(0, len(base), n)).to(DEV)],
                random_fq(n, rng), g2)
    Q[0:64] = P[0:64]
    Q[64:128] = rescale(P[64:128], random_fq(64, rng), g2)
    Q[128:192] = negate(P[128:192])
    ident = curve.identity(64, g2, DEV)
    P[192:256] = ident
    Q[256:320] = ident
    P[320:384] = ident
    Q[320:384] = ident
    return P.contiguous(), Q.contiguous()


def carry_edge_points(n, g2, rng):
    """n raw coordinate triples, not on the curve, for the field core's rare
    carries: every coordinate (each Fq part on G2) holds the Montgomery
    words of 0, 1, q - 1, q - 2^32, 2^255 mod q, or a random value below q
    whose low words are all ones."""
    q = FIELD_MODULUS
    vals = [0, 1, q - 1, q - (1 << 32), (1 << 255) % q]
    for k in range(1, 8):
        vals.append((int.from_bytes(rng.bytes(32), "little")
                     | ((1 << (32 * k)) - 1)) % q)
    pick = rng.integers(0, len(vals), n * (6 if g2 else 3))
    words = ints_to_words_np([vals[i] for i in pick])
    return torch.from_numpy(words).reshape(
        (n,) + curve.point_shape(g2)).to(DEV)


def same(name, got, want):
    """Max |kernel - plain| over the int32 words; fails unless 0."""
    if got.shape != want.shape:
        fail("%s: shapes %s and %s" % (name, tuple(got.shape),
                                       tuple(want.shape)))
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err != 0:
        fail("%s: kernel and plain version differ (max |err| %d)"
             % (name, err))
    log("  %-34s bit-exact over %d points" % (name, got.shape[0]))
    return err


# ---------------------------------------------------------------- phase 2

def phase_fq_chain():
    """K7b against its plain version, word for word, on 256 lanes of 64
    dependent products; then t_fq, one dependent Fq product on a lone
    lane (probe.t_fq_ms), the unit of K2's and K3's latency floors."""
    log("== phase 2: t_fq (K7b fq_chain), then K1-K3 vs plain twins")
    k = kernels.FQ_CHAIN
    x, y = probe.fq_inputs(256, DEV, seed=1)
    iters = 64
    plain_ms, want = cuda_ms(lambda: int_probe.fq_chain_plain(x, y, iters),
                             warm=False)
    err = same("K7b %s (256 lanes x %d)" % (k.name, iters),
               kernels.fq_chain(x, y, iters), want)
    t_fq, _ = probe.t_fq_ms()
    ms = t_fq * probe.FQ_ITERS
    b_ms, b_by = bound_ms(3 * 32, probe.FQ_ITERS * FQ_MUL_IMAD)
    log("  %-16s one lane x %d products: %.4f ms, t_fq = %.4f us; plain "
        "%.2f ms (256 lanes x %d); bound %.6f ms (%s)" % (
            k.name, probe.FQ_ITERS, ms, t_fq * 1e3, plain_ms, iters, b_ms,
            b_by))
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, t_fq_ms=t_fq,
               shape="one lane, %d dependent products" % probe.FQ_ITERS,
               plain_shape="256 lanes x %d products" % iters)
    return t_fq, {k.name: rec}


def phase_kernels(rng, fixture_cs, t_fq):
    """Every kernel against its plain twin, bit for bit: on 2^14 random
    lanes with completeness edge cases (K2 there on its one-thread path),
    K2 at n = 1 and n = c on 1 and 16 lanes (its team path) on curve
    points and carry-edge coordinates, K3 at the red MSM's pairfold tail
    and at the fixture prove's window widths ``fixture_cs``, and on the
    2^20-MSM shapes at which each kernel is timed, with its IMAD bound and,
    for K2 and K3, its latency floor in units of ``t_fq``."""
    rec = {}
    c = msm.best_c(1 << 20)
    nw = msm.n_windows(c)
    for g2 in (False, True):
        tag = "g2" if g2 else "g1"
        k_add, k_dbl, k_hor = (kernels.POINT_ADD[g2], kernels.POINT_DOUBLE[g2],
                               kernels.HORNER[g2])
        errs = {k_add: [], k_dbl: [], k_hor: []}
        _, base = base_points(g2)
        n = CHECK_POINTS
        P, Q = test_points(base, n, rng, g2)
        errs[k_add].append(same(
            "K1 point_add_%s" % tag, kernels.point_add(P, Q, g2=g2),
            curve.point_add_plain(P, Q, g2=g2)))
        ia = torch.from_numpy(rng.integers(0, n, n)).to(DEV)
        ib = torch.from_numpy(rng.integers(-1, n, n)).to(DEV)
        ib[:512] = -1
        errs[k_add].append(same(
            "K1 point_add_%s (indices)" % tag,
            kernels.point_add(P, Q, ia, ib, g2),
            curve.point_add_plain(P, Q, ia, ib, g2)))
        errs[k_dbl].append(same(
            "K2 point_double_%s (one thread a point)" % tag,
            kernels.point_double(P, g2), curve.point_double_plain(P, g2)))
        # raw triples off the curve that reach the rare carries of the
        # field core: the formulas are polynomials, so the two still agree
        E, F = carry_edge_points(n, g2, rng), carry_edge_points(n, g2, rng)
        errs[k_add].append(same(
            "K1 point_add_%s (carry edges)" % tag,
            kernels.point_add(E, F, g2=g2), curve.point_add_plain(E, F, g2=g2)))
        errs[k_add].append(same(
            "K1 point_add_%s (carry edges, indices)" % tag,
            kernels.point_add(E, F, ia, ib, g2),
            curve.point_add_plain(E, F, ia, ib, g2)))
        errs[k_dbl].append(same(
            "K2 point_double_%s (carry edges, one thread a point)" % tag,
            kernels.point_double(E, g2), curve.point_double_plain(E, g2)))
        # K2's team path, at the lanes the drivers give it: the identity
        # (P[192:256]) and P + (-P) (a lane of 2^n (0, Y, 0)) among them
        PmP = curve.point_add_plain(P[128:144], Q[128:144], g2=g2)
        for lanes in (1, 16):
            for pts, what in ((P[184:184 + lanes], "curve, identities"),
                              (PmP[:lanes], "P + (-P)"),
                              (E[:lanes], "carry edges")):
                pts = pts.contiguous()
                for nd in (1, c):
                    if not kernels.double_team(lanes, g2,
                                               kernels.card_sms(DEV)):
                        fail("K2 %s: %d lanes not on the team path"
                             % (tag, lanes))
                    errs[k_dbl].append(same(
                        "K2 point_double_%s (%d lane%s, n=%d, %s)" % (
                            tag, lanes, "s" if lanes > 1 else "", nd, what),
                        kernels.point_double(pts, g2, nd),
                        curve.point_double_plain(pts, g2, nd)))
        del E, F, PmP
        for n_win, c_test in ((2, 5), (4, 3)):
            W = P.reshape((n_win, n // n_win) + P.shape[1:]).contiguous()
            errs[k_hor].append(same(
                "K3 horner_%s (%d windows, c=%d)" % (tag, n_win, c_test),
                kernels.horner(W, c_test, g2),
                curve.horner_plain(W, c_test, g2)))
        # the red MSM's pairfold tail at the 2^20 MSM's shape: c windows
        # (the totals) of nw lanes, c = 1; identities among them
        W = P[128:128 + c * nw].reshape((c, nw) + P.shape[1:]).contiguous()
        errs[k_hor].append(same(
            "K3 horner_%s (%d windows x %d, c=1)" % (tag, c, nw),
            kernels.horner(W, 1, g2), curve.horner_plain(W, 1, g2)))
        # the fixture prove's shapes: the red pairfold's K3 tail (cf
        # windows of nw lanes), K3 on one accumulator over nw windows, and
        # the generic combine's K2 on one lane, n = cf
        for cf in fixture_cs:
            nwf = msm.n_windows(cf)
            W = P[:cf * nwf].reshape((cf, nwf) + P.shape[1:]).contiguous()
            errs[k_hor].append(same(
                "K3 horner_%s (%d windows x %d, c=1)" % (tag, cf, nwf),
                kernels.horner(W, 1, g2), curve.horner_plain(W, 1, g2)))
            W = P[:nwf].reshape((nwf, 1) + P.shape[1:]).contiguous()
            errs[k_hor].append(same(
                "K3 horner_%s (%d windows x 1, c=%d)" % (tag, nwf, cf),
                kernels.horner(W, cf, g2), curve.horner_plain(W, cf, g2)))
            errs[k_dbl].append(same(
                "K2 point_double_%s (1 lane, n=%d)" % (tag, cf),
                kernels.point_double(P[:1].contiguous(), g2, cf),
                curve.point_double_plain(P[:1].contiguous(), g2, cf)))

        # the shapes of a 2^20-point MSM, timed and compared: K1's first
        # segmented round gathers pairs from the 2^20-point table (8M lanes
        # there, timed at TIME_LANES); K2 is the scan MSM's window step
        # (one lane, n = c) and also timed at 16 lanes and n = 1; K3
        # combines the nw window sums (one accumulator, c) and is the red
        # pairfold's tail (c windows of nw lanes, c = 1)
        table = base[torch.from_numpy(rng.integers(0, 256, 1 << 20)).to(
            DEV)].contiguous()
        lanes = TIME_LANES
        ia = torch.from_numpy(rng.integers(0, 1 << 20, lanes)).to(DEV)
        ib = torch.from_numpy(rng.integers(0, 1 << 20, lanes)).to(DEV)
        pb = point_bytes(g2)
        wins = table[:nw].reshape((nw, 1) + table.shape[1:]).contiguous()
        tail = table[:c * nw].reshape((c, nw) + table.shape[1:]).contiguous()
        dbl, add = OP_IMAD[("double", g2)], OP_IMAD[("add", g2)]

        def k2_shape(n_pts, nd):
            acc = table[:n_pts].contiguous()
            return (lambda: kernels.point_double(acc, g2, nd),
                    lambda: curve.point_double_plain(acc, g2, nd),
                    2 * pb * n_pts, n_pts * nd * dbl, nd,
                    "%d lane%s, n=%d" % (n_pts, "s" if n_pts > 1 else "",
                                         nd))

        shapes = [
            (k_add, "", (
                lambda: kernels.point_add(table, table, ia, ib, g2),
                lambda: curve.point_add_plain(table, table, ia, ib, g2),
                table.numel() * 4 + 16 * lanes + pb * lanes,
                lanes * add, None, "%d lanes from a 2^20 table" % lanes)),
            (k_dbl, "", k2_shape(1, c)),
            (k_dbl, "16 lanes, n=1", k2_shape(16, 1)),
            (k_dbl, "1 lane, n=1", k2_shape(1, 1)),
            (k_hor, "", (
                lambda: kernels.horner(wins, c, g2),
                lambda: curve.horner_plain(wins, c, g2),
                pb * (nw + 1),
                (nw - 1) * (c * dbl + add), horner_steps(nw, c),
                "%d windows x 1, c=%d" % (nw, c))),
            (k_hor, "pairfold tail", (
                lambda: kernels.horner(tail, 1, g2),
                lambda: curve.horner_plain(tail, 1, g2),
                pb * (c + 1) * nw, nw * (c - 1) * (dbl + add),
                horner_steps(c, 1), "%d windows x %d, c=1" % (c, nw))),
        ]
        for k, extra, (kfn, pfn, n_bytes, n_imad, steps, shape) in shapes:
            ms, got = cuda_ms(kfn)
            plain_ms, want = cuda_ms(pfn, reps=1)
            errs[k].append(same("%s (%s)" % (k.name, shape), got, want))
            del got, want
            b_ms, b_by = bound_ms(n_bytes, n_imad)
            r = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     shape=shape)
            floor = ""
            if steps is not None:
                r["latency_floor_ms"] = latency_floor_ms(steps, g2, t_fq)
                r["steps"] = steps
                floor = "  latency floor %8.4f ms (%d steps)" % (
                    r["latency_floor_ms"], steps)
            if extra:
                rec[k.name].setdefault("other_shapes", {})[extra] = r
            else:
                rec[k.name] = r
            log("  %-16s %-30s kernel %10.4f ms  plain %10.2f ms  "
                "bound %8.6f ms (%s)%s" % (k.name, shape, ms, plain_ms, b_ms,
                                           b_by, floor))
        for k in (k_add, k_dbl, k_hor):
            rec[k.name]["max_abs_err"] = max(errs[k])
        del table, ia, ib, wins, tail
        torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------- phase 4

def fixture_context():
    """The fixture's ProverContext on the card (key uploaded once)."""
    cs = fixture_cs()
    t0 = time.perf_counter()
    pk = read_pk_binary(os.path.join(FIXTURE, "pk.bin"), DEV)
    ctx = ProverContext(pk, cs, device=DEV)
    log("  fixture key load + context: %.3f s (m = %d, c = %s)"
        % (time.perf_counter() - t0, ctx.qap.domain_size, ctx.c))
    return ctx


def launch_counts():
    return {k.name: k.launches for k in kernels.ALL}


RED_KERNELS = [kernels.POINT_ADD[False], kernels.POINT_ADD[True],
               kernels.HORNER[False], kernels.HORNER[True]]


def check_red_launches(launches, what, mesh=False):
    """'red' proofs launch K1 and K3 of both groups (K3 twice an MSM: the
    pairfold's tail and the window combine) and, on one card, the witness
    map's K8 and K9; no other kernel."""
    want = set(RED_KERNELS) | (set() if mesh else set(kernels.WITNESS))
    ran = {k for k in kernels.ALL if launches[k.name]}
    if ran != want:
        fail("%s launched %s; expected %s" % (
            what, sorted(k.name for k in ran),
            sorted(k.name for k in want)))


def phase_prove(ctx):
    log("== phase 4: prove the fixture")
    witness = witness_from_json(os.path.join(FIXTURE, "witness.json"))
    with open(os.path.join(FIXTURE, "proof.json")) as fh:
        expected = fh.read()
    kernels.reset_counts()
    profiles = []
    for rep in range(2):
        t0 = time.perf_counter()
        proof = ctx.prove(witness)
        dt = time.perf_counter() - t0
        if proof.to_json() != expected:
            fail("proof %d JSON differs from the reference proof" % rep)
        profiles.append(ctx.last_profile)
        log("  proof %d: %.3f s, JSON equal to the reference; phases %s"
            % (rep, dt, json.dumps({k: round(v, 4) for k, v in
                                    ctx.last_profile.items()})))
    launches = launch_counts()
    log("  launches over the two proofs: %s" % json.dumps(launches))
    check_red_launches(launches, "the fixture prove")
    for impl in ("fused", "generic"):
        other = ProverContext(ctx.pk, None, device=DEV, qap=ctx.qap,
                              msm_impl=impl)
        t0 = time.perf_counter()
        proof = other.prove(witness)
        if proof.to_json() != expected:
            fail("msm_impl=%r: the fixture proof differs from the reference"
                 % impl)
        log("  msm_impl=%r: %.3f s, JSON equal to the reference; routes %s"
            % (impl, time.perf_counter() - t0, other.last_routes))
    return launches, profiles


# ---------------------------------------------------------------- phase 5

def random_scalars(n, rng):
    """Uniform-ish scalars in [0, r): 256-bit draws reduced mod r."""
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    vals = np.zeros(n, dtype=object)
    for k in range(7, -1, -1):
        vals = (vals << 32) | words[:, k].astype(object)
    return vals % CURVE_ORDER


def phase_msm(g2, rng, reps=3):
    tag = "G2" if g2 else "G1"
    log_n = FULL_LOG
    n = 1 << log_n
    t0 = time.perf_counter()
    base_host, base = base_points(g2)
    points = base.repeat((n // 256,) + (1,) * (base.dim() - 1)).contiguous()
    scalars = random_scalars(n, rng)
    words = torch.from_numpy(ints_to_words_np(scalars)).to(DEV)
    want = None
    for j in range(256):
        cls = int(scalars[j::256].sum()) % CURVE_ORDER
        want = bn254.add(want, bn254.multiply(base_host[j], cls))
    log("  %s set-up (points, scalars, class-sum oracle): %.2f s"
        % (tag, time.perf_counter() - t0))
    c = msm.best_c(n)
    run = msm.msm_g2 if g2 else msm.msm_g1
    times, launches = [], []
    for rep in range(reps + 1):
        kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        digits = msm.window_digits(words, c)
        got = run(points, digits, c)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches.append(launch_counts())
        if got != want:
            fail("%s MSM at 2^%d differs from the class-sum oracle"
                 % (tag, log_n))
    if any(cnt != launches[0] for cnt in launches):
        fail("%s MSM: launch counts differ between runs: %s" % (tag,
                                                                launches))
    # K1 (bucket sums and pairfold), K3 twice (pairfold tail and window
    # combine), no K2 and nothing else
    for k in kernels.ALL:
        count = launches[0][k.name]
        expect = {kernels.POINT_ADD[g2]: count > 0,
                  kernels.HORNER[g2]: count == 2}.get(k, count == 0)
        if not expect:
            fail("%s MSM: kernel %s launched %d times" % (tag, k.name, count))
    best = min(times[1:])
    log("  %s MSM 2^%d (c=%d): exact; times %s s; min %.4f s = %.1f "
        "points/s; launches per MSM %s" % (
            tag, log_n, c, [round(t, 4) for t in times], best, n / best,
            json.dumps(launches[0])))
    stages = msm_stages(points, words, c, g2)
    log("  %s MSM stages (s, synchronised): %s" % (tag, json.dumps(stages)))
    return {"n": n, "c": c, "seconds": times, "points_per_s": n / best,
            "launches": launches[0], "stages": stages}, (points, words, want)


def phase_msm_routes(g2, points, words, want, reps=2):
    """5b: the 2^20 MSM of phase 5 through the dense all-windows driver
    and the scan MSM (digits made outside the timed region); each must
    equal the oracle and launch exactly the kernels of its route."""
    tag = "G2" if g2 else "G1"
    n = points.shape[0]
    c = msm.best_c(n)
    digits = msm.window_digits(words, c)
    expect = {
        "fused": {kernels.POINT_ADD[g2], kernels.BUCKET_FOLD[g2],
                  kernels.HORNER[g2]},
        "generic": {kernels.SEG_SCAN[g2], kernels.BUCKET_FOLD[g2],
                    kernels.POINT_DOUBLE[g2], kernels.POINT_ADD[g2]}}
    scan = msm_scan.msm_g2 if g2 else msm_scan.msm_g1
    run = {"fused": lambda: msm_dense.msm(points, digits, c, g2),
           "generic": lambda: (scan(points, digits, c), "scan")}
    out = {}
    for impl in ("fused", "generic"):
        times, counts = [], []
        for rep in range(reps + 1):
            kernels.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, route = run[impl]()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            counts.append(launch_counts())
            if got != want:
                fail("%s MSM 2^%d, msm_impl=%r, differs from the class-sum "
                     "oracle" % (tag, FULL_LOG, impl))
            if impl == "fused" and route != "dense":
                fail("%s MSM 2^%d: the dense driver took route %r"
                     % (tag, FULL_LOG, route))
        ran = {k for k in kernels.ALL if counts[0][k.name]}
        if ran != expect[impl]:
            fail("%s MSM, msm_impl=%r, launched %s; expected %s" % (
                tag, impl, sorted(k.name for k in ran),
                sorted(k.name for k in expect[impl])))
        k2 = kernels.POINT_DOUBLE[g2]
        if impl == "generic" and counts[0][k2.name] != digits.shape[0] - 1:
            fail("%s scan MSM: K2 launched %d times for %d windows (once a "
                 "window below the top one)" % (tag, counts[0][k2.name],
                                                digits.shape[0]))
        best = min(times[1:])
        log("  %s MSM 2^%d msm_impl=%r (c=%d, route %s): exact; times %s s;"
            " min %.4f s = %.1f points/s; launches %s" % (
                tag, FULL_LOG, impl, c, route, [round(t, 4) for t in times],
                best, n / best, json.dumps({k: v for k, v in
                                            counts[0].items() if v})))
        out[impl] = {"c": c, "route": route, "seconds": times,
                     "points_per_s": n / best, "launches": counts[0]}
    return out


def phase_msm_mesh(points, words, want, reps=2):
    """5c: the 2^20 G1 MSM of phase 5 on MESH_SHARDS virtual shards of the
    card, through ShardedRedMSM and make_sharded_msm (window bits as the
    mesh prover picks them: best_c of a shard's points)."""
    n = points.shape[0]
    t0 = time.perf_counter()
    mesh = make_mesh(devices=[DEV] * MESH_SHARDS)
    c = msm.best_c(-(-n // MESH_SHARDS))
    red = get_sharded_msm(mesh, n, c)
    shards = red.shard_points(points)
    scan = make_sharded_msm(mesh, "g1", c)
    digits = msm.window_digits(words, c)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    nw = digits.shape[0]
    k1, k2, k3 = kernels.POINT_ADD[False], kernels.POINT_DOUBLE[False], \
        kernels.HORNER[False]
    expect = {
        "red": ({k1, k3}, {k3.name: 2 * MESH_SHARDS}),
        "scan": ({kernels.SEG_SCAN[False], kernels.BUCKET_FOLD[False], k2,
                  k1}, {k2.name: (nw - 1) * MESH_SHARDS})}
    run = {"red": lambda: red(shards, digits),
           "scan": lambda: msm_scan.to_host(scan(shards, digits), False)}
    out = {"shards": MESH_SHARDS, "c": c, "setup_seconds": t_setup}
    for name in ("red", "scan"):
        times, counts = [], []
        for rep in range(reps + 1):
            kernels.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = run[name]()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            counts.append(launch_counts())
            if got != want:
                fail("G1 MSM 2^%d on %d shards (%s) differs from the "
                     "class-sum oracle" % (FULL_LOG, MESH_SHARDS, name))
        ran = {k for k in kernels.ALL if counts[0][k.name]}
        kinds, exact = expect[name]
        if ran != kinds or any(counts[0][k] != v for k, v in exact.items()):
            fail("G1 MSM on %d shards (%s) launched %s; expected %s, %s" % (
                MESH_SHARDS, name, json.dumps({k: v for k, v in
                                               counts[0].items() if v}),
                sorted(k.name for k in kinds), exact))
        best = min(times[1:])
        log("  G1 MSM 2^%d on %d shards, %s (c=%d): exact; times %s s; min "
            "%.4f s = %.1f points/s; launches %s" % (
                FULL_LOG, MESH_SHARDS, name, c, [round(t, 4) for t in times],
                best, n / best, json.dumps({k: v for k, v in
                                            counts[0].items() if v})))
        out[name] = {"seconds": times, "points_per_s": n / best,
                     "launches": counts[0]}
    log("  mesh and shards (make_mesh, the red MSM's point shards, digits):"
        " %.3f s" % t_setup)
    return out


def msm_stages(points, words, c, g2):
    """One more MSM, synchronised after each stage of ops.msm.msm_tensor."""
    marks = []

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    k1, k3 = kernels.POINT_ADD[g2], kernels.HORNER[g2]
    mark("start")
    digits = msm.window_digits(words, c)
    mark("digits")
    msm.check_digit_contract(digits, c)
    mark("contract")
    keys, src = msm.sorted_keys(digits)
    mark("sort")
    k1_before = k1.launches
    run_keys, sums = msm.bucket_sums(points, keys, src, g2)
    mark("bucket_sums")
    rounds = k1.launches - k1_before
    k1_before, k3_before = k1.launches, k3.launches
    wins = msm.window_sums(run_keys, sums, digits.shape[0], c, g2)
    mark("pairfold")
    pairfold = {k1.name: k1.launches - k1_before,
                k3.name: k3.launches - k3_before}
    res = msm.combine_windows(wins, c, g2)
    mark("horner")
    (curve.tensor_to_g2 if g2 else curve.tensor_to_g1)(res)
    mark("to_host")
    out = {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])}
    out.update(keys=int(keys.shape[0]), buckets=int(run_keys.shape[0]),
               bucket_rounds=rounds, pairfold_launches=pairfold)
    return out


def phase_transform(rng, n_spot=2):
    log_m = FULL_LOG
    m = 1 << log_m
    r = SNARK_SCALAR_FIELD
    t0 = time.perf_counter()
    dom = NttDomain(m, DEV)
    torch.cuda.synchronize()
    t_dom = time.perf_counter() - t0
    vals = random_fq(3 * m, rng)                # canonical < 2^252 < r
    abc = Fr.to_mont(vals).reshape(16, 3, m)
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = h_coefficients(dom, abc)
    torch.cuda.synchronize()
    t_chain = time.perf_counter() - t0
    launches = launch_counts()
    x3 = abc.reshape(16, 3 * m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dom.dif(x3, dom.tw_inv)
    torch.cuda.synchronize()
    t_dif = time.perf_counter() - t0
    log("  transform chain m = 2^%d: %.3f s, of which one batched 3-vector "
        "DIF takes %.3f s (domain constants %.3f s)"
        % (log_m, t_chain, t_dif, t_dom))
    # spot checks: h(x) by Horner over the coefficients (natural order =
    # bit-reversed storage read through the involution) against
    # (A(x) B(x) - C(x)) / Z(x) at coset points x = g w^j, A(x) from the
    # evaluations by the Lagrange form sum_i a_i w^i (x^m - 1) / (m (x - w^i))
    t0 = time.perf_counter()
    coeffs = np.array(words_to_ints(h16_to_words(
        Fr.from_mont(h)[:, dom.bitrev])), dtype=object)
    ev = [np.array(words_to_ints(h16_to_words(vals[:, k * m:(k + 1) * m])),
                   dtype=object) for k in range(3)]
    w_pows = np.array(words_to_ints(h16_to_words(Fr.from_mont(
        dom.tw_fwd))), dtype=object)                     # w^0 .. w^(m/2-1)
    w_half = pow(dom.omega, m // 2, r)
    w_pows = np.concatenate([w_pows, w_pows * w_half % r])
    g = dom.coset_gen
    for j in rng.integers(0, m, n_spot):
        x = g * pow(dom.omega, int(j), r) % r
        acc = 0
        for cf in coeffs[::-1]:
            acc = (acc * x + cf) % r
        zx = (pow(x, m, r) - 1) % r
        diff = (x - w_pows) % r
        pref = np.empty(m + 1, dtype=object)
        pref[0] = 1
        for i in range(m):
            pref[i + 1] = pref[i] * diff[i] % r
        inv = pow(int(pref[m]), -1, r)
        inv_diff = np.empty(m, dtype=object)
        for i in range(m - 1, -1, -1):
            inv_diff[i] = inv * pref[i] % r
            inv = inv * diff[i] % r
        lag = w_pows * inv_diff % r
        scale = zx * pow(m, -1, r) % r
        a, b, cc = (int((e * lag % r).sum()) * scale % r for e in ev)
        want = (a * b - cc) * pow(zx, -1, r) % r
        if acc != want:
            fail("transform chain: h(g w^%d) differs from (A B - C) / Z"
                 % j)
    log("  %d coset spot evaluations exact (%.1f s on the host)"
        % (n_spot, time.perf_counter() - t0))
    return {"m": m, "seconds": t_chain, "dif3_seconds": t_dif,
            "domain_seconds": t_dom, "launches": launches}


# ---------------------------------------------------------------- phase 2b

def k4_check_scalars(n, rng):
    """n scalars for the K4 comparison: 0, 1, r - 1; every byte value
    alone at a position (d at byte d mod 31, and 1..0x30 in the top byte);
    uniform scalars, a quarter of them with random bytes zeroed."""
    special = [0, 1, CURVE_ORDER - 1]
    special += [d << (8 * (d % 31)) for d in range(1, 256)]
    special += [d << 248 for d in range(1, 0x31)]
    vals = list(random_scalars(n - len(special), rng))
    for j in range(0, len(vals), 4):
        v = vals[j]
        for b in rng.integers(0, 32, 8):
            v &= ~(0xFF << (8 * int(b)))
        vals[j] = v
    return special + [int(v) for v in vals]


def k4_bound(words, n_win, c, g2, table):
    """(bound ms, by) for K4 on these scalars: the point adds they need
    (nonzero digits less one per nonzero scalar) at the add's IMADs, and
    the bytes of the scalars, the table and the output."""
    nz = (curve.scalar_digits(words, n_win, c) != 0).sum(0)
    adds = int((nz - 1).clamp(min=0).sum())
    n = words.shape[0]
    n_bytes = 32 * n + table.numel() * 4 + point_bytes(g2) * n
    return bound_ms(n_bytes, adds * OP_IMAD[("add", g2)]) + (adds,)


def phase_k4(rng):
    """K4 against its plain version, bit for bit, at CHECK_POINTS scalars
    with the edge cases, and on 2^FULL_LOG uniform scalars (the H query of
    the full-width setup), where both are timed; a sample of lanes against
    host double-and-add."""
    log("== phase 2b: K4 fixed_base_mul vs plain version")
    rec = {}
    n_time = 1 << FULL_LOG
    for g2 in (False, True):
        tag = "g2" if g2 else "g1"
        k = kernels.FIXED_BASE_MUL[g2]
        gen = bn254.G2_GEN if g2 else bn254.G1_GEN
        t0 = time.perf_counter()
        be = BatchExp(gen, g2, device=DEV)
        log("  %s window table (%d points) built and uploaded in %.2f s"
            % (tag, be.table.shape[0], time.perf_counter() - t0))
        scalars = k4_check_scalars(CHECK_POINTS, rng)
        words = torch.from_numpy(ints_to_words_np(scalars)).to(DEV)
        got = kernels.fixed_base_mul(be.table, words, N_WIN, C, g2)
        torch.cuda.synchronize()
        want = curve.fixed_base_plain(be.table, words, N_WIN, C, g2)
        errs = [same("K4 %s (edge cases)" % k.name, got, want)]
        sample = list(range(0, 3 + 255 + 48)) + list(
            range(len(scalars) - 64, len(scalars)))
        host = (curve.tensor_to_g2 if g2 else curve.tensor_to_g1)(
            got[torch.tensor(sample, device=DEV)])
        for j, pt in zip(sample, host):
            if pt != bn254.multiply(gen, scalars[j]):
                fail("K4 %s: lane %d differs from host double-and-add"
                     % (k.name, j))
        log("  %-34s %d lanes equal host double-and-add" % (k.name,
                                                            len(sample)))
        del got, want
        words = torch.from_numpy(ints_to_words_np(
            random_scalars(n_time, rng))).to(DEV)
        ms, got = cuda_ms(lambda: kernels.fixed_base_mul(
            be.table, words, N_WIN, C, g2))
        plain_ms, want = cuda_ms(lambda: curve.fixed_base_plain(
            be.table, words, N_WIN, C, g2), warm=False)
        shape = "%d uniform scalars, c=%d" % (n_time, C)
        errs.append(same("K4 %s (%s)" % (k.name, shape), got, want))
        del got, want
        b_ms, b_by, adds = k4_bound(words, N_WIN, C, g2, be.table)
        rec[k.name] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, shape=shape,
                           adds=adds)
        log("  %-18s %-30s kernel %10.4f ms  plain %10.2f ms  bound "
            "%8.4f ms (%s, %d adds)" % (k.name, shape, ms, plain_ms, b_ms,
                                        b_by, adds))
        del words, be
        torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------- phase 2c

def fold_check_buckets(base, rng, g2):
    """CHECK_POINTS buckets whose fold meets the completeness cases: a run
    of equal buckets (P + P in the running sums), buckets followed by
    their negations (P + (-P)), identities and a run of empty buckets."""
    B, _ = test_points(base, CHECK_POINTS, rng, g2)
    e = CHECK_POINTS // 16
    B[e:e + 64] = B[e:e + 1]
    B[2 * e:2 * e + 64:2] = negate(B[2 * e + 1:2 * e + 65:2])
    B[4 * e:4 * e + e // 2] = curve.identity(e // 2, g2, DEV)
    return B.contiguous()


def fold_check_schedules(c, g2):
    """K5's schedule on this card for 16 windows of 2^c buckets, and
    schedules of 32-thread blocks that split a window over several blocks
    and its tail (132 x 3), into parts of a bucket count that is not a
    power of two (100 x 1: 6 buckets a thread), and into one block a
    window (2 x 1)."""
    T = fold.FOLD_THREADS[g2]
    out = [fold.fold_schedule(16, c, g2, *kernels.card_shape(DEV, g2))]
    for sms, blocks in ((132, 3), (100, 1), (2, 1)):
        out.append(fold.fold_schedule(16, c, g2, sms, blocks, 32))
    return out


def scan_check_inputs(base, rng, g2):
    """Sorted keys with the point index of each, over points with
    identities and negations: negative keys first (never merging), short
    random runs, runs of P then -P, a run of one point repeated (P + P),
    and one run over 16 tiles of K6's default schedule, starting and ending
    inside a tile; CHECK_POINTS elements besides that run, the last tile
    ragged."""
    P, Q = test_points(base, CHECK_POINTS, rng, g2)
    X = torch.cat([P, Q]).contiguous()              # Q[128:192] = -P[128:192]
    n = CHECK_POINTS
    log_t, items = fold.scan_schedule(g2)
    long_run = (16 << log_t) * items + (items << log_t) // 2
    lengths = [1] * 6 + [2] * 64 + [64, long_run]
    lengths += list(rng.integers(1, 20, n))
    keys = np.repeat(np.arange(len(lengths)), lengths)[:n + long_run] - 6
    keys[:6] = [-2, -2, -1, -1, -1, -1]
    idx = rng.integers(0, 2 * n, n + long_run)
    idx[6:134:2] = 128 + np.arange(64)              # P ...
    idx[7:135:2] = n + 128 + np.arange(64)          # ... then -P
    idx[134:198] = 777
    return X, torch.from_numpy(keys).to(DEV), torch.from_numpy(idx).to(DEV)


def phase_fused_kernels(rng, resources, t_fq):
    """K5 and K6 against their plain versions, bit for bit, on the edge
    cases and at the 2^20-MSM shapes (timed; K5 also at the dense driver's
    2 windows); K5 against the pairfold; K2 at the scan MSM's window step
    (one lane, n = c), timed with its latency floor in units of ``t_fq``;
    K7 against its plain version, every op.  ``resources``: each kernel's
    registers and frame."""
    log("== phase 2c: K5 bucket_fold, K6 seg_scan, K7 int_probe vs plain "
        "versions")
    rec = {}
    c = msm.best_c(1 << FULL_LOG)
    nw = msm.n_windows(c)
    plain_scan = (lambda P, k, i, g, s: fold.seg_scan_tile_plain(P, k, i, g, s))
    for g2 in (False, True):
        tag = "g2" if g2 else "g1"
        k5, k6 = kernels.BUCKET_FOLD[g2], kernels.SEG_SCAN[g2]
        pb = point_bytes(g2)
        _, base = base_points(g2)
        # edge cases: 16 windows of CHECK_POINTS / 16 buckets
        B = fold_check_buckets(base, rng, g2)
        cf = CHECK_POINTS.bit_length() - 5
        errs5 = []
        for sched in fold_check_schedules(cf, g2):
            errs5.append(same("K5 %s (16 x 2^%d, schedule %s)" % (
                k5.name, cf, sched), kernels.bucket_fold(B, 16, cf, g2,
                                                         sched),
                fold.bucket_fold_plain(B, 16, cf, g2, sched)))
        X, keys, idx = scan_check_inputs(base, rng, g2)
        sched = fold.scan_schedule(g2)
        # every prefix of the long run against host sums
        to_host = curve.tensor_to_g2 if g2 else curve.tensor_to_g1
        run = (keys == keys[198 + 64]).nonzero().squeeze(1)
        prefix, acc = [], None
        for pt in to_host(X[idx[run]]):
            acc = bn254.add(acc, pt)
            prefix.append(acc)
        errs6 = []
        # the default tiles, and small ones for three levels of tiles
        for sc in (sched, (5, 4)):
            errs6.append(same("K6 %s (one launch, schedule %s)" % (
                k6.name, sc), kernels.seg_scan_tiles(X, keys, idx, g2, sc),
                fold.seg_scan_tile_plain(X, keys, idx, g2, sc)))
            got = msm_scan.seg_scan(X, keys, idx, g2, sc)
            errs6.append(same(
                "K6 %s (all levels, K1 carries, schedule %s)" % (k6.name, sc),
                got, msm_scan.seg_scan(X, keys, idx, g2, sc,
                                       tiles=plain_scan,
                                       add=curve.point_add_plain)))
            if to_host(got[run]) != prefix:
                fail("K6 %s: the prefixes of the %d-element run differ from "
                     "their host sums (schedule %s)" % (k6.name, run.numel(),
                                                        sc))
            log("  %-34s every prefix of a %d-element run over %d tiles "
                "equals its host sum (schedule %s)" % (
                    k6.name, run.numel(), run.numel() // (sc[1] << sc[0]),
                    sc))

        # the generic window step: 2^c acc, one lane (K2, n = c)
        k2 = kernels.POINT_DOUBLE[g2]
        one = base[:1].contiguous()
        ms, got = cuda_ms(lambda: kernels.point_double(one, g2, c))
        same("K2 %s (one lane, n=%d)" % (k2.name, c), got,
             curve.point_double_plain(one, g2, c))
        rec_k2 = dict(one_lane_ms=ms, one_lane_bound_ms=bound_ms(
            2 * pb, c * OP_IMAD[("double", g2)])[0],
            one_lane_latency_floor_ms=latency_floor_ms(c, g2, t_fq))
        log("  %-16s %-30s kernel %10.4f ms  bound %8.6f ms  latency floor "
            "%8.4f ms" % (k2.name, "1 lane, n=%d (generic step)" % c, ms,
                          rec_k2["one_lane_bound_ms"],
                          rec_k2["one_lane_latency_floor_ms"]))

        # the fold of a 2^20-point MSM: the scan MSM's nw windows of 2^c
        # buckets, and the dense driver's groups of 2 and 1 windows
        sms, blocks = kernels.card_shape(DEV, g2)
        for n_win in (nw, 2, 1):
            dense = base[torch.from_numpy(rng.integers(
                0, 256, n_win << c)).to(DEV)].contiguous()
            sched5 = fold.fold_schedule(n_win, c, g2, sms, blocks)
            ms, got = cuda_ms(lambda: kernels.bucket_fold(dense, n_win, c,
                                                          g2))
            plain_ms, want = cuda_ms(lambda: fold.bucket_fold_plain(
                dense, n_win, c, g2, sched5), warm=False)
            shape5 = "%d windows x 2^%d buckets" % (n_win, c)
            errs5.append(same("K5 %s (%s, schedule %s)" % (
                k5.name, shape5, sched5), got, want))
            pf_ms, pf = cuda_ms(lambda: msm.pairfold(dense, n_win, c, g2),
                                reps=3)
            if to_host(pf) != to_host(got):
                fail("K5 %s and the pairfold differ at %s" % (k5.name,
                                                              shape5))
            b5 = bound_ms(dense.numel() * 4 + n_win * pb,
                          n_win * (2 * (1 << c) - 3) * OP_IMAD[("add", g2)])
            r5 = dict(ms=ms, plain_ms=plain_ms, bound_ms=b5[0],
                      bound_by=b5[1], shape=shape5, schedule=sched5,
                      pairfold_ms=pf_ms)
            if n_win == nw:
                rec[k5.name] = dict(r5, by_windows={})
            else:
                rec[k5.name]["by_windows"][n_win] = r5
            log("  %-16s %-30s kernel %10.4f ms  plain %10.2f ms  bound "
                "%8.4f ms (%s); pairfold %8.4f ms on the same buckets; "
                "schedule %s; %s" % (k5.name, shape5, ms, plain_ms, b5[0],
                                     b5[1], pf_ms, sched5,
                                     json.dumps(resources[k5.name])))
            del dense, got, want, pf
        rec[k5.name]["max_abs_err"] = max(errs5)
        rec[k2.name] = rec_k2

        # the scan of a 2^20-point MSM: its sorted nonzero digits
        points = base.repeat((1 << FULL_LOG) // 256, *([1] * (base.dim() - 1)))
        words = torch.from_numpy(ints_to_words_np(random_scalars(
            1 << FULL_LOG, rng))).to(DEV)
        keys, src = msm.sorted_keys(msm.window_digits(words, c))
        ms, got = cuda_ms(lambda: kernels.seg_scan_tiles(points, keys, src,
                                                         g2))
        all_ms = cuda_ms(lambda: msm_scan.seg_scan(points, keys, src, g2))[0]
        m = 1 << SCAN_PLAIN_LOG
        ks, ss = keys[:m].contiguous(), src[:m].contiguous()
        plain_ms, want = cuda_ms(lambda: fold.seg_scan_tile_plain(
            points, ks, ss, g2, sched), warm=False)
        errs6.append(same("K6 %s (first 2^%d elements)" % (
            k6.name, SCAN_PLAIN_LOG), kernels.seg_scan_tiles(
                points, ks, ss, g2), want))
        n6 = keys.numel()
        merges = int((keys[1:] == keys[:-1]).sum())
        b6 = bound_ms(n6 * (16 + 2 * pb), merges * OP_IMAD[("add", g2)])
        shape6 = "%d keys of 2^%d scalars, c=%d" % (n6, FULL_LOG, c)
        rec[k6.name] = dict(max_abs_err=max(errs6), ms=ms, plain_ms=plain_ms,
                            all_levels_ms=all_ms,
                            bound_ms=b6[0], bound_by=b6[1], shape=shape6,
                            plain_shape="first 2^%d keys" % SCAN_PLAIN_LOG)
        log("  %-16s %-30s kernel %10.4f ms (all levels %.4f ms)  plain "
            "%10.2f ms (2^%d keys)  bound %8.4f ms (%s, %d adds)" % (
                k6.name, shape6, ms, all_ms, plain_ms, SCAN_PLAIN_LOG, b6[0],
                b6[1], merges))
        del points, words, keys, src, got, want, ks, ss
        torch.cuda.empty_cache()

    # K7: every op at the probe's size
    k7 = kernels.INT_PROBE
    errs7, rates = [], {}
    for op in int_probe.OPS:
        x, y = probe.inputs(op, probe.N, DEV)
        ms, got = probe.measure(op, x, y, probe.ITERS)
        t0 = time.perf_counter()
        want = int_probe.int_probe_plain(op, x, y, probe.ITERS)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if op == 'f32_fma':
            a, b = got.view(torch.float32), want.view(torch.float32)
            rel = float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
            if not rel <= int_probe.F32_RTOL:
                fail("K7 f32_fma: relative error %g above %g"
                     % (rel, int_probe.F32_RTOL))
            log("  K7 %-14s within relative %.3g of the plain version"
                % (op, rel))
        else:
            errs7.append(same("K7 %s" % op, got, want))
        rates[op] = probe.N * probe.ITERS * int_probe.CHAIN / (ms * 1e-3)
        log("  K7 %-14s kernel %9.4f ms = %10.1f Gop/s  plain %9.1f ms"
            % (op, ms, rates[op] / 1e9, plain_ms))
        if op == 'u32_mul_wide':
            n_imad = 2 * probe.N * probe.ITERS * int_probe.CHAIN
            b7 = bound_ms(12 * probe.N, n_imad)
            rec[k7.name] = dict(
                max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=b7[0],
                bound_by=b7[1], shape="u32_mul_wide, %d x %d x %d" % (
                    probe.N, probe.ITERS, int_probe.CHAIN))
    rec[k7.name]["max_abs_err"] = max(errs7)
    wide = 2 * rates['u32_mul_wide']
    log("  K7 u32_mul_wide: %.4g IMAD/s (2 per product) = %.3f of the "
        "%.4g IMAD/s every bound assumes; u32_mul %.4g/s, u32_add %.4g/s"
        % (wide, wide / IMAD_PER_S, IMAD_PER_S,
           rates['u32_mul'], rates['u32_add']))
    rec[k7.name]["rates"] = rates
    return rec


def counting_fold_windows(counts):
    """kernels.bucket_fold that also counts its calls by curve and window
    count in ``counts`` (the drivers call it through the module)."""
    launch = kernels.bucket_fold

    def counted(buckets, n_win, c, g2=False, *args, **kw):
        key = "%s %d windows" % ("g2" if g2 else "g1", n_win)
        counts[key] = counts.get(key, 0) + 1
        return launch(buckets, n_win, c, g2, *args, **kw)
    return counted


# ---------------------------------------------------------------- phase 3

def fixture_cs():
    with open(os.path.join(FIXTURE, "r1cs.json")) as fh:
        return r1cs_from_dict(json.load(fh))


def check_fixture_key(kp, what):
    """The keypair writes the committed pk.bin and vk.json byte for
    byte."""
    path = os.path.join(_build.BUILD_DIR, "fixture_pk.bin")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    write_pk_binary(kp.pk, path)
    for name, data in (("pk.bin", open(path, "rb").read()),
                       ("vk.json", kp.vk.to_json().encode())):
        with open(os.path.join(FIXTURE, name), "rb") as fh:
            if fh.read() != data:
                fail("%s: %s differs from the committed one" % (what, name))
    os.remove(path)


def phase_fixture_setup():
    """The port's setup of the fixture circuit, with the seeded rng the
    committed key was made with, must reproduce pk.bin and vk.json."""
    log("== phase 3: setup of the fixture")
    cs = fixture_cs()
    seeded = random.Random(SETUP_SEED)
    kernels.reset_counts()
    t0 = time.perf_counter()
    kp = generator(cs, rng=lambda: seeded.randrange(1, SNARK_SCALAR_FIELD),
                   device=DEV)
    dt = time.perf_counter() - t0
    launches = launch_counts()
    check_fixture_key(kp, "fixture setup")
    if launches[kernels.FIXED_BASE_MUL[False].name] == 0:
        fail("fixture setup did not launch K4 fixed_base_mul_g1")
    log("  setup %.3f s: pk.bin and vk.json equal the committed files; "
        "phases %s; launches %s" % (
            dt, json.dumps({k: round(v, 4) for k, v in kp.profile.items()}),
            json.dumps(launches)))
    return {"seconds": dt, "profile": kp.profile, "launches": launches}


def phase_fixture_zk(nozk_ctx):
    """3b: the zk setup of the fixture keeps the committed nozk parts; its
    unblinded proof is the committed one, blinded proofs verify and
    differ; a nozk key refuses blinding."""
    log("== phase 3b: zk setup and blinded proofs of the fixture")
    cs = fixture_cs()
    seeded = random.Random(SETUP_SEED)
    kernels.reset_counts()
    t0 = time.perf_counter()
    kp = generator(cs, rng=lambda: seeded.randrange(1, SNARK_SCALAR_FIELD),
                   device=DEV, zk=True)
    t_setup = time.perf_counter() - t0
    launches = launch_counts()
    check_fixture_key(kp, "zk fixture setup")
    if not kp.pk.has_zk_extras:
        fail("generator(zk=True) made a key without its zk extras")
    if launches[kernels.FIXED_BASE_MUL[False].name] < 5:
        fail("zk setup launched K4 G1 %d times; expected A, H, L, gamma_abc"
             " and the B query in G1" % launches[
                 kernels.FIXED_BASE_MUL[False].name])
    witness = witness_from_json(os.path.join(FIXTURE, "witness.json"))
    with open(os.path.join(FIXTURE, "proof.json")) as fh:
        expected = fh.read()
    ctx = ProverContext(kp.pk, cs, device=DEV, qap=kp.qap)
    if ctx.prove(witness).to_json() != expected:
        fail("the zk key's unblinded proof differs from proof.json")
    blinder = random.Random(SEED)
    kernels.reset_counts()
    t0 = time.perf_counter()
    blinded = [ctx.prove(witness, blind=True, rng=lambda: blinder.randrange(
        1, SNARK_SCALAR_FIELD)) for _ in range(2)]
    t_blind = (time.perf_counter() - t0) / 2
    blind_launches = launch_counts()
    for rep, proof in enumerate(blinded):
        if not kp.vk.verify(proof):
            fail("blinded proof %d does not verify" % rep)
    if len({p.to_json() for p in blinded} | {expected}) != 3:
        fail("blinded proofs equal each other or the unblinded proof")
    try:
        nozk_ctx.prove(witness, blind=True)
        fail("blind=True on the nozk fixture key did not raise")
    except ValueError:
        pass
    log("  zk setup %.3f s: pk.bin and vk.json equal the committed files; "
        "unblinded proof equals proof.json; two blinded proofs (%.3f s "
        "each) verify and differ; blind=True on the nozk key raises "
        "ValueError; routes %s; setup launches %s; blinded launches %s" % (
            t_setup, t_blind, ctx.last_routes, json.dumps(
                {k: v for k, v in launches.items() if v}),
            json.dumps({k: v for k, v in blind_launches.items() if v})))
    return {"setup_seconds": t_setup, "blinded_prove_seconds": t_blind,
            "setup_launches": launches, "blinded_launches": blind_launches}


# ---------------------------------------------------------------- phase 6

def build_circuit(log_n):
    """Chain of MiMC-e7 ciphers (tools/bench_prove.py:build_circuit):
    digest = E_k(...E_k(x)); each link is 364 constraints, plus one bind.
    Public input: the final digest."""
    target = 1 << log_n
    n_links = max(1, (target - 2) // 365)
    pb = ConstraintSystem()
    digest = pb.allocate('digest')
    pb.set_input_sizes(1)
    x = pb.allocate('x')
    k = pb.allocate('k')
    gadgets = []
    cur = x + 0
    for i in range(n_links):
        g = MiMCe7_gadget(pb, cur, k + 0, 'mimc_%d' % i)
        g.generate_r1cs_constraints()
        gadgets.append(g)
        cur = g.result() + 0
    pb.add_constraint(cur, 1, digest + 0, 'bind')

    pb.setval(x, 777)
    pb.setval(k, 888)
    val = 777
    for g in gadgets:
        g.generate_r1cs_witness()
        val = mimc(val, 888)
    pb.setval(digest, val)
    assert pb.is_satisfied()
    return pb


def host_rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def phase_full_path():
    """setup -> two proofs -> verify on the MiMC chain of 2^CHAIN_LOG."""
    log_n = CHAIN_LOG
    log("== phase 6: setup -> prove -> verify, MiMC-e7 chain 2^%d" % log_n)
    t0 = time.perf_counter()
    cs = build_circuit(log_n)
    t_build = time.perf_counter() - t0
    log("  circuit: %d constraints, %d variables, built with its witness "
        "in %.1f s; host peak RSS %.2f GB" % (
            cs.num_constraints, cs.num_variables, t_build, host_rss_gb()))
    seeded = random.Random(SEED)
    kernels.reset_counts()
    t0 = time.perf_counter()
    kp = generator(cs, rng=lambda: seeded.randrange(1, SNARK_SCALAR_FIELD),
                   device=DEV)
    t_setup = time.perf_counter() - t0
    setup_launches = launch_counts()
    log("  setup %.2f s (m = %d); phases %s; launches %s; host peak RSS "
        "%.2f GB" % (t_setup, kp.qap.domain_size, json.dumps(
            {k: round(v, 4) for k, v in kp.profile.items()}),
            json.dumps(setup_launches), host_rss_gb()))
    for k in kernels.SETUP:
        if setup_launches[k.name] == 0:
            fail("setup did not launch %s" % k.name)
    t0 = time.perf_counter()
    ctx = ProverContext(kp.pk, cs, device=DEV, qap=kp.qap)
    t_ctx = time.perf_counter() - t0
    log("  ProverContext on the setup's key and QAP: %.3f s (c = %s); the "
        "setup's qap_build took %.2f s" % (t_ctx, ctx.c,
                                          kp.profile["qap_build"]))
    kernels.reset_counts()
    proofs, profiles, seconds = [], [], []
    for rep in range(2):
        t0 = time.perf_counter()
        proofs.append(ctx.prove(cs.values))
        seconds.append(time.perf_counter() - t0)
        profiles.append(ctx.last_profile)
        log("  proof %d: %.3f s; phases %s" % (
            rep, seconds[-1], json.dumps({k: round(v, 4) for k, v in
                                          ctx.last_profile.items()})))
    prove_launches = launch_counts()
    log("  launches over the two proofs: %s" % json.dumps(prove_launches))
    check_red_launches(prove_launches, "the 2^%d prove" % log_n)
    if proofs[0].to_json() != proofs[1].to_json():
        fail("two nozk proofs of one witness differ")
    t0 = time.perf_counter()
    for rep, proof in enumerate(proofs):
        if not kp.vk.verify(proof):
            fail("2^%d proof %d does not verify" % (log_n, rep))
    bad = Proof(proofs[0].A, proofs[0].B, proofs[0].C,
                [(proofs[0].input[0] + 1) % SNARK_SCALAR_FIELD])
    if kp.vk.verify(bad):
        fail("the proof with its input changed by one verifies")
    t_verify = time.perf_counter() - t0
    log("  both proofs verify, the tampered one does not (%.2f s for three"
        " host verifications)" % t_verify)
    log("== phase 6b: the same witness through msm_impl 'fused' and "
        "'generic'")
    other = {}
    for impl in ("fused", "generic"):
        ctx_i = ProverContext(kp.pk, cs, device=DEV, qap=kp.qap,
                              msm_impl=impl)
        kernels.reset_counts()
        t0 = time.perf_counter()
        proof = ctx_i.prove(cs.values)
        dt = time.perf_counter() - t0
        launches = launch_counts()
        if proof.to_json() != proofs[0].to_json():
            fail("msm_impl=%r: the 2^%d proof differs from the 'red' proof"
                 % (impl, log_n))
        if not kp.vk.verify(proof):
            fail("msm_impl=%r: the 2^%d proof does not verify" % (impl,
                                                                 log_n))
        log("  msm_impl=%r: %.3f s, JSON equal to the 'red' proof, "
            "verifies; routes %s; phases %s; launches %s" % (
                impl, dt, ctx_i.last_routes, json.dumps(
                    {k: round(v, 4) for k, v in ctx_i.last_profile.items()}),
                json.dumps({k: v for k, v in launches.items() if v})))
        other[impl] = {"seconds": dt, "routes": ctx_i.last_routes,
                       "profile": ctx_i.last_profile, "launches": launches}
    return {"constraints": cs.num_constraints, "m": kp.qap.domain_size,
            "build_seconds": t_build, "setup_seconds": t_setup,
            "setup_profile": kp.profile, "setup_launches": setup_launches,
            "context_seconds": t_ctx, "prove_seconds": seconds,
            "prove_profiles": profiles, "prove_launches": prove_launches,
            "verify_seconds": t_verify, "msm_impls": other}


# ---------------------------------------------------------------- phase 7

def phase_entry_points():
    """The bench in its four modes, each as ``python -m``, and the probe's
    main in this process (its K7 launches are the probe path's)."""
    log("== phase 7: entry points")
    out = {}
    for mode in bench.MODES:
        env = dict(os.environ, BENCH_MSM_SIZE="16", BENCH_MSM_MODE=mode)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "ethsnarks_tpu_torch.bench"], cwd=ROOT,
            env=env, capture_output=True, text=True, timeout=600)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith('{"metric"')]
        if proc.returncode != 0 or not lines or \
                "correct=True" not in lines[-1]:
            fail("bench mode %s: rc %d\n%s%s" % (
                mode, proc.returncode, proc.stdout[-2000:],
                proc.stderr[-2000:]))
        out[mode] = json.loads(lines[-1])
        log("  bench %-10s %.1f s: %s" % (mode, time.perf_counter() - t0,
                                          lines[-1]))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ethsnarks_tpu_torch.bench_workloads"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    rows = [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith('{"metric"')]
    if proc.returncode != 0 or len(rows) != len(bench_workloads.WORKLOADS) \
            or not all(r["correct"] for r in rows):
        fail("bench_workloads: rc %d\n%s%s" % (
            proc.returncode, proc.stdout[-3000:], proc.stderr[-3000:]))
    log("  bench_workloads, %d rows, all correct, %.1f s:"
        % (len(rows), time.perf_counter() - t0))
    for row in rows:
        log("    " + json.dumps(row))
    out["workloads"] = rows
    kernels.reset_counts()
    probe.main()
    launches = launch_counts()
    for k in kernels.PROBE:
        if launches[k.name] == 0:
            fail("the probe did not launch %s" % k.name)
    out["probe_launches"] = launches
    return out


# ---------------------------------------------------------------- phase 8

def host_rss_now_gb():
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2 ** 20
    return float("nan")


def prove_every_impl(kp, cs, what, others=("fused", "generic")):
    """Two proofs from one ProverContext on the setup's key and QAP with
    the default msm_impl 'auto', which takes the red MSM (equal JSON; K1
    and K3 of both groups and nothing else), then one proof each with the
    msm_impl of ``others``, each equal to the first.  -> (the proofs, each
    run's seconds, routes and phases, the launches of the 'auto' pair and
    of each other design)."""
    ctx = ProverContext(kp.pk, cs, device=DEV, qap=kp.qap)
    kernels.reset_counts()
    proofs, runs = [], {}
    for rep in range(2):
        t0 = time.perf_counter()
        proofs.append(ctx.prove(cs.values))
        dt = time.perf_counter() - t0
        runs["auto_%d" % rep] = {"seconds": dt, "routes": ctx.last_routes,
                                "profile": ctx.last_profile}
        log("  'auto' proof %d: %.3f s; routes %s; phases %s" % (
            rep, dt, ctx.last_routes, json.dumps(
                {k: round(v, 4) for k, v in ctx.last_profile.items()})))
    launches = {"auto": launch_counts()}
    check_red_launches(launches["auto"], "%s: the 'auto' proofs" % what)
    log("  launches over the two 'auto' proofs: %s" % json.dumps(
        {k: v for k, v in launches["auto"].items() if v}))
    if proofs[0].to_json() != proofs[1].to_json():
        fail("%s: two nozk proofs differ" % what)
    for impl in others:
        ctx_i = ProverContext(kp.pk, cs, device=DEV, qap=kp.qap,
                              msm_impl=impl)
        kernels.reset_counts()
        t0 = time.perf_counter()
        proof = ctx_i.prove(cs.values)
        dt = time.perf_counter() - t0
        launches[impl] = launch_counts()
        if proof.to_json() != proofs[0].to_json():
            fail("%s: the msm_impl=%r proof differs from the 'auto' proof"
                 % (what, impl))
        proofs.append(proof)
        runs[impl] = {"seconds": dt, "routes": ctx_i.last_routes,
                      "profile": ctx_i.last_profile}
        log("  msm_impl=%r: %.3f s, JSON equal to the 'auto' proof; routes "
            "%s; phases %s; launches %s" % (
                impl, dt, ctx_i.last_routes, json.dumps(
                    {k: round(v, 4) for k, v in ctx_i.last_profile.items()}),
                json.dumps({k: v for k, v in launches[impl].items() if v})))
    return proofs, runs, launches


def checked_setup(cs, log_m, what):
    """The port's setup of ``cs`` on the card with bench_merkle's seeded
    rng: the domain must be 2^log_m and both K4 instances must launch.
    -> (keypair, seconds, launches)."""
    kernels.reset_counts()
    t0 = time.perf_counter()
    kp = generator(cs, rng=bench_merkle.seeded_rng(), device=DEV)
    t_setup = time.perf_counter() - t0
    launches = launch_counts()
    if kp.qap.domain_size != 1 << log_m:
        fail("%s: domain %d, not 2^%d" % (what, kp.qap.domain_size, log_m))
    for k in kernels.SETUP:
        if launches[k.name] == 0:
            fail("%s: the setup did not launch %s" % (what, k.name))
    log("  setup %.2f s (m = %d); phases %s; launches %s; host peak RSS "
        "%.2f GB" % (t_setup, kp.qap.domain_size, json.dumps(
            {k: round(v, 4) for k, v in kp.profile.items()}),
            json.dumps({k: v for k, v in launches.items() if v}),
            host_rss_gb()))
    return kp, t_setup, launches


def input_changed(proof, k):
    """The proof with its public input k plus one."""
    inputs = list(proof.input)
    inputs[k] = (inputs[k] + 1) % SNARK_SCALAR_FIELD
    return Proof(proof.A, proof.B, proof.C, inputs)


def phase_witness_map(qap, values, what):
    """The witness map of ``qap`` through K8 and K9 against the plain map
    on the card, bit for bit, at the circuit's size; K8 and each K9 pass
    against their plain versions, each timed (CUDA events, mean of 5 after
    a warm-up; plain: one call) beside its bound -> (the kernels'
    records, a summary)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wm = WordWitnessMap(qap)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    m, dom, k = qap.domain_size, wm.domain, wm.domain.k
    w = torch.from_numpy(ints_to_words_np(values)).to(DEV)
    kernels.reset_counts()
    got = qap.witness_map(w)
    torch.cuda.synchronize()
    launches = {n: c for n, c in launch_counts().items() if c}
    if launches != {kernels.CSR_MATVEC.name: 1,
                    kernels.NTT_PASS.name: len(qap.word_map.domain.plan)}:
        fail("%s: the witness map launched %s" % (what, launches))
    plain_ms, want = cuda_ms(lambda: qap.witness_map_plain(w), warm=False)
    if not torch.equal(got, want):
        fail("%s: the kernels' witness map differs from the plain map"
             % what)
    map_ms, _ = cuda_ms(lambda: qap.witness_map(w))
    nnz, n_rows = wm.cols.shape[0], wm.row_ptr.shape[0] - 1
    k8_ms, abc = cuda_ms(lambda: wm.matvecs(w))
    k8_plain_ms, abc_plain = cuda_ms(lambda: witness_words.csr_matvec_plain(
        wm.row_ptr, wm.cols, wm.coeffs, w), warm=False)
    if not torch.equal(abc, abc_plain):
        fail("%s: K8 differs from its plain version" % what)
    n_bytes, prods = witness_words.matvec_work(n_rows, nnz, w.shape[0])
    b_ms, b_by = bound_ms(n_bytes, prods * FQ_MUL_IMAD)
    k8 = dict(max_abs_err=0, ms=k8_ms, plain_ms=k8_plain_ms, bound_ms=b_ms,
              bound_by=b_by, shape="%s: %d rows, %d terms" % (
                  what, n_rows, nnz))
    passes, x = [], abc
    for (lo, t, g), steps in dom.plan:
        args = (dom.tw_inv, dom.tw_fwd, dom.scale, dom.unscale, k)
        ms, y = cuda_ms(lambda x=x: kernels.ntt_pass(x, *args, lo, t, g,
                                                     steps))
        p_ms, y_plain = cuda_ms(lambda x=x: witness_words.ntt_pass_plain(
            x, *args, lo, t, steps), warm=False)
        if not torch.equal(y, y_plain):
            fail("%s: K9 pass %s differs from its plain version"
                 % (what, (lo, t, g, steps)))
        n_bytes, prods = witness_words.pass_work(k, lo, t, steps,
                                                 x.shape[0] // m)
        b_ms, b_by = bound_ms(n_bytes, prods * FQ_MUL_IMAD)
        passes.append(dict(range=[lo, t, g], steps=steps, vectors=x.shape[0]
                           // m, ms=ms, plain_ms=p_ms, bound_ms=b_ms,
                           bound_by=b_by, products=prods))
        x = y
    if not torch.equal(x, got):
        fail("%s: the K9 passes one by one differ from the map" % what)
    k9_ms = sum(p["ms"] for p in passes)
    butterflies = 7 * (m // 2) * k
    k9 = dict(max_abs_err=0, ms=k9_ms,
              plain_ms=sum(p["plain_ms"] for p in passes),
              bound_ms=sum(p["bound_ms"] for p in passes),
              bound_by="operations" if all(p["bound_by"] == "operations"
                                           for p in passes) else "mixed",
              shape="%s: the %d passes of one map, m = 2^%d"
              % (what, len(passes), k), other_shapes=passes)
    summary = dict(m=m, build_s=t_build, map_ms=map_ms, plain_map_ms=plain_ms,
                   k8_ms=k8_ms,
                   k9_ms=k9_ms, butterflies_per_s=butterflies / k9_ms * 1e3,
                   launches=launches)
    log("  %s witness map on K8 + K9: %.4f ms (plain %.1f ms), equal; K8 "
        "%.4f ms (bound %.4f, plain %.1f), K9 passes %s; %.3e butterflies/s;"
        " CSR and word planes built in %.3f s"
        % (what, map_ms, plain_ms, k8_ms, k8["bound_ms"], k8_plain_ms,
           json.dumps([[p["range"], p["steps"], round(p["ms"], 4),
                        round(p["bound_ms"], 4)] for p in passes]),
           summary["butterflies_per_s"], t_build))
    return {kernels.CSR_MATVEC.name: k8, kernels.NTT_PASS.name: k9}, summary


def phase_merkle():
    """setup -> proofs of every msm_impl -> both verifiers on the flagship,
    BatchMerkleMembership(29, MERKLE_PROOFS), on bench_merkle's data."""
    n_proofs, depth = MERKLE_PROOFS, MERKLE_DEPTH
    log("== phase 8: the flagship, BatchMerkleMembership(%d, %d)"
        % (depth, n_proofs))
    gc.collect()
    torch.cuda.empty_cache()
    log("  host RSS %.2f GB (peak so far %.2f GB) with phase 6 freed"
        % (host_rss_now_gb(), host_rss_gb()))
    t0 = time.perf_counter()
    model = BatchMerkleMembership(depth, n_proofs, device=DEV)
    cs = model.pb
    t_build = time.perf_counter() - t0
    want = n_proofs * (depth * 733 + 1)
    if cs.num_constraints != want:
        fail("the flagship has %d constraints, not %d"
             % (cs.num_constraints, want))
    log("  circuit: %d constraints, %d variables, built in %.1f s; host RSS"
        " %.2f GB" % (cs.num_constraints, cs.num_variables, t_build,
                      host_rss_now_gb()))
    t0 = time.perf_counter()
    tree = bench_merkle.build_tree(depth, bench_merkle.N_LEAVES)
    t_tree = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.set_witness(tree, bench_merkle.proof_indices(
        n_proofs, bench_merkle.N_LEAVES))
    t_witness = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not cs.is_satisfied():
        fail("the flagship's witness does not satisfy its constraints")
    t_sat = time.perf_counter() - t0
    log("  tree of %d leaves %.1f s; witness %.2f s, of which the batched "
        "MiMC trace on the card %.2f s (%d levels x %d proofs); "
        "is_satisfied() %.1f s" % (
            bench_merkle.N_LEAVES, t_tree, t_witness, model.trace_seconds,
            depth, n_proofs, t_sat))
    kp, t_setup, setup_launches = checked_setup(cs, FULL_LOG, "the flagship")
    wm_records, wm_summary = phase_witness_map(kp.qap, cs.values,
                                               "the flagship")
    proofs, runs, launches = prove_every_impl(kp, cs, "the flagship")
    t0 = time.perf_counter()
    for rep, proof in enumerate(proofs):
        if not kp.vk.verify(proof):
            fail("flagship proof %d does not verify" % rep)
    if kp.vk.verify(bench_merkle.root_changed(proofs[0])):
        fail("the flagship proof with its root changed verifies")
    t_verify = time.perf_counter() - t0
    t0 = time.perf_counter()
    accepted, refused = bench_merkle.evm_check(
        kp.vk, proofs[0], bench_merkle.root_changed(proofs[0]))
    t_evm = time.perf_counter() - t0
    if not accepted:
        fail("the Verifier.sol twin refuses the flagship proof")
    if not refused:
        fail("the Verifier.sol twin accepts the proof with its root changed")
    log("  all %d proofs pass vk.verify, the root-changed one fails it "
        "(%.2f s); the Verifier.sol twin accepts the 'red' proof and "
        "refuses it with the root changed (%.2f s); host peak RSS %.2f GB"
        % (len(proofs), t_verify, t_evm, host_rss_gb()))
    entry = phase_merkle_entry(kp, cs, proofs[0])
    mesh = {"virtual": phase_merkle_mesh(kp, cs, proofs[0],
                                         [DEV] * MESH_SHARDS)}
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        mesh["cards"] = phase_merkle_mesh(
            kp, cs, proofs[0], list(range(1 << (n_cards.bit_length() - 1))))
    mesh["evm_path"] = merkle_path_evm(tree, n_proofs)
    return {"constraints": cs.num_constraints, "m": kp.qap.domain_size,
            "entry": entry, "mesh": mesh, "witness_map": wm_summary,
            "witness_kernels": wm_records,
            "build_seconds": t_build, "tree_seconds": t_tree,
            "witness_seconds": t_witness,
            "trace_seconds": model.trace_seconds,
            "is_satisfied_seconds": t_sat, "setup_seconds": t_setup,
            "setup_profile": kp.profile, "setup_launches": setup_launches,
            "proofs": runs, "prove_launches": launches,
            "verify_seconds": t_verify, "evm_seconds": t_evm,
            "host_peak_rss_gb": host_rss_gb()}


# ---------------------------------------------------------------- phase 8c

def phase_merkle_mesh(kp, cs, proof, devices):
    """8c: one proof of the flagship from a mesh context on ``devices``; it
    must equal the 'red' ``proof``, launch K1 and K3 of both groups only and
    pass vk.verify."""
    log("== phase 8c: the flagship on a mesh of %s" % devices)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh = make_mesh(devices=devices)
    ctx = ProverContext(kp.pk, cs, mesh=mesh, qap=kp.qap)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    kernels.reset_counts()
    t0 = time.perf_counter()
    got = ctx.prove(cs.values)
    dt = time.perf_counter() - t0
    launches = launch_counts()
    check_red_launches(launches, "the flagship's mesh proof", mesh=True)
    if got.to_json() != proof.to_json():
        fail("the flagship's mesh proof differs from its 'red' proof")
    t0 = time.perf_counter()
    if not kp.vk.verify(got):
        fail("the flagship's mesh proof does not verify")
    t_verify = time.perf_counter() - t0
    log("  make_mesh + ProverContext(mesh=..., qap=kp.qap) %.3f s (c = %s); "
        "proof %.3f s, JSON equal to the 'red' proof, vk.verify %.2f s; "
        "phases %s; launches %s; host peak RSS %.2f GB" % (
            t_setup, ctx.c, dt, t_verify, json.dumps(
                {k: round(v, 4) for k, v in ctx.last_profile.items()}),
            json.dumps({k: v for k, v in launches.items() if v}),
            host_rss_gb()))
    out = {"devices": [str(d) for d in mesh], "setup_seconds": t_setup,
           "seconds": dt, "profile": ctx.last_profile, "c": ctx.c,
           "launches": launches, "verify_seconds": t_verify}
    del ctx
    torch.cuda.empty_cache()
    return out


def merkle_path_evm(tree, n_proofs):
    """The first of the flagship's paths through the VerifyPath bytecode
    twin: its root, and another root with one sibling changed."""
    idx = bench_merkle.proof_indices(n_proofs, bench_merkle.N_LEAVES)[0]
    path = tree.proof(idx)
    t0 = time.perf_counter()
    root = evm_merkle.verify_path_evm(tree[idx], path.path, path.address)
    bad = list(path.path)
    bad[0] = (bad[0] + 1) % SNARK_SCALAR_FIELD
    root_bad = evm_merkle.verify_path_evm(tree[idx], bad, path.address)
    dt = time.perf_counter() - t0
    if root != tree.root:
        fail("the VerifyPath twin gives another root for leaf %d" % idx)
    if root_bad == tree.root:
        fail("the VerifyPath twin accepts leaf %d with a sibling changed"
             % idx)
    log("  VerifyPath twin (depth %d, leaf %d): the root, and another with "
        "one sibling changed (%.2f s for both)" % (len(path.path), idx, dt))
    return {"leaf": idx, "seconds": dt}


# ---------------------------------------------------------------- phase 8b

# Runs a module as __main__ (as ``python -m`` does) and prints every
# kernel's launch count in that process when it exits.
COUNTING_MAIN = """
import atexit, json, runpy, sys
from ethsnarks_tpu_torch.ops import kernels
atexit.register(lambda: print("LAUNCHES " + json.dumps(
    {k.name: k.launches for k in kernels.ALL}), flush=True))
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
"""


def run_module(args, want_rc, counted=False):
    """``python -m <args>`` from the repo root, which must exit with
    ``want_rc`` -> (its stdout lines, seconds, its launches or None).
    counted: run it under COUNTING_MAIN; the LAUNCHES line is taken out
    of the lines."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable] + (["-c", COUNTING_MAIN] if counted else ["-m"])
        + list(args), cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    dt = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    if proc.returncode != want_rc:
        fail("python -m %s: rc %d, not %d\n%s%s" % (
            " ".join(args), proc.returncode, want_rc, proc.stdout[-3000:],
            proc.stderr[-3000:]))
    counts = None
    if counted:
        tagged = [ln for ln in lines if ln.startswith("LAUNCHES ")]
        if len(tagged) != 1:
            fail("python -m %s printed no launch counts\n%s" % (
                " ".join(args), proc.stderr[-3000:]))
        counts = json.loads(tagged[0][len("LAUNCHES "):])
        lines = [ln for ln in lines if not ln.startswith("LAUNCHES ")]
    log("  python -m %s: rc %d, %.2f s, last line %r%s" % (
        " ".join(os.path.basename(a) for a in args), proc.returncode, dt,
        lines[-1] if lines else "", "" if counts is None else
        "; launches %s" % json.dumps({k: v for k, v in counts.items()
                                      if v})))
    return lines, dt, counts


def add_counts(*counts):
    return {k.name: sum(c[k.name] for c in counts) for k in kernels.ALL}


def phase_merkle_entry(kp, cs, proof):
    """8b: the flagship's keys through files and the one-call helpers of
    ``stubs``: the proof must equal the 'red' ``proof``, and every
    verifier flavour and ``cli.verify`` must accept it and refuse it with
    the root changed."""
    log("== phase 8b: the flagship through the entry points")
    out, times = {}, {}
    want = proof.to_json()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        vk_file, pk_file = os.path.join(d, "vk.json"), os.path.join(d, "pk")
        t0 = time.perf_counter()
        vk2json_file(kp.vk, vk_file)
        write_pk_binary(kp.pk, pk_file)
        times["key_write"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pk = stubs.load_proving_key(pk_file)
        times["key_read"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ctx = stubs.make_prover_context(pk, cs)
        times["context"] = time.perf_counter() - t0
        if ctx.device.type != DEV.type:
            fail("make_prover_context took %s, not %s" % (ctx.device, DEV))
        kernels.reset_counts()
        t0 = time.perf_counter()
        got = stubs.prove(ctx, cs)
        times["prove"] = time.perf_counter() - t0
        out["launches"] = launch_counts()
        check_red_launches(out["launches"], "the flagship's stubs.prove")
        if got != want:
            fail("stubs.prove of the flagship differs from its 'red' proof")
        log("  key write %.2f s (%.1f MB), read %.2f s, context %.2f s, "
            "stubs.prove %.3f s: JSON equal to the 'red' proof; launches %s"
            % (times["key_write"], os.path.getsize(pk_file) / 1e6,
               times["key_read"], times["context"], times["prove"],
               json.dumps({k: v for k, v in out["launches"].items() if v})))
        del ctx, pk
        torch.cuda.empty_cache()
        good = Proof.from_json(got)
        bad = bench_merkle.root_changed(good)
        files = {}
        for tag, p in (("good", good), ("bad", bad)):
            files[tag] = os.path.join(d, tag + ".json")
            with open(files[tag], "w") as fh:
                fh.write(p.to_json())
        with open(vk_file) as fh:
            vk_json = fh.read()
        vk = VerifyingKey.from_json(vk_json)
        t0 = time.perf_counter()
        pvk = vk.process()
        times["process"] = time.perf_counter() - t0
        nvk = NativeVerifier.from_dict(vk.to_dict())
        t0 = time.perf_counter()
        npvk = nvk.process_native()
        times["native_build_process"] = time.perf_counter() - t0
        flavours = [
            ("stub_verify", lambda tag, p: stubs.stub_verify(
                vk_json, p.to_json())),
            ("stub_main_verify", lambda tag, p: stubs.stub_main_verify(
                "stub_main_verify", [vk_file, files[tag]]) == 0),
            ("processed_strong", lambda tag, p:
             pvk.online_verify_strong_IC(p)),
            ("processed_weak", lambda tag, p: pvk.online_verify_weak_IC(p)),
            ("affine_weak", lambda tag, p: affine_verify_weak_IC(vk, p)),
            ("native", lambda tag, p: nvk.verify(p)),
            ("native_processed_strong", lambda tag, p: npvk.verify(p)),
            ("native_processed_weak", lambda tag, p: npvk.verify(p, False)),
            ("cli_verify", lambda tag, p: run_module(
                ["ethsnarks_tpu_torch.cli.verify", vk_file, files[tag]],
                0 if tag == "good" else 1)[0] == ["OK"])]
        for name, check in flavours:
            t0 = time.perf_counter()
            if not check("good", good):
                fail("%s refuses the flagship proof" % name)
            if check("bad", bad):
                fail("%s accepts the flagship proof with its root changed"
                     % name)
            times[name] = time.perf_counter() - t0
        npvk.close()
        sol = (vk_to_sol(vk), proof_to_sol(good))
        if not all(sol):
            fail("vk_to_sol / proof_to_sol gave empty text")
        log("  every verifier accepts the proof and refuses it with the "
            "root changed (seconds for both): %s; Solidity %d + %d chars"
            % (json.dumps({k: round(v, 3) for k, v in times.items()}),
               len(sol[0]), len(sol[1])))
    out["seconds"] = times
    return out


# ---------------------------------------------------------------- phase 12

def pinocchio_circuit(n_blocks, rng):
    """A generated ``.arith`` circuit and its ``.input`` text: two public
    inputs (a byte s and a field element acc), two nizk inputs, and
    ``n_blocks`` blocks of 27 constraints, each with every opcode the
    reader knows: split s into 8 bits; xor, or; tables of 1, 2 and 3 bits
    (t3 reads the xor and the or); acc * t3 by mul, checked again by
    assert; const-mul and const-mul-neg; acc' = the add of four wires (a
    nizk input among them); zerop of the xor; s' = pack of 7 of the bits
    and the zerop flag.  Outputs: the last acc, s and t3."""
    r = SNARK_SCALAR_FIELD
    count = [0]

    def wires(n):
        count[0] += n
        return list(range(count[0] - n, count[0]))

    def consts(n):
        return " ".join(str(int.from_bytes(rng.bytes(32), "little") % r)
                        for _ in range(n))

    def ws(ids):
        return " ".join(map(str, ids))
    s, acc = wires(2)
    nizk = wires(2)
    body = []
    for i in range(n_blocks):
        bits = wires(8)
        x, o, t1, t2, t3, m, k1, k2, acc2, zm, zy, s2 = wires(12)
        c1, c2 = (int(v) for v in rng.integers(1, 1 << 62, 2))
        body += [
            "split in 1 <%d> out 8 <%s>" % (s, ws(bits)),
            "xor in 2 <%d %d> out 1 <%d>" % (bits[0], bits[1], x),
            "or in 2 <%d %d> out 1 <%d>" % (bits[2], bits[3], o),
            "table 1 <%s> in <%d> out <%d>" % (consts(2), bits[4], t1),
            "table 2 <%s> in <%d %d> out <%d>" % (consts(4), bits[5],
                                                  bits[6], t2),
            "table 3 <%s> in <%d %d %d> out <%d>" % (consts(8), bits[7], x,
                                                     o, t3),
            "mul in 2 <%d %d> out 1 <%d>" % (acc, t3, m),
            "assert in 2 <%d %d> out 1 <%d>" % (acc, t3, m),
            "const-mul-%x in 1 <%d> out 1 <%d>" % (c1, m, k1),
            "const-mul-neg-%x in 1 <%d> out 1 <%d>" % (c2, t1, k2),
            "add in 4 <%s> out 1 <%d>" % (ws([k1, k2, t2, nizk[i % 2]]),
                                          acc2),
            "zerop in 1 <%d> out 2 <%d %d>" % (x, zm, zy),
            "pack in 8 <%s> out 1 <%d>" % (ws(bits[1:] + [zy]), s2),
        ]
        acc, s = acc2, s2
    head = ["total %d" % count[0], "input 0", "input 1",
            "nizkinput %d" % nizk[0], "nizkinput %d" % nizk[1]]
    tail = ["output %d" % w for w in (acc, s, t3)]
    inputs = {0: int(rng.integers(0, 256)), nizk[0]: None, nizk[1]: None,
              1: None}
    for w in inputs:
        if inputs[w] is None:
            inputs[w] = int.from_bytes(rng.bytes(32), "little") % r
    return ("\n".join(head + body + tail) + "\n",
            "".join("%d=%x\n" % kv for kv in sorted(inputs.items())))


def phase_pinocchio():
    """12: the generated circuit through ``python -m
    ethsnarks_tpu_torch.pinocchio``: eval, genkeys, prove, verify (and
    the proof with an output changed), test."""
    log("== phase 12: a generated Pinocchio circuit through its command "
        "line")
    t0 = time.perf_counter()
    arith, inputs = pinocchio_circuit(PINOCCHIO_BLOCKS,
                                      np.random.default_rng(SEED))
    reader = CircuitReader(arith)
    reader.set_inputs(inputs)
    outputs = reader.eval()
    cs, w2v = reader.build_constraint_system()
    reader.fill_witness(cs, w2v)
    t_build = time.perf_counter() - t0
    if not cs.is_satisfied():
        fail("the generated circuit's witness does not satisfy it")
    m = 1 << (cs.num_constraints + cs.num_inputs).bit_length()
    if m != 1 << PINOCCHIO_LOG:
        fail("the generated circuit (%d constraints) is not at m = 2^%d"
             % (cs.num_constraints, PINOCCHIO_LOG))
    want = ["%d=%d" % (w, outputs[w]) for w in reader.output_wires]
    log("  circuit: %d instructions, %d wires, %d constraints, %d public "
        "inputs, m = %d; parse, eval, constraints and witness in the parent "
        "%.2f s" % (len(reader.instructions), reader.total,
                    cs.num_constraints, cs.num_inputs, m, t_build))
    out = {"constraints": cs.num_constraints, "m": m,
           "build_seconds": t_build, "seconds": {}}
    mod = "ethsnarks_tpu_torch.pinocchio"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        path = {n: os.path.join(d, n) for n in (
            "c.arith", "c.input", "pk", "vk.json", "proof.json", "bad.json")}
        with open(path["c.arith"], "w") as fh:
            fh.write(arith)
        with open(path["c.input"], "w") as fh:
            fh.write(inputs)
        circ = path["c.arith"]
        lines, out["seconds"]["eval"], _ = run_module(
            [mod, circ, "eval", path["c.input"]], 0)
        if lines != want:
            fail("pinocchio eval printed %s, the parent's eval %s"
                 % (lines, want))
        lines, out["seconds"]["genkeys"], genkeys = run_module(
            [mod, circ, "genkeys", path["pk"], path["vk.json"]], 0, True)
        if lines[-1:] != ["OK"]:
            fail("pinocchio genkeys ended with %s" % lines[-1:])
        for k in kernels.SETUP:
            if not genkeys[k.name]:
                fail("pinocchio genkeys did not launch %s" % k.name)
        lines, out["seconds"]["prove"], prove = run_module(
            [mod, circ, "prove", path["c.input"], path["pk"],
             path["proof.json"]], 0, True)
        if lines[-1:] != ["OK"]:
            fail("pinocchio prove ended with %s" % lines[-1:])
        check_red_launches(prove, "pinocchio prove")
        lines, out["seconds"]["verify"], _ = run_module(
            [mod, circ, "verify", path["vk.json"], path["proof.json"]], 0)
        if lines != ["OK"]:
            fail("pinocchio verify printed %s" % lines)
        with open(path["proof.json"]) as fh:
            proof = json.load(fh)
        k = len(reader.input_wires)
        proof["input"][k] = hex((int(proof["input"][k], 16) + 1)
                                % SNARK_SCALAR_FIELD)
        with open(path["bad.json"], "w") as fh:
            json.dump(proof, fh)
        lines, out["seconds"]["verify_output_changed"], _ = run_module(
            [mod, circ, "verify", path["vk.json"], path["bad.json"]], 1)
        if lines != ["FAIL"]:
            fail("pinocchio verify of the changed proof printed %s" % lines)
        lines, out["seconds"]["test"], test = run_module(
            [mod, circ, "test", path["c.input"]], 0, True)
        if lines[-1:] != ["OK"]:
            fail("pinocchio test ended with %s" % lines[-1:])
        for k in kernels.SETUP + RED_KERNELS:
            if not test[k.name]:
                fail("pinocchio test did not launch %s" % k.name)
    out["launches"] = add_counts(genkeys, prove, test)
    return out


# ---------------------------------------------------------------- phase 9

def phase_sha256():
    """setup -> proofs of every msm_impl -> both verifiers on the SHA-256
    preimage, BatchSha256(1, 512) of SHA_MESSAGE (bench_workloads'
    sha256_preimage row): every witness value but the two public digest
    halves is a bit."""
    log("== phase 9: the SHA-256 preimage, BatchSha256(1, 512)")
    t0 = time.perf_counter()
    model = BatchSha256(1, 8 * len(SHA_MESSAGE), device=DEV)
    cs = model.pb
    t_build = time.perf_counter() - t0
    if cs.num_constraints != SHA_CONSTRAINTS:
        fail("BatchSha256(1, 512) has %d constraints, not %d"
             % (cs.num_constraints, SHA_CONSTRAINTS))
    t0 = time.perf_counter()
    model.set_witness([SHA_MESSAGE])        # asserts hashlib's digest
    t_witness = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not cs.is_satisfied():
        fail("the SHA-256 witness does not satisfy its constraints")
    t_sat = time.perf_counter() - t0
    log("  circuit: %d constraints, %d variables, built in %.1f s; witness "
        "(the batched trace on the card) %.2f s; is_satisfied() %.2f s"
        % (cs.num_constraints, cs.num_variables, t_build, t_witness, t_sat))
    kp, t_setup, setup_launches = checked_setup(cs, 16, "the SHA-256 circuit")
    proofs, runs, launches = prove_every_impl(kp, cs, "the SHA-256 circuit")
    digest = list(model.digests()[0])
    t0 = time.perf_counter()
    for rep, proof in enumerate(proofs):
        if proof.input != digest:
            fail("SHA-256 proof %d has inputs %s, not the digest halves"
                 % (rep, proof.input))
        if not kp.vk.verify(proof):
            fail("SHA-256 proof %d does not verify" % rep)
    bad = input_changed(proofs[0], 1)
    if kp.vk.verify(bad):
        fail("the SHA-256 proof with digest_lo + 1 verifies")
    t_verify = time.perf_counter() - t0
    t0 = time.perf_counter()
    accepted, refused = bench_merkle.evm_check(kp.vk, proofs[0], bad)
    t_evm = time.perf_counter() - t0
    if not accepted:
        fail("the Verifier.sol twin refuses the SHA-256 proof")
    if not refused:
        fail("the Verifier.sol twin accepts the SHA-256 proof with "
             "digest_lo + 1")
    log("  all %d proofs pass vk.verify with [digest_hi, digest_lo], the "
        "one with digest_lo + 1 fails it (%.2f s); the Verifier.sol twin "
        "accepts the 'red' proof and refuses the changed one (%.2f s); "
        "host peak RSS %.2f GB" % (len(proofs), t_verify, t_evm,
                                   host_rss_gb()))
    return {"constraints": cs.num_constraints, "m": kp.qap.domain_size,
            "build_seconds": t_build, "witness_seconds": t_witness,
            "is_satisfied_seconds": t_sat, "setup_seconds": t_setup,
            "setup_profile": kp.profile, "setup_launches": setup_launches,
            "proofs": runs, "prove_launches": launches,
            "verify_seconds": t_verify, "evm_seconds": t_evm,
            "host_peak_rss_gb": host_rss_gb()}


# ---------------------------------------------------------------- phase 10

def poseidon_inputs(n, rng):
    """n pairs of field elements uniform below r (254-bit draws, rejected
    at r or above)."""
    vals = []
    while len(vals) < 2 * n:
        v = int.from_bytes(rng.bytes(32), "little") >> 2
        if v < SNARK_SCALAR_FIELD:
            vals.append(v)
    return [(vals[2 * i], vals[2 * i + 1]) for i in range(n)]


def phase_poseidon():
    """setup -> proofs of every msm_impl -> vk.verify on the batched
    Poseidon hash, BatchPoseidonHash(POSEIDON_INSTANCES, 2): full-field
    witness values at m = 2^19.  Its public inputs are the 1,024 digests,
    so vk.verify (a host scalar product an input) runs once each way and
    the other proofs are held to the 'red' one by JSON."""
    n = POSEIDON_INSTANCES
    log("== phase 10: the batched Poseidon hash, BatchPoseidonHash(%d, 2)"
        % n)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = BatchPoseidonHash(n, 2, device=DEV)
    cs = model.pb
    t_build = time.perf_counter() - t0
    if cs.num_constraints != n * 316:
        fail("BatchPoseidonHash(%d, 2) has %d constraints, not %d"
             % (n, cs.num_constraints, n * 316))
    log("  circuit: %d constraints, %d variables, built in %.1f s; host RSS"
        " %.2f GB" % (cs.num_constraints, cs.num_variables, t_build,
                      host_rss_now_gb()))
    inputs = poseidon_inputs(n, np.random.default_rng(SEED))
    t0 = time.perf_counter()
    model.set_witness(inputs)
    t_witness = time.perf_counter() - t0
    t0 = time.perf_counter()
    if model.digests() != [poseidon(list(pair)) for pair in inputs]:
        fail("a batched Poseidon digest differs from the host poseidon")
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not cs.is_satisfied():
        fail("the Poseidon witness does not satisfy its constraints")
    t_sat = time.perf_counter() - t0
    log("  witness (the batched trace on the card, %d instances) %.2f s; "
        "all %d digests equal the host poseidon (%.1f s); is_satisfied() "
        "%.1f s" % (n, t_witness, n, t_host, t_sat))
    kp, t_setup, setup_launches = checked_setup(
        cs, POSEIDON_LOG, "the Poseidon circuit")
    _, wm_summary = phase_witness_map(kp.qap, cs.values,
                                      "the Poseidon circuit")
    proofs, runs, launches = prove_every_impl(kp, cs, "the Poseidon circuit")
    t0 = time.perf_counter()
    if proofs[0].input != model.digests():
        fail("the Poseidon proof's inputs are not the digests")
    if not kp.vk.verify(proofs[0]):
        fail("the Poseidon 'red' proof does not verify")
    if kp.vk.verify(input_changed(proofs[0], n // 2)):
        fail("the Poseidon proof with one digest changed verifies")
    t_verify = time.perf_counter() - t0
    log("  the 'red' proof passes vk.verify and fails it with digest %d "
        "changed (%.1f s for both); host peak RSS %.2f GB"
        % (n // 2, t_verify, host_rss_gb()))
    return {"constraints": cs.num_constraints, "m": kp.qap.domain_size,
            "build_seconds": t_build, "witness_seconds": t_witness,
            "host_digest_seconds": t_host, "is_satisfied_seconds": t_sat,
            "setup_seconds": t_setup, "setup_profile": kp.profile,
            "setup_launches": setup_launches, "proofs": runs,
            "prove_launches": launches, "verify_seconds": t_verify,
            "witness_map": wm_summary, "host_peak_rss_gb": host_rss_gb()}


# ---------------------------------------------------------------- phase 11

def other_key(proof, A):
    """The proof with its public inputs replaced by the key A."""
    return Proof(proof.A, proof.B, proof.C, [A.x.n, A.y.n])


def phase_eddsa():
    """setup -> proofs of every msm_impl -> both verifiers on the EdDSA
    verify circuit, EdDSAVerify(256, PureEdDSA_gadget), on the first
    signature of bench_workloads' eddsa16k seed; then the batched verify's
    intermediates on that seed's first EDDSA_LANES signatures."""
    log("== phase 11: the EdDSA verify circuit, EdDSAVerify(%d, "
        "PureEdDSA_gadget)" % EDDSA_MSG_BITS)
    t0 = time.perf_counter()
    sigs = bench_workloads.eddsa_signatures(EDDSA_LANES)
    t_sign = time.perf_counter() - t0
    A, sig, msg = sigs[0]
    t0 = time.perf_counter()
    model = EdDSAVerify(EDDSA_MSG_BITS, PureEdDSA_gadget)
    cs = model.pb
    t_build = time.perf_counter() - t0
    if cs.num_constraints != EDDSA_CONSTRAINTS:
        fail("EdDSAVerify(%d) has %d constraints, not %d" % (
            EDDSA_MSG_BITS, cs.num_constraints, EDDSA_CONSTRAINTS))
    t0 = time.perf_counter()
    model.set_witness(A, sig, msg, require_satisfied=False)
    t_witness = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not cs.is_satisfied():
        fail("the EdDSA witness does not satisfy its constraints")
    t_sat = time.perf_counter() - t0
    log("  %d signatures signed on the host in %.2f s; circuit: %d "
        "constraints, %d variables, built in %.2f s; witness (host curve) "
        "%.2f s; is_satisfied() %.2f s" % (
            len(sigs), t_sign, cs.num_constraints, cs.num_variables,
            t_build, t_witness, t_sat))
    kp, t_setup, setup_launches = checked_setup(
        cs, EDDSA_LOG, "the EdDSA circuit")
    proofs, runs, launches = prove_every_impl(
        kp, cs, "the EdDSA circuit", others=("red", "fused", "generic"))
    t0 = time.perf_counter()
    for rep, proof in enumerate(proofs):
        if proof.input != [A.x.n, A.y.n]:
            fail("EdDSA proof %d has inputs %s, not [A.x, A.y]"
                 % (rep, proof.input))
        if not kp.vk.verify(proof):
            fail("EdDSA proof %d does not verify" % rep)
    bad = other_key(proofs[0], sigs[1][0])
    if kp.vk.verify(bad):
        fail("the EdDSA proof verifies with another key's A")
    t_verify = time.perf_counter() - t0
    t0 = time.perf_counter()
    accepted, refused = bench_merkle.evm_check(kp.vk, proofs[0], bad)
    t_evm = time.perf_counter() - t0
    if not accepted:
        fail("the Verifier.sol twin refuses the EdDSA proof")
    if not refused:
        fail("the Verifier.sol twin accepts the EdDSA proof with another "
             "key's A")
    log("  all %d proofs pass vk.verify with [A.x, A.y], the one with the "
        "next signature's key fails it (%.2f s); the Verifier.sol twin "
        "accepts the 'red' proof and refuses the changed one (%.2f s)"
        % (len(proofs), t_verify, t_evm))

    As, lane_sigs, msgs = bench_workloads.eddsa_columns(sigs)
    inputs = eddsa_ops.prepare(As, lane_sigs, msgs, DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lhs, hash_pt, rhs = eddsa_ops.eddsa_verify_parts(*inputs)
    mask = jubjub_ops.etec_equal(lhs, rhs).cpu().tolist()
    t_parts = time.perf_counter() - t0
    got = [jubjub_ops.device_to_points(p) for p in (lhs, hash_pt, rhs)]
    base = PureEdDSA.B()
    for i, (Ai, (R, s), m) in enumerate(sigs):
        t = PureEdDSA.hash_public(R, Ai, m)
        if got[0][i] != base * s:
            fail("EdDSA lane %d: lhs differs from the host's s B" % i)
        if got[1][i].x.n != t:
            fail("EdDSA lane %d: the Pedersen hash's x differs from the "
                 "host's" % i)
        if got[2][i] != R + Ai * t:
            fail("EdDSA lane %d: rhs differs from the host's R + t A" % i)
    if mask != [True] * len(sigs):
        fail("the batched verify refuses a valid lane: %s" % mask)
    log("  batched verify of %d lanes on the card %.2f s: lhs, the hash's "
        "x and rhs equal the host's on every lane, every lane accepts"
        % (len(sigs), t_parts))
    return {"constraints": cs.num_constraints, "m": kp.qap.domain_size,
            "sign_seconds": t_sign, "build_seconds": t_build,
            "witness_seconds": t_witness, "is_satisfied_seconds": t_sat,
            "setup_seconds": t_setup, "setup_profile": kp.profile,
            "setup_launches": setup_launches, "proofs": runs,
            "prove_launches": launches, "verify_seconds": t_verify,
            "evm_seconds": t_evm, "batch_lanes": len(sigs),
            "batch_seconds": t_parts, "evm": eddsa_evm(sigs),
            "host_peak_rss_gb": host_rss_gb()}


def eddsa_evm(sigs):
    """The EdDSA.sol twin on the first signature's key, R and message,
    signed under the contract's rule (s = t k, t = sha256(R, A, M) masked
    to 250 bits; the circuit's PureEdDSA hashes with Pedersen and checks
    s B = R + t A instead) with the key's secret k, drawn as
    ``bench_workloads.eddsa_signatures`` draws it; then with the next
    signature's key."""
    A, (R, _), msg = sigs[0]
    k = int.from_bytes(np.random.default_rng(bench_workloads.EDDSA_SEED)
                       .bytes(32), 'little') % (JUBJUB_L - 1) + 1
    if PureEdDSA.B() * k != A:
        fail("the first eddsa16k key is not k B")
    m = int.from_bytes(msg, 'big')
    t = int.from_bytes(hashlib.sha256(b''.join(
        v.to_bytes(32, 'big') for v in (R.x.n, R.y.n, A.x.n, A.y.n, m)))
        .digest(), 'big') & evm_jubjub.MASK_250
    s = t * k % JUBJUB_L
    t0 = time.perf_counter()
    good = evm_jubjub.eddsa_verify_evm((A.x.n, A.y.n), m, (R.x.n, R.y.n), s)
    A1 = sigs[1][0]
    bad = evm_jubjub.eddsa_verify_evm((A1.x.n, A1.y.n), m, (R.x.n, R.y.n),
                                      s)
    dt = time.perf_counter() - t0
    if not good:
        fail("the EdDSA.sol twin refuses the first key's signature")
    if bad:
        fail("the EdDSA.sol twin accepts the signature with the next key")
    log("  EdDSA.sol twin: accepts the first key's signature, refuses it "
        "with the next key (%.2f s for both)" % dt)
    return {"seconds": dt}


# ---------------------------------------------------------------- main

def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log("== phase 1: device %s (%s); torch %s, CUDA %s"
        % (torch.cuda.get_device_name(0), smi, torch.__version__,
           torch.version.cuda))
    t0 = time.perf_counter()
    _build.build()
    log("  kernels built in %.1f s; compiler report:" % (
        time.perf_counter() - t0))
    for line in _build.build_log().splitlines():
        if "Used" in line or "stack frame" in line or \
                "Compiling entry" in line or "Function properties" in line:
            log("    " + line.strip())
    report = compiler_report(_build.build_log())
    symbols = {k.name: kernel_symbol(k, report) for k in kernels.ALL}
    # K2's one-thread path beside its team path
    team = {k.name: kernel_symbol(k, report, "_team")
            for k in kernels.POINT_DOUBLE.values()}
    mix = sass_mix(_build._stem("msm_kernels") + ".so",
                   set(symbols.values()) | set(team.values())) or {}
    resources = {}
    for k in kernels.ALL:
        sym = team.get(k.name, symbols[k.name])
        resources[k.name] = dict(report.get(sym) or {})
        resources[k.name]["sass"] = mix.get(sym)
        if k.name in team:
            resources[k.name]["one_thread_path"] = dict(
                report.get(symbols[k.name]) or {},
                sass=mix.get(symbols[k.name]))
        log("  %-20s %s" % (k.name, json.dumps(resources[k.name])))

    rng = np.random.default_rng(SEED)
    ctx = fixture_context()
    card_state("before phase 2")
    t_fq, rec = phase_fq_chain()
    rec.update(phase_kernels(rng, sorted(set(ctx.c.values())), t_fq))
    card_state("after phase 2")
    rec.update(phase_k4(rng))
    for name, r in phase_fused_kernels(rng, resources, t_fq).items():
        rec.setdefault(name, {}).update(r)
    card_state("after phase 2c")
    fixture_setup = phase_fixture_setup()
    fixture_zk = phase_fixture_zk(ctx)
    launches, profiles = phase_prove(ctx)
    log("== phase 5: full size")
    card_state("before the MSMs")
    # K5's calls by window count over every run of phases 5b and 6b
    fold_windows = {}
    bucket_fold = kernels.bucket_fold
    kernels.bucket_fold = counting_fold_windows(fold_windows)
    full = {}
    for g2 in (False, True):
        tag = "msm_g2" if g2 else "msm_g1"
        full[tag], inputs = phase_msm(g2, rng)
        log("== phase 5b: %s through the dense and scan drivers" % tag)
        full[tag + "_routes"] = phase_msm_routes(g2, *inputs)
        if not g2:
            log("== phase 5c: msm_g1 on a mesh of %d virtual shards"
                % MESH_SHARDS)
            full["msm_g1_mesh"] = phase_msm_mesh(*inputs)
        del inputs
        torch.cuda.empty_cache()
    full["transform"] = phase_transform(rng)
    log("  full-size results: %s" % json.dumps(full))
    log("  fixture prove profiles: %s" % json.dumps(profiles))
    path = phase_full_path()
    kernels.bucket_fold = bucket_fold
    log("  K5 calls by window count over every run of phases 5b and 6b: %s"
        % json.dumps(fold_windows))
    card_state("after phase 6")
    entry = phase_entry_points()
    merkle = phase_merkle()
    rec.update(merkle.pop("witness_kernels"))
    sha = phase_sha256()
    pos = phase_poseidon()
    ed = phase_eddsa()
    pino = phase_pinocchio()
    card_state("at the end")
    log("  full-path results: %s" % json.dumps(
        dict(path, fixture_setup=fixture_setup, fixture_zk=fixture_zk),
        default=str))
    log("  flagship results: %s" % json.dumps(merkle, default=str))
    log("  SHA-256 results: %s" % json.dumps(sha, default=str))
    log("  Poseidon results: %s" % json.dumps(pos, default=str))
    log("  EdDSA results: %s" % json.dumps(ed, default=str))
    log("  Pinocchio results: %s" % json.dumps(pino, default=str))
    # launches by path: the setups (K4), their 'red' proofs (K1, K3),
    # their 'fused' and 'generic' proofs and the 5b MSMs (K1-K3, K5, K6),
    # the probe (K7, K7b), and the entry points of phases 8b and 12 (K1,
    # K3, K4); "launches" is their sum
    chain = "chain_2^%d" % CHAIN_LOG
    by_path = {"setup_" + chain: path["setup_launches"],
               "prove_%s_red_x2" % chain: path["prove_launches"],
               "probe": entry["probe_launches"],
               "entry": add_counts(merkle["entry"]["launches"],
                                   pino["launches"])}
    for tag, r in (("2^20_merkle", merkle), ("2^16_sha256", sha),
                   ("2^19_poseidon", pos), ("2^13_eddsa", ed)):
        by_path["setup_" + tag] = r["setup_launches"]
        for impl, counts in r["prove_launches"].items():
            by_path["prove_%s_%s" % (tag, impl)] = counts
    for impl, r in path["msm_impls"].items():
        by_path["prove_%s_%s" % (chain, impl)] = r["launches"]
    # the mesh path: 5c's sharded MSMs (one run each) and 8c's proofs
    by_path["mesh"] = add_counts(
        full["msm_g1_mesh"]["red"]["launches"],
        full["msm_g1_mesh"]["scan"]["launches"],
        *[r["launches"] for key, r in merkle["mesh"].items()
          if key != "evm_path"])
    for tag in ("msm_g1", "msm_g2"):
        for impl, r in full[tag + "_routes"].items():
            by_path["%s_2^20_%s" % (tag, impl)] = r["launches"]
    fixture_launches = dict(launches,
                            **{k.name: fixture_setup["launches"][k.name]
                               for k in kernels.SETUP})

    out = []
    for k in kernels.ALL:
        r = rec[k.name]
        per_path = {p: c[k.name] for p, c in by_path.items() if c[k.name]}
        out.append({"name": k.name, "route": k.route, "source": k.source,
                    "replaces": k.replaces,
                    "launches": sum(per_path.values()),
                    "launches_by_path": per_path,
                    "fixture_launches": fixture_launches[k.name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": None,
                    "shape": r["shape"]})
        out[-1].update({key: r[key] for key in (
            "one_lane_ms", "one_lane_latency_floor_ms", "latency_floor_ms",
            "steps", "t_fq_ms", "other_shapes", "pairfold_ms", "plain_shape",
            "rates", "all_levels_ms", "schedule", "by_windows") if key in r})
        if k in kernels.BUCKET_FOLD.values():
            tag = k.name[-2:] + " "
            out[-1]["calls_by_windows"] = {
                key[3:]: n for key, n in fold_windows.items()
                if key.startswith(tag)}
        out[-1].update(resources[k.name])
        if not out[-1]["launches"]:
            fail("kernel %s was launched on no main path" % k.name)
    log("total %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
