"""The flagship workload on the card: depth-29 MiMC Merkle membership, N
proofs in one circuit (counterpart of ``tools/bench_merkle_prove.py``).

    python -m ethsnarks_tpu_torch.bench_merkle [n_proofs=48] [reps=2]

Data: a ``MerkleTree(1 << 29)`` holding the 4,096 leaves 1234567 + 7919 i,
and proofs at the well-separated indices i (4096 // n) + 1.  The run
builds :class:`.models.BatchMerkleMembership` (29, n) (1,020,384
constraints at n = 48, domain 2^20), fills its witness with the batched
MiMC trace, makes a key with a seeded rng, proves ``reps`` times, and
checks the last proof with ``vk.verify`` and on the Verifier.sol bytecode
twin (:mod:`.evm_verifier`).  It prints each phase's seconds, then one
JSON line, and exits 1 unless both verifiers accept the proof and refuse
it with the public root changed.  ``chip_smoke.py`` runs the same
functions.
"""

import json
import random
import sys
import time

from .evm_verifier import evm_verify
from .evmasm import EvmError
from .field import SNARK_SCALAR_FIELD
from .groth16 import ProverContext, generator
from .merkletree import MerkleTree
from .models import BatchMerkleMembership
from .verifier import Proof

DEPTH = 29
N_LEAVES = 4096
SETUP_SEED = 12345


def build_tree(depth=DEPTH, n_leaves=N_LEAVES):
    """The bench's tree: leaves 1234567 + 7919 i, i < n_leaves."""
    tree = MerkleTree(1 << depth)
    tree.extend(1234567 + i * 7919 for i in range(n_leaves))
    return tree


def proof_indices(n_proofs, n_leaves=N_LEAVES):
    """Well-separated leaves, as the reference's bench proves them."""
    return [i * (n_leaves // max(1, n_proofs)) + 1 for i in range(n_proofs)]


def seeded_rng(seed=SETUP_SEED):
    rng = random.Random(seed)
    return lambda: rng.randrange(1, SNARK_SCALAR_FIELD)


def root_changed(proof):
    """The proof with its public root plus one."""
    return Proof(proof.A, proof.B, proof.C,
                 [(proof.input[0] + 1) % SNARK_SCALAR_FIELD]
                 + list(proof.input[1:]))


def evm_check(vk, proof, tampered):
    """(``proof`` accepted, ``tampered`` refused) on the Verifier.sol
    bytecode twin; a revert counts as a refusal."""
    try:
        refused = not evm_verify(vk, tampered)
    except EvmError:
        refused = True
    return evm_verify(vk, proof), refused


def run(n_proofs=48, reps=2, device=None, log=print):
    """The whole bench -> its result dict (see the module docstring)."""
    secs = {}
    t0 = time.perf_counter()
    model = BatchMerkleMembership(DEPTH, n_proofs, device=device)
    cs = model.pb
    secs['build'] = time.perf_counter() - t0
    log("circuit: %d constraints (%d proofs x depth %d), %.1f s"
        % (cs.num_constraints, n_proofs, DEPTH, secs['build']))
    t0 = time.perf_counter()
    tree = build_tree()
    secs['tree'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.set_witness(tree, proof_indices(n_proofs))
    secs['witness'] = time.perf_counter() - t0
    secs['trace'] = model.trace_seconds
    log("tree %.1f s; witness %.1f s (trace %.2f s)"
        % (secs['tree'], secs['witness'], secs['trace']))
    t0 = time.perf_counter()
    kp = generator(cs, rng=seeded_rng(), device=model.device)
    secs['setup'] = time.perf_counter() - t0
    log("setup %.1f s (m = %d)" % (secs['setup'], kp.qap.domain_size))
    ctx = ProverContext(kp.pk, cs, device=model.device, qap=kp.qap)
    prove_sec = []
    for _ in range(reps):
        t0 = time.perf_counter()
        proof = ctx.prove(cs.values)
        prove_sec.append(time.perf_counter() - t0)
        log("prove %.3f s; routes %s" % (prove_sec[-1], ctx.last_routes))
    t0 = time.perf_counter()
    verified = kp.vk.verify(proof)
    tampered_refused = not kp.vk.verify(root_changed(proof))
    evm_verified, evm_refused = evm_check(kp.vk, proof,
                                           root_changed(proof))
    secs['verify'] = time.perf_counter() - t0
    log("vk.verify %s, root changed refused %s; Verifier.sol twin %s, "
        "root changed refused %s (%.1f s)" % (
            verified, tampered_refused, evm_verified, evm_refused,
            secs['verify']))
    return {"constraints": cs.num_constraints,
            "domain": kp.qap.domain_size, "n_proofs": n_proofs,
            "prove_sec": prove_sec, "setup_sec": secs['setup'],
            "seconds": secs, "verified": verified,
            "evm_verified": evm_verified,
            "tampered_refused": tampered_refused and evm_refused}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    n_proofs = int(argv[0]) if argv else 48
    reps = int(argv[1]) if len(argv) > 1 else 2
    out = run(n_proofs, reps)
    print(json.dumps(out), flush=True)
    ok = out["verified"] and out["evm_verified"] and out["tampered_refused"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
