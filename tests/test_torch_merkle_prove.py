"""A depth-1, one-proof batched Merkle model proved by the port
(``BatchMerkleMembership.prove`` on the CPU's plain path, seeded setup
rng) against the JAX package's model proved on its host path
(``use_device_msm=False``) with the same rng: equal proof JSON, which
both verifiers accept, and which fails with the public root changed.

The reference's host prove takes about a minute, so its proof and
verifying key are committed in ``ethsnarks_tpu_torch/fixtures/
merkle_depth1/``; the test makes the reference's key again (a few
seconds) and holds it to the committed vk.json.  Regenerate with::

    JAX_PLATFORMS=cpu python tests/test_torch_merkle_prove.py
"""
import os
import random
import sys

from torch_port_helpers import torch_threads  # noqa: F401

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
FIXTURE = os.path.join(ROOT, "ethsnarks_tpu_torch", "fixtures",
                       "merkle_depth1")
LEAVES = [1234567, 1234567 + 7919]
SETUP_SEED = 2024


def _rng(seed):
    from ethsnarks_tpu.field import SNARK_SCALAR_FIELD
    rng = random.Random(seed)
    return lambda: rng.randrange(1, SNARK_SCALAR_FIELD)


def _ref_model():
    from ethsnarks_tpu.merkletree import MerkleTree
    from ethsnarks_tpu.models.merkle_batch import BatchMerkleMembership
    tree = MerkleTree(2)
    for v in LEAVES:
        tree.append(v)
    return BatchMerkleMembership(depth=1, n_proofs=1).set_witness(tree, [1])


def write_fixture(out_dir):
    proof, keypair, _ = _ref_model().prove(use_device_msm=False,
                                           rng=_rng(SETUP_SEED))
    assert keypair.vk.verify(proof)
    os.makedirs(out_dir, exist_ok=True)
    for name, text in (("proof.json", proof.to_json()),
                       ("vk.json", keypair.vk.to_json())):
        with open(os.path.join(out_dir, name), "w") as fh:
            fh.write(text)


def test_depth1_proof_matches_reference():
    from ethsnarks_tpu.groth16 import generator as ref_generator
    from ethsnarks_tpu.verifier import Proof as RefProof, \
        VerifyingKey as RefVerifyingKey

    from ethsnarks_tpu_torch.bench_merkle import root_changed
    from ethsnarks_tpu_torch.merkletree import MerkleTree
    from ethsnarks_tpu_torch.models import BatchMerkleMembership

    with open(os.path.join(FIXTURE, "proof.json")) as fh:
        want_proof = fh.read()
    with open(os.path.join(FIXTURE, "vk.json")) as fh:
        want_vk = fh.read()
    ref = _ref_model()
    assert ref_generator(ref.pb, rng=_rng(SETUP_SEED),
                         device_exp=False).vk.to_json() == want_vk

    tree = MerkleTree(2)
    tree.extend(LEAVES)
    model = BatchMerkleMembership(depth=1, n_proofs=1, device='cpu')
    model.set_witness(tree, [1])
    assert model.pb.values == ref.pb.values
    proof, keypair, ctx = model.prove(rng=_rng(SETUP_SEED))
    assert ctx.qap is keypair.qap
    assert keypair.vk.to_json() == want_vk
    assert proof.to_json() == want_proof
    assert proof.input == [tree.root]
    assert keypair.vk.verify(proof)
    assert RefVerifyingKey.from_json(want_vk).verify(
        RefProof.from_json(proof.to_json()))
    assert not keypair.vk.verify(root_changed(proof))


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    write_fixture(FIXTURE)
    print("wrote", FIXTURE)
