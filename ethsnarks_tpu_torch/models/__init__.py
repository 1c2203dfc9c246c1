"""Provable workloads (counterpart of ``ethsnarks_tpu/models``): each
model builds its circuit from :mod:`..gadgets`, fills its witness and
proves through :mod:`..groth16`.  The batched models fill all their
instances' witnesses with one batched trace on the model's device: the
Merkle membership with the MiMC trace of :mod:`..ops.mimc`, the Poseidon
hash with :mod:`..ops.poseidon_ops`, SHA-256 with :mod:`..ops.sha256_ops`.
``EdDSAVerify`` verifies one EdDSA signature in the circuit, its witness
from the host oracle (:mod:`..jubjub`); ``eddsa_open`` and its variants
check a signature through that circuit."""

from .eddsa_verify import (  # noqa: F401
    EdDSAVerify, eddsa_open, pureeddsa_open, hasheddsa_open)
from .merkle_batch import BatchMerkleMembership  # noqa: F401
from .merkle_membership import MerkleMembership  # noqa: F401
from .mimc_preimage import MiMCPreimage  # noqa: F401
from .poseidon_batch import BatchPoseidonHash  # noqa: F401
from .sha256_batch import BatchSha256  # noqa: F401
