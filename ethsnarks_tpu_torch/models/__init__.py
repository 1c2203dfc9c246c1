"""Provable workloads (counterpart of ``ethsnarks_tpu/models``): each
model builds its circuit from :mod:`..gadgets`, fills its witness and
proves through :mod:`..groth16`.  The batched Merkle membership fills all
its proofs' witnesses with the batched MiMC trace of :mod:`..ops.mimc` on
the model's device."""

from .merkle_batch import BatchMerkleMembership  # noqa: F401
from .merkle_membership import MerkleMembership  # noqa: F401
from .mimc_preimage import MiMCPreimage  # noqa: F401
