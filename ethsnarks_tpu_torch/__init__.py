"""PyTorch/CUDA port of the ethsnarks_tpu Groth16 setup and prover.

The JAX package ``ethsnarks_tpu`` is the reference; this package imports
nothing of it (nor JAX) and keeps its own copies of what it needs.  The
paths are the setup (:func:`groth16.generator`, nozk or with
``zk=True`` the zk key: QAP, host instance map, every query as one
fixed-base batch multiplication on a hand-written Hopper kernel) and the
prover (:class:`groth16.ProverContext`, nozk or blinded with r and s:
witness map, window digits, the Pippenger MSMs on hand-written Hopper
kernels, host finalisation); the kernels are in ``csrc/``.  The circuit
library (``gadgets``, ``models``) with its batched witness traces
(``ops/mimc.py``, ``ops/sha256_ops.py``, ``ops/poseidon_ops.py``) feeds
them; ``ops/eddsa_ops.py`` verifies EdDSA signatures in batches.  The
reference's user surface sits on top: ``stubs``, ``pinocchio`` and
``cli`` (``python -m`` entry points), the key and proof formats of
``serialization``, and the processed, affine and native verifiers.

Entry points take ``device=None``, which means the CUDA card.  Without one
they raise: nothing drops to the CPU unless the caller passes
``device="cpu"`` (as the tests do) or, to the prover, the reference's
``use_device_msm=False``.

torch is imported on first use, so the host-only tools (``pinocchio
eval``, ``cli.verify``, ``python -m ethsnarks_tpu_torch.mimc``) start
without it.
"""


def resolve_device(device=None):
    """``None`` -> ``cuda`` (raises without a card); else ``torch.device``."""
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' explicitly to run the "
                "plain PyTorch versions")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device %r requested but CUDA is not available"
                           % (device,))
    return dev
