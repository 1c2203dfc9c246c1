"""PyTorch/CUDA port of the ethsnarks_tpu Groth16 setup and prover.

The JAX package ``ethsnarks_tpu`` is the reference; this package imports
nothing of it (nor JAX) and keeps its own copies of what it needs.  The
paths are the nozk setup (:func:`groth16.generator`: QAP, host instance
map, every query as one fixed-base batch multiplication on a hand-written
Hopper kernel) and the nozk prover (:class:`groth16.ProverContext`:
witness map, window digits, four Pippenger MSMs on hand-written Hopper
kernels, host finalisation); the kernels are in ``csrc/``.

Entry points take ``device=None``, which means the CUDA card.  Without one
they raise: nothing drops to the CPU unless the caller passes
``device="cpu"`` (as the tests do).
"""

import torch


def resolve_device(device=None):
    """``None`` -> ``cuda`` (raises without a card); else ``torch.device``."""
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
