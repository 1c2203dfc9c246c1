"""The models' common prove step."""

from .. import resolve_device
from ..groth16 import ProverContext, generator


def prove(pb, keypair=None, context=None, device=None, rng=None,
          msm_impl='auto'):
    """Prove ``pb``'s witness -> (proof, keypair, context).  Without a
    keypair or a context, a setup of ``pb`` with ``rng`` on ``device``
    (None: the card) makes the key; without a context, one is made on
    ``device`` with ``msm_impl``, reusing the setup's QAP where it was
    compiled for that device."""
    dev = resolve_device(device)
    if keypair is None and context is None:
        keypair = generator(pb, rng=rng, device=dev)
    if context is None:
        qap = keypair.qap if keypair.qap is not None and \
            keypair.qap.device == dev else None
        context = ProverContext(keypair.pk, pb, device=dev, qap=qap,
                                msm_impl=msm_impl)
    return context.prove(pb.values), keypair, context
