"""One-call helpers over setup, prover and verifier (own copy of
``ethsnarks_tpu/stubs.py``).

:func:`stub_genkeys_from_pb` / :func:`stub_genkeys` write ``vk.json`` and
the binary Montgomery-form proving key (:func:`.serialization.
write_pk_binary`); :func:`load_proving_key` reads it back; :func:`prove`
turns a context and a satisfied protoboard into proof JSON;
:func:`stub_verify`, :func:`stub_main_verify` and
:func:`stub_test_proof_verify` check proofs.

Everything runs on the CUDA card unless the caller asks for the CPU, with
``use_device_msm=False`` or ``device='cpu'``.  Two differences from the
reference, both deliberate:

- :func:`stub_test_proof_verify` defaults to ``use_device_msm=True`` (the
  reference's defaults to its host prover);
- :func:`load_proving_key` reads the binary key or a pickle of this
  package's own ``ProvingKey``; a pickle of the reference's key names the
  JAX package's classes and is refused with ValueError.
"""

import pickle

from . import resolve_device
from .groth16 import generator, ProverContext, ProvingKey
from .verifier import VerifyingKey, Proof
from .serialization import (
    vk2json_file, write_pk_binary, read_pk_binary, _PK_MAGIC)


def stub_genkeys_from_pb(pb, pk_file, vk_file, rng=None, device=None):
    """Setup of ``pb`` on ``device`` (None = the card); writes both keys
    and returns the keypair."""
    keypair = generator(pb, rng=rng, device=device)
    vk2json_file(keypair.vk, vk_file)
    write_pk_binary(keypair.pk, pk_file)
    return keypair


def stub_genkeys(gadget_cls, pk_file, vk_file, *gadget_args, rng=None,
                 device=None):
    """``gadget_cls`` on a fresh protoboard, constrained, then its keys."""
    from .r1cs import ConstraintSystem
    pb = ConstraintSystem()
    gadget = gadget_cls(pb, *gadget_args)
    gadget.generate_r1cs_constraints()
    stub_genkeys_from_pb(pb, pk_file, vk_file, rng=rng, device=device)
    return pb, gadget


class _PortUnpickler(pickle.Unpickler):
    """Loads only classes of this package (and builtins): a pickle of the
    reference's key would import the JAX package."""

    def find_class(self, module, name):
        if module.split('.')[0] not in ('ethsnarks_tpu_torch', 'builtins',
                                        'collections', 'torch', 'numpy'):
            raise ValueError(
                "pickled proving key names %s.%s: only the binary key "
                "(magic %r) and pickles of this package's ProvingKey load"
                % (module, name, _PK_MAGIC))
        return super().find_class(module, name)


def load_proving_key(pk_file, device=None):
    """The binary Montgomery-form key (sniffed by its magic) or a pickle
    of this package's :class:`groth16.ProvingKey`, on ``device`` (None =
    the card).  Anything else raises ValueError naming what was read."""
    with open(pk_file, 'rb') as fh:
        head = fh.read(len(_PK_MAGIC))
    if head == _PK_MAGIC:
        return read_pk_binary(pk_file, device)
    with open(pk_file, 'rb') as fh:
        try:
            pk = _PortUnpickler(fh).load()
        except (pickle.UnpicklingError, EOFError) as e:
            raise ValueError(
                "%s: neither a binary proving key (head %r, magic %r) nor "
                "a pickle (%s)" % (pk_file, head, _PK_MAGIC, e)) from e
    if not isinstance(pk, ProvingKey):
        raise ValueError("%s: a pickle of %s, not a ProvingKey"
                         % (pk_file, type(pk).__name__))
    return pk.to(resolve_device(device))


def make_prover_context(pk, pb, use_device_msm=True):
    return ProverContext(pk, pb, use_device_msm=use_device_msm)


def prove(context, pb):
    """A ProverContext and a satisfied protoboard -> proof JSON."""
    return context.prove(pb.values).to_json()


def prove_from_pb(pb, pk_file, use_device_msm=True):
    """Load the key, prove ``pb``'s witness -> proof JSON (the working
    form of the reference's stub_prove_from_pb)."""
    pk = load_proving_key(pk_file, None if use_device_msm else 'cpu')
    return prove(ProverContext(pk, pb, use_device_msm=use_device_msm), pb)


def stub_verify(vk_json, proof_json):
    vk = VerifyingKey.from_json(vk_json)
    proof = Proof.from_json(proof_json)
    return vk.verify(proof)


def stub_main_verify(prog_name, args):
    if len(args) < 2:
        print("Usage: %s <vk.json> <proof.json>" % prog_name)
        return 1
    with open(args[0]) as fh:
        vk_json = fh.read()
    with open(args[1]) as fh:
        proof_json = fh.read()
    if stub_verify(vk_json, proof_json):
        print("OK")
        return 0
    print("FAIL")
    return 1


def stub_test_proof_verify(pb, rng=None, use_device_msm=True):
    """Setup, proof and verification of ``pb`` in one process.  True (the
    default) runs setup and proof on the card; False is the explicit
    request for the CPU (the reference's default)."""
    device = None if use_device_msm else 'cpu'
    keypair = generator(pb, rng=rng, device=device)
    context = ProverContext(keypair.pk, pb, use_device_msm=use_device_msm,
                            qap=keypair.qap)
    proof = context.prove(pb.values)
    return keypair.vk.verify(proof)
