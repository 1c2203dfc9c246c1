"""The port's multi-device prover, ``ProverContext(mesh=...)``, on a mesh
of two CPU devices with the kernels' plain versions: its nozk proof
against the reference host prover's JSON (``use_device_msm=False``) and
the port's ``vk.verify``, a blinded proof, and the argument rules."""
import random

import pytest
import torch

from ethsnarks_tpu.field import SNARK_SCALAR_FIELD as R
from ethsnarks_tpu.groth16 import generator as ref_generator, \
    ProverContext as RefContext
from ethsnarks_tpu.serialization import r1cs_to_dict

from ethsnarks_tpu_torch.groth16 import ProverContext, generator
from ethsnarks_tpu_torch.parallel import make_mesh
from ethsnarks_tpu_torch.parallel.mesh import Mesh
from ethsnarks_tpu_torch.serialization import r1cs_from_dict

from torch_port_helpers import torch_threads  # noqa: F401

SEED = 1234


def _seeded():
    rng = random.Random(SEED)
    return lambda: rng.randrange(1, R)


@pytest.fixture(scope="module")
def cubic():
    """The cubic circuit, the port's zk key from the reference's setup
    seed (its nozk part is the reference's key, point for point) and a
    context on two CPU shards."""
    from test_groth16 import _cubic_circuit
    pb = _cubic_circuit()
    cs = r1cs_from_dict(r1cs_to_dict(pb))
    kp = generator(cs, rng=_seeded(), device='cpu', zk=True)
    ctx = ProverContext(kp.pk, cs, use_device_msm=False,
                        mesh=make_mesh(devices=['cpu'] * 2), qap=kp.qap)
    return pb, cs, kp, ctx


def test_mesh_proof_matches_reference_host_prover(cubic):
    pb, _, kp, ctx = cubic
    proof = ctx.prove(pb.values)
    ref_kp = ref_generator(pb, rng=_seeded(), device_exp=False)
    want = RefContext(ref_kp.pk, pb, use_device_msm=False).prove(
        pb.values).to_json()
    assert proof.to_json() == want
    assert kp.vk.verify(proof)
    assert set(ctx.last_profile) >= {'witness_map', 'exchange', 'h_msm',
                                     'a_msm', 'b_msm_g2', 'l_msm'}
    assert set(ctx.last_routes.values()) == {'mesh'}


def test_mesh_blinded_proof_verifies(cubic):
    pb, _, kp, ctx = cubic
    rng = random.Random(5)
    proof = ctx.prove(pb.values, blind=True,
                      rng=lambda: rng.randrange(1, R))
    assert kp.vk.verify(proof)
    assert 'b1_msm' in ctx.last_profile and ctx.last_routes['b1'] == 'mesh'


def test_mesh_argument_errors(cubic):
    _, cs, kp, _ = cubic
    mesh = make_mesh(devices=['cpu'] * 2)
    with pytest.raises(ValueError):
        ProverContext(kp.pk, cs, mesh=mesh, device='cpu')
    with pytest.raises(ValueError):
        ProverContext(kp.pk, cs, mesh=mesh, msm_impl='generic')
    # a mesh of cards asked with use_device_msm=False (made here without
    # a card)
    with pytest.raises(ValueError):
        ProverContext(kp.pk, cs, use_device_msm=False,
                      mesh=Mesh([torch.device('cuda', 0)] * 2))
