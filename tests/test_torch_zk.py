"""The zk form of the port's key and proof (ethsnarks_tpu_torch.groth16
``generator(zk=True)`` and ``prove(blind=True)``, plain path on the CPU)
against the JAX package's, on the one-gadget MiMC circuit of
tests/test_zk_blinding.py: the four cases there, plus the zk keypair equal
point for point to the reference's ``generator(zk=True, device_exp=False)``
and a blinded proof with a fixed rng equal to the reference's blinded
proof JSON.  The reference's blinded host prove takes about half a
minute, so that proof is committed in ``ethsnarks_tpu_torch/fixtures/
zk_mimc/``; regenerate it with::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_zk.py
"""
import os
import random

import pytest

from ethsnarks_tpu.groth16 import generator as ref_generator
from ethsnarks_tpu.verifier import Proof as RefProof

from ethsnarks_tpu_torch.field import SNARK_SCALAR_FIELD
from ethsnarks_tpu_torch.gadgets import MiMCe7_gadget
from ethsnarks_tpu_torch.groth16 import ProverContext, generator
from ethsnarks_tpu_torch.mimc import mimc
from ethsnarks_tpu_torch.ops import curve
from ethsnarks_tpu_torch.r1cs import ConstraintSystem

from test_zk_blinding import _circuit as ref_circuit
from torch_port_helpers import affine, torch_threads  # noqa: F401

P = SNARK_SCALAR_FIELD
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "ethsnarks_tpu_torch", "fixtures", "zk_mimc")


def _circuit():
    """The port's build of test_zk_blinding's circuit: digest = E_k(x)."""
    pb = ConstraintSystem()
    digest = pb.allocate('digest')
    pb.set_input_sizes(1)
    x = pb.allocate('x')
    k = pb.allocate('k')
    g = MiMCe7_gadget(pb, x + 0, k + 0, 'mimc')
    g.generate_r1cs_constraints()
    pb.add_constraint(g.result() + 0, 1, digest + 0, 'bind')
    pb.setval(x, 123)
    pb.setval(k, 456)
    g.generate_r1cs_witness()
    pb.setval(digest, mimc(123, 456))
    assert pb.is_satisfied()
    return pb


def _rng(seed):
    rng = random.Random(seed)
    return lambda: rng.randrange(1, P)


@pytest.fixture(scope="module")
def zk():
    """Both packages' zk keypairs from one seed, and two blinded proofs of
    the port from one blinding rng."""
    pb = _circuit()
    ref_pb = ref_circuit()
    assert pb.values == ref_pb.values
    want = ref_generator(ref_pb, rng=_rng(77), device_exp=False, zk=True)
    got = generator(pb, rng=_rng(77), device='cpu', zk=True)
    ctx = ProverContext(got.pk, pb, device='cpu', qap=got.qap)
    blinder = _rng(99)
    blinded = [ctx.prove(pb.values, blind=True, rng=blinder)
               for _ in range(2)]
    return pb, ref_pb, want, got, ctx, blinded


def test_zk_key_has_extras(zk):
    _, _, _, got, _, _ = zk
    assert got.pk.has_zk_extras
    assert 'b_query_g1' in got.profile


def test_zk_keypair_equals_reference(zk):
    _, _, want, got, _, _ = zk
    pk, ref = got.pk, want.pk
    assert pk.b_idx.tolist() == [i for i, _ in ref.b_query_g1]
    assert [affine(p) for p in curve.tensor_to_g1(pk.b1_pts)] == \
        [affine(p) for _, p in ref.b_query_g1]
    assert [affine(p) for p in curve.tensor_to_g1(pk.a_pts)] == \
        [affine(p) for _, p in ref.a_query]
    assert [affine(p) for p in curve.tensor_to_g2(pk.b_pts)] == \
        [affine(p) for _, p in ref.b_query]
    assert [affine(p) for p in curve.tensor_to_g1(pk.h_pts)] == \
        [affine(p) for p in ref.h_query_bitrev]
    assert [affine(p) for p in curve.tensor_to_g1(pk.l_pts)] == \
        [affine(p) for p in ref.l_query]
    assert [affine(p) for p in (pk.alpha_g1, pk.beta_g1, pk.delta_g1,
                                pk.beta_g2, pk.delta_g2)] == \
        [affine(p) for p in (ref.alpha_g1, ref.beta_g1, ref.delta_g1,
                             ref.beta_g2, ref.delta_g2)]
    assert got.vk.to_json() == want.vk.to_json()


def test_blinded_proof_verifies_and_randomizes(zk):
    _, _, want, got, _, (p1, p2) = zk
    assert got.vk.verify(p1)
    assert got.vk.verify(p2)
    assert want.vk.verify(RefProof.from_json(p2.to_json()))
    assert p1.to_json() != p2.to_json()


def test_blinded_proof_equals_reference(zk):
    _, _, want, _, _, (p1, _) = zk
    with open(os.path.join(FIXTURE, "vk.json")) as fh:
        assert fh.read() == want.vk.to_json()
    with open(os.path.join(FIXTURE, "proof_blinded.json")) as fh:
        assert p1.to_json() == fh.read()


def test_unblinded_stays_deterministic(zk):
    pb, _, _, got, ctx, _ = zk
    p1 = ctx.prove(pb.values)
    p2 = ctx.prove(pb.values)
    assert p1.to_json() == p2.to_json()
    assert got.vk.verify(p1)
    assert 'b1' not in ctx.last_routes


def test_nozk_key_rejects_blinding(zk):
    pb, _, _, got, _, _ = zk
    kp = generator(pb, rng=_rng(77), device='cpu')
    assert not kp.pk.has_zk_extras
    # the same draws: the nozk key is the zk key without its extras
    assert kp.vk.to_json() == got.vk.to_json()
    ctx = ProverContext(kp.pk, pb, device='cpu', qap=kp.qap)
    with pytest.raises(ValueError):
        ctx.prove(pb.values, blind=True)


def write_fixture(out_dir):
    """The reference's zk key (rng seed 77) and its first blinded proof
    with blinding rng seed 99 (host prove)."""
    from ethsnarks_tpu.groth16 import ProverContext as RefContext
    pb = ref_circuit()
    kp = ref_generator(pb, rng=_rng(77), device_exp=False, zk=True)
    proof = RefContext(kp.pk, pb, use_device_msm=False).prove(
        pb.values, blind=True, rng=_rng(99))
    assert kp.vk.verify(proof)
    os.makedirs(out_dir, exist_ok=True)
    for name, text in (("proof_blinded.json", proof.to_json()),
                       ("vk.json", kp.vk.to_json())):
        with open(os.path.join(out_dir, name), "w") as fh:
            fh.write(text)


if __name__ == "__main__":
    write_fixture(FIXTURE)
    print("wrote", FIXTURE)
