"""The port's Groth16 setup (ethsnarks_tpu_torch.groth16.generator, plain
path on the CPU with every batch on K4's plain version) against the JAX
package's ``generator(device_exp=False)`` with the same seeded rng: equal
points, byte-identical binary key and verifying-key JSON, and proofs from
the port's key that both verifiers accept."""
import random

import pytest

from ethsnarks_tpu.field import SNARK_SCALAR_FIELD
from ethsnarks_tpu.groth16 import generator as ref_generator
from ethsnarks_tpu.serialization import r1cs_to_dict, \
    write_pk_binary as ref_write_pk_binary
from ethsnarks_tpu.verifier import Proof as RefProof, \
    VerifyingKey as RefVerifyingKey

from ethsnarks_tpu_torch.groth16 import ProverContext, generator
from ethsnarks_tpu_torch.ops import curve
from ethsnarks_tpu_torch.serialization import r1cs_from_dict, \
    read_pk_binary, write_pk_binary
from ethsnarks_tpu_torch.verifier import Proof

from torch_port_helpers import torch_threads  # noqa: F401

SEED = 4321


def _seeded():
    rng = random.Random(SEED)
    return lambda: rng.randrange(1, SNARK_SCALAR_FIELD)


def _g1(pts):
    return [None if p is None else (p[0].n, p[1].n) for p in pts]


def _g2(pts):
    return [None if p is None else (tuple(p[0].coeffs), tuple(p[1].coeffs))
            for p in pts]


@pytest.fixture(scope="module")
def keys():
    from test_groth16 import _cubic_circuit
    pb = _cubic_circuit()
    want = ref_generator(pb, rng=_seeded(), device_exp=False)
    cs = r1cs_from_dict(r1cs_to_dict(pb))
    got = generator(cs, rng=_seeded(), device='cpu')
    return pb, cs, want, got


def test_keypair_points_equal_reference(keys):
    _, _, want, got = keys
    pk, ref = got.pk, want.pk
    assert pk.a_idx.tolist() == [i for i, _ in ref.a_query]
    assert pk.b_idx.tolist() == [i for i, _ in ref.b_query]
    assert _g1(curve.tensor_to_g1(pk.a_pts)) == _g1([p for _, p in
                                                     ref.a_query])
    assert _g2(curve.tensor_to_g2(pk.b_pts)) == _g2([p for _, p in
                                                     ref.b_query])
    assert _g1(curve.tensor_to_g1(pk.h_pts)) == _g1(ref.h_query_bitrev)
    assert _g1(curve.tensor_to_g1(pk.l_pts)) == _g1(ref.l_query)
    assert _g1([pk.alpha_g1]) == _g1([ref.alpha_g1])
    assert _g2([pk.beta_g2, pk.delta_g2]) == _g2([ref.beta_g2,
                                                  ref.delta_g2])
    assert pk.num_inputs == ref.num_inputs
    assert set(got.profile) == {'qap_build', 'instance_map', 'a_query',
                                'b_query_g2', 'h_query', 'l_query',
                                'gamma_abc', 'vk_pk'}


def test_binary_key_and_vk_json_identical(keys, tmp_path):
    _, _, want, got = keys
    ref_write_pk_binary(want.pk, str(tmp_path / "want.bin"))
    write_pk_binary(got.pk, str(tmp_path / "got.bin"))
    assert (tmp_path / "got.bin").read_bytes() == \
        (tmp_path / "want.bin").read_bytes()
    assert got.vk.to_json() == want.vk.to_json()
    # and the port reads back what it wrote
    again = read_pk_binary(str(tmp_path / "got.bin"), 'cpu')
    assert _g1(curve.tensor_to_g1(again.h_pts)) == \
        _g1(curve.tensor_to_g1(got.pk.h_pts))


def test_instance_map_matches_reference(keys):
    from ethsnarks_tpu.qap import QAP as RefQAP
    pb, _, _, got = keys
    t = 123456789
    assert got.qap.instance_map(t) == RefQAP(pb).instance_map(t)


def test_port_proof_verifies_under_both_verifiers(keys):
    pb, cs, want, got = keys
    proof = ProverContext(got.pk, cs, device='cpu',
                          qap=got.qap).prove(pb.values)
    assert got.vk.verify(proof)
    assert want.vk.verify(RefProof.from_json(proof.to_json()))
    assert RefVerifyingKey.from_json(got.vk.to_json()).verify(
        RefProof.from_json(proof.to_json()))
    tampered = Proof(proof.A, proof.B, proof.C, [proof.input[0] + 1])
    assert not got.vk.verify(tampered)
    assert not want.vk.verify(RefProof.from_json(tampered.to_json()))
    swapped = Proof(proof.C, proof.B, proof.A, proof.input)
    assert not got.vk.verify(swapped)
