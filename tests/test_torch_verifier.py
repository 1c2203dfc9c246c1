"""The port's verifier (ethsnarks_tpu_torch verifier, pairing) on the
committed fixture's verifying key and proof, against the JAX package's
verdicts."""
import json
import os

import pytest

from ethsnarks_tpu.verifier import Proof as RefProof, \
    VerifyingKey as RefVerifyingKey

from ethsnarks_tpu_torch import bn254
from ethsnarks_tpu_torch.pairing import pairing
from ethsnarks_tpu_torch.verifier import Proof, VerifyingKey

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "ethsnarks_tpu_torch", "fixtures", "mimc_chain_10")


@pytest.fixture(scope="module")
def fixture():
    vk = VerifyingKey.from_file(os.path.join(FIXTURE, "vk.json"))
    with open(os.path.join(FIXTURE, "vk.json")) as fh:
        vk_json = fh.read()
    with open(os.path.join(FIXTURE, "proof.json")) as fh:
        proof_json = fh.read()
    return vk, vk_json, proof_json


def _tampered(proof_json):
    """One field changed in each way: the input, A, and C."""
    d = json.loads(proof_json)
    out = []
    e = dict(d, input=[hex(int(d['input'][0], 16) + 1)])
    out.append(json.dumps(e))
    g = bn254.multiply(bn254.G1_GEN, 5)
    for key in ('A', 'C'):
        e = dict(d)
        e[key] = [hex(g[0].n), hex(g[1].n)]
        out.append(json.dumps(e))
    return out


def test_fixture_proof_accepted(fixture):
    vk, vk_json, proof_json = fixture
    assert vk.to_json() == vk_json
    proof = Proof.from_json(proof_json)
    assert proof.to_json() == proof_json
    assert vk.verify(proof)
    assert vk.verify_weak_IC(proof)
    assert RefVerifyingKey.from_json(vk_json).verify(
        RefProof.from_json(proof_json))


@pytest.mark.parametrize('which', [0, 1, 2], ids=['input', 'A', 'C'])
def test_tampered_proof_rejected_as_reference(fixture, which):
    vk, vk_json, proof_json = fixture
    bad = _tampered(proof_json)[which]
    got = vk.verify(Proof.from_json(bad))
    want = RefVerifyingKey.from_json(vk_json).verify(RefProof.from_json(bad))
    assert got is False and want is False


def test_input_count_rules(fixture):
    vk, _, proof_json = fixture
    proof = Proof.from_json(proof_json)
    extra = Proof(proof.A, proof.B, proof.C, proof.input + [0])
    assert not vk.verify(extra)
    assert not vk.verify_weak_IC(extra)
    with pytest.raises(TypeError):
        vk.verify(tuple(proof))


def test_off_curve_point_rejected_on_load(fixture):
    _, _, proof_json = fixture
    d = json.loads(proof_json)
    d['A'] = ['0x1', '0x3']
    with pytest.raises(ValueError):
        Proof.from_dict(d)


def test_pairing_bilinear():
    g1, g2 = bn254.G1_GEN, bn254.G2_GEN
    assert pairing(g2, bn254.multiply(g1, 6)) == \
        pairing(bn254.multiply(g2, 3), bn254.multiply(g1, 2))
