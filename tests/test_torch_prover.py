"""The port's nozk prover (ethsnarks_tpu_torch.groth16, plain path on the
CPU) against the JAX package's host prover: byte-identical proof JSON, a
proof the reference verifier accepts, and the committed fixture's proof."""
import json
import os
import random

import pytest
import torch

from ethsnarks_tpu.field import SNARK_SCALAR_FIELD
from ethsnarks_tpu.groth16 import generator, ProverContext as RefContext
from ethsnarks_tpu.serialization import r1cs_to_dict, write_pk_binary
from ethsnarks_tpu.verifier import Proof as RefProof

import ethsnarks_tpu_torch
from ethsnarks_tpu_torch.groth16 import Config, ProverContext
from ethsnarks_tpu_torch.serialization import read_pk_binary, \
    r1cs_from_dict, witness_from_json
from ethsnarks_tpu_torch.verifier import Proof

from torch_port_helpers import torch_threads  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "ethsnarks_tpu_torch", "fixtures", "mimc_chain_10")


@pytest.fixture(scope="module")
def cubic(tmp_path_factory):
    from test_groth16 import _cubic_circuit
    pb = _cubic_circuit()
    seeded = random.Random(1234)
    keypair = generator(pb, rng=lambda: seeded.randrange(
        1, SNARK_SCALAR_FIELD), device_exp=False)
    path = str(tmp_path_factory.mktemp("cubic") / "pk.bin")
    write_pk_binary(keypair.pk, path)
    return pb, keypair, path


def test_cubic_proof_matches_reference_and_verifies(cubic):
    pb, keypair, path = cubic
    ctx = ProverContext(read_pk_binary(path, 'cpu'),
                        r1cs_from_dict(r1cs_to_dict(pb)), device='cpu')
    got = ctx.prove(pb.values).to_json()
    want = RefContext(keypair.pk, pb, use_device_msm=False).prove(
        pb.values).to_json()
    assert got == want
    assert keypair.vk.verify(RefProof.from_json(got))
    assert set(ctx.last_profile) >= {'witness_map', 'h_msm', 'a_msm',
                                     'b_msm_g2', 'l_msm'}


def test_fixture_proof_matches_stored():
    with open(os.path.join(FIXTURE, "r1cs.json")) as fh:
        cs = r1cs_from_dict(json.load(fh))
    ctx = ProverContext(read_pk_binary(os.path.join(FIXTURE, "pk.bin"),
                                       'cpu'), cs, device='cpu')
    proof = ctx.prove(witness_from_json(os.path.join(FIXTURE,
                                                     "witness.json")))
    with open(os.path.join(FIXTURE, "proof.json")) as fh:
        assert proof.to_json() == fh.read()


def test_proof_json_layout_matches_reference():
    from ethsnarks_tpu import bn254 as ref
    from ethsnarks_tpu_torch import bn254 as port
    a, c = ref.multiply(ref.G1_GEN, 5), ref.multiply(ref.G1_GEN, 7)
    b = ref.multiply(ref.G2_GEN, 11)
    want = RefProof(A=a, B=b, C=c, input=[35, 0, 1 << 200])
    got = Proof(A=(port.Fq(a[0].n), port.Fq(a[1].n)),
                B=(port.Fq2(b[0].coeffs), port.Fq2(b[1].coeffs)),
                C=(port.Fq(c[0].n), port.Fq(c[1].n)), input=want.input)
    assert got.to_json() == want.to_json()


def test_default_device_without_cuda_raises(monkeypatch, cubic):
    pb, _, path = cubic
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ethsnarks_tpu_torch.resolve_device(None)
    with pytest.raises(RuntimeError):
        read_pk_binary(path)
    with pytest.raises(RuntimeError):
        ProverContext(read_pk_binary(path, 'cpu'),
                      r1cs_from_dict(r1cs_to_dict(pb)))
    with pytest.raises(RuntimeError):
        ethsnarks_tpu_torch.resolve_device('cuda')


def test_blind_not_ported(cubic):
    """A nozk key (the binary key holds no zk extras) refuses blinding with
    the reference's ValueError; a witness not starting with 1 is refused
    too."""
    pb, _, path = cubic
    ctx = ProverContext(read_pk_binary(path, 'cpu'),
                        r1cs_from_dict(r1cs_to_dict(pb)), device='cpu')
    assert not ctx.pk.has_zk_extras
    with pytest.raises(ValueError):
        ctx.prove(pb.values, blind=True)
    with pytest.raises(ValueError):
        ctx.prove([2] + pb.values[1:])


def test_config_multi_exp_c_sets_every_window(cubic):
    """Config(multi_exp_c=c) gives every MSM c window bits, and the proof
    stays the reference's."""
    pb, keypair, path = cubic
    ctx = ProverContext(read_pk_binary(path, 'cpu'),
                        r1cs_from_dict(r1cs_to_dict(pb)), device='cpu',
                        config=Config(multi_exp_c=9))
    assert ctx.c == dict(h=9, a=9, b=9, l=9)
    want = RefContext(keypair.pk, pb, use_device_msm=False).prove(pb.values)
    assert ctx.prove(pb.values).to_json() == want.to_json()
    with pytest.raises(ValueError):
        Config(msm_static_plan='sometimes')
