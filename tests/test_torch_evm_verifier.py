"""The port's fixture proof and verifying key (ethsnarks_tpu_torch/
fixtures/mimc_chain_10), read by the port's readers, accepted by the
bytecode twin of contracts/Verifier.sol, both the JAX package's
evm_verifier (on the mini-EVM of tests/test_evm_verifier.py) and the
port's own copy (ethsnarks_tpu_torch.evm_verifier on its evmasm); a proof
with one coordinate changed is refused.  The points cross to the JAX
package as integers; the port's twin reads the port's own objects."""
import os

import pytest

from ethsnarks_tpu.bn254 import Fq2
from ethsnarks_tpu.evm_verifier import encode_calldata, groth16_verifier_code
from ethsnarks_tpu.evmasm import EvmError, execute
from ethsnarks_tpu.verifier import Proof as RefProof, \
    VerifyingKey as RefVerifyingKey

from ethsnarks_tpu_torch import evm_verifier, evmasm
from ethsnarks_tpu_torch.verifier import Proof, VerifyingKey

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "ethsnarks_tpu_torch", "fixtures", "mimc_chain_10")


def _g1(pt):
    return [pt[0].n, pt[1].n]


def _g2(pt):
    return tuple(Fq2([int(c) for c in x.coeffs]) for x in pt)


def _ints(vk, proof):
    """The port's key and proof as the JAX package's, from integers."""
    ref_vk = RefVerifyingKey(_g1(vk.alpha), _g2(vk.beta), _g2(vk.gamma),
                             _g2(vk.delta), [_g1(p) for p in vk.gammaABC])
    ref_proof = RefProof(_g1(proof.A), _g2(proof.B), _g1(proof.C),
                         [int(v) for v in proof.input])
    return ref_vk, ref_proof


def _run(vk, proof):
    out = execute(groth16_verifier_code(), encode_calldata(vk, proof))
    return bool(int.from_bytes(out, 'big'))


def _port_fixture():
    vk = VerifyingKey.from_file(os.path.join(FIXTURE, "vk.json"))
    with open(os.path.join(FIXTURE, "proof.json")) as fh:
        return vk, Proof.from_json(fh.read())


@pytest.fixture(scope="module")
def fixture_key_and_proof():
    return _ints(*_port_fixture())


def test_port_verifier_code_equals_reference():
    assert evm_verifier.groth16_verifier_code() == groth16_verifier_code()


def test_fixture_proof_accepted_by_port_twin():
    vk, proof = _port_fixture()
    assert evm_verifier.evm_verify(vk, proof)
    ref_vk, ref_proof = _ints(vk, proof)
    assert evm_verifier.encode_calldata(vk, proof) == \
        encode_calldata(ref_vk, ref_proof)


def test_fixture_proof_accepted(fixture_key_and_proof):
    vk, proof = fixture_key_and_proof
    assert _run(vk, proof)


@pytest.mark.parametrize('where', ['A.y', 'C.x', 'input'])
def test_tampered_fixture_proof_refused(fixture_key_and_proof, where):
    """One coordinate (or the public input) plus one: the pairing check
    fails, or the precompile rejects a point off the curve and the
    verifier reverts."""
    vk, proof = fixture_key_and_proof
    A, C, inputs = list(proof.A), list(proof.C), list(proof.input)
    if where == 'A.y':
        A[1] += 1
    elif where == 'C.x':
        C[0] += 1
    else:
        inputs[0] += 1
    bad = RefProof(A, proof.B, C, inputs)
    try:
        assert not _run(vk, bad)
    except EvmError:
        pass


@pytest.mark.parametrize('where', ['A.y', 'C.x', 'input'])
def test_tampered_fixture_proof_refused_by_port_twin(where):
    """As above, on the port's own execute: refused or reverted."""
    from ethsnarks_tpu_torch.bn254 import Fq
    vk, proof = _port_fixture()
    A, C, inputs = list(proof.A), list(proof.C), list(proof.input)
    if where == 'A.y':
        A[1] = Fq(A[1].n + 1)
    elif where == 'C.x':
        C[0] = Fq(C[0].n + 1)
    else:
        inputs[0] += 1
    bad = Proof(tuple(A), proof.B, tuple(C), inputs)
    try:
        assert not evm_verifier.evm_verify(vk, bad)
    except evmasm.EvmError:
        pass
