"""The port's processed, affine and native verifiers and its precomputed
Miller loop, on ``tests/test_verifier.py``'s ``VK_STATIC`` /
``PROOF_STATIC``, against the JAX package's."""
import pytest

from ethsnarks_tpu import bn254 as ref_bn254, pairing as ref_pairing
from ethsnarks_tpu.verifier import VerifyingKey as RefVerifyingKey, \
    Proof as RefProof

from ethsnarks_tpu_torch import bn254, pairing, verifier
from ethsnarks_tpu_torch.verifier import NativeVerifier, Proof, \
    VerifyingKey, affine_verify_weak_IC

from test_verifier import PROOF_STATIC, VK_STATIC


def _fq12_ints(f):
    return [int(c) for c in f.coeffs]


@pytest.fixture(scope="module")
def static():
    vk = VerifyingKey.from_dict(VK_STATIC)
    proof = Proof.from_dict(PROOF_STATIC)
    bad = Proof(proof.A, proof.B, proof.C, [proof.input[0], 8])
    short = Proof(proof.A, proof.B, proof.C, proof.input[:1])
    return vk, proof, bad, short


@pytest.fixture(scope="module")
def processed(static):
    return static[0].process()


def test_miller_loop_precomp_matches_plain_loops(static):
    """G2Precomp(gamma) against both packages' plain Miller loop, at a G1
    point of the proof and at the negated C."""
    vk, proof = static[0], static[1]
    ref_gamma = RefVerifyingKey.from_dict(VK_STATIC).gamma
    pre = pairing.G2Precomp(vk.gamma)
    for p in (proof.A, bn254.neg(proof.C)):
        got = pairing.miller_loop_precomp(pre, p)
        plain = pairing.miller_loop(pairing.twist(vk.gamma),
                                    pairing.cast_g1_to_fq12(p))
        ref_p = (ref_bn254.Fq(p[0].n), ref_bn254.Fq(p[1].n))
        want = ref_pairing.miller_loop(ref_pairing.twist(ref_gamma),
                                       ref_pairing.cast_g1_to_fq12(ref_p))
        assert _fq12_ints(got) == _fq12_ints(plain) == _fq12_ints(want)
    assert pairing.miller_loop_precomp(pre, None) == bn254.Fq12.one()
    assert len(pre.steps) == len(ref_pairing.G2Precomp(ref_gamma).steps)


def test_processed_key_matches_reference(processed):
    ref = RefVerifyingKey.from_dict(VK_STATIC).process()
    assert _fq12_ints(processed.alpha_beta) == _fq12_ints(ref.alpha_beta)


@pytest.mark.parametrize('strong', [True, False], ids=['strong', 'weak'])
def test_processed_verify(static, processed, strong):
    vk, proof, bad, short = static
    check = processed.online_verify_strong_IC if strong else \
        processed.online_verify_weak_IC
    assert check(proof)
    assert not check(bad)
    assert not check(short)   # strong: its length; weak: the pairing
    ref_pvk = RefVerifyingKey.from_dict(VK_STATIC).process()
    ref_check = ref_pvk.online_verify_strong_IC if strong else \
        ref_pvk.online_verify_weak_IC
    assert not ref_check(RefProof.from_dict(dict(
        PROOF_STATIC, input=[PROOF_STATIC['input'][0], '0x8'])))
    with pytest.raises(TypeError):
        processed.online_verify_weak_IC(PROOF_STATIC)


def test_processed_verify_refuses_off_curve(static, processed):
    vk, proof = static[0], static[1]
    off = (proof.A[0], proof.A[1] + 1)
    assert not processed.online_verify_weak_IC(
        Proof(off, proof.B, proof.C, proof.input))


def test_affine_verify_weak_IC(static):
    vk, proof, bad, _ = static
    assert affine_verify_weak_IC(vk, proof)
    assert not affine_verify_weak_IC(vk, bad)


def test_native_verifier(static):
    vk, proof, bad, _ = static
    lib = verifier.native_library()
    nvk = NativeVerifier.from_dict(VK_STATIC)
    assert nvk.verify(proof, lib)
    assert not nvk.verify(bad, lib)
    assert nvk.verify(proof)          # the default path builds the same


def test_native_processed_vk(static):
    vk, proof, bad, short = static
    pvk = NativeVerifier.from_dict(VK_STATIC).process_native()
    try:
        assert pvk.verify(proof)
        assert pvk.verify(proof, strong_ic=False)
        assert not pvk.verify(bad)
        assert not pvk.verify(bad, strong_ic=False)
        assert not pvk.verify(short)
        assert not pvk.verify(short, strong_ic=False)
    finally:
        pvk.close()
    pvk.close()   # a second close is a no-op


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A failed make raises; nothing falls back."""
    monkeypatch.setattr(verifier, "NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(verifier, "NATIVE_BUILD", str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="native verifier failed"):
        verifier.native_library()
