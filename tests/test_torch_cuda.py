"""The port's CUDA kernels on the card, against their plain twins.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
fixture, never at import).  On a machine with a card and without JAX::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package."""
import json
import os
import random

import numpy as np
import pytest
import torch

from ethsnarks_tpu_torch import bn254
from ethsnarks_tpu_torch.field import SNARK_SCALAR_FIELD
from ethsnarks_tpu_torch.groth16 import ProverContext, generator
from ethsnarks_tpu_torch import probe
from ethsnarks_tpu_torch.ops import curve, fold, int_probe, kernels, msm, \
    msm_dense, msm_scan
from ethsnarks_tpu_torch.ops.batch_exp import BatchExp, C, N_WIN
from ethsnarks_tpu_torch.ops import witness_words
from ethsnarks_tpu_torch.ops.fp import Fr, h16_to_words, ints_to_words_np, \
    words_to_h16
from ethsnarks_tpu_torch.ops.ntt import NttDomain
from ethsnarks_tpu_torch.qap import QAP, WordDomain
from ethsnarks_tpu_torch.serialization import read_pk_binary, \
    r1cs_from_dict, witness_from_json, write_pk_binary

from torch_port_helpers import carry_edge_values, random_constraint_system

pytestmark = pytest.mark.cuda

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "ethsnarks_tpu_torch", "fixtures", "mimc_chain_10")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _points(n, g2, device, seed):
    gen = bn254.G2_GEN if g2 else bn254.G1_GEN
    base = [bn254.multiply(gen, j + 1) for j in range(32)] + [None]
    rng = np.random.default_rng(seed)
    conv = curve.g2_to_tensor if g2 else curve.g1_to_tensor
    table = conv(base, device)
    return table[torch.from_numpy(rng.integers(0, len(base), n)).to(
        device)].contiguous()


@pytest.mark.parametrize('g2', [False, True], ids=['g1', 'g2'])
def test_kernels_match_twins(card, g2):
    n = 2048
    P, Q = _points(n, g2, card, 1), _points(n, g2, card, 2)
    Q[:64] = P[:64]
    rng = np.random.default_rng(3)
    ia = torch.from_numpy(rng.integers(0, n, n)).to(card)
    ib = torch.from_numpy(rng.integers(-1, n, n)).to(card)
    W = P.reshape((4, n // 4) + P.shape[1:]).contiguous()
    for got, want in (
            (kernels.point_add(P, Q, g2=g2), curve.point_add_plain(P, Q, g2=g2)),
            (kernels.point_add(P, Q, ia, ib, g2),
             curve.point_add_plain(P, Q, ia, ib, g2)),
            (kernels.point_double(P, g2), curve.point_double_plain(P, g2)),
            (kernels.horner(W, 4, g2), curve.horner_plain(W, 4, g2))):
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def _carry_edge_points(n, g2, device, seed):
    """n raw coordinate triples, not on the curve, every coordinate (each
    Fq part on G2) one of :func:`carry_edge_values` as Montgomery words."""
    rng = np.random.default_rng(seed)
    vals = carry_edge_values(bn254.FIELD_MODULUS, rng)
    pick = rng.integers(0, len(vals), n * (6 if g2 else 3))
    words = ints_to_words_np([vals[i] for i in pick])
    return torch.from_numpy(words).reshape(
        (n,) + curve.point_shape(g2)).to(device)


@pytest.mark.parametrize('g2', [False, True], ids=['g1', 'g2'])
def test_point_kernels_carry_edges(card, g2):
    """K1 (with and without indices) and K2 on coordinates that reach the
    field core's rare carries: the RCB15 formulas are polynomials, so
    kernel and plain version agree bit for bit off the curve too."""
    n = 4096
    P, Q = _carry_edge_points(n, g2, card, 11), \
        _carry_edge_points(n, g2, card, 12)
    rng = np.random.default_rng(13)
    ia = torch.from_numpy(rng.integers(0, n, n)).to(card)
    ib = torch.from_numpy(rng.integers(-1, n, n)).to(card)
    for got, want in (
            (kernels.point_add(P, Q, g2=g2), curve.point_add_plain(P, Q, g2=g2)),
            (kernels.point_add(P, Q, ia, ib, g2),
             curve.point_add_plain(P, Q, ia, ib, g2)),
            (kernels.point_double(P, g2), curve.point_double_plain(P, g2))):
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize('g2', [False, True], ids=['g1', 'g2'])
def test_team_kernels_match_plain(card, g2):
    """K2 on its team path (1 and 16 lanes, n = 1 and 16) and K3 (one
    accumulator of 16 windows at c = 16, the red pairfold's tail of 16
    windows of 16 lanes at c = 1, a batch with a spare team) word for word
    against their plain versions, on curve points with identities and on
    carry-edge coordinates."""
    P = _points(256, g2, card, 14)
    E = _carry_edge_points(64, g2, card, 15)
    assert kernels.double_team(16, g2, kernels.card_sms(card))
    for pts in (P, E):
        for lanes in (1, 16):
            for n in (1, 16):
                A = pts[:lanes].contiguous()
                got = kernels.point_double(A, g2, n)
                torch.cuda.synchronize()
                assert torch.equal(got, curve.point_double_plain(A, g2, n))
        for n_win, batch, c in ((16, 1, 16), (16, 3, 1), (3, 5, 2)):
            W = pts[:n_win * batch].reshape(
                (n_win, batch) + pts.shape[1:]).contiguous()
            got = kernels.horner(W, c, g2)
            torch.cuda.synchronize()
            assert torch.equal(got, curve.horner_plain(W, c, g2))


def test_fq_chain_matches_plain(card):
    x, y = probe.fq_inputs(300, card, seed=2)
    got = kernels.fq_chain(x, y, 50)
    torch.cuda.synchronize()
    assert torch.equal(got, int_probe.fq_chain_plain(x, y, 50))


@pytest.mark.parametrize('g2', [False, True], ids=['g1', 'g2'])
def test_msm_on_card(card, g2):
    n = 256
    gen = bn254.G2_GEN if g2 else bn254.G1_GEN
    pts = [bn254.multiply(gen, j + 1) for j in range(n)]
    rng = np.random.default_rng(4)
    scalars = [int.from_bytes(rng.bytes(32), 'little') % bn254.CURVE_ORDER
               for _ in range(n)]
    conv = curve.g2_to_tensor if g2 else curve.g1_to_tensor
    digits = msm.window_digits(torch.from_numpy(
        ints_to_words_np(scalars)).to(card), 8)
    got = (msm.msm_g2 if g2 else msm.msm_g1)(conv(pts, card), digits, 8)
    want = None
    for s, p in zip(scalars, pts):
        want = bn254.add(want, bn254.multiply(p, s))
    assert got == want


def test_prove_fixture_on_card(card):
    with open(os.path.join(FIXTURE, "r1cs.json")) as fh:
        cs = r1cs_from_dict(json.load(fh))
    ctx = ProverContext(read_pk_binary(os.path.join(FIXTURE, "pk.bin")), cs)
    proof = ctx.prove(witness_from_json(os.path.join(FIXTURE,
                                                     "witness.json")))
    with open(os.path.join(FIXTURE, "proof.json")) as fh:
        assert proof.to_json() == fh.read()


@pytest.mark.parametrize('g2', [False, True], ids=['g1', 'g2'])
def test_fixed_base_mul_matches_plain(card, g2):
    gen = bn254.G2_GEN if g2 else bn254.G1_GEN
    be = BatchExp(gen, g2, device=card)
    rng = np.random.default_rng(5)
    scalars = [0, 1, bn254.CURVE_ORDER - 1] + \
        [d << (8 * (d % 32)) for d in range(1, 0x31)] + \
        [int.from_bytes(rng.bytes(32), 'little') % bn254.CURVE_ORDER
         for _ in range(2000)]
    words = torch.from_numpy(ints_to_words_np(scalars)).to(card)
    before = kernels.FIXED_BASE_MUL[g2].launches
    got = be.mul_many(scalars)
    torch.cuda.synchronize()
    assert kernels.FIXED_BASE_MUL[g2].launches == before + 1
    assert torch.equal(got, curve.fixed_base_plain(be.table, words, N_WIN, C,
                                                   g2))
    host = (curve.tensor_to_g2 if g2 else curve.tensor_to_g1)(got[:64])
    assert host == [bn254.multiply(gen, s) for s in scalars[:64]]


def test_setup_reproduces_fixture_key(card, tmp_path):
    with open(os.path.join(FIXTURE, "r1cs.json")) as fh:
        cs = r1cs_from_dict(json.load(fh))
    seeded = random.Random(20261016)
    kp = generator(cs, rng=lambda: seeded.randrange(1, SNARK_SCALAR_FIELD))
    write_pk_binary(kp.pk, str(tmp_path / "pk.bin"))
    with open(os.path.join(FIXTURE, "pk.bin"), "rb") as fh:
        assert (tmp_path / "pk.bin").read_bytes() == fh.read()
    with open(os.path.join(FIXTURE, "vk.json")) as fh:
        assert kp.vk.to_json() == fh.read()


# (n_win, c, SMs, blocks an SM, threads a block) of tests/test_torch_fold.py
FOLD_CASES = [(1, 7, 132, 3, 32), (2, 6, 132, 4, 32), (16, 4, 132, 3, 32),
              (1, 7, 2, 1, 32), (2, 7, 2, 1, 32), (16, 4, 2, 1, None),
              (1, 6, 2, 1, 32), (1, 8, 3, 1, 32), (1, 11, 132, 3, 32)]


@pytest.mark.parametrize('g2', [False, True], ids=['g1', 'g2'])
def test_fold_and_scan_kernels_match_plain(card, g2):
    """K5 in this card's schedule and in those of the CPU tests (several
    blocks a window and the tail launch, parts of 3 buckets, two partials
    a tail thread), K6 one launch and all levels, against their plain
    versions on the card."""
    B = _points(16 << 6, g2, card, 6)
    sms, blocks = kernels.card_shape(card, g2)
    got = kernels.bucket_fold(B, 16, 6, g2)
    torch.cuda.synchronize()
    assert torch.equal(got, fold.bucket_fold_plain(
        B, 16, 6, g2, fold.fold_schedule(16, 6, g2, sms, blocks)))
    for n_win, c, sms, blocks, threads in FOLD_CASES:
        sched = fold.fold_schedule(n_win, c, g2, sms, blocks, threads)
        B = _points(n_win << c, g2, card, c)
        got = kernels.bucket_fold(B, n_win, c, g2, sched)
        torch.cuda.synchronize()
        assert torch.equal(got, fold.bucket_fold_plain(B, n_win, c, g2,
                                                       sched))
    rng = np.random.default_rng(7)
    n = 3000
    keys = np.sort(rng.integers(0, 200, n))
    keys[:3] = -1
    keys[1000:2500] = keys[1000]
    keys = torch.from_numpy(keys).to(card)
    idx = torch.from_numpy(rng.integers(0, n, n)).to(card)
    P = _points(n, g2, card, 8)
    for sched in (None, (2, 3)):
        got = kernels.seg_scan_tiles(P, keys, idx, g2, sched)
        torch.cuda.synchronize()
        assert torch.equal(got, fold.seg_scan_tile_plain(
            P, keys, idx, g2, fold.scan_schedule(g2, *(sched or (None,
                                                                 None)))))
        assert torch.equal(
            msm_scan.seg_scan(P, keys, idx, g2, sched),
            msm_scan.seg_scan(P, keys, idx, g2, sched,
                              tiles=fold.seg_scan_tile_plain,
                              add=curve.point_add_plain))


def test_int_probe_matches_plain(card):
    for op in int_probe.OPS:
        x, y = probe.inputs(op, 1 << 14, card)
        got = kernels.int_probe(op, x, y, 4)
        torch.cuda.synchronize()
        want = int_probe.int_probe_plain(op, x, y, 4)
        if op == 'f32_fma':
            a, b = got.view(torch.float32), want.view(torch.float32)
            assert bool(((a - b).abs() <= int_probe.F32_RTOL * b.abs()).all())
        else:
            assert torch.equal(got, want)


@pytest.mark.parametrize('g2', [False, True], ids=['g1', 'g2'])
def test_dense_and_scan_msm_on_card(card, g2):
    n = 512
    gen = bn254.G2_GEN if g2 else bn254.G1_GEN
    pts = [bn254.multiply(gen, j + 1) for j in range(n)]
    rng = np.random.default_rng(9)
    scalars = [int.from_bytes(rng.bytes(32), 'little') % bn254.CURVE_ORDER
               for _ in range(n)]
    conv = curve.g2_to_tensor if g2 else curve.g1_to_tensor
    digits = msm.window_digits(torch.from_numpy(
        ints_to_words_np(scalars)).to(card), 8)
    want = None
    for s, p in zip(scalars, pts):
        want = bn254.add(want, bn254.multiply(p, s))
    P = conv(pts, card)
    assert msm_dense.msm(P, digits, 8, g2, min_points=0) == (want, 'dense')
    for combine in msm_scan.COMBINES:
        assert msm_scan.to_host(msm_scan.msm_tensor(
            P, digits, 8, g2, combine), g2) == want


def test_prove_fixture_msm_impls_on_card(card):
    with open(os.path.join(FIXTURE, "r1cs.json")) as fh:
        cs = r1cs_from_dict(json.load(fh))
    pk = read_pk_binary(os.path.join(FIXTURE, "pk.bin"))
    witness = witness_from_json(os.path.join(FIXTURE, "witness.json"))
    with open(os.path.join(FIXTURE, "proof.json")) as fh:
        want = fh.read()
    for impl in ('fused', 'generic'):
        ctx = ProverContext(pk, cs, msm_impl=impl)
        assert ctx.prove(witness).to_json() == want


def test_prove_fixture_on_mesh_of_card(card):
    """Two virtual shards on the one card: the mesh prover's proof is the
    committed proof.json."""
    from ethsnarks_tpu_torch.parallel import make_mesh
    with open(os.path.join(FIXTURE, "r1cs.json")) as fh:
        cs = r1cs_from_dict(json.load(fh))
    mesh = make_mesh(devices=[torch.device("cuda", 0)] * 2)
    ctx = ProverContext(read_pk_binary(os.path.join(FIXTURE, "pk.bin")), cs,
                        mesh=mesh)
    proof = ctx.prove(witness_from_json(os.path.join(FIXTURE,
                                                     "witness.json")))
    with open(os.path.join(FIXTURE, "proof.json")) as fh:
        assert proof.to_json() == fh.read()
    assert set(ctx.last_routes.values()) == {'mesh'}


def test_fixture_zk_key_and_blinded_proofs_on_card(card, tmp_path):
    """generator(zk=True) on the card keeps the committed nozk key; its
    unblinded proof is proof.json, blinded proofs verify and differ, and
    the nozk key refuses blinding."""
    with open(os.path.join(FIXTURE, "r1cs.json")) as fh:
        cs = r1cs_from_dict(json.load(fh))
    seeded = random.Random(20261016)
    kp = generator(cs, rng=lambda: seeded.randrange(1, SNARK_SCALAR_FIELD),
                   zk=True)
    assert kp.pk.has_zk_extras and kp.pk.b1_pts.is_cuda
    write_pk_binary(kp.pk, str(tmp_path / "pk.bin"))
    with open(os.path.join(FIXTURE, "pk.bin"), "rb") as fh:
        assert (tmp_path / "pk.bin").read_bytes() == fh.read()
    witness = witness_from_json(os.path.join(FIXTURE, "witness.json"))
    ctx = ProverContext(kp.pk, cs, qap=kp.qap)
    with open(os.path.join(FIXTURE, "proof.json")) as fh:
        assert ctx.prove(witness).to_json() == fh.read()
    blinder = random.Random(5)
    proofs = [ctx.prove(witness, blind=True, rng=lambda: blinder.randrange(
        1, SNARK_SCALAR_FIELD)) for _ in range(2)]
    assert ctx.last_routes['b1'] == 'red'
    assert all(kp.vk.verify(p) for p in proofs)
    assert proofs[0].to_json() != proofs[1].to_json()
    nozk = ProverContext(read_pk_binary(os.path.join(FIXTURE, "pk.bin")), cs)
    with pytest.raises(ValueError):
        nozk.prove(witness, blind=True)


def test_mimc_trace_on_card_matches_cpu(card):
    """The batched MiMC MP trace at the flagship's shape (29 chained
    levels, a batch of 48) on the card, word for word its CPU run."""
    from ethsnarks_tpu_torch.gadgets import merkle_tree_IVs
    from ethsnarks_tpu_torch.ops.fp import Fr
    from ethsnarks_tpu_torch.ops.mimc import mimc_mp_witness_device
    rng = np.random.default_rng(29)

    def rand48():
        return [int.from_bytes(rng.bytes(32), 'little') % SNARK_SCALAR_FIELD
                for _ in range(48)]

    left = Fr.ints_to_h16(rand48(), 'cpu', mont=True)
    for iv in merkle_tree_IVs(29):
        right = Fr.ints_to_h16(rand48(), 'cpu', mont=True)
        out, aux = mimc_mp_witness_device(left.to(card), right.to(card), iv)
        want_out, want_aux = mimc_mp_witness_device(left, right, iv)
        assert aux.is_cuda and aux.shape == (16, 730, 48)
        assert torch.equal(out.cpu(), want_out)
        assert torch.equal(aux.cpu(), want_aux)
        left = want_out


def test_sha256_trace_on_card_matches_cpu(card):
    """The batched SHA-256 trace of 16 random 96-byte messages (two
    compressions each) on the card, word for word its CPU run."""
    from ethsnarks_tpu_torch.models.sha256_batch import _padded_words
    from ethsnarks_tpu_torch.ops.sha256_ops import sha256_witness_trace
    rng = np.random.default_rng(96)
    blocks = torch.from_numpy(np.moveaxis(np.stack(
        [_padded_words(rng.bytes(96), 768) for _ in range(16)]), 0, 2).copy())
    final, ops = sha256_witness_trace(blocks.to(card))
    want_final, want_ops = sha256_witness_trace(blocks)
    assert ops.is_cuda and ops.shape == (2, 1264, 16)
    assert torch.equal(final.cpu(), want_final)
    assert torch.equal(ops.cpu(), want_ops)


def test_poseidon_witness_on_card_matches_cpu(card):
    """The batched Poseidon witness trace of 64 random full-width states on
    the card, word for word its CPU run (the final state and the 105 sboxes'
    x^2, x^4, x^5)."""
    from ethsnarks_tpu_torch.ops.fp import Fr
    from ethsnarks_tpu_torch.ops.poseidon_ops import poseidon_witness_device
    rng = np.random.default_rng(6)
    state = Fr.ints_to_h16(
        [int.from_bytes(rng.bytes(32), 'little') % SNARK_SCALAR_FIELD
         for _ in range(6 * 64)], 'cpu', mont=True).reshape(16, 6, 64)
    final, aux = poseidon_witness_device(state.to(card))
    want_final, want_aux = poseidon_witness_device(state)
    assert aux.is_cuda and aux.shape == (105, 3, 16, 64)
    assert torch.equal(final.cpu(), want_final)
    assert torch.equal(aux.cpu(), want_aux)


def test_eddsa_verify_batch_on_card(card):
    """eddsa_verify_batch of 64 signatures on the card (the eddsa16k seed's
    first 16, tiled four times) with lanes tampered as the eddsa16k row
    tampers them, lane for lane the host verify."""
    from ethsnarks_tpu_torch.bench_workloads import eddsa_signatures, \
        eddsa_tampered, eddsa_columns
    from ethsnarks_tpu_torch.eddsa import PureEdDSA
    from ethsnarks_tpu_torch.ops.eddsa_ops import eddsa_verify_batch
    bad, want = eddsa_tampered(eddsa_signatures(16) * 4)
    got = eddsa_verify_batch(*eddsa_columns(bad))
    assert got == want
    assert got == [PureEdDSA.verify(*x) for x in bad]
    assert want.count(False) == 3


def test_eddsa_verify_circuit_proof_on_card(card):
    """EdDSAVerify(256) on the eddsa16k seed's first signature: setup and
    a proof on the card, vk.verify accepting [A.x, A.y] and refusing the
    next signature's key."""
    from ethsnarks_tpu_torch.bench_merkle import seeded_rng
    from ethsnarks_tpu_torch.bench_workloads import eddsa_signatures
    from ethsnarks_tpu_torch.models import EdDSAVerify
    from ethsnarks_tpu_torch.verifier import Proof
    sigs = eddsa_signatures(2)
    model = EdDSAVerify(256).set_witness(*sigs[0])
    proof, kp, _ = model.prove(device=card, rng=seeded_rng())
    A, other = sigs[0][0], sigs[1][0]
    assert proof.input == [A.x.n, A.y.n]
    assert kp.vk.verify(proof)
    assert not kp.vk.verify(Proof(proof.A, proof.B, proof.C,
                                  [other.x.n, other.y.n]))


def test_stubs_cycle_on_card(card, tmp_path):
    """tests/test_stubs.py's circuit through the stubs on the card (their
    default): the keys and the proof JSON equal the CPU's from the same
    seeded rng, stub_verify accepts it and refuses a changed input, and
    stub_test_proof_verify runs on the card."""
    from ethsnarks_tpu_torch import stubs
    from ethsnarks_tpu_torch.r1cs import ConstraintSystem

    def circuit():
        pb = ConstraintSystem()
        out = pb.allocate('out')
        pb.set_input_sizes(1)
        x, sq = pb.allocate('x'), pb.allocate('sq')
        pb.add_constraint(x, x, sq, 'x*x')
        pb.add_constraint(sq + x, 1, out, 'sum')
        for var, val in ((x, 6), (sq, 36), (out, 42)):
            pb.setval(var, val)
        return pb

    got = {}
    for tag, kw in (('card', {}), ('cpu', {'device': 'cpu'})):
        pb = circuit()
        rng = random.Random(9009)
        pk_file, vk_file = tmp_path / (tag + '.pk'), tmp_path / (tag + '.vk')
        stubs.stub_genkeys_from_pb(
            pb, str(pk_file), str(vk_file),
            rng=lambda: rng.randrange(1, SNARK_SCALAR_FIELD), **kw)
        pk = stubs.load_proving_key(str(pk_file), **kw)
        ctx = stubs.make_prover_context(pk, pb, use_device_msm=not kw)
        assert ctx.device.type == ('cpu' if kw else 'cuda')
        got[tag] = (vk_file.read_bytes(), pk_file.read_bytes(),
                    stubs.prove(ctx, pb))
    assert got['card'] == got['cpu']
    vk_json, proof_json = got['card'][0].decode(), got['card'][2]
    assert stubs.stub_verify(vk_json, proof_json)
    assert not stubs.stub_verify(vk_json,
                                 proof_json.replace('"0x2a"', '"0x2b"'))
    assert stubs.stub_test_proof_verify(circuit())


def _witness_case(case):
    if case == 'fixture':
        with open(os.path.join(FIXTURE, "r1cs.json")) as fh:
            cs = r1cs_from_dict(json.load(fh))
        return cs, witness_from_json(os.path.join(FIXTURE, "witness.json"))
    # m = 2^16: 64 inputs, a row of 300 terms, four K9 passes with columns
    return random_constraint_system(1 << 16, 64, 5000, 300, seed=7)


@pytest.mark.parametrize('case', ['fixture', 'random_2^16'])
def test_witness_map_kernels_match_plain(card, case):
    """K8 and K9 (the map a QAP on the card dispatches to) against the
    plain map on the same card, bit for bit, and K8 against its plain
    version; one K8 launch and one K9 launch a planned pass."""
    cs, w = _witness_case(case)
    qap = QAP(cs, card)
    words = torch.from_numpy(ints_to_words_np(w)).to(card)
    kernels.reset_counts()
    got = qap.witness_map(words)
    torch.cuda.synchronize()
    assert (kernels.CSR_MATVEC.launches, kernels.NTT_PASS.launches) == \
        (1, len(qap.word_map.domain.plan))
    assert torch.equal(got, qap.witness_map_plain(words))
    wm = qap.word_map
    assert torch.equal(wm.matvecs(words), witness_words.csr_matvec_plain(
        wm.row_ptr, wm.cols, wm.coeffs, words))


def _random_words(n, device, seed):
    """n canonical Fr words (below 2^252)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(-(1 << 31), 1 << 31, (n, 8), dtype=torch.int32,
                      device=device, generator=gen)
    x[:, 7] &= 0x0FFFFFFF
    return x


@pytest.mark.parametrize('k', [16, 19, 20])
def test_ntt_passes_match_domain_transforms(card, k):
    """K9's DIF and DIT passes on B = 3 stacked vectors against
    NttDomain.dif / .dit, and DIT after DIF is m times the identity."""
    m = 1 << k
    dom = NttDomain(m, card)
    wd = WordDomain(dom)
    ranges = witness_words.ntt_ranges(k)
    x = _random_words(3 * m, card, k)

    def passes(x, order, step):
        for lo, t, g in order:
            x = kernels.ntt_pass(x, wd.tw_inv, wd.tw_fwd, wd.scale,
                                 wd.unscale, k, lo, t, g, step)
        return x

    dif = passes(x, ranges[::-1], witness_words.DIF_IN)
    assert torch.equal(dif, h16_to_words(dom.dif(words_to_h16(x),
                                                 dom.tw_inv)))
    dit = passes(x, ranges, witness_words.DIT)
    assert torch.equal(dit, h16_to_words(dom.dit(words_to_h16(x),
                                                 dom.tw_fwd)))
    back = passes(dif, ranges, witness_words.DIT)
    assert torch.equal(back, h16_to_words(Fr.mul(
        words_to_h16(x), Fr.const_mont(m, card))))
