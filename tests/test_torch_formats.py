"""The port's file formats and small host modules against the JAX
package's, byte for byte where they write text: the serialization writers
on the committed fixture, the bellman proving-key dict and the key it
converts back to, ``vk2sol`` / ``proof2sol``, ``shamirspoly``, ``utils``,
the profiler and the MiMC command line."""
import json
import os

import pytest
import torch

from ethsnarks_tpu import serialization as ref_ser, utils as ref_utils
from ethsnarks_tpu.cli import proof2sol as ref_proof2sol, \
    vk2sol as ref_vk2sol
from ethsnarks_tpu.field import FQ as RefFQ
from ethsnarks_tpu.mimc import __main__ as ref_mimc_main
from ethsnarks_tpu.ops.ntt import _bitrev_indices
from ethsnarks_tpu.shamirspoly import shamirs_poly as ref_shamirs_poly, \
    lagrange as ref_lagrange, inverse_lagrange as ref_inverse_lagrange
from ethsnarks_tpu.verifier import Proof as RefProof, \
    VerifyingKey as RefVerifyingKey

from ethsnarks_tpu_torch import serialization, utils
from ethsnarks_tpu_torch.cli import proof2sol, vk2sol
from ethsnarks_tpu_torch.field import FQ, SNARK_SCALAR_FIELD
from ethsnarks_tpu_torch.mimc import __main__ as mimc_main
from ethsnarks_tpu_torch.ops.ntt import bitrev_indices
from ethsnarks_tpu_torch.shamirspoly import inverse_lagrange, lagrange, \
    shamirs_poly
from ethsnarks_tpu_torch.utils import profiling
from ethsnarks_tpu_torch.verifier import Proof, VerifyingKey

from torch_port_helpers import rand_ints, torch_threads  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "ethsnarks_tpu_torch", "fixtures", "mimc_chain_10")


def _fixture(name):
    return os.path.join(FIXTURE, name)


def _read(path, mode='r'):
    with open(path, mode) as fh:
        return fh.read()


@pytest.fixture(scope="module")
def r1cs_dict():
    with open(_fixture("r1cs.json")) as fh:
        return json.load(fh)


def test_r1cs_writers_equal_reference(r1cs_dict, tmp_path):
    cs = serialization.r1cs_from_dict(r1cs_dict)
    ref_cs = ref_ser.r1cs_from_dict(r1cs_dict)
    cs.values = ref_cs.values = serialization.witness_from_json(
        _fixture("witness.json"))
    assert cs.is_satisfied()
    assert serialization.r1cs_to_dict(cs) == ref_ser.r1cs_to_dict(ref_cs) \
        == r1cs_dict
    for name, port_fn, ref_fn in (
            ("r1cs", serialization.r1cs2json, ref_ser.r1cs2json),
            ("witness", serialization.witness2json, ref_ser.witness2json)):
        got, want = tmp_path / (name + "_port"), tmp_path / (name + "_ref")
        assert port_fn(cs, str(got)) and ref_fn(ref_cs, str(want))
        assert got.read_bytes() == want.read_bytes()
    assert serialization.witness_from_json(str(tmp_path / "witness_port")) \
        == cs.values


def test_vk_and_proof_json_equal_reference(tmp_path):
    vk_json, proof_json = _read(_fixture("vk.json")), \
        _read(_fixture("proof.json"))
    serialization.vk2json_file(VerifyingKey.from_json(vk_json),
                               str(tmp_path / "port"))
    ref_ser.vk2json_file(RefVerifyingKey.from_json(vk_json),
                         str(tmp_path / "ref"))
    assert (tmp_path / "port").read_text() == (tmp_path / "ref").read_text() \
        == vk_json
    assert serialization.proof_to_json(Proof.from_json(proof_json)) == \
        ref_ser.proof_to_json(RefProof.from_json(proof_json)) == proof_json


@pytest.fixture(scope="module")
def bellman(r1cs_dict):
    """The committed key through both packages' pk_to_bellman_dict."""
    pk = serialization.read_pk_binary(_fixture("pk.bin"), 'cpu')
    m = int(pk.h_pts.shape[0])
    nv = int(r1cs_dict["nVars"])
    got = serialization.pk_to_bellman_dict(pk, nv, bitrev_indices(m, 'cpu'))
    want = ref_ser.pk_to_bellman_dict(ref_ser.read_pk_binary(
        _fixture("pk.bin")), nv, _bitrev_indices(m))
    return got, want


def test_pk_to_bellman_dict_equals_reference(bellman):
    got, want = bellman
    assert got == want
    assert got["C"][:2] == [["0", "1", "0"]] * 2


def test_pk_bellman2ethsnarks_writes_fixture_key(bellman, tmp_path):
    """The bellman dict back to the binary key: the committed pk.bin, and
    the reference's conversion of the same file, byte for byte."""
    bell = tmp_path / "bellman.json"
    bell.write_text(json.dumps(bellman[0]))
    assert serialization.pk_bellman2ethsnarks(
        str(bell), str(tmp_path / "port.bin"), device='cpu')
    ref_ser.pk_bellman2ethsnarks(str(bell), str(tmp_path / "ref.bin"))
    fixture = _read(_fixture("pk.bin"), 'rb')
    assert (tmp_path / "port.bin").read_bytes() == fixture
    assert (tmp_path / "ref.bin").read_bytes() == fixture


def test_pk_from_bellman_dict_projective_and_infinity():
    """Projective coordinates (Z != 1) normalise, [0, 1, 0] and Z = 0 are
    infinity: dropped from A and B2, kept in L and H."""
    from ethsnarks_tpu_torch.bn254 import G1_GEN, G2_GEN, multiply
    from ethsnarks_tpu_torch.ops import curve
    q = serialization.FIELD_MODULUS
    p3 = multiply(G1_GEN, 3)
    z = 7
    proj = [str(p3[0].n * z % q), str(p3[1].n * z % q), str(z)]
    g2 = multiply(G2_GEN, 2)
    inf1, inf2 = ["0", "1", "0"], [["0", "0"], ["1", "0"], ["0", "0"]]
    d = {"A": [inf1, proj], "B1": [inf1, inf1],
         "B2": [inf2, serialization._bell_dump_g2(g2)],
         "C": [inf1, inf1, proj, inf1], "hExps": [proj, inf1, proj],
         "vk_alfa_1": proj, "vk_beta_2": serialization._bell_dump_g2(g2),
         "vk_delta_2": serialization._bell_dump_g2(g2), "nPublic": 1}
    pk = serialization.pk_from_bellman_dict(d, device='cpu')
    ref = ref_ser.pk_from_bellman_dict(d)
    assert pk.a_idx.tolist() == [i for i, _ in ref.a_query] == [1]
    assert pk.b_idx.tolist() == [i for i, _ in ref.b_query] == [1]
    assert pk.alpha_g1 == p3 and pk.num_inputs == ref.num_inputs == 1

    def ints(pts):
        return [None if p is None else (p[0].n, p[1].n) for p in pts]
    assert ints(curve.tensor_to_g1(pk.l_pts)) == ints(ref.l_query)
    assert ints(curve.tensor_to_g1(pk.h_pts)) == ints(ref.h_query_bitrev)
    assert len(ref.h_query_bitrev) == 4


def test_sol_text_equals_reference():
    vk_json, proof_json = _read(_fixture("vk.json")), \
        _read(_fixture("proof.json"))
    vk, ref_vk = VerifyingKey.from_json(vk_json), \
        RefVerifyingKey.from_json(vk_json)
    proof, ref_proof = Proof.from_json(proof_json), \
        RefProof.from_json(proof_json)
    assert vk2sol.vk_to_sol(vk) == ref_vk2sol.vk_to_sol(ref_vk)
    assert vk2sol.vk_to_sol(vk, 'f') == ref_vk2sol.vk_to_sol(ref_vk, 'f')
    assert proof2sol.proof_to_sol(proof) == \
        ref_proof2sol.proof_to_sol(ref_proof)
    assert proof2sol.proof_to_sol(proof, 'g') == \
        ref_proof2sol.proof_to_sol(ref_proof, 'g')


@pytest.mark.parametrize('tool', ['vk2sol', 'proof2sol'])
def test_sol_main_equals_reference(tool, capsys):
    mods = {'vk2sol': (vk2sol, ref_vk2sol, "vk.json"),
            'proof2sol': (proof2sol, ref_proof2sol, "proof.json")}
    port, ref, name = mods[tool]
    port.main(_fixture(name))
    got = capsys.readouterr().out
    ref.main(_fixture(name))
    assert got == capsys.readouterr().out
    assert got.startswith("\tfunction ")


def test_shamirspoly_static_vectors():
    """tests/test_shamirspoly.py's vectors, and the port's interpolation
    against the reference's on seeded shares."""
    alpha = [6808181831819141657160280673506432691407806061837762993142662373500430825792,
             4138536697521448323155976179625860582331141320072618244300034508091478437877,
             20259243729221075783953642258755031830946498253783650311586175820530608751936,
             11227115470523445882235139084890542822660569362938710556861479160600812964997]
    expected = [6808181831819141657160280673506432691407806061837762993142662373500430825792,
                20544834857245836424258632451520592838797650598216707762192147676147522484985,
                10833210933219706719196668784844423052753721417299010433393634464005858464330,
                1259517139202877390892412692306630092142705895884865660519589327528699562575]
    got = [shamirs_poly(FQ(i), [FQ(a) for a in alpha]) for i in range(4)]
    assert [int(g) for g in got] == expected
    coeffs = rand_ints(4, SNARK_SCALAR_FIELD, 11)
    xs = rand_ints(4, SNARK_SCALAR_FIELD, 12)
    shares = [(FQ(x), shamirs_poly(FQ(x), [FQ(a) for a in coeffs]))
              for x in xs]
    ref_shares = [(RefFQ(x), ref_shamirs_poly(
        RefFQ(x), [RefFQ(a) for a in coeffs])) for x in xs]
    assert [int(y) for _, y in shares] == [int(y) for _, y in ref_shares]
    assert int(lagrange(shares, 0)) == int(ref_lagrange(ref_shares, 0)) \
        == coeffs[0]
    assert int(inverse_lagrange(shares, shares[2][1])) == int(
        ref_inverse_lagrange(ref_shares, ref_shares[2][1])) == xs[2]
    with pytest.raises(TypeError):
        shamirs_poly(1, [FQ(1), FQ(2)])
    with pytest.raises(ValueError):
        shamirs_poly(FQ(1), [FQ(1)])


def test_utils_equal_reference():
    data = bytes(range(97))
    assert utils.bytes_to_field_elements(data) == \
        ref_utils.bytes_to_field_elements(data)
    assert utils.bytes_to_field_elements(data, 64) == \
        ref_utils.bytes_to_field_elements(data, 64)
    words = rand_ints(5, 1 << 253, 13) + [5, 1 << 90]
    assert utils.libsnark2python(words) == ref_utils.libsnark2python(words)
    assert utils.native_lib_path("x") == ref_utils.native_lib_path("x")


def test_profiling_blocks(capsys):
    profiling.start_profiling()
    profiling.enter_block("outer")
    with profiling.block("inner", sync_value=torch.zeros(2)):
        pass
    profiling.leave_block("outer", torch.ones(1))
    profiling.leave_block("nothing open")
    profiling.print_summary()
    profiling.print_mem("x")
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == ["(enter) outer", "  (enter) inner"]
    assert out[2].startswith("  (leave) inner [")
    assert out[3].startswith("(leave) outer [")
    assert out[4] == "(leave) nothing open [unmatched]"
    assert out[5] == "-- profiling summary --"
    assert [ln.split()[0] for ln in out[6:8]] == ["inner", "outer"]


@pytest.mark.parametrize('argv', [
    ['test'], ['hash', '1', '2'], ['-k', '3', 'encrypt', '5', '6'],
    ['-r', '5', 'constants'], ['-s', 'other', '-e', '5', 'hash', '7'],
    ['nothing']], ids=['test', 'hash', 'encrypt', 'constants', 'seed',
                       'unknown'])
def test_mimc_main_equals_reference(argv, capsys):
    rc = mimc_main.main(argv)
    got = capsys.readouterr().out
    assert rc == ref_mimc_main.main(argv)
    assert got == capsys.readouterr().out


@pytest.mark.parametrize('g2', [False, True], ids=['g1', 'g2'])
def test_key_blocks_normalise_projective_points(g2):
    """The key writer's device normalisation against the host ints: points
    with random Z (Montgomery words scaled by lambda), and infinity."""
    from ethsnarks_tpu_torch.bn254 import G1_GEN, G2_GEN, multiply
    from ethsnarks_tpu_torch.ops import curve, fp2
    from ethsnarks_tpu_torch.ops.fp import Fq as FqOps, words_to_h16
    n = 37
    pts = [multiply(G2_GEN if g2 else G1_GEN, j + 2) for j in range(n)]
    P = (curve.g2_to_tensor if g2 else curve.g1_to_tensor)(
        pts[:5] + [None] + pts[5:], 'cpu')
    lam = rand_ints(n + 1, serialization.FIELD_MODULUS, 21 + g2)
    lam_h = words_to_h16(torch.from_numpy(curve.mont_words(lam)))
    if g2:
        lam_h = torch.stack([lam_h, lam_h.flip(1)], -1)
    X, Y, Z = curve.unpack(P)
    mul = fp2.mul if g2 else FqOps.mul
    P = curve.pack([mul(c, lam_h) for c in (X, Y, Z)])
    got_w, got_inf = (serialization._g2_block if g2
                      else serialization._g1_block)(P)
    xs, ys, inf = curve.affine_ints(P, g2)
    if g2:
        cols = [[x[0] for x in xs], [x[1] for x in xs],
                [y[0] for y in ys], [y[1] for y in ys]]
    else:
        cols = [xs, ys]
    assert got_w.tolist() == serialization._mont_words(cols).tolist()
    assert got_inf.tolist() == [int(i) for i in inf] and sum(inf) == 1


def test_batch_inverse_over_several_rows(monkeypatch):
    """The key writer's inversion with 8 lanes, so 37 values take 5 rows
    (the last padded), zeros among them: each value's inverse mod q."""
    from ethsnarks_tpu_torch.ops.fp import Fq as FqOps
    monkeypatch.setattr(serialization, "_INV_LANES", 8)
    q = serialization.FIELD_MODULUS
    vals = rand_ints(37, q, 31)
    vals[3] = vals[20] = 0
    got = FqOps.h16_to_ints(serialization._inverse_mont(
        FqOps.ints_to_h16(vals, 'cpu', mont=True)), mont=True)
    assert got == [pow(v, -1, q) if v else 0 for v in vals]
