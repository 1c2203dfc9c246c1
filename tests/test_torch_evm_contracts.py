"""The port's host EVM and contract modules (ethsnarks_tpu_torch
evm_snarkutils, evm_jubjub, evm_merkle, mimc.contract, mimc.contract_sol,
poseidon.contract, poseidon.contract_sol and
mimc.permutation._constants_list) against the reference's: every generated
bytecode and Solidity source byte for byte, and every EVM result equal to
the reference's and to the host oracles on the vectors of the reference's
tests (test_evm.py, test_evm_snarkutils.py, test_evm_jubjub.py,
test_evm_wnaf.py, test_evm_merkle.py).  Host Python only."""
import hashlib
import random

import pytest

from ethsnarks_tpu import evm_jubjub as ref_jubjub
from ethsnarks_tpu import evm_merkle as ref_merkle
from ethsnarks_tpu import evm_snarkutils as ref_snarkutils
from ethsnarks_tpu.merkletree import MerkleTree as RefTree
from ethsnarks_tpu.mimc import contract as ref_mimc_contract
from ethsnarks_tpu.mimc import contract_sol as ref_mimc_sol
from ethsnarks_tpu.mimc import permutation as ref_mimc_perm
from ethsnarks_tpu.poseidon import contract as ref_poseidon_contract
from ethsnarks_tpu.poseidon import contract_sol as ref_poseidon_sol

from ethsnarks_tpu_torch import evm_jubjub, evm_merkle, evm_snarkutils
from ethsnarks_tpu_torch.evmasm import execute
from ethsnarks_tpu_torch.field import FQ, SNARK_SCALAR_FIELD as P
from ethsnarks_tpu_torch.jubjub import JUBJUB_L, Point, mult_naf_lut
from ethsnarks_tpu_torch.merkletree import MerkleTree
from ethsnarks_tpu_torch.mimc import mimc
from ethsnarks_tpu_torch.mimc import contract as mimc_contract
from ethsnarks_tpu_torch.mimc import contract_sol as mimc_sol
from ethsnarks_tpu_torch.mimc import permutation as mimc_perm
from ethsnarks_tpu_torch.poseidon import DefaultParams, poseidon
from ethsnarks_tpu_torch.poseidon import contract as poseidon_contract
from ethsnarks_tpu_torch.poseidon import contract_sol as poseidon_sol
from ethsnarks_tpu_torch.utils import bytes_to_field_elements

_G = Point(FQ(evm_jubjub.GEN[0]), FQ(evm_jubjub.GEN[1]))


def _call(code, *words):
    data = b''.join(int(w).to_bytes(32, 'big') for w in words)
    return int.from_bytes(execute(code, data), 'big')


# ---- mimc.permutation._constants_list ----

@pytest.mark.parametrize('seed, rounds', [(b'mimc', 91), (b'mimc', 110),
                                          ('mimc', 91), (12345, 7),
                                          (b'other', 5)])
def test_constants_list_matches_reference(seed, rounds):
    got = mimc_perm._constants_list(seed, P, rounds)
    assert got == ref_mimc_perm._constants_list(seed, P, rounds)
    assert got is mimc_perm._constants_list(seed, P, rounds)   # cached
    if seed == b'mimc' and rounds == 91:
        assert got == mimc_perm.constants_list()


# ---- generated code, byte for byte ----

CODES = {
    'merkle_verify_path_29': lambda m: m['merkle'].merkle_verify_path_code(
        29),
    'merkle_verify_path_3': lambda m: m['merkle'].merkle_verify_path_code(3),
    'scalar_mult': lambda m: m['jubjub'].scalar_mult_code(),
    'scalar_mult_naf5': lambda m: m['jubjub'].scalar_mult_naf5_code(),
    'eddsa_verify': lambda m: m['jubjub'].eddsa_verify_code(),
    'reverse_bits': lambda m: m['snarkutils'].reverse_bits_code(),
    'pack_words': lambda m: m['snarkutils'].pack_words_code(),
    'mimc_e7': lambda m: m['mimc'].mimc_contract(),
    'mimc_e5_110': lambda m: m['mimc'].mimc_contract(5, rounds=110),
    'mimc_e7_deployable': lambda m: m['mimc'].mimc_contract_deployable(),
    'mimc_e5_deployable': lambda m: m['mimc'].mimc_contract_deployable(
        5, rounds=110),
    'poseidon': lambda m: m['poseidon'].poseidon_contract(),
    'poseidon_3_inputs': lambda m: m['poseidon'].poseidon_contract(
        n_inputs=3),
    'poseidon_deployable': lambda m: m['poseidon'].
    poseidon_contract_deployable(),
    'mimc_solidity_e7': lambda m: m['mimc_sol'].mimc_contract_solidity(7),
    'mimc_solidity_e5': lambda m: m['mimc_sol'].mimc_contract_solidity(
        5, rounds=110, name='MiMCpe5_x'),
    'poseidon_solidity': lambda m: m['poseidon_sol'].
    poseidon_contract_solidity(),
}

PORT = dict(merkle=evm_merkle, jubjub=evm_jubjub, snarkutils=evm_snarkutils,
            mimc=mimc_contract, poseidon=poseidon_contract,
            mimc_sol=mimc_sol, poseidon_sol=poseidon_sol)
REF = dict(merkle=ref_merkle, jubjub=ref_jubjub, snarkutils=ref_snarkutils,
           mimc=ref_mimc_contract, poseidon=ref_poseidon_contract,
           mimc_sol=ref_mimc_sol, poseidon_sol=ref_poseidon_sol)


@pytest.mark.parametrize('name', sorted(CODES))
def test_generated_code_matches_reference(name):
    got, want = CODES[name](PORT), CODES[name](REF)
    assert type(got) is type(want)
    assert got == want


def test_solidity_mains_print_the_sources(capsys, monkeypatch):
    monkeypatch.setattr('sys.argv', ['contract_sol'])
    mimc_sol.main()
    poseidon_sol.main()
    out = capsys.readouterr().out
    assert out == (ref_mimc_sol.mimc_contract_solidity(7) + "\n"
                   + ref_poseidon_sol.poseidon_contract_solidity() + "\n")


# ---- the contracts in the port's evmasm (tests/test_evm.py) ----

def test_mimc_contract_runs():
    code7, code5 = mimc_contract.mimc_contract(7), \
        mimc_contract.mimc_contract(5, rounds=110)
    m0 = 3703141493535563179657531719960160174296085208671919316200479060314459804651
    m1 = 134551314051432487569247388144051420116740427803855572138106146683954151557
    assert _call(code7, m0, m1) == mimc(m0, m1)
    rng = random.Random(4242)
    for _ in range(3):
        x, k = rng.randrange(P), rng.randrange(P)
        assert _call(code7, x, k) == mimc(x, k)
        assert _call(code5, x, k) == mimc(x, k, e=5, R=110)


def test_poseidon_contract_runs():
    code = poseidon_contract.poseidon_contract()
    assert _call(code, 1, 2) == poseidon([1, 2])
    rng = random.Random(4242)
    for _ in range(2):
        a, b = rng.randrange(P), rng.randrange(P)
        assert _call(code, a, b) == poseidon([a, b])
    src = poseidon_sol.poseidon_contract_solidity()
    n_rounds = DefaultParams.nRoundsF + DefaultParams.nRoundsP
    assert src.count('        C[') == n_rounds
    assert src.count('        M[') == DefaultParams.t ** 2


# ---- evm_snarkutils (tests/test_evm_snarkutils.py) ----

def _rev256(v):
    return int(bin(v)[2:].rjust(256, '0')[::-1], 2)


def test_reverse_bits():
    rng = random.Random(1717)
    for v in [0, 1, (1 << 256) - 1, 0b1011] + \
            [rng.getrandbits(256) for _ in range(6)]:
        got = evm_snarkutils.reverse_bits_evm(v)
        assert got == _rev256(v) == ref_snarkutils.reverse_bits_evm(v)


@pytest.mark.parametrize('words', [
    [0x1234], [(1 << 256) - 1, 0, (1 << 256) - 1],
    [random.Random(1717).getrandbits(256) for _ in range(5)]])
def test_pack_words(words):
    data = b''.join(int(w).to_bytes(32, 'big') for w in words)
    got = evm_snarkutils.pack_words_evm(words)
    assert got == bytes_to_field_elements(data) == \
        ref_snarkutils.pack_words_evm(words)
    assert all(w < 1 << 253 for w in got)


# ---- evm_jubjub (tests/test_evm_jubjub.py, test_evm_wnaf.py) ----

def test_scalar_mult_binary_and_naf5():
    rng = random.Random(4242)
    scalars = [0, 1, 2, 3, 7, 15, 16, 17, 31, 32, 33, 255, 0xDEADBEEF,
               JUBJUB_L - 1, rng.randrange(1, JUBJUB_L)]
    for s in scalars:
        want = _G * s
        want = (int(want.x), int(want.y))
        gx, gy = evm_jubjub.GEN
        assert evm_jubjub.scalar_mult_evm(gx, gy, s) == want == \
            ref_jubjub.scalar_mult_evm(gx, gy, s), s
        assert evm_jubjub.scalar_mult_naf5_evm(gx, gy, s) == want == \
            ref_jubjub.scalar_mult_naf5_evm(gx, gy, s), s
    s = rng.randrange(1, JUBJUB_L)
    lut = mult_naf_lut(_G.as_etec(), s, width=5).as_point()
    assert evm_jubjub.scalar_mult_naf5_evm(*evm_jubjub.GEN, s) == \
        (int(lut.x), int(lut.y))
    p = _G * 99991                        # a base other than the generator
    assert evm_jubjub.scalar_mult_evm(int(p.x), int(p.y), 31337) == \
        tuple(int(v) for v in p * 31337)
    p = _G * 12345
    assert evm_jubjub.scalar_mult_naf5_evm(int(p.x), int(p.y), s) == \
        tuple(int(v) for v in p * s)


def _hash_to_int(*words):
    data = b''.join(int(w).to_bytes(32, 'big') for w in words)
    return int.from_bytes(hashlib.sha256(data).digest(), 'big') & \
        evm_jubjub.MASK_250


def test_eddsa_verify():
    a = 0x1234567890ABCDEF
    A = _G * a
    R = _G * 424242
    m = 998877665544332211
    t = _hash_to_int(int(R.x), int(R.y), int(A.x), int(A.y), m)
    s = t * a % JUBJUB_L
    pub, r = (int(A.x), int(A.y)), (int(R.x), int(R.y))
    for args, ok in (((pub, m, r, s), True),
                     ((pub, m, r, (s + 1) % JUBJUB_L), False),
                     ((pub, m + 1, r, s), False)):
        assert evm_jubjub.eddsa_verify_evm(*args) is ok
        assert ref_jubjub.eddsa_verify_evm(*args) is ok


# ---- evm_merkle (tests/test_evm_merkle.py) ----

def test_verify_path_depth3_every_leaf_and_wrong_sibling():
    tree, ref_tree = MerkleTree(8), RefTree(8)
    for leaf in range(1, 6):
        tree.append(leaf * 7919)
        ref_tree.append(leaf * 7919)
    assert tree.root == ref_tree.root
    for idx in range(5):
        proof = tree.proof(idx)
        got = evm_merkle.verify_path_evm(tree[idx], proof.path,
                                         proof.address)
        assert got == tree.root == ref_merkle.verify_path_evm(
            tree[idx], proof.path, proof.address), idx
    proof = tree.proof(2)
    bad = list(proof.path)
    bad[1] += 1
    got = evm_merkle.verify_path_evm(tree[2], bad, proof.address)
    assert got != tree.root
    assert got == ref_merkle.verify_path_evm(tree[2], bad, proof.address)


def test_verify_path_depth29_contract_shape():
    tree = MerkleTree(2 ** 29)
    tree.append(123456789)
    tree.append(987654321)
    proof = tree.proof(1)
    assert len(proof.path) == 29
    assert evm_merkle.verify_path_evm(tree[1], proof.path,
                                      proof.address) == tree.root
