"""The plain reference against the program on the CPU at a tiny size: the
hashes, the curve, the assignment in the circuit's variable order and
the expected proof equal the program's, value for value.  The tests may
import the program; the reference never does."""

import random

import pytest

from port_bench import compare
from port_bench.reference import bn254, groth16
from port_bench.reference import merkle_membership as rm
from port_bench.reference import poseidon_hashes as rp
from port_bench.traffic import generate

KEY_SEED = 12345


def test_curve_and_hashes_against_the_program():
    from ethsnarks_tpu_torch import bn254 as pb
    from ethsnarks_tpu_torch.mimc import mimc_hash
    from ethsnarks_tpu_torch.poseidon import poseidon
    rng = random.Random(3)
    for _ in range(3):
        k = rng.randrange(bn254.R)
        a = pb.multiply(pb.G1_GEN, k)
        assert bn254.g1_mul(k) == (a[0].n, a[1].n)
        b = pb.multiply(pb.G2_GEN, k)
        assert bn254.g2_mul(k) == (tuple(b[0].coeffs), tuple(b[1].coeffs))
    h = rm.MiMC(3)
    x, y = rng.randrange(bn254.R), rng.randrange(bn254.R)
    assert h.node(2, x, y) == mimc_hash([x, y], h.ivs[2])
    assert rp.Params().permute([x, y]) == poseidon([x, y])


def _program_proof(model):
    from ethsnarks_tpu_torch.groth16 import ProverContext, generator
    cs = model.pb
    kp = generator(cs, rng=generate.key_rng(KEY_SEED), device='cpu')
    ctx = ProverContext(kp.pk, cs, device='cpu', qap=kp.qap)
    return compare.proof_ints(ctx.prove(cs.values))


def _expected(st, args, shape_of):
    shape = shape_of(args)
    m = groth16.domain_size(shape['constraints'], shape['inputs'])
    sec = groth16.Secrets(KEY_SEED, m)
    sums = groth16.RowSums(groth16.lagrange_at(sec.t, m))
    st.rows(sums)
    assert sums.unsatisfied == 0
    assert sums.j == shape['constraints'] + shape['inputs'] + 1
    return groth16.expected_proof(sec, sums, st.inputs())


def test_merkle_depth4_two_statements():
    from ethsnarks_tpu_torch.merkletree import MerkleTree
    from ethsnarks_tpu_torch.models import BatchMerkleMembership
    args = {'depth': 4, 'n_proofs': 2}
    req = generate.make({'kind': 'merkle_statements', 'leaves': 11,
                         'statements': 2}, 99)['pool'][0]
    model = BatchMerkleMembership(4, 2, device='cpu')
    tree = MerkleTree(1 << 4)
    tree.extend(req['leaves'])
    model.set_witness(tree, req['indices'])
    st = rm.Statement(args, req)
    cs = model.pb
    assert rm.shape(args) == dict(constraints=cs.num_constraints,
                                  inputs=cs.num_inputs,
                                  variables=cs.num_variables)
    assert st.root == tree.root
    assert st.values == cs.values
    assert _program_proof(model) == _expected(st, args, rm.shape)


def test_poseidon_four_instances():
    from ethsnarks_tpu_torch.models import BatchPoseidonHash
    args = {'n_instances': 4, 'n_inputs': 2}
    req = generate.make({'kind': 'field_tuples', 'batch': 4, 'arity': 2,
                         'pool': 1}, 2 ** 31 + 5)['pool'][0]
    model = BatchPoseidonHash(4, 2, device='cpu')
    model.set_witness(req['tuples'])
    st = rp.Statement(args, req)
    cs = model.pb
    assert rp.shape(args) == dict(constraints=cs.num_constraints,
                                  inputs=cs.num_inputs,
                                  variables=cs.num_variables)
    assert st.values == cs.values
    assert _program_proof(model) == _expected(st, args, rp.shape)


def test_full_size_shapes():
    """The configurations' circuits as the issue states them."""
    assert rm.shape({'depth': 29, 'n_proofs': 48})['constraints'] == 1020384
    assert rp.shape({'n_instances': 1024, 'n_inputs': 2})['constraints'] \
        == 323584
    assert groth16.domain_size(1020384, 1) == 1 << 20
    assert groth16.domain_size(323584, 1024) == 1 << 19


@pytest.mark.parametrize('seed', [0, 2 ** 31 + 11])
def test_traffic_same_seed_same_requests(seed):
    for params in ({'kind': 'merkle_statements', 'leaves': 64,
                    'statements': 4},
                   {'kind': 'field_tuples', 'batch': 8, 'arity': 2,
                    'pool': 2}):
        a, b = generate.make(params, seed), generate.make(params, seed)
        assert a == b
        assert a != generate.make(params, seed + 1)
