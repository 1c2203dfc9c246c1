"""The port's Merkle stack (ethsnarks_tpu_torch mimc hash modes, poseidon,
merkletree, gadgets.mimc / gadgets.merkle, ops.mimc and
models.BatchMerkleMembership) against the JAX package's on the same seeded
inputs, value for value: field values and constraint triples, so no
tolerance.  The batched trace runs on the CPU (plain torch) and the
reference's through JAX on the CPU; results cross as python ints."""
import random

import numpy as np
import pytest
import torch

from ethsnarks_tpu import gadgets as ref_gadgets
from ethsnarks_tpu import merkletree as ref_merkletree
from ethsnarks_tpu import r1cs as ref_r1cs
from ethsnarks_tpu.mimc import mimc_hash as ref_mimc_hash, \
    mimc_hash_md as ref_mimc_hash_md
from ethsnarks_tpu.models.merkle_batch import \
    BatchMerkleMembership as RefBatchMerkle
from ethsnarks_tpu.poseidon import poseidon as ref_poseidon

from ethsnarks_tpu_torch import gadgets, merkletree, r1cs
from ethsnarks_tpu_torch.field import SNARK_SCALAR_FIELD
from ethsnarks_tpu_torch.mimc import mimc_hash, mimc_hash_md
from ethsnarks_tpu_torch import models
from ethsnarks_tpu_torch.models import BatchMerkleMembership
from ethsnarks_tpu_torch.ops.fp import Fr
from ethsnarks_tpu_torch.mimc import mimc
from ethsnarks_tpu_torch.ops.mimc import mimc_hash_batch, \
    mimc_mp_witness_device, mimc_permutation, round_constants_mont
from ethsnarks_tpu_torch.poseidon import poseidon

from torch_port_helpers import rand_ints, same_board, \
    torch_threads  # noqa: F401

P = SNARK_SCALAR_FIELD


@pytest.mark.parametrize('n', [1, 2, 5])
def test_hash_modes_match_reference(n):
    xs = rand_ints(n + 1, P, seed=n)
    k, xs = xs[0], xs[1:]
    assert mimc_hash(xs, k) == ref_mimc_hash(xs, k)
    assert mimc_hash(xs) == ref_mimc_hash(xs)
    assert mimc_hash_md(xs, k) == ref_mimc_hash_md(xs, k)
    assert mimc_hash(xs, k, e=5, R=110) == ref_mimc_hash(xs, k, e=5, R=110)
    assert poseidon(xs) == ref_poseidon(xs)


def test_poseidon_chained_matches_reference():
    xs = rand_ints(6, P, seed=7)
    assert poseidon(xs, chained=True) == ref_poseidon(xs, chained=True)


def test_merkle_tree_ivs_match_reference():
    ivs = gadgets.merkle_tree_IVs(29)
    assert ivs == ref_gadgets.merkle_tree_IVs(29)
    assert merkletree.MerkleHasher_MiMC(29)._IVs == ivs


@pytest.mark.parametrize('hasher', ['mimc', 'poseidon'])
def test_merkle_tree_matches_reference(hasher):
    """Appends, then updates: equal roots and proofs at every step; one
    extend gives the same nodes as the appends."""
    def make(mod):
        h = None if hasher == 'mimc' else \
            mod.MerkleHasher_Poseidon.factory()
        return mod.MerkleTree(16, hasher=h)

    got, want, bulk = make(merkletree), make(ref_merkletree), \
        make(merkletree)
    leaves = rand_ints(7, P, seed=11)
    for v in leaves:
        got.append(v)
        want.append(v)
        assert got.root == want.root
    bulk.extend(leaves)
    assert bulk._nodes == got._nodes
    for ix, v in ((3, 5), (6, 12345)):
        got.update(ix, v)
        want.update(ix, v)
        assert got.root == want.root
    for ix in range(len(leaves)):
        gp, wp = got.proof(ix), want.proof(ix)
        assert (gp.leaf, gp.address, gp.path) == \
            (wp.leaf, wp.address, wp.path)
        assert gp.verify(got.root)
        assert not gp.verify(got.root + 1)


def _same_board(got, want):
    same_board(got, want)
    assert got.is_satisfied()


def _owf_board(r1cs_mod, gadgets_mod, kind, msgs, iv):
    pb = r1cs_mod.ConstraintSystem()
    vs = pb.allocate_array(len(msgs), 'm')
    pb.set_input_sizes(len(msgs))
    if kind == 'e5':
        g = gadgets_mod.MiMCe5_gadget(pb, vs[0] + 0, vs[1] + 0, 'e5')
    else:
        cls = getattr(gadgets_mod, kind)
        g = cls(pb, vs, iv, kind)
    g.generate_r1cs_constraints()
    for v, m in zip(vs, msgs):
        pb.setval(v, m)
    g.generate_r1cs_witness()
    return pb, g


@pytest.mark.parametrize('kind', ['e5', 'MiyaguchiPreneel_OWF',
                                  'MerkleDamgard_OWF'])
def test_mimc_gadgets_match_reference(kind):
    msgs = rand_ints(2, P, seed=3)
    iv = 987654321
    got, g = _owf_board(r1cs, gadgets, kind, msgs, iv)
    want, _ = _owf_board(ref_r1cs, ref_gadgets, kind, msgs, iv)
    _same_board(got, want)
    if kind == 'MiyaguchiPreneel_OWF':
        assert got.val(g.result()) == mimc_hash(msgs, iv)
    elif kind == 'MerkleDamgard_OWF':
        assert got.val(g.result()) == mimc_hash_md(msgs, iv)


def _path_board(r1cs_mod, gadgets_mod, tree, index, depth):
    proof = tree.proof(index)
    pb = r1cs_mod.ConstraintSystem()
    root = pb.allocate('root')
    pb.set_input_sizes(1)
    leaf = pb.allocate('leaf')
    addr = pb.allocate_array(depth, 'addr')
    path = pb.allocate_array(depth, 'path')
    g = gadgets_mod.merkle_path_authenticator(
        pb, depth, addr, root + 0, leaf + 0, path, 'auth')
    g.generate_r1cs_constraints()
    pb.setval(root, tree.root)
    pb.setval(leaf, tree[index])
    for d in range(depth):
        pb.setval(addr[d], proof.address[d])
        pb.setval(path[d], proof.path[d])
    g.generate_r1cs_witness()
    return pb, g


@pytest.mark.parametrize('depth,index', [(1, 1), (2, 2)])
def test_merkle_path_gadget_matches_reference(depth, index):
    tree = merkletree.MerkleTree(1 << depth)
    tree.extend(rand_ints(1 << depth, P, seed=depth))
    got, g = _path_board(r1cs, gadgets, tree, index, depth)
    want, _ = _path_board(ref_r1cs, ref_gadgets, tree, index, depth)
    _same_board(got, want)
    assert g.is_valid()
    assert got.num_constraints == depth * 733 + 1


def test_mp_witness_trace_matches_reference():
    """ops.mimc.mimc_mp_witness_device on two chained levels of a batch of
    three, against the reference's (JAX on the CPU), as ints."""
    import jax
    import jax.numpy as jnp
    from ethsnarks_tpu.ops.fp import Fr as RefFr
    from ethsnarks_tpu.ops.mimc import mimc_mp_witness_device as ref_trace

    ivs = gadgets.merkle_tree_IVs(2)
    lefts, rights = rand_ints(3, P, seed=21), rand_ints(6, P, seed=22)
    ref_fn = jax.jit(ref_trace)
    for level in range(2):
        right = rights[3 * level:3 * level + 3]
        out, aux = mimc_mp_witness_device(
            Fr.ints_to_h16(lefts, 'cpu', mont=True),
            Fr.ints_to_h16(right, 'cpu', mont=True), ivs[level])
        got_aux = np.array(Fr.h16_to_ints(
            Fr.from_mont(aux.reshape(16, -1))), dtype=object).reshape(
                aux.shape[1:])
        lm = jnp.asarray(RefFr.to_mont_jit(RefFr.to_limbs_fast(lefts)))
        rm = jnp.asarray(RefFr.to_mont_jit(RefFr.to_limbs_fast(right)))
        ivm = jnp.broadcast_to(jnp.asarray(RefFr.constant_mont(
            ivs[level], lm.shape[1:])), lm.shape).astype(jnp.uint32)
        w_out, w_aux = ref_fn(lm, rm, ivm)
        want_aux = RefFr.from_limbs_fast(np.asarray(RefFr.from_mont_jit(
            jnp.moveaxis(w_aux, 1, 0))))
        want_out = RefFr.from_limbs_fast(np.asarray(
            RefFr.from_mont_jit(w_out)))
        assert got_aux.shape == (730, 3)
        assert [[int(v) for v in row] for row in got_aux] == \
            [[int(v) for v in row] for row in want_aux]
        got_out = Fr.h16_to_ints(out, mont=True)
        assert got_out == [int(v) for v in want_out] == \
            [mimc_hash([a, b], ivs[level]) for a, b in zip(lefts, right)]
        lefts = got_out


@pytest.mark.parametrize('e,R', [(7, 91), (5, 110)])
def test_batched_permutation_and_hash_match_host(e, R):
    """ops.mimc.mimc_permutation and mimc_hash_batch on a batch of three
    against the host cipher and Miyaguchi-Preneel hash."""
    xs, ys, ks = (rand_ints(3, P, seed=40 + j) for j in range(3))
    h16 = [Fr.ints_to_h16(v, 'cpu', mont=True) for v in (xs, ys, ks)]
    got = mimc_permutation(h16[0], h16[2], round_constants_mont(R=R), e)
    assert Fr.h16_to_ints(got, mont=True) == \
        [mimc(x, k, e=e, R=R) for x, k in zip(xs, ks)]
    got = mimc_hash_batch(torch.stack(h16[:2], dim=1), h16[2], e=e, R=R)
    assert Fr.h16_to_ints(got, mont=True) == \
        [mimc_hash([x, y], k, e=e, R=R) for x, y, k in zip(xs, ys, ks)]


@pytest.mark.parametrize('name', ['MerkleMembership', 'MiMCPreimage'])
def test_host_models_match_reference(name):
    """The models whose witness the gadgets fill on the host: the same
    constraints and witness as the reference's."""
    from ethsnarks_tpu import models as ref_models
    if name == 'MiMCPreimage':
        got = models.MiMCPreimage().set_witness(777, 888)
        want = ref_models.MiMCPreimage().set_witness(777, 888)
    else:
        leaves = rand_ints(3, P, seed=9)
        trees = [merkletree.MerkleTree(4), ref_merkletree.MerkleTree(4)]
        for tree in trees:
            for v in leaves:
                tree.append(v)
        got = models.MerkleMembership(2).set_witness(trees[0], 2)
        want = ref_models.MerkleMembership(2).set_witness(trees[1], 2)
    _same_board(got.pb, want.pb)


@pytest.fixture(scope="module")
def batch_models():
    """The depth-4, three-proof batched model of both packages on one
    tree (after tests/test_merkle_batch.py)."""
    rng = random.Random(31337)
    leaves = [rng.randrange(P) for _ in range(6)]
    got_tree, want_tree = merkletree.MerkleTree(16), \
        ref_merkletree.MerkleTree(16)
    for v in leaves:
        got_tree.append(v)
        want_tree.append(v)
    got = BatchMerkleMembership(depth=4, n_proofs=3, device='cpu')
    got.set_witness(got_tree, [0, 2, 5])
    want = RefBatchMerkle(depth=4, n_proofs=3)
    want.set_witness(want_tree, [0, 2, 5])
    return got, want


def test_batch_model_matches_reference(batch_models):
    got, want = batch_models
    assert got.pb.num_constraints == 3 * (4 * 733 + 1)
    _same_board(got.pb, want.pb)
    assert got.trace_seconds > 0


def test_batch_model_tampered_path_unsatisfied(batch_models):
    got, _ = batch_models
    pb = got.pb
    values = list(pb.values)
    values[got.path_vs[1][0].index] = (pb.val(got.path_vs[1][0]) + 1) % P
    assert not pb.is_satisfied(values=values)
    assert pb.is_satisfied()
