"""Miximus-style Merkle membership (own copy of
``ethsnarks_tpu/models/merkle_membership.py``): knowledge of a leaf at a
secret position in a depth-d MiMC Merkle tree with a public root.  Public
input: the root; private: the leaf, the address bits and the path."""

from ..gadgets import merkle_path_authenticator
from ..merkletree import MerkleTree
from ..r1cs import ConstraintSystem
from ._prove import prove


class MerkleMembership(object):
    def __init__(self, depth=29):
        self.depth = depth
        pb = ConstraintSystem()
        self.root_v = pb.allocate('root')
        pb.set_input_sizes(1)
        self.leaf_v = pb.allocate('leaf')
        self.addr = pb.allocate_array(depth, 'address')
        self.path = pb.allocate_array(depth, 'path')
        self.auth = merkle_path_authenticator(
            pb, depth, self.addr, self.root_v + 0, self.leaf_v + 0,
            self.path, 'membership')
        self.auth.generate_r1cs_constraints()
        self.pb = pb

    def set_witness(self, tree, index):
        """Fill the witness from a host MerkleTree and a leaf index."""
        assert isinstance(tree, MerkleTree)
        proof = tree.proof(index)
        pb = self.pb
        pb.setval(self.root_v, tree.root)
        pb.setval(self.leaf_v, tree[index])
        for d in range(self.depth):
            pb.setval(self.addr[d], proof.address[d])
            pb.setval(self.path[d], proof.path[d])
        self.auth.generate_r1cs_witness()
        assert self.pb.is_satisfied()
        return self

    def prove(self, keypair=None, context=None, device=None, rng=None,
              msm_impl='auto'):
        """-> (proof, keypair, context); see :func:`._prove.prove`."""
        return prove(self.pb, keypair, context, device, rng, msm_impl)
