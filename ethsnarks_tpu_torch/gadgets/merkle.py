"""Merkle path gadgets: MiMC Miyaguchi-Preneel node hash, per-depth IVs
(own copy of ``ethsnarks_tpu/gadgets/merkle.py:19-117``).

Left/right mux by the address bit (3 constraints a level: booleanity and
two selects), a per-depth IV table equal to the host
:class:`..merkletree.MerkleTree`'s and MerkleTree.sol's, the root
recomputed from the leaf, and (authenticator) one root equality
constraint.
"""

import hashlib

from ..r1cs import Gadget, LinearCombination
from ..field import SNARK_SCALAR_FIELD
from .mimc import MiyaguchiPreneel_OWF, MiMCe7_gadget

P = SNARK_SCALAR_FIELD


def merkle_tree_IVs(depth):
    """Per-depth IVs: running-sha256 over 'MerkleTree-'||LE16(i); same chain
    as merkletree.Abstract_MerkleHasher._make_IVs and MerkleTree.sol."""
    out = []
    hasher = hashlib.sha256()
    for i in range(depth):
        hasher.update(b'MerkleTree-' + int(i).to_bytes(2, 'little'))
        out.append(int.from_bytes(hasher.digest(), 'big') % P)
    return out


class merkle_path_selector(Gadget):
    """(input, pathvar, bit) -> (left, right): bit=0 keeps input on the left.

    3 constraints: bit booleanity + two muxes."""

    def __init__(self, pb, input_lc, pathvar_lc, bit, annotation):
        super().__init__(pb, annotation)
        self.input = LinearCombination() + input_lc
        self.pathvar = LinearCombination() + pathvar_lc
        self.bit = bit
        self.left = pb.allocate(self.fmt('left'))
        self.right = pb.allocate(self.fmt('right'))

    def generate_r1cs_constraints(self):
        pb = self.pb
        pb.add_constraint(self.bit, 1 - (LinearCombination() + self.bit), 0,
                          self.fmt('bit'))
        # left = input + bit*(pathvar - input)
        pb.add_constraint(self.bit, self.pathvar - self.input,
                          (LinearCombination() + self.left) - self.input,
                          self.fmt('left'))
        # right = pathvar + bit*(input - pathvar)
        pb.add_constraint(self.bit, self.input - self.pathvar,
                          (LinearCombination() + self.right) - self.pathvar,
                          self.fmt('right'))

    def generate_r1cs_witness(self):
        pb = self.pb
        b = pb.val(self.bit)
        iv = pb.lc_val(self.input)
        pv = pb.lc_val(self.pathvar)
        pb.setval(self.left, pv if b else iv)
        pb.setval(self.right, iv if b else pv)


class merkle_path_compute(Gadget):
    """Recompute the root from a leaf, address bits, and path elements."""

    def __init__(self, pb, depth, address_bits, leaf_lc, path_vars,
                 annotation, hasher=None):
        super().__init__(pb, annotation)
        assert len(address_bits) == depth and len(path_vars) == depth
        self.depth = depth
        ivs = merkle_tree_IVs(depth)
        self.selectors = []
        self.hashers = []
        cur = LinearCombination() + leaf_lc
        for d in range(depth):
            sel = merkle_path_selector(
                pb, cur, path_vars[d], address_bits[d], self.fmt('sel_%d' % d))
            self.selectors.append(sel)
            h = MiyaguchiPreneel_OWF(
                pb, [sel.left, sel.right], ivs[d], self.fmt('hash_%d' % d),
                cipher=MiMCe7_gadget)
            self.hashers.append(h)
            cur = LinearCombination() + h.result()

    def generate_r1cs_constraints(self):
        for sel, h in zip(self.selectors, self.hashers):
            sel.generate_r1cs_constraints()
            h.generate_r1cs_constraints()

    def generate_r1cs_witness(self):
        for sel, h in zip(self.selectors, self.hashers):
            sel.generate_r1cs_witness()
            h.generate_r1cs_witness()

    def result(self):
        return self.hashers[-1].result()


class merkle_path_authenticator(merkle_path_compute):
    """merkle_path_compute + root equality constraint."""

    def __init__(self, pb, depth, address_bits, expected_root_lc, leaf_lc,
                 path_vars, annotation):
        super().__init__(pb, depth, address_bits, leaf_lc, path_vars,
                         annotation)
        self.expected_root = LinearCombination() + expected_root_lc

    def generate_r1cs_constraints(self):
        super().generate_r1cs_constraints()
        self.pb.add_constraint(
            LinearCombination() + self.result(), 1, self.expected_root,
            self.fmt('root_match'))

    def is_valid(self):
        return self.pb.val(self.result()) == self.pb.lc_val(self.expected_root)
