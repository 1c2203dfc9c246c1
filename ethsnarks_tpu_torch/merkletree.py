"""Incremental Merkle tree with MiMC or Poseidon node hashers (own copy
of ``ethsnarks_tpu/merkletree.py:26-220``).

Roots and proofs are bit-exact with the reference's: the same sha256
placeholder for every node not yet filled, the same running-sha256
'MerkleTree-' IV chain for the MiMC hasher (equal to
:func:`.gadgets.merkle.merkle_tree_IVs`), the same proof layout (per-level
siblings and the position the running item is spliced back into).  Nodes
live in sparse per-level dicts; a write re-hashes only its root path, and
:meth:`MerkleTree.extend` appends many leaves with one hash per touched
node.  Leaves are python ints below r.
"""

import hashlib
import math

from .poseidon import poseidon, DefaultParams as poseidon_DefaultParams
from .mimc import mimc_hash
from .field import SNARK_SCALAR_FIELD


def _sha_to_field(data):
    return int.from_bytes(hashlib.sha256(data).digest(), 'big') \
        % SNARK_SCALAR_FIELD


class Abstract_MerkleHasher(object):
    """Node-hash provider: ``hash_node(depth, *children)`` plus the shared
    placeholder scheme for nodes that have not been appended yet."""

    def unique(self, depth, index):
        """Deterministic placeholder for the absent node at (depth, index):
        sha256 over BE16(depth) || BE240(index), reduced into the field."""
        assert depth < self._tree_depth
        tag = int(depth).to_bytes(2, 'big') + int(index).to_bytes(30, 'big')
        return _sha_to_field(tag)

    def _make_IVs(self):
        """Per-depth IVs: a RUNNING sha256 fed 'MerkleTree-' || LE16(i) at
        every depth (each digest depends on all previous updates)."""
        ivs = []
        h = hashlib.sha256()
        for i in range(self._tree_depth):
            h.update(b'MerkleTree-' + int(i).to_bytes(2, 'little'))
            ivs.append(int.from_bytes(h.digest(), 'big') % SNARK_SCALAR_FIELD)
        return ivs

    def valid(self, item):
        return isinstance(item, int) and 0 < item < SNARK_SCALAR_FIELD


class MerkleHasher_MiMC(Abstract_MerkleHasher):
    """MiMC/Miyaguchi-Preneel node hash keyed by the per-depth IV chain."""

    def __init__(self, tree_depth, node_width=2):
        if node_width != 2:
            raise ValueError(
                "Invalid node width %r, must be 2" % (node_width,))
        self._tree_depth = tree_depth
        self._IVs = self._make_IVs()

    def hash_node(self, depth, *args):
        return mimc_hash(args, self._IVs[depth])


class MerkleHasher_Poseidon(Abstract_MerkleHasher):
    """Poseidon sponge node hash (depth-independent, width < t-1)."""

    def __init__(self, params, depth, node_width=2):
        assert node_width > 0
        params = params or poseidon_DefaultParams
        if not 0 < node_width < params.t - 1:
            raise ValueError("Node width must be in range: 0 < width < (t-1)")
        self._params = params
        self._tree_depth = depth

    @classmethod
    def factory(cls, params=None):
        return lambda *args, **kwa: cls(params, *args, **kwa)

    def hash_node(self, depth, *args):
        return poseidon(args, params=self._params)


DEFAULT_HASHER = MerkleHasher_MiMC


class MerkleProof(object):
    """Membership proof: ``path[d]`` holds the level-d siblings (a bare
    value when width is 2), ``address[d]`` the position the running item is
    spliced back into before hashing."""

    __slots__ = ('leaf', 'address', 'path', 'hasher', 'width')

    def __init__(self, leaf, address, path, hasher, width):
        self.leaf = leaf
        self.address = address
        self.path = path
        self.hasher = hasher
        self.width = width

    def verify(self, root):
        item = self.leaf
        for depth in range(len(self.path)):
            siblings = self.path[depth]
            children = list(siblings) if isinstance(siblings, list) \
                else [siblings]
            children.insert(self.address[depth], item)
            item = self.hasher.hash_node(depth, *children)
        return root == item


class MerkleTree(object):
    """Append/update Merkle tree over ``n_items`` leaves, ``width``
    children per node.  Unfilled positions read as placeholder hashes, so
    proofs and the root are well-defined from the first append."""

    def __init__(self, n_items, width=2, hasher=None):
        assert n_items >= width
        assert n_items % width == 0
        self._width = width
        self._tree_depth = int(math.log(n_items, width))
        self._hasher = (hasher or DEFAULT_HASHER)(self._tree_depth, width)
        self._n_items = n_items
        self._cur = 0
        # sparse storage: one {index: value} dict per level, leaves at [0]
        self._nodes = [dict() for _ in range(self._tree_depth + 1)]

    # -------- container protocol over the leaf level --------

    def __len__(self):
        return self._cur

    def __getitem__(self, key):
        if not isinstance(key, int):
            raise TypeError("Invalid key")
        if not 0 <= key < self._cur:
            raise KeyError("Out of bounds")
        return self._nodes[0][key]

    def __setitem__(self, key, value):
        self.update(key, value)

    def __contains__(self, value):
        return any(self._nodes[0][i] == value for i in range(self._cur))

    def index(self, leaf):
        for i in range(self._cur):
            if self._nodes[0][i] == leaf:
                return i
        raise ValueError("%r is not in tree" % (leaf,))

    # -------- reads --------

    def leaf(self, depth, offset):
        """Node value at (depth, offset); placeholder when absent."""
        level = self._nodes[depth]
        if offset in level:
            return level[offset]
        return self._hasher.unique(depth, offset)

    @property
    def root(self):
        if self._cur == 0:
            return None
        return self._nodes[self._tree_depth][0]

    # -------- writes --------

    @staticmethod
    def _as_leaf(leaf):
        if not isinstance(leaf, int):
            raise TypeError("Invalid leaf")
        assert 0 <= leaf < SNARK_SCALAR_FIELD
        return leaf

    def append(self, leaf):
        if self._cur >= self._n_items:
            raise RuntimeError("Tree Full")
        self._nodes[0][self._cur] = self._as_leaf(leaf)
        self._rehash_path(self._cur)
        self._cur += 1
        return self._cur - 1

    def extend(self, leaves):
        """Append every leaf of ``leaves``: the same nodes, root and proofs
        as one :meth:`append` a leaf, with each touched node hashed once
        (level by level) instead of once a leaf below it."""
        leaves = [self._as_leaf(v) for v in leaves]
        if self._cur + len(leaves) > self._n_items:
            raise RuntimeError("Tree Full")
        if not leaves:
            return
        lo, hi = self._cur, self._cur + len(leaves) - 1
        self._nodes[0].update(enumerate(leaves, lo))
        self._cur = hi + 1
        for depth in range(self._tree_depth):
            lo, hi = lo // self._width, hi // self._width
            for index in range(lo, hi + 1):
                self._nodes[depth + 1][index] = self._hasher.hash_node(
                    depth, *[self.leaf(depth, i) for i in
                             self._siblings_range(index * self._width)])

    def update(self, index, leaf):
        value = self._as_leaf(leaf)
        if index >= self._cur:
            raise KeyError("Out of bounds")
        self._nodes[0][index] = value
        self._rehash_path(index)

    def _siblings_range(self, index):
        first = index - index % self._width
        return range(first, first + self._width)

    def _rehash_path(self, index):
        """Recompute ancestors of leaf ``index`` up to the root."""
        for depth in range(self._tree_depth):
            index, _ = divmod(index, self._width)
            children = [self.leaf(depth, i)
                        for i in self._siblings_range(index * self._width)]
            self._nodes[depth + 1][index] = \
                self._hasher.hash_node(depth, *children)

    # -------- proofs --------

    def proof(self, index):
        if index >= self._cur:
            raise RuntimeError("Proof for invalid item!")
        leaf = self[index]
        address, path = [], []
        for depth in range(self._tree_depth):
            pos = index % self._width
            siblings = [self.leaf(depth, i)
                        for i in self._siblings_range(index) if i != index]
            address.append(pos)
            path.append(siblings[0] if len(siblings) == 1 else siblings)
            index //= self._width
        return MerkleProof(leaf, address, path, self._hasher, self._width)
