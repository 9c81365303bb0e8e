"""Merkle tree over Tip5.

Mirrors twenty-first/src/util_types/merkle_tree.rs in API and values. Node
indexing is the reference's 1-based array convention (root at 1, leafs at
n..2n; merkle_tree.rs:25-88). Construction is a layer-wise batched
`hash_pair` reduction — the replacement for the reference's rayon subtree
parallelism (par_new, merkle_tree.rs:165-212): trees up to
HOST_MERKLE_MAX_LEAFS build on the host (native OpenMP core), larger ones
build every layer on the device in one jitted graph
(parallel/dist_merkle.tree_nodes); across chips, layers are sharded
(parallel/dist_merkle.py).

The de-duplicated authentication structure, inclusion proofs and partial-tree
verification (merkle_tree.rs:449-931) are pure index math on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..config import merkle_tree_parallelization_cutoff
from ..errors import MerkleTreeError
from ..math import gf
from ..tip5 import permutation as device
from ..tip5.digest import Digest
from ..tip5.tip5 import Tip5

ROOT_INDEX = 1

# In-struct size limit, as in the reference (merkle_tree.rs:76-79).
MAX_TREE_HEIGHT = 24


def _as_leaf_array(leafs) -> np.ndarray:
    """Normalize leafs (list[Digest] | np.ndarray (n, 5)) to uint64 (n, 5)."""
    if isinstance(leafs, np.ndarray):
        arr = np.asarray(leafs, dtype=np.uint64)
        if arr.ndim != 2 or arr.shape[1] != Digest.LEN:
            raise MerkleTreeError(f"leaf array must be (n, 5), got {arr.shape}")
        return arr
    return np.array([d.to_array() for d in leafs], dtype=np.uint64).reshape(
        -1, Digest.LEN
    )


# Host-vs-device crossover for the one-shot object API (same design split
# as ntt.HOST_NTT_MAX_ELEMS): trees up to this many leafs build on the host
# (OpenMP native batch permutation); larger trees build on the device in one
# graph, paying one transfer each way. The value dates from an earlier
# accelerator and is not yet measured on the H100. Override with
# TWENTY_FIRST_TPU_HOST_MERKLE_MAX_LEAFS.
import os as _os

HOST_MERKLE_MAX_LEAFS = int(_os.environ.get(
    "TWENTY_FIRST_TPU_HOST_MERKLE_MAX_LEAFS", str(1 << 21)))


def _hash_layer(nodes: np.ndarray) -> np.ndarray:
    """One tree layer: (2b, 5) -> (b, 5) via batched hash_pair.

    Used for trees up to HOST_MERKLE_MAX_LEAFS: layers run on the OpenMP
    native batch permutation when it is available; without it, tiny layers
    (below the reference's parallelization cutoff, config.rs:68-77) take
    the scalar path and larger ones the device hash_pair."""
    from .. import native

    b = nodes.shape[0] // 2
    small = nodes.shape[0] < merkle_tree_parallelization_cutoff()
    host_native = native.available() and (
        small or nodes.shape[0] <= HOST_MERKLE_MAX_LEAFS)
    if host_native:
        return native.tip5_hash_pairs(nodes)
    if small:
        out = np.empty((b, Digest.LEN), dtype=np.uint64)
        for i in range(b):
            out[i] = Tip5.hash_pair(
                Digest.from_array(nodes[2 * i]), Digest.from_array(nodes[2 * i + 1])
            ).to_array()
        return out
    pairs = nodes.reshape(b, 2, Digest.LEN)
    left = gf.to_limbs(pairs[:, 0, :])
    right = gf.to_limbs(pairs[:, 1, :])
    return gf.from_limbs(device.hash_pair(left, right))


def _check_num_leafs(num_leafs: int) -> int:
    if num_leafs == 0 or num_leafs & (num_leafs - 1):
        raise MerkleTreeError("number of leafs must be a power of two")
    return int(num_leafs).bit_length() - 1


class MerkleTree:
    """A full Merkle tree holding all 2n nodes (row 0 unused)."""

    def __init__(self, nodes: np.ndarray):
        self._nodes = nodes

    # -- construction -------------------------------------------------------

    @classmethod
    def new(cls, leafs) -> "MerkleTree":
        leafs = _as_leaf_array(leafs)
        height = _check_num_leafs(leafs.shape[0])
        if height > MAX_TREE_HEIGHT:
            raise MerkleTreeError(f"tree height {height} exceeds {MAX_TREE_HEIGHT}")
        n = leafs.shape[0]
        if n > HOST_MERKLE_MAX_LEAFS:
            from ..parallel import dist_merkle

            return cls(gf.from_limbs(
                dist_merkle.tree_nodes(gf.to_limbs(leafs), height)))
        nodes = np.zeros((2 * n, Digest.LEN), dtype=np.uint64)
        nodes[n:] = leafs
        layer = leafs
        lo = n
        while layer.shape[0] > 1:
            layer = _hash_layer(layer)
            lo //= 2
            nodes[lo: 2 * lo] = layer
        return cls(nodes)

    # The reference's par_new/sequential_new distinction is a host-threading
    # artifact; here both are the same batched layer reduction.
    par_new = new
    sequential_new = new

    @classmethod
    def frugal_root(cls, leafs) -> Digest:
        """Root with O(layer) memory: never materializes the node array
        (reference: sequential/par_frugal_root, merkle_tree.rs:299-364).
        Host-sized inputs run the whole layer loop in native code."""
        from .. import native

        layer = _as_leaf_array(leafs)
        height = _check_num_leafs(layer.shape[0])
        if layer.shape[0] > HOST_MERKLE_MAX_LEAFS:
            from ..parallel import dist_merkle

            root = dist_merkle.merkle_root_limbs(gf.to_limbs(layer), height)
            return Digest.from_array(gf.from_limbs(root)[0])
        if native.available():
            return Digest.from_array(native.tip5_merkle_root(layer))
        while layer.shape[0] > 1:
            layer = _hash_layer(layer)
        return Digest.from_array(layer[0])

    par_frugal_root = frugal_root
    sequential_frugal_root = frugal_root

    # -- accessors ----------------------------------------------------------

    def num_leafs(self) -> int:
        return self._nodes.shape[0] // 2

    def height(self) -> int:
        return self.num_leafs().bit_length() - 1

    def root(self) -> Digest:
        return Digest.from_array(self._nodes[ROOT_INDEX])

    def node(self, index: int) -> Digest | None:
        if index < 1 or index >= self._nodes.shape[0]:
            return None
        return Digest.from_array(self._nodes[index])

    def node_array(self) -> np.ndarray:
        return self._nodes

    def leaf(self, index: int) -> Digest | None:
        if index < 0 or index >= self.num_leafs():
            return None
        return Digest.from_array(self._nodes[self.num_leafs() + index])

    def leafs(self):
        n = self.num_leafs()
        return [Digest.from_array(row) for row in self._nodes[n:]]

    def indexed_leafs(self, indices) -> list[tuple[int, Digest]]:
        out = []
        for i in indices:
            leaf = self.leaf(i)
            if leaf is None:
                raise MerkleTreeError(f"invalid leaf index {i}")
            out.append((i, leaf))
        return out

    # -- authentication structure -------------------------------------------

    @staticmethod
    def authentication_structure_node_indices(
        num_leafs: int, leaf_indices
    ) -> list[int]:
        """De-duplicated node indices, sorted descending
        (merkle_tree.rs:449-504)."""
        if num_leafs == 0 or num_leafs & (num_leafs - 1):
            raise MerkleTreeError("number of leafs must be a power of two")
        needed: set[int] = set()
        computable: set[int] = set()
        for leaf_index in leaf_indices:
            if leaf_index >= num_leafs or leaf_index < 0:
                raise MerkleTreeError(f"invalid leaf index {leaf_index}")
            node_index = leaf_index + num_leafs
            while node_index > ROOT_INDEX:
                computable.add(node_index)
                needed.add(node_index ^ 1)
                node_index //= 2
        return sorted(needed - computable, reverse=True)

    def authentication_structure(self, leaf_indices) -> list[Digest]:
        indices = self.authentication_structure_node_indices(
            self.num_leafs(), leaf_indices
        )
        return [Digest.from_array(self._nodes[i]) for i in indices]

    @classmethod
    def authentication_structure_from_leafs(
        cls, leafs, leaf_indices
    ) -> list[Digest]:
        """Auth structure without a full tree: frugal-roots of the needed
        subtrees (merkle_tree.rs:514-575)."""
        leafs = _as_leaf_array(leafs)
        num_leafs = leafs.shape[0]
        indices = cls.authentication_structure_node_indices(num_leafs, leaf_indices)
        out = []
        for node_index in indices:
            # Subtree rooted at node_index covers a contiguous leaf range.
            layer_size = 1 << (node_index.bit_length() - 1)
            offset_in_layer = node_index - layer_size
            subtree_leaf_count = num_leafs // layer_size
            start = offset_in_layer * subtree_leaf_count
            out.append(
                cls.frugal_root(leafs[start: start + subtree_leaf_count])
            )
        return out

    sequential_authentication_structure_from_leafs = authentication_structure_from_leafs
    par_authentication_structure_from_leafs = authentication_structure_from_leafs

    def inclusion_proof_for_leaf_indices(
        self, indices
    ) -> "MerkleTreeInclusionProof":
        return MerkleTreeInclusionProof(
            tree_height=self.height(),
            indexed_leafs=self.indexed_leafs(indices),
            authentication_structure=self.authentication_structure(indices),
        )

    def __eq__(self, other):
        return isinstance(other, MerkleTree) and np.array_equal(
            self._nodes, other._nodes
        )


@dataclass
class MerkleTreeInclusionProof:
    """Inclusion proof relative to a (possibly unknown) Merkle tree
    (merkle_tree.rs:94-113)."""

    tree_height: int
    indexed_leafs: list[tuple[int, Digest]] = field(default_factory=list)
    authentication_structure: list[Digest] = field(default_factory=list)

    def leaf_indices(self) -> list[int]:
        return [i for i, _ in self.indexed_leafs]

    def is_trivial(self) -> bool:
        return not self.indexed_leafs and not self.authentication_structure

    def verify(self, expected_root: Digest) -> bool:
        if self.is_trivial():
            return True
        try:
            tree = PartialMerkleTree.from_proof(self)
            return tree.root() == expected_root
        except MerkleTreeError:
            return False

    def try_verify(self, expected_root: Digest) -> None:
        """Like verify, but raising a typed error with the failure cause
        (merkle_tree.rs:736-745)."""
        if self.is_trivial():
            return
        tree = PartialMerkleTree.from_proof(self)  # raises MerkleTreeError
        if tree.root() != expected_root:
            raise MerkleTreeError("root mismatch")

    def into_authentication_paths(self) -> list[list[Digest]]:
        """Decompress into one authentication path per indicated leaf
        (merkle_tree.rs:773-776, :861-887)."""
        tree = PartialMerkleTree.from_proof(self)
        return [
            tree.authentication_path_for_index(i) for i in tree.leaf_indices
        ]


class PartialMerkleTree:
    """Helper for verifying inclusion proofs (merkle_tree.rs:779-931)."""

    def __init__(self, tree_height: int, leaf_indices: list[int],
                 nodes: dict[int, Digest]):
        self.tree_height = tree_height
        self.leaf_indices = leaf_indices
        self.nodes = nodes

    @classmethod
    def from_proof(cls, proof: MerkleTreeInclusionProof) -> "PartialMerkleTree":
        leaf_indices = proof.leaf_indices()
        if proof.tree_height > 62:
            raise MerkleTreeError("tree too high")
        num_leafs = 1 << proof.tree_height
        if any(i >= num_leafs or i < 0 for i in leaf_indices):
            raise MerkleTreeError("invalid leaf index")
        node_indices = MerkleTree.authentication_structure_node_indices(
            num_leafs, leaf_indices
        )
        if len(proof.authentication_structure) != len(node_indices):
            raise MerkleTreeError("authentication structure length mismatch")
        nodes = dict(zip(node_indices, proof.authentication_structure))
        for leaf_index, leaf_digest in proof.indexed_leafs:
            node_index = leaf_index + num_leafs
            if node_index not in nodes:
                nodes[node_index] = leaf_digest
            elif nodes[node_index] != leaf_digest:
                raise MerkleTreeError("repeated leaf digest mismatch")
        tree = cls(proof.tree_height, leaf_indices, nodes)
        tree.fill()
        return tree

    def num_leafs(self) -> int:
        return 1 << self.tree_height

    def root(self) -> Digest:
        if ROOT_INDEX not in self.nodes:
            raise MerkleTreeError("root not found")
        return self.nodes[ROOT_INDEX]

    def node(self, index: int) -> Digest:
        if index not in self.nodes:
            raise MerkleTreeError(f"missing node index {index}")
        return self.nodes[index]

    def fill(self) -> None:
        num_leafs = self.num_leafs()
        parents = sorted({(i + num_leafs) // 2 for i in self.leaf_indices})
        for _ in range(self.tree_height):
            for parent in parents:
                left = self.node(2 * parent)
                right = self.node(2 * parent + 1)
                digest = Tip5.hash_pair(left, right)
                if parent in self.nodes:
                    raise MerkleTreeError(f"spurious node index {parent}")
                self.nodes[parent] = digest
            next_parents = []
            for p in parents:
                q = p // 2
                if not next_parents or next_parents[-1] != q:
                    next_parents.append(q)
            parents = next_parents

    def authentication_path_for_index(self, leaf_index: int) -> list[Digest]:
        num_leafs = self.num_leafs()
        path = []
        node_index = leaf_index + num_leafs
        while node_index > ROOT_INDEX:
            path.append(self.node(node_index ^ 1))
            node_index //= 2
        return path
