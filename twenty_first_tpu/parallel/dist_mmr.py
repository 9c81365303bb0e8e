"""Distributed MMR: mesh-sharded peaks-from-leafs and batch-append.

Batched reformulation of the reference's diagonal sweep
(mmr_accumulator.rs:96-115), which is inherently sequential: the leaf
count's binary decomposition splits the leafs into contiguous perfect
trees, so each peak is an independent Merkle reduction. Peaks large
enough to span the mesh are reduced with the sharded layer kernel
(dist_merkle: local subtrees + one small all-gather); tail peaks fall
back to the host path.

Batch-append (the MmrSuccessorProof workload, mmr_successor_proof.rs:34-91)
decomposes the appended range into maximal aligned perfect subtrees —
exactly the carry chain of binary addition leaf_count + batch_size — and
reduces each subtree on the mesh; the O(log^2) peak merges between chunks
are scalar hash_pairs on host.

Both entry points work in multi-controller (jax.distributed) runs: chunk
leafs are materialized per process via shard_host_array, and collectives
cross process boundaries through the distributed runtime.
"""

from __future__ import annotations

import numpy as np

from ..math import gf
from ..tip5.digest import Digest
from ..tip5.tip5 import Tip5
from ..util_types.mmr import shared_advanced
from . import dist_merkle
from .mesh import AXIS, shard_host_array


def _chunk_root(arr: np.ndarray, mesh) -> Digest:
    """Merkle root of a (2^h, 5) uint64 chunk, sharded when it spans the
    mesh, host frugal-root otherwise."""
    n = arr.shape[0]
    if n == 1:
        return Digest.from_array(arr[0])
    d = mesh.shape[AXIS] if mesh is not None else 1
    # chunk sizes are powers of two; a non-power-of-two mesh axis (e.g. 3
    # processes) cannot divide them — fall back to the host frugal root
    if mesh is not None and n >= max(d, 2) and n % d == 0:
        log_n = n.bit_length() - 1
        lo, hi = gf.to_limbs(np.ascontiguousarray(arr))
        glo = shard_host_array(mesh, (AXIS, None), lo)
        ghi = shard_host_array(mesh, (AXIS, None), hi)
        rlo, rhi = dist_merkle.distributed_merkle_root_limbs(
            (glo, ghi), mesh, log_n)
        root = gf.from_limbs((np.asarray(rlo.addressable_data(0)),
                              np.asarray(rhi.addressable_data(0))))[0]
        return Digest.from_array(root)
    from ..util_types.merkle_tree import MerkleTree

    return MerkleTree.frugal_root(arr)


def distributed_peaks_from_leafs(leafs, mesh) -> list[Digest]:
    """MMR peaks of (n, 5) uint64 leafs, each peak a sharded reduction.

    Bit-exact with MmrAccumulator.peaks_from_leafs for any n >= 0.
    """
    arr = np.asarray(leafs, dtype=np.uint64)
    n = arr.shape[0]
    if n == 0:
        return []
    peaks: list[Digest] = []
    offset = 0
    for height in shared_advanced.get_peak_heights(n):
        size = 1 << height
        peaks.append(_chunk_root(arr[offset: offset + size], mesh))
        offset += size
    return peaks


def distributed_batch_append(peaks: list[Digest], leaf_count: int,
                             new_leafs, mesh) -> tuple[list[Digest], int]:
    """Append a (m, 5) uint64 batch to an accumulator's (peaks, count).

    Returns (new_peaks, new_leaf_count), bit-exact with m sequential
    MmrAccumulator.append calls. Device work: one sharded Merkle
    reduction per maximal aligned perfect subtree of the appended range
    (<= 2*64 chunks); host work: the scalar carry-merge hash_pairs.
    """
    arr = np.asarray(new_leafs, dtype=np.uint64)
    m = arr.shape[0]
    peaks = list(peaks)
    count = leaf_count
    offset = 0
    while offset < m:
        rem = m - offset
        align = (count & -count) if count else 1 << 63
        size = min(align, 1 << (rem.bit_length() - 1))
        node = _chunk_root(arr[offset: offset + size], mesh)
        # carry chain of count + size: each set bit of count at/above
        # log2(size) that propagates corresponds to a trailing peak of
        # that exact size (peak sizes are count's set bits, descending)
        bit = size
        while count & bit:
            node = Tip5.hash_pair(peaks.pop(), node)
            bit <<= 1
        peaks.append(node)
        count += size
        offset += size
    return peaks, count
