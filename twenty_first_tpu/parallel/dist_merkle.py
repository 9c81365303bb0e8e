"""Distributed Merkle commitment: sharded layers + cross-chip top tree.

Replacement for the reference's rayon subtree parallelism
(merkle_tree.rs:165-212): leafs are sharded over the mesh; each chip reduces
its contiguous subtree locally (log(n/d) batched hash_pair layers — exactly
the reference's "split into 2^t subtrees" strategy, with chips instead of
threads); the d subtree roots are all-gathered (one small collective) and the
top log(d) layers are computed redundantly on every chip, which is cheaper
than communicating for trees this small.

On the GPU, a reduction whose first layer fills at least one kernel block
runs all its layers on the Tip5 kernel (tip5/kernel.py) over heap-ordered
word-major node planes; smaller reductions and other backends run the XLA
form on row-major (n, 5) planes.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..math import gf
from ..tip5 import kernel
from ..tip5 import permutation as tip5_dev
from ..tip5.digest import Digest
from .mesh import AXIS


def _kernel_tree(digests, num_layers: int):
    """Word-major (5, n) digests -> word-major (5, n >> num_layers), every
    layer on the GPU Tip5 kernel (one compiled kernel for all layers)."""
    n = digests[0].shape[1]
    lo, hi = kernel.merkle_layers(kernel.tree_planes(digests), n, num_layers)
    m = n >> num_layers
    return lo[:, m:2 * m], hi[:, m:2 * m]


def _xla_layers(state, num_layers: int):
    """Repeated batched hash_pair on row-major (b, 5) limb planes."""
    lo, hi = state
    for _ in range(num_layers):
        b = lo.shape[0] // 2
        plo = lo.reshape(b, 2, 5)
        phi = hi.reshape(b, 2, 5)
        lo, hi = tip5_dev.hash_pair(
            (plo[:, 0], phi[:, 0]), (plo[:, 1], phi[:, 1])
        )
    return lo, hi


def _reduce_layers(state, num_layers: int):
    """Repeated batched hash_pair: (b, 5) limb planes -> (b / 2^k, 5)."""
    lo, hi = state
    if num_layers and kernel.use_kernel(lo.shape[0] // 2):
        wlo, whi = _kernel_tree((lo.T, hi.T), num_layers)
        return wlo.T, whi.T
    return _xla_layers(state, num_layers)


def reduce_layers_wm(digests, num_layers: int):
    """Word-major (5, b) digest planes -> row-major (b / 2^k, 5)."""
    lo, hi = digests
    if num_layers and kernel.use_kernel(lo.shape[1] // 2):
        lo, hi = _kernel_tree(digests, num_layers)
        return lo.T, hi.T
    return _xla_layers((lo.T, hi.T), num_layers)


@functools.partial(jax.jit, static_argnames="height")
def tree_nodes(leafs, height: int):
    """All nodes of a Merkle tree: (n, 5) leaf planes -> (2n, 5) planes in
    the reference's heap order (row 0 unused, root at row 1, leafs at rows
    n..2n)."""
    lo, hi = leafs
    n = lo.shape[0]
    if height and kernel.use_kernel(n // 2):
        nodes = kernel.merkle_layers(kernel.tree_planes((lo.T, hi.T)), n,
                                     height)
        return nodes[0][:, :2 * n].T, nodes[1][:, :2 * n].T
    layers = [leafs]
    for _ in range(height):
        layers.append(_xla_layers(layers[-1], 1))
    zero = jnp.zeros((1, 5), jnp.uint32)
    return (jnp.concatenate([zero] + [l[0] for l in reversed(layers)]),
            jnp.concatenate([zero] + [l[1] for l in reversed(layers)]))


@functools.partial(jax.jit, static_argnames="height")
def merkle_root_limbs(leafs, height: int):
    """Single-device Merkle root: (n, 5) leaf planes -> (1, 5)."""
    return _reduce_layers(leafs, height)


@functools.lru_cache(maxsize=None)
def _make_distributed_root(mesh, log_n: int):
    d = mesh.shape[AXIS]
    log_d = d.bit_length() - 1
    if (1 << log_d) != d:
        raise ValueError("mesh size must be a power of two")
    if log_n < log_d:
        raise ValueError("tree smaller than mesh")

    def local(lo, hi):
        # (n/d, 5) local leafs -> local subtree root
        slo, shi = _reduce_layers((lo, hi), log_n - log_d)
        # gather the d subtree roots everywhere (tiny: d * 5 words)
        glo = jax.lax.all_gather(slo, AXIS, axis=0, tiled=True)
        ghi = jax.lax.all_gather(shi, AXIS, axis=0, tiled=True)
        rlo, rhi = _reduce_layers((glo, ghi), log_d)
        # Every chip holds the same (1, 5) root; expose it as a sharded
        # (d, 5) output (row per chip) — shard_map cannot statically infer
        # replication through the hash arithmetic.
        return rlo, rhi

    # check_vma=False: the Tip5 kernel's pallas_call carries no
    # varying-axes rule for its block loads
    fn = shard_map(local, mesh=mesh, in_specs=(P(AXIS, None), P(AXIS, None)),
                   out_specs=(P(AXIS, None), P(AXIS, None)), check_vma=False)
    return jax.jit(fn)


def distributed_merkle_root(leafs, mesh) -> Digest:
    """Merkle root of (n, 5) uint64 leafs, sharded over the mesh.

    Bit-exact with MerkleTree.new(leafs).root() for any mesh size.
    """
    leafs = np.asarray(leafs, dtype=np.uint64)
    n = leafs.shape[0]
    log_n = n.bit_length() - 1
    if (1 << log_n) != n:
        raise ValueError("number of leafs must be a power of two")
    lo, hi = _make_distributed_root(mesh, log_n)(*gf.to_limbs(leafs))
    # replicated output: every chip holds the (1, 5) root
    return Digest.from_array(gf.from_limbs((lo, hi))[0])


def distributed_merkle_root_limbs(state, mesh, log_n: int):
    """Jit-composable variant on limb planes (n, 5) -> (1, 5)."""
    return _make_distributed_root(mesh, log_n)(*state)
