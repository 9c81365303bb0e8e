"""The Tip5 Pallas kernel (tip5/kernel.py) in interpret mode, and the
dispatch that decides which callers run it, against the XLA permutation
and the native core."""

import numpy as np
import pytest

import jax

from twenty_first_tpu import native
from twenty_first_tpu.math import gf
from twenty_first_tpu.math.b_field_element import P
from twenty_first_tpu.tip5 import kernel
from twenty_first_tpu.tip5 import permutation as tip5_dev

RNG = np.random.default_rng(11)


def _wm(values):
    """uint64 (B, k) -> word-major (k, B) limb planes."""
    return gf.to_limbs(np.ascontiguousarray(values.T))


def _unwm(planes):
    return gf.from_limbs(planes).T


@pytest.fixture
def kernel_on_cpu(monkeypatch):
    """Dispatch as on the GPU (kernel for batches of >= BLOCK), with every
    kernel call run by the Pallas interpreter."""
    pallas_call = kernel._pallas_call
    monkeypatch.setattr(kernel, "use_kernel",
                        lambda batch, platform=None: batch >= kernel.BLOCK)
    monkeypatch.setattr(
        kernel, "_pallas_call",
        lambda body, name, grid, out_shape, interpret, **kw:
        pallas_call(body, name, grid, out_shape, True, **kw))
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("batch", [1, 7, 1000, 4096])
def test_permutation_wm_matches_xla(batch):
    states = RNG.integers(0, P, size=(batch, 16), dtype=np.uint64)
    got = _unwm(kernel.permutation_wm(_wm(states), interpret=True))
    np.testing.assert_array_equal(got, tip5_dev.permutation_values(states))


def test_permutation_wm_matches_native_snapshot_states():
    # edge words: 0, p - 1, and values just below 2^64 (non-canonical
    # inputs are reduced like the XLA form does)
    edges = np.array([0, 1, P - 1, P - 2, (1 << 32) - 1, 1 << 32],
                     dtype=np.uint64)
    states = edges[RNG.integers(0, edges.size, size=(200, 16))]
    got = _unwm(kernel.permutation_wm(_wm(states), interpret=True))
    np.testing.assert_array_equal(got, native.tip5_permute_batch(states))


@pytest.mark.parametrize("log_n", [3, 9])
def test_merkle_layers_fill_the_heap(log_n):
    """Every node of the tree, small top layers (masked lanes) included,
    against the native host tree."""
    from twenty_first_tpu.util_types.merkle_tree import MerkleTree

    n = 1 << log_n
    leafs = RNG.integers(0, P, size=(n, 5), dtype=np.uint64)
    planes = kernel.tree_planes(_wm(leafs))
    nodes = kernel.merkle_layers(planes, n, log_n, interpret=True)
    got = _unwm(nodes)
    np.testing.assert_array_equal(got[1:2 * n], MerkleTree.new(leafs)
                                  .node_array()[1:])
    assert not got[2 * n:].any()


def test_merkle_layers_partial_reduction():
    """Two layers of a 2^8 tree leave layer 2 at columns [64, 128)."""
    leafs = RNG.integers(0, P, size=(256, 5), dtype=np.uint64)
    lo, hi = kernel.merkle_layers(kernel.tree_planes(_wm(leafs)), 256, 2,
                                  interpret=True)
    want = native.tip5_hash_pairs(native.tip5_hash_pairs(leafs))
    np.testing.assert_array_equal(_unwm((lo[:, 64:128], hi[:, 64:128])),
                                  want)


@pytest.mark.parametrize("width", [3, 10])
def test_hash_rows_wm_matches_hash_10(width):
    rows = RNG.integers(0, P, size=(130, width), dtype=np.uint64)
    got = _unwm(kernel.hash_rows_wm(_wm(rows), interpret=True))
    padded = np.zeros((130, 10), dtype=np.uint64)
    padded[:, :width] = rows
    want = gf.from_limbs(tip5_dev.hash_10(gf.to_limbs(padded)))
    np.testing.assert_array_equal(got, want)


def test_hash_rows_wm_rejects_wide_rows():
    rows = gf.to_limbs(np.zeros((11, 128), dtype=np.uint64))
    with pytest.raises(ValueError):
        kernel.hash_rows_wm(rows, interpret=True)


@pytest.mark.parametrize("platform, batch, expected", [
    ("cpu", 1 << 20, False),
    ("gpu", kernel.BLOCK - 1, False),
    ("gpu", kernel.BLOCK, True),
    ("gpu", 1 << 22, True),
])
def test_use_kernel_by_backend_and_shape(platform, batch, expected):
    assert kernel.use_kernel(batch, platform) is expected


def test_permutation_batch_dispatch_fallback_on_cpu():
    """Off the GPU, permutation_batch is the XLA form for every batch —
    bit-exact with permutation."""
    assert not kernel.use_kernel(1 << 12)
    for b in (1 << 12, 24):
        states = RNG.integers(0, P, size=(b, 16), dtype=np.uint64)
        got = gf.from_limbs(tip5_dev.permutation_batch(gf.to_limbs(states)))
        np.testing.assert_array_equal(got, tip5_dev.permutation_values(states))


def test_permutation_batch_kernel_path(kernel_on_cpu):
    states = RNG.integers(0, P, size=(256, 16), dtype=np.uint64)
    got = tip5_dev.permutation_batch_values(states)
    np.testing.assert_array_equal(got, native.tip5_permute_batch(states))


def test_merkle_root_kernel_layers(kernel_on_cpu):
    """Leading layers (>= BLOCK pairs) on the kernel, the rest on XLA."""
    from twenty_first_tpu.parallel import dist_merkle

    leafs = RNG.integers(0, P, size=(1 << 9, 5), dtype=np.uint64)
    root = dist_merkle.merkle_root_limbs(gf.to_limbs(leafs), 9)
    np.testing.assert_array_equal(gf.from_limbs(root)[0],
                                  native.tip5_merkle_root(leafs))


def test_trace_lde_commit_kernel_tail(kernel_on_cpu):
    """W = 10 trace, 2^8 extended rows: leaf hashing and the first layer
    on the kernel, straight from the word-major evaluation planes."""
    import chip_smoke
    from twenty_first_tpu.parallel.pipeline import trace_lde_commit

    trace = RNG.integers(0, P, size=(10, 1 << 6), dtype=np.uint64)
    root = jax.jit(trace_lde_commit)(gf.to_limbs(trace))
    np.testing.assert_array_equal(gf.from_limbs(root)[0],
                                  chip_smoke.commit_oracle(trace, 4))


def test_distributed_root_kernel_under_shard_map(kernel_on_cpu):
    from twenty_first_tpu.parallel import make_mesh
    from twenty_first_tpu.parallel.dist_merkle import distributed_merkle_root

    leafs = RNG.integers(0, P, size=(1 << 10, 5), dtype=np.uint64)
    got = distributed_merkle_root(leafs, make_mesh(4))
    np.testing.assert_array_equal(got.to_array(),
                                  native.tip5_merkle_root(leafs))
