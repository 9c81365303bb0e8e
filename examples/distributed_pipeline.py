"""Runnable multi-chip demo on a virtual CPU mesh (no cards needed).

Shards the STARK primitives over an 8-device jax.sharding.Mesh exactly
as a multi-card run would — distributed four-step NTT (one all_to_all),
sharded Merkle root (local subtrees + small all-gather), and the
mesh-sharded MMR peaks — and checks every result against the host
oracle. On several cards the same code runs unmodified with real
collectives; multi-PROCESS variants (jax.distributed) live in
scripts/run_multihost.py.

    python examples/distributed_pipeline.py [log_n]
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from twenty_first_tpu.math import ntt
from twenty_first_tpu.math.b_field_element import P
from twenty_first_tpu.parallel import make_mesh
from twenty_first_tpu.parallel.dist_merkle import distributed_merkle_root
from twenty_first_tpu.parallel.dist_mmr import distributed_peaks_from_leafs
from twenty_first_tpu.parallel.dist_ntt import distributed_ntt_values
from twenty_first_tpu.util_types.merkle_tree import MerkleTree
from twenty_first_tpu.util_types.mmr.mmr_accumulator import MmrAccumulator


def main(log_n: int = 14) -> None:
    rng = np.random.default_rng(0xD157)
    mesh = make_mesh()
    print(f"mesh: {mesh.shape} over {len(jax.devices())} devices")

    n = 1 << log_n
    x = rng.integers(0, P, n, dtype=np.uint64)
    got = distributed_ntt_values(x, mesh)
    want = ntt.ntt_host(x)
    assert np.array_equal(got, want)
    print(f"distributed NTT 2^{log_n}: bit-exact vs host oracle")

    leafs = rng.integers(0, P, size=(1 << 10, 5), dtype=np.uint64)
    root = distributed_merkle_root(leafs, mesh)
    assert root == MerkleTree.frugal_root(leafs)
    print(f"sharded Merkle root over {leafs.shape[0]} leafs: bit-exact")

    mmr_leafs = rng.integers(0, P, size=(1000, 5), dtype=np.uint64)
    peaks = distributed_peaks_from_leafs(mmr_leafs, mesh)
    assert peaks == MmrAccumulator.peaks_from_leafs(mmr_leafs)
    print(f"mesh-sharded MMR peaks over {mmr_leafs.shape[0]} leafs "
          f"({len(peaks)} peaks): bit-exact")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 14)
