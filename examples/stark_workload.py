"""Runnable single-chip STARK workload through the public API.

The end-to-end flow every piece of this library exists to serve:
trace column -> interpolation -> coset low-degree extension -> Tip5
Merkle commitment -> Fiat-Shamir index sampling -> authenticated
opening -> out-of-domain evaluation at an extension-field challenge.

    python examples/stark_workload.py [log_trace_len]

Runs on whatever backend JAX finds (GPU if available, CPU otherwise);
everything printed is verified in-process. The same flow at test scale
is pinned in tests/test_e2e_stark_workload.py.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from twenty_first_tpu.math.b_field_element import P, bfe
from twenty_first_tpu.math.polynomial import Polynomial
from twenty_first_tpu.tip5.tip5 import Tip5
from twenty_first_tpu.util_types.merkle_tree import MerkleTree


def main(log_n: int = 10) -> None:
    rng = np.random.default_rng(0xABCD)
    trace_len, expansion = 1 << log_n, 4
    lde_len = trace_len * expansion
    offset = bfe(7)

    t0 = time.perf_counter()
    trace = rng.integers(0, P, trace_len, dtype=np.uint64)
    interpolant = Polynomial.fast_coset_interpolate(bfe(1), trace)
    codeword = interpolant.fast_coset_evaluate_array(offset, lde_len)
    print(f"trace 2^{log_n} -> LDE x{expansion}: "
          f"{time.perf_counter()-t0:.3f}s")

    t0 = time.perf_counter()
    leafs = Tip5.hash_varlen_batch(codeword[:, None])
    tree = MerkleTree.new(leafs)
    root = tree.root()
    print(f"Merkle commit over {lde_len} leafs: "
          f"{time.perf_counter()-t0:.3f}s  root={root.to_hex()[:16]}…")

    # Fiat-Shamir: absorb the root, sample indices and a challenge
    sponge = Tip5.init()
    sponge.pad_and_absorb_all(list(root.values()))
    indices = sponge.sample_indices(lde_len, 16)
    (challenge,) = sponge.sample_scalars(1)

    proof = tree.inclusion_proof_for_leaf_indices(indices)
    assert proof.verify(root)
    print(f"opened {len(indices)} indices, "
          f"auth structure {len(proof.authentication_structure)} digests, "
          f"verified ok")

    [ood] = Polynomial.coset_extrapolate(offset, codeword, [challenge])
    assert ood == interpolant.evaluate(challenge)
    print(f"out-of-domain sample at xfe challenge consistent: {ood}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 10)
