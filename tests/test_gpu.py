"""Card-only checks: the compiled Tip5 kernel and the paths that dispatch to
it, against the XLA form and the native core. They skip without a GPU; run
them with `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`."""

import numpy as np
import pytest

from twenty_first_tpu import native
from twenty_first_tpu.math import gf
from twenty_first_tpu.math.b_field_element import P
from twenty_first_tpu.tip5 import kernel
from twenty_first_tpu.tip5 import permutation as tip5_dev

pytestmark = pytest.mark.gpu

RNG = np.random.default_rng(23)


def test_kernel_permutation_on_card(gpu):
    states = RNG.integers(0, P, size=(1 << 14, 16), dtype=np.uint64)
    assert kernel.use_kernel(states.shape[0])
    got = tip5_dev.permutation_batch_values(states)
    np.testing.assert_array_equal(got, native.tip5_permute_batch(states))
    np.testing.assert_array_equal(got, tip5_dev.permutation_values(states))


def test_kernel_merkle_root_on_card(gpu):
    from twenty_first_tpu.parallel import dist_merkle

    leafs = RNG.integers(0, P, size=(1 << 14, 5), dtype=np.uint64)
    root = dist_merkle.merkle_root_limbs(gf.to_limbs(leafs), 14)
    np.testing.assert_array_equal(gf.from_limbs(root)[0],
                                  native.tip5_merkle_root(leafs))


def test_kernel_lde_commit_on_card(gpu):
    import chip_smoke

    trace, root = chip_smoke.commit_inputs(12, 10, 4, RNG)
    assert chip_smoke.phase_commit(trace, root, 4, reps=1)["bit_exact"] == "ok"
