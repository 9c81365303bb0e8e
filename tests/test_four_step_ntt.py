"""Four-step (Bailey) NTT vs the direct radix-2 kernel."""

import numpy as np

from twenty_first_tpu.math import gf, ntt
from twenty_first_tpu.math.b_field_element import P

RNG = np.random.default_rng(404)


def test_four_step_matches_direct():
    log_n = 10  # use the machinery directly at a small size
    n = 1 << log_n
    x = RNG.integers(0, P, n, dtype=np.uint64)
    lo, hi = gf.to_limbs(x)
    diag = ntt._four_step_diag_device(log_n, False)
    got = gf.from_limbs(
        ntt._jitted_four_step(log_n, False)(lo, hi, diag[0], diag[1])
    )
    want = gf.from_limbs(ntt._jitted_ntt(log_n, False)(lo, hi))
    np.testing.assert_array_equal(got, want)


def test_four_step_inverse_roundtrip():
    log_n = 12
    n = 1 << log_n
    x = RNG.integers(0, P, n, dtype=np.uint64)
    lo, hi = gf.to_limbs(x)
    dfwd = ntt._four_step_diag_device(log_n, False)
    dinv = ntt._four_step_diag_device(log_n, True)
    fwd = ntt._jitted_four_step(log_n, False)(lo, hi, dfwd[0], dfwd[1])
    back = ntt._jitted_four_step(log_n, True)(fwd[0], fwd[1], dinv[0], dinv[1])
    np.testing.assert_array_equal(gf.from_limbs(back), x)


def test_large_path_dispatch_and_batch():
    # 2^17 hits the four-step path in ntt_values; compare with explicit
    # direct kernel + batch semantics
    log_n = ntt.FOUR_STEP_THRESHOLD_LOG2
    n = 1 << log_n
    x = RNG.integers(0, P, size=(2, n), dtype=np.uint64)
    got = ntt.ntt_values(x)
    lo, hi = gf.to_limbs(x)
    want = gf.from_limbs(ntt._jitted_ntt(log_n, False)(lo, hi))
    np.testing.assert_array_equal(got, want)
    back = ntt.intt_values(got)
    np.testing.assert_array_equal(back, x)


def test_radix8_plan_optin_matches_radix4():
    """The radix-8 stage plan (opt-in, TWENTY_FIRST_TPU_NTT_RADIX8) stays
    bit-exact vs the default radix-4 plan."""
    import jax

    # log 3: single r8 stage; log 6: two r8 stages (r4 plan: r2 lead + r4s
    # vs pure r4s). Inverse only at log 6 — CPU compile time dominates.
    for log_n, inverses in ((3, (False,)), (6, (False, True))):
        n = 1 << log_n
        x = RNG.integers(0, P, (n, 8), dtype=np.uint64)
        lo, hi = gf.to_limbs(x)
        for inverse in inverses:
            perm4, plan4 = ntt._device_tables_mixed(log_n, inverse, radix8=False)
            perm8, plan8 = ntt._device_tables_mixed(log_n, inverse, radix8=True)
            assert any(k == "r8" for k, *_ in plan8)
            assert all(k != "r8" for k, *_ in plan4)

            old = ntt._USE_RADIX8
            try:
                ntt._USE_RADIX8 = False
                want = jax.jit(lambda s: ntt._ntt_core_ax2(s, log_n, inverse))((lo, hi))
                ntt._USE_RADIX8 = True
                got = jax.jit(lambda s: ntt._ntt_core_ax2(s, log_n, inverse))((lo, hi))
            finally:
                ntt._USE_RADIX8 = old
            np.testing.assert_array_equal(
                gf.from_limbs((np.asarray(got[0]), np.asarray(got[1]))),
                gf.from_limbs((np.asarray(want[0]), np.asarray(want[1]))),
            )


def test_batched_slab_fold_matches_per_row():
    """Batched matrices fold the batch into the slab-map axis (round-3 fix:
    leaving the batch inside the map body multiplies each step's working set);
    (8, 2^19) hits the slabbed + batched + four-step path end to end."""
    import jax

    from twenty_first_tpu.math import gf, ntt

    rng = np.random.default_rng(17)
    x = rng.integers(0, P, size=(8, 1 << 19), dtype=np.uint64)
    got = gf.from_limbs(ntt.ntt_limbs(gf.to_limbs(x)))
    for i in (0, 5, 7):
        np.testing.assert_array_equal(got[i], ntt.ntt_host(x[i]))
    back = gf.from_limbs(ntt.ntt_limbs(gf.to_limbs(got), inverse=True))
    np.testing.assert_array_equal(back, x)
    assert jax is not None
