"""Flag-gated NTT schedule variants stay bit-exact with the default path.

Covers the piece-paired radix-4 layers (TWENTY_FIRST_TPU_NTT_PIECES) and
the DIF (Gentleman-Sande) stages / DIF four-step (TWENTY_FIRST_TPU_NTT_DIF)
— both kept in-tree behind switches (DESIGN.md §3)."""

import functools

import numpy as np
import jax
import pytest

from twenty_first_tpu.math import gf
import twenty_first_tpu.math.ntt as ntt

P = (1 << 64) - (1 << 32) + 1
rng = np.random.default_rng(7)


@pytest.fixture
def restore_flags():
    pieces, dif = ntt._USE_PIECES, ntt._USE_DIF
    yield
    ntt._USE_PIECES, ntt._USE_DIF = pieces, dif


@pytest.mark.parametrize("log_n", [8, 9, 10])
@pytest.mark.parametrize("inverse", [False, True])
def test_pieces_core_matches(restore_flags, log_n, inverse):
    n = 1 << log_n
    data = rng.integers(0, P, size=(n, 8), dtype=np.uint64)
    lo, hi = gf.to_limbs(data)
    ntt._USE_PIECES = False
    ref = jax.jit(functools.partial(
        lambda x, l, i: ntt._ntt_core_ax2(x, l, i), l=log_n, i=inverse))(
            (lo, hi))
    ntt._USE_PIECES = True
    got = jax.jit(functools.partial(
        lambda x, l, i: ntt._ntt_core_ax2(x, l, i), l=log_n, i=inverse))(
            (lo, hi))
    assert np.array_equal(np.asarray(got[0]), np.asarray(ref[0]))
    assert np.array_equal(np.asarray(got[1]), np.asarray(ref[1]))


@pytest.mark.parametrize("log_n", [4, 5, 8])
@pytest.mark.parametrize("inverse", [False, True])
def test_dif_stages_bitrev_of_dit(log_n, inverse):
    n = 1 << log_n
    data = rng.integers(0, P, size=(n, 8), dtype=np.uint64)
    lo, hi = gf.to_limbs(data)
    perm = ntt._bit_reverse_permutation(log_n)
    ref = jax.jit(functools.partial(
        lambda x, l, i: ntt._ntt_core_ax2(x, l, i), l=log_n, i=inverse))(
            (lo, hi))
    dif = jax.jit(functools.partial(
        lambda x, l, i: ntt._ntt_core_ax2_dif(x, l, i), l=log_n, i=inverse))(
            (lo, hi))
    assert np.array_equal(np.asarray(dif[0])[perm], np.asarray(ref[0]))
    assert np.array_equal(np.asarray(dif[1])[perm], np.asarray(ref[1]))


@pytest.mark.parametrize("inverse", [False, True])
def test_dif_four_step_matches(restore_flags, inverse):
    log_n = 18
    data = rng.integers(0, P, size=1 << log_n, dtype=np.uint64)
    lo, hi = gf.to_limbs(data)
    ntt._USE_DIF = False
    diag = ntt._four_step_diag_device.__wrapped__(log_n, inverse, False)
    ref = jax.jit(functools.partial(
        lambda x, d, l, i: ntt.four_step_ntt_traceable(x, l, i, d),
        l=log_n, i=inverse))((lo, hi), diag)
    ntt._USE_DIF = True
    diag = ntt._four_step_diag_device.__wrapped__(log_n, inverse, True)
    got = jax.jit(functools.partial(
        lambda x, d, l, i: ntt.four_step_ntt_traceable(x, l, i, d),
        l=log_n, i=inverse))((lo, hi), diag)
    assert np.array_equal(np.asarray(got[0]), np.asarray(ref[0]))
    assert np.array_equal(np.asarray(got[1]), np.asarray(ref[1]))
