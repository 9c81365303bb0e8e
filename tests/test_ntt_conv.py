"""Orderless NTT-domain convolution (ntt.conv_values / conv_table_values).

The scrambled four-step path removes every bit-reverse gather from the
forward+pointwise+inverse round trip (DESIGN.md §8); these tests
pin it bit-exact against the natural-order ntt_values oracle, across the
four-step threshold, on the host path and the forced-device path, for the
multiply / divide / prepared-table variants the polynomial engine uses
(reference round-trip structure: polynomial.rs:900-932, 2334-2413,
1087-1144).
"""

import numpy as np
import pytest

from twenty_first_tpu.math import gf_numpy as gfn
from twenty_first_tpu.math import ntt
from twenty_first_tpu.math import xgf_numpy as xgfn
from twenty_first_tpu.math.b_field_element import P

RNG = np.random.default_rng(7)

# spans the four-step threshold (2^17) in the forced-device runs; kept
# minimal above it — each (log_n, variant) device graph is a ~25 s cold
# CPU compile (cached across runs in .jax_cache)
SIZES = [2, 4, 10, 17]


def _oracle_conv(a, b, xfield=False, divide=False):
    """Natural-order reference: intt(ntt(a) * ntt(b)^(+-1))."""
    if xfield:
        fa = ntt.ntt_values(a.T).T
        fb = ntt.ntt_values(b.T).T
        if divide:
            fb = xgfn.inverse(fb)
        prod = xgfn.mul(fa, fb)
        return ntt.ntt_values(prod.T, inverse=True).T
    fa = ntt.ntt_values(a)
    fb = ntt.ntt_values(b)
    if divide:
        fb = gfn.inverse(fb)
    prod = gfn.mul(fa, fb)
    return ntt.ntt_values(prod, inverse=True)


@pytest.fixture(params=["host", "device", "device-scrambled"])
def conv_path(request, monkeypatch):
    """Run each test on the host-native path and on BOTH forced-device
    transform orders (crossover knob pinned to 0): the production
    natural-order four-step and the gather-free scrambled experiment
    (TWENTY_FIRST_TPU_CONV_SCRAMBLED=1)."""
    if request.param.startswith("device"):
        monkeypatch.setattr(ntt, "HOST_CONV_MAX_ELEMS", 0)
    if request.param == "device-scrambled":
        monkeypatch.setenv("TWENTY_FIRST_TPU_CONV_SCRAMBLED", "1")
    else:
        monkeypatch.delenv("TWENTY_FIRST_TPU_CONV_SCRAMBLED",
                           raising=False)
    return request.param


@pytest.mark.parametrize("log_n", SIZES)
def test_conv_base_matches_oracle(log_n, conv_path):
    n = 1 << log_n
    a = RNG.integers(0, P, size=n, dtype=np.uint64)
    b = RNG.integers(0, P, size=n, dtype=np.uint64)
    np.testing.assert_array_equal(ntt.conv_values(a, b), _oracle_conv(a, b))


@pytest.mark.parametrize("log_n", SIZES)
def test_conv_xfield_matches_oracle(log_n, conv_path):
    n = 1 << log_n
    a = RNG.integers(0, P, size=(n, 3), dtype=np.uint64)
    b = RNG.integers(0, P, size=(n, 3), dtype=np.uint64)
    np.testing.assert_array_equal(
        ntt.conv_values(a, b, xfield=True), _oracle_conv(a, b, xfield=True)
    )


@pytest.mark.parametrize("log_n", [4])
def test_conv_divide_base(log_n, conv_path):
    n = 1 << log_n
    a = RNG.integers(0, P, size=n, dtype=np.uint64)
    # divisor with explicitly nonzero evaluations everywhere
    fb = RNG.integers(1, P, size=n, dtype=np.uint64)
    b = ntt.intt_values(fb)
    np.testing.assert_array_equal(
        ntt.conv_values(a, b, divide=True), _oracle_conv(a, b, divide=True)
    )


@pytest.mark.parametrize("log_n", [4, 17])
def test_conv_divide_xfield(log_n, conv_path):
    n = 1 << log_n
    a = RNG.integers(0, P, size=(n, 3), dtype=np.uint64)
    fb = RNG.integers(0, P, size=(n, 3), dtype=np.uint64)
    fb[:, 0] = RNG.integers(1, P, size=n, dtype=np.uint64)  # nonzero evals
    b = ntt.ntt_values(fb.T, inverse=True).T
    np.testing.assert_array_equal(
        ntt.conv_values(a, b, xfield=True, divide=True),
        _oracle_conv(a, b, xfield=True, divide=True),
    )


@pytest.mark.parametrize("log_n", SIZES)
def test_conv_table_base(log_n, conv_path):
    n = 1 << log_n
    a = RNG.integers(0, P, size=n, dtype=np.uint64)
    b = RNG.integers(0, P, size=n, dtype=np.uint64)
    table = ntt.conv_table_prepare(ntt.ntt_values(b))
    np.testing.assert_array_equal(
        ntt.conv_table_values(a, table), _oracle_conv(a, b)
    )


@pytest.mark.parametrize("log_n", [4, 17])
def test_conv_table_xfield(log_n, conv_path):
    n = 1 << log_n
    a = RNG.integers(0, P, size=(n, 3), dtype=np.uint64)
    b = RNG.integers(0, P, size=(n, 3), dtype=np.uint64)
    table = ntt.conv_table_prepare(ntt.ntt_values(b.T).T, xfield=True)
    np.testing.assert_array_equal(
        ntt.conv_table_values(a, table, xfield=True, table_xfield=True),
        _oracle_conv(a, b, xfield=True),
    )


@pytest.mark.parametrize("log_n", [4])
def test_conv_table_base_applied_to_xfield(log_n, conv_path):
    """Base-field table against extension-field data — the
    reduce_by_ntt_friendly_modulus shape when the modulus is base-field
    but the reduced polynomial is extension-field."""
    n = 1 << log_n
    a = RNG.integers(0, P, size=(n, 3), dtype=np.uint64)
    b = RNG.integers(0, P, size=n, dtype=np.uint64)
    table = ntt.conv_table_prepare(ntt.ntt_values(b))
    got = ntt.conv_table_values(a, table, xfield=True, table_xfield=False)
    lifted = np.zeros((n, 3), dtype=np.uint64)
    lifted[:, 0] = b
    np.testing.assert_array_equal(got, _oracle_conv(a, lifted, xfield=True))


@pytest.mark.parametrize("log_n", [17, 18, 19])
def test_scrambled_index_is_involution_and_matches_layout(log_n):
    idx = ntt.scrambled_index(log_n)
    n = 1 << log_n
    assert idx.shape == (n,)
    np.testing.assert_array_equal(idx[idx], np.arange(n))


@pytest.mark.parametrize("log_n", [17])
@pytest.mark.parametrize("inverse", [False, True])
def test_scrambled_four_step_is_permuted_ntt(log_n, inverse):
    """forward: scrambled_out[scrambled_index] == natural ntt;
    inverse: natural out from scrambled_index-permuted natural input."""
    from twenty_first_tpu.math import gf

    n = 1 << log_n
    x = RNG.integers(0, P, size=n, dtype=np.uint64)
    idx = ntt.scrambled_index(log_n)
    diag = ntt._scrambled_diag_device(log_n, inverse)
    if inverse:
        # scrambled-order input (natural x viewed through idx) -> natural
        # intt(x) output, incl. the fused 1/n
        out = gf.from_limbs(
            ntt.four_step_ntt_scrambled(gf.to_limbs(x[idx]), log_n, True,
                                        diag)
        )
        np.testing.assert_array_equal(out, ntt.ntt_values(x, inverse=True))
    else:
        # natural input -> scrambled output: unscrambling gives ntt(x)
        out = gf.from_limbs(
            ntt.four_step_ntt_scrambled(gf.to_limbs(x), log_n, False, diag)
        )
        np.testing.assert_array_equal(out[idx], ntt.ntt_values(x))


def test_conv_batched_rows(conv_path):
    n = 1 << 10
    a = RNG.integers(0, P, size=(3, n), dtype=np.uint64)
    b = RNG.integers(0, P, size=(3, n), dtype=np.uint64)
    got = ntt.conv_values(a, b)
    for i in range(3):
        np.testing.assert_array_equal(got[i], _oracle_conv(a[i], b[i]))
