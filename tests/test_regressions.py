"""Pinned regression corpus — the proptest-regressions analogue.

The reference permanently replays known-bad property-test cases from
`twenty-first/proptest-regressions/math/polynomial.txt:1` (SURVEY §4.1:
regression persistence is part of the test strategy). That file records an
opaque proptest RNG seed (`cc 72ab41c4…`) for a polynomial property — the
concrete inputs cannot be reconstructed without proptest's generator, so
this suite pins the corresponding adversarial case CLASSES as fixed,
named, deterministic cases instead, plus the dispatch-boundary cases this
library's own fuzzer has flagged historically (dispatch retunes:
Lagrange crossover 2^12, row-product batch dispatch, slab branches).

Every case here is replayed unconditionally on every run — the same
guarantee the reference's committed seed file provides.
"""

import numpy as np
import pytest

from twenty_first_tpu.math.b_field_element import P, bfe
from twenty_first_tpu.math.polynomial import Polynomial, PolynomialError


def poly(cs):
    return Polynomial([bfe(c) for c in cs])


# ---------------------------------------------------------------------------
# Polynomial property regressions (proptest-regressions/math/polynomial.txt)
# ---------------------------------------------------------------------------


def test_regression_clean_divide_with_shared_roots_and_leading_zeros():
    """clean_divide where dividend carries un-normalized leading zeros and
    the divisor's roots all divide it — the case family the reference's
    pinned seed exercises (clean_divide is its only polynomial op with a
    debug-assert precondition, polynomial.rs clean_divide)."""
    roots = [bfe(v) for v in (1, 5, 5, 7, 0xFFFF_FFFF)]
    divisor = Polynomial.zerofier(roots[:3])
    quotient_raw = Polynomial.zerofier(roots[3:])
    product = divisor * quotient_raw
    # append high-order zero coefficients (non-normalized representation)
    product = Polynomial(product.coefficients + [bfe(0)] * 4)
    assert product.clean_divide(divisor) == quotient_raw


def test_regression_clean_divide_zero_dividend():
    assert poly([]).clean_divide(poly([3, 1])) == poly([])


def test_regression_interpolate_near_p_domain_points():
    """Interpolation with domain points at the field boundary (p-1, p-2):
    values whose canonical residues straddle the Goldilocks wrap are the
    classic proptest shrink target."""
    domain = np.array([P - 1, P - 2, 1, 2, 3], dtype=np.uint64)
    values = np.array([P - 1, 0, 1, P - 3, 12345], dtype=np.uint64)
    f = Polynomial.fast_interpolate(domain, values)
    for d, v in zip(domain, values):
        assert f.evaluate(bfe(int(d))) == bfe(int(v))


def test_regression_interpolate_crossover_sizes():
    """Fixed cases pinning the native-Lagrange / tree-interpolation
    dispatch boundary retuned in round 4 (crossover 2^12): one size on
    each side must agree with direct evaluation."""
    rng = np.random.default_rng(0x72AB41C4)  # prefix of the reference seed
    for n in ((1 << 12) - 1, (1 << 12) + 1):
        domain = np.unique(rng.integers(1, P, size=n + 64, dtype=np.uint64))[:n]
        values = rng.integers(0, P, size=n, dtype=np.uint64)
        f = Polynomial.fast_interpolate(domain, values)
        for i in (0, n // 2, n - 1):
            assert f.evaluate(bfe(int(domain[i]))) == bfe(int(values[i]))


def test_regression_xgcd_self_and_zero():
    """xgcd degenerate pairs (x, x) and (f, 0) — gcd normalization edge."""
    f = poly([2, 0, 1])
    g, u, v = f.xgcd(f)
    assert u * f + v * f == g
    assert g.leading_coefficient() == bfe(1)
    g0, u0, v0 = f.xgcd(poly([]))
    assert u0 * f + v0 * poly([]) == g0


def test_regression_formal_power_series_inverse_unit_constant():
    """fps inverse where the constant term is p-1 (self-inverse unit)."""
    f = poly([P - 1, 3, 5])
    inv = f.formal_power_series_inverse_newton(8)
    prod = (f * inv).coefficients[:8]
    assert prod[0] == bfe(1)
    assert all(c == bfe(0) for c in prod[1:8])


def test_regression_reduce_by_higher_degree_modulus():
    f = poly([1, 2])
    m = poly([0, 0, 0, 1])
    assert f.reduce(m) == f


def test_regression_zerofier_with_repeated_roots():
    roots = [bfe(9), bfe(9), bfe(9)]
    z = Polynomial.zerofier(roots)
    assert z.degree() == 3
    assert z.evaluate(bfe(9)) == bfe(0)


def test_regression_modular_interpolate_minus_two_inverse_case():
    """fast_modular_coset_interpolate's (-2)^{-1} branch (polynomial.py
    cites polynomial.rs:1751-1758) on the smallest domain that takes it."""
    from twenty_first_tpu.math import ntt as ntt_mod

    n = 1 << 5
    rng = np.random.default_rng(5)
    cw = rng.integers(0, P, size=n, dtype=np.uint64)
    f = Polynomial.fast_coset_interpolate(bfe(7), cw)
    # round-trip through evaluation on the same coset
    back = f.fast_coset_evaluate(bfe(7), n)
    assert np.array_equal(np.asarray(back, dtype=np.uint64), cw)
