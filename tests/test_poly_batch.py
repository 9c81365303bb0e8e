"""Batch-first device polynomial API vs the scalar engine."""

import numpy as np

from twenty_first_tpu.math import poly_batch
from twenty_first_tpu.math.b_field_element import BFieldElement, bfe, P
from twenty_first_tpu.math.polynomial import Polynomial, barycentric_evaluate

RNG = np.random.default_rng(55)


def test_batch_coset_evaluate_interpolate_roundtrip():
    rows, k, order = 5, 20, 64
    coeffs = RNG.integers(0, P, size=(rows, k), dtype=np.uint64)
    evals = poly_batch.batch_coset_evaluate(coeffs, order)
    # cross-check one row against the scalar engine
    p0 = Polynomial([bfe(int(v)) for v in coeffs[0]])
    want = p0.fast_coset_evaluate(BFieldElement.generator(), order)
    assert [int(v) for v in evals[0]] == [w.value() for w in want]
    back = poly_batch.batch_coset_interpolate(evals)
    np.testing.assert_array_equal(back[:, :k], coeffs)
    assert not back[:, k:].any()


def test_batch_multiply():
    rows = 4
    a = RNG.integers(0, P, size=(rows, 9), dtype=np.uint64)
    b = RNG.integers(0, P, size=(rows, 13), dtype=np.uint64)
    got = poly_batch.batch_multiply(a, b)
    for r in range(rows):
        pa = Polynomial([bfe(int(v)) for v in a[r]])
        pb = Polynomial([bfe(int(v)) for v in b[r]])
        want = pa * pb
        got_poly = Polynomial([bfe(int(v)) for v in got[r]])
        assert got_poly == want


def test_batch_barycentric():
    rows, n = 3, 32
    codewords = RNG.integers(0, P, size=(rows, n), dtype=np.uint64)
    z = 987654321
    got = poly_batch.batch_evaluate_barycentric(codewords, z)
    for r in range(rows):
        want = barycentric_evaluate([bfe(int(v)) for v in codewords[r]],
                                    bfe(z))
        assert int(got[r]) == want.value()


def test_batch_coset_extrapolate_matches_object_api():
    """Device barycentric coset extrapolation == interpolate-then-evaluate
    for out-of-domain points, across codeword rows."""
    from twenty_first_tpu.math import poly_batch
    from twenty_first_tpu.math.polynomial import Polynomial
    from twenty_first_tpu.math.b_field_element import bfe

    rng = np.random.default_rng(17)
    n, rows = 64, 3
    cws = rng.integers(0, P, size=(rows, n), dtype=np.uint64)
    offset = 7
    # random points are outside the 64-element coset with overwhelming
    # probability (64/p)
    pts = rng.integers(1, P, size=9, dtype=np.uint64)
    # eager on the CPU backend: XLA:CPU's LLVM pass takes minutes on the
    # unrolled inversion-chain graph
    got = poly_batch.batch_coset_extrapolate(cws, offset, pts,
                                             point_chunk=4, use_jit=False)
    for r in range(rows):
        want = Polynomial.coset_extrapolate(
            bfe(offset), cws[r], [bfe(int(z)) for z in pts])
        assert [int(v) for v in got[r]] == [w.value() for w in want]


def test_batch_coset_extrapolate_xfe_points():
    """Device extrapolation at EXTENSION-FIELD points (the STARK
    out-of-domain-sample shape) == host interpolate-then-evaluate, for
    both base-field and extension-field codeword rows."""
    from twenty_first_tpu.math import poly_batch
    from twenty_first_tpu.math.polynomial import Polynomial
    from twenty_first_tpu.math.b_field_element import bfe
    from twenty_first_tpu.math.x_field_element import XFieldElement

    rng = np.random.default_rng(29)
    n, rows = 32, 2
    pts = rng.integers(0, P, size=(5, 3), dtype=np.uint64)
    pt_objs = [XFieldElement((int(a), int(b), int(c))) for a, b, c in pts]

    cws = rng.integers(0, P, size=(rows, n), dtype=np.uint64)
    got = poly_batch.batch_coset_extrapolate_xfe(
        cws, 7, pts, point_chunk=4, use_jit=False)
    for r in range(rows):
        poly = Polynomial.fast_coset_interpolate(bfe(7), cws[r])
        want = [poly.evaluate(z) for z in pt_objs]
        have = [XFieldElement((int(a), int(b), int(c)))
                for a, b, c in got[r]]
        assert have == want

    cwx = rng.integers(0, P, size=(rows, n, 3), dtype=np.uint64)
    gotx = poly_batch.batch_coset_extrapolate_xfe(
        cwx, 7, pts, point_chunk=4, use_jit=False)
    for r in range(rows):
        poly = Polynomial.fast_coset_interpolate(bfe(7), cwx[r])
        want = [poly.evaluate(z) for z in pt_objs]
        have = [XFieldElement((int(a), int(b), int(c)))
                for a, b, c in gotx[r]]
        assert have == want


def test_object_api_device_extrapolate_dispatch(monkeypatch):
    """Object coset_extrapolate / batch_coset_extrapolate dispatch to the
    device coefficient-route kernel (forced on CPU) and stay bit-exact
    with the host modular-interpolation path — including at in-domain
    points, where the kernel reproduces the codeword entry exactly."""
    import numpy as np

    from twenty_first_tpu.math.b_field_element import P, bfe
    from twenty_first_tpu.math.ntt import PRIMITIVE_ROOTS
    from twenty_first_tpu.math.polynomial import Polynomial

    rng = np.random.default_rng(7)
    n = 1 << 7
    cw = [int(v) for v in rng.integers(0, P, n, dtype=np.uint64)]
    pts = [int(v) for v in rng.integers(0, P, 11, dtype=np.uint64)]
    monkeypatch.setenv("TWENTY_FIRST_TPU_EXTRAPOLATE_DEVICE", "0")
    want = Polynomial.coset_extrapolate(3, cw, pts)
    want_b = Polynomial.batch_coset_extrapolate(3, n, cw + cw, pts)
    monkeypatch.setenv("TWENTY_FIRST_TPU_EXTRAPOLATE_DEVICE", "1")
    got = Polynomial.coset_extrapolate(3, cw, pts)
    got_b = Polynomial.batch_coset_extrapolate(3, n, cw + cw, pts)
    assert got == want
    assert got_b == want_b
    # in-domain point: the device kernel reproduces the codeword entry
    omega = int(PRIMITIVE_ROOTS[n])
    dom_pt = 3 * pow(omega, 5, P) % P
    vals = Polynomial.coset_extrapolate(3, cw, [dom_pt])
    assert vals[0] == bfe(cw[5])
