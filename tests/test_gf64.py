"""Tests for the native-u64 (packed) field ops and the w64 NTT experiment.

These paths are opt-in (not yet measured against the u32 limb core on the
H100, ROADMAP S2) and stay CI-covered so the experiment remains runnable.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from twenty_first_tpu.math import gf, gf64, ntt
from twenty_first_tpu.math import gf_numpy as gfn
from twenty_first_tpu.math.b_field_element import P

rng = np.random.default_rng(7)


def _rand_u64(n, full=False):
    """Random canonical residues, or arbitrary u64 (non-canonical) values."""
    hi = (1 << 64) if full else P
    return rng.integers(0, hi, size=n, dtype=np.uint64)


def test_pack_unpack_roundtrip():
    v = _rand_u64(256, full=True)
    planes = gf.to_limbs(v)
    packed = gf64.pack((jnp.asarray(planes[0]), jnp.asarray(planes[1])))
    assert np.array_equal(np.asarray(packed), v)
    lo, hi = gf64.unpack(packed)
    assert np.array_equal(np.asarray(lo), planes[0])
    assert np.array_equal(np.asarray(hi), planes[1])


@pytest.mark.parametrize("lazy_inputs", [False, True])
def test_gf64_mul_add_sub_vs_oracle(lazy_inputs):
    a = _rand_u64(512, full=lazy_inputs)
    b = _rand_u64(512, full=lazy_inputs)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ca = (a.astype(object) % P).astype(np.uint64)  # canonical residues
    cb = (b.astype(object) % P).astype(np.uint64)
    got_mul = np.asarray(gf64.canon(gf64.mul_lazy(ja, jb)))
    assert np.array_equal(got_mul, gfn.mul(ca, cb))
    got_add = np.asarray(gf64.canon(gf64.add_lazy(ja, jb)))
    assert np.array_equal(got_add, gfn.add(ca, cb))
    got_sub = np.asarray(gf64.canon(gf64.sub_lazy(ja, jb)))
    assert np.array_equal(got_sub, gfn.sub(ca, cb))


@pytest.mark.parametrize("e", [1, 24, 31, 32, 48, 63, 64, 65, 72, 95])
@pytest.mark.parametrize("negate", [False, True])
def test_gf64_mul_by_pow2(e, negate):
    a = _rand_u64(128, full=True)
    want = np.array(
        [((-1 if negate else 1) * int(v) * pow(2, e, P)) % P for v in a],
        dtype=np.uint64)
    got = np.asarray(gf64.canon(gf64.mul_by_pow2_lazy(jnp.asarray(a), e,
                                                      negate=negate)))
    assert np.array_equal(got, want)


def test_hybrid_mul_dispatch_matches_u32():
    a = _rand_u64(256, full=True)
    b = _rand_u64(256, full=True)
    pa = tuple(jnp.asarray(v) for v in gf.to_limbs(a))
    pb = tuple(jnp.asarray(v) for v in gf.to_limbs(b))
    want = np.asarray(gf.from_limbs(gf.mul_u32(pa, pb)))
    prev = gf._MUL_W64
    gf._MUL_W64 = True
    try:
        got = np.asarray(gf.from_limbs(gf.mul(pa, pb)))
        got_lazy = np.asarray(gf.from_limbs(gf.canon(gf.mul_lazy(pa, pb))))
    finally:
        gf._MUL_W64 = prev
    assert np.array_equal(got, want)
    assert np.array_equal(got_lazy, want)


def test_u32_ops_context_forces_limb_path():
    prev = gf._MUL_W64
    gf._MUL_W64 = True
    try:
        with gf.u32_ops():
            assert gf._MUL_W64 is False
        assert gf._MUL_W64 is True
    finally:
        gf._MUL_W64 = prev


def test_w64_four_step_matches_host_oracle():
    log_n = 17  # smallest four-step size
    x = _rand_u64(1 << log_n)
    want = ntt.ntt_host(x)
    diag = ntt._four_step_diag_device_w64(log_n, False)
    got = np.asarray(
        ntt.four_step_ntt_w64(jnp.asarray(x), log_n, False, diag))
    assert np.array_equal(got, want)
    want_i = ntt.ntt_host(x, inverse=True)
    diag_i = ntt._four_step_diag_device_w64(log_n, True)
    got_i = np.asarray(
        ntt.four_step_ntt_w64(jnp.asarray(x), log_n, True, diag_i))
    assert np.array_equal(got_i, want_i)
