"""Device extension-field arithmetic on limb planes, component axis -2.

The device layout for extension-field data is ``(..., 3, n)`` limb-plane
pairs: the 3 coefficient planes of F_p[x]/(x^3 - x + 1) ride as a small
batch axis while ``n`` stays the minor (lane) dimension, so every op is a
full-width vector op and the base-field NTT (math/ntt.py) transforms
extension data unchanged (twiddles are base-field scalars, the reference's
`MulAssign<BFieldElement>` bound, x_field_element.rs:600-612).

Product/inverse mirror the reference's Shah-polynomial reduction and
adjugate inverse (x_field_element.rs:512-535, :370-399), expressed on
(lo, hi) uint32 limb pairs from math/gf.py. All functions are pure and
jit/vmap/shard_map-safe.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from . import gf

P = gf.P


def _comp(x, i):
    lo, hi = x
    return lo[..., i, :], hi[..., i, :]


def _stack3(a, b, c):
    return (
        jnp.stack([a[0], b[0], c[0]], axis=-2),
        jnp.stack([a[1], b[1], c[1]], axis=-2),
    )


def to_limbs(values) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Host (..., 3) uint64 xfe array -> device (..., 3, n)-style limb pair.

    The trailing component axis moves to -2 and the leading axis becomes the
    minor axis: input (n, 3) -> output planes of shape (3, n)."""
    arr = np.asarray(values, dtype=np.uint64)
    arr = np.moveaxis(arr, -1, -2) if arr.ndim >= 2 else arr
    lo = (arr & np.uint64(0xFFFF_FFFF)).astype(np.uint32)
    hi = (arr >> np.uint64(32)).astype(np.uint32)
    return jnp.asarray(lo), jnp.asarray(hi)


def from_limbs(x) -> np.ndarray:
    """Device (..., 3, n) limb pair -> host (..., n, 3) uint64."""
    lo, hi = x
    lo = np.asarray(lo, dtype=np.uint64)
    hi = np.asarray(hi, dtype=np.uint64)
    out = lo | (hi << np.uint64(32))
    return np.moveaxis(out, -2, -1)


def add(a, b):
    return gf.add(a, b)


def sub(a, b):
    return gf.sub(a, b)


def neg(a):
    return gf.neg(a)


def mul(a, b):
    """Extension product of (..., 3, n) limb pairs (broadcastable)."""
    s0, s1, s2 = _comp(a, 0), _comp(a, 1), _comp(a, 2)
    o0, o1, o2 = _comp(b, 0), _comp(b, 1), _comp(b, 2)
    r0 = gf.sub(gf.mul(s0, o0), gf.add(gf.mul(s2, o1), gf.mul(s1, o2)))
    r1 = gf.add(gf.mul(s1, o0), gf.mul(s0, o1))
    r1 = gf.add(r1, gf.mul(s2, o1))
    r1 = gf.add(r1, gf.mul(gf.sub(s1, s2), o2))
    r2 = gf.add(gf.mul(s2, o0), gf.mul(s1, o1))
    r2 = gf.add(r2, gf.mul(gf.add(s0, s2), o2))
    return _stack3(r0, r1, r2)


def mul_base(a, b):
    """(..., 3, n) xfe limbs times (..., n) base-field limbs."""
    blo, bhi = b
    return gf.mul(a, (blo[..., None, :], bhi[..., None, :]))


def lift(b):
    """(..., n) base limb pair -> (..., 3, n) xfe limb pair."""
    lo, hi = b
    z = jnp.zeros_like(lo)
    return (
        jnp.stack([lo, z, z], axis=-2),
        jnp.stack([hi, jnp.zeros_like(hi), jnp.zeros_like(hi)], axis=-2),
    )


def _inverse_parts(a):
    c0, c1, c2 = _comp(a, 0), _comp(a, 1), _comp(a, 2)
    ca = gf.add(c0, c2)
    b_m_a = gf.sub(c1, c2)
    m00 = gf.sub(gf.mul(ca, ca), gf.mul(c1, b_m_a))
    m01 = gf.sub(gf.mul(c1, ca), gf.mul(c2, b_m_a))
    m02 = gf.sub(gf.mul(c1, c1), gf.mul(c2, ca))
    det = gf.sub(gf.add(gf.mul(c0, m00), gf.mul(c2, m01)), gf.mul(c1, m02))
    return m00, gf.neg(m01), m02, det


def inverse_or_zero(a):
    """Elementwise inverse of (..., 3, n) xfe limbs; 0 -> 0."""
    i0, i1, i2, det = _inverse_parts(a)
    det_inv = gf.inverse_or_zero(det)
    return _stack3(gf.mul(i0, det_inv), gf.mul(i1, det_inv),
                   gf.mul(i2, det_inv))


def batch_inversion(a, axis: int = -1):
    """Batch inversion along the lane axis: reduce to ONE base-field batch
    inversion of the determinants (3n muls + adjugates), instead of the
    reference's generic Montgomery trick over extension muls
    (traits.rs:93-121) — fewer extension products, same values."""
    i0, i1, i2, det = _inverse_parts(a)
    det_inv = gf.batch_inversion(det, axis=axis)
    return _stack3(gf.mul(i0, det_inv), gf.mul(i1, det_inv),
                   gf.mul(i2, det_inv))
