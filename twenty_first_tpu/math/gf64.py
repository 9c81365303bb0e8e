"""Goldilocks field arithmetic on native-u64 planes.

The limb-plane module (`gf.py`) holds elements as 2xuint32 planes and
decomposes every 64-bit operation by hand (16-bit digit products, explicit
carry captures). This module mirrors gf.py's *lazy* op set on single uint64
arrays, whose multiplies split into four 32x32->64 partial products — the
GPU's widening multiply. It backs the Tip5 GPU kernel (tip5/kernel.py) and
the opt-in u64 NTT and multiply routes; the package enables
`jax_enable_x64` at import. Semantics are identical to the
gf.py ops:

  * "lazy" values are arbitrary u64 residues (any x < 2^64 with
    x = value mod p); `canon` restores canonical form with one conditional
    subtract (valid for all u64 because 2^64 < 2p).
  * all functions are pure, shape-polymorphic elementwise jnp ops.

Reference semantics: twenty-first/src/math/b_field_element.rs:234-370 (the
values, not the Montgomery representation — see gf.py's module docstring).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .b_field_element import P

_M32 = np.uint64(0xFFFF_FFFF)
_EPS = np.uint64(0xFFFF_FFFF)  # 2^32 - 1 == 2^64 mod p
_P64 = np.uint64(P)
_U64 = jnp.uint64


# ---------------------------------------------------------------------------
# Packing between the 2xu32 limb-plane format and u64 planes
# ---------------------------------------------------------------------------


def pack(x):
    """(lo, hi) uint32 limb planes -> one uint64 plane."""
    lo, hi = x
    return lo.astype(_U64) | (hi.astype(_U64) << 32)


def unpack(v):
    """uint64 plane -> (lo, hi) uint32 limb planes."""
    return (v & _M32).astype(jnp.uint32), (v >> 32).astype(jnp.uint32)


# ---------------------------------------------------------------------------
# Lazy ops (arbitrary u64 residues in / out)
# ---------------------------------------------------------------------------


def add_lazy(a, b):
    """Modular add on arbitrary u64 residues.

    On 64-bit wrap the sum gains 2^64 = EPS (mod p); the EPS fix wraps a
    second time exactly when the wrapped sum >= p (note 2^64 - EPS == p),
    never a third. k in {0, 1, 2}; s + k*EPS == s + (k << 32) - k.
    """
    s = a + b
    c = (s < a).astype(_U64)
    k = c + (c & (s >= _P64).astype(_U64))
    return s + (k << 32) - k


def sub_lazy(a, b):
    """Modular subtract on arbitrary u64 residues (borrow costs -EPS; the
    -EPS fix borrows again exactly when the wrapped difference < EPS)."""
    d = a - b
    br = (a < b).astype(_U64)
    k = br + (br & (d < _EPS).astype(_U64))
    return d - (k << 32) + k


def reduce128_lazy(lo, hi):
    """Reduce a 128-bit value (two u64 words) to a u64 residue.

    n = lo + 2^64*(x2 + 2^32*x3)  ==  lo - x3 + x2*(2^32 - 1)   (mod p).
    """
    x2 = hi & _M32
    x3 = hi >> 32
    t = lo - x3
    t = jnp.where(lo < x3, t - _EPS, t)  # borrow: -2^64 == -EPS (mod p)
    m = (x2 << 32) - x2
    t2 = t + m
    # wrap: +2^64 == +EPS; t2' = t + m - 2^64 <= 2^64 - 2^33 < p, so the
    # fix never wraps again.
    return jnp.where(t2 < t, t2 + _EPS, t2)


def mul_lazy(a, b):
    """Modular multiply: arbitrary u64 residues in, u64 residue out.

    Full 128-bit product from four 32x32 partials held in u64 registers —
    XLA lowers each u64 multiply of 32-bit-ranged operands onto the native
    multiply path.
    """
    alo = a & _M32
    ahi = a >> 32
    blo = b & _M32
    bhi = b >> 32
    ll = alo * blo
    lh = alo * bhi
    hl = ahi * blo
    hh = ahi * bhi
    mid = lh + hl
    midc = (mid < lh).astype(_U64)  # carry worth 2^64 at the 2^32 position
    lo = ll + (mid << 32)
    c = (lo < ll).astype(_U64)
    hi = hh + (mid >> 32) + (midc << 32) + c
    return reduce128_lazy(lo, hi)


def mul_by_pow2_lazy(a, e: int, negate: bool = False):
    """Multiply a u64 residue by +-2^e for 0 < e < 96 (lazy residue out).

    Pure shifts + one 128-bit fold; used for the shift-class butterfly
    twiddles omega_4 = 2^48, omega_8 = -2^24, omega_8^3 = -2^72.
    """
    assert 0 < e < 96
    if e < 64:
        out = reduce128_lazy(a << e, a >> (64 - e))
    else:
        w = e - 64
        x_lo = (a << w) if w else a          # (v * 2^w) mod 2^64
        y = (a >> (64 - w)) if w else jnp.zeros_like(a)  # < 2^32
        # v*2^e = 2^64*x_lo + 2^128*y;  2^128 == -2^32 (mod p)
        out = sub_lazy(reduce128_lazy(jnp.zeros_like(a), x_lo), y << 32)
    if negate:
        out = sub_lazy(jnp.zeros_like(a), out)
    return out


def mul_by_i_lazy(a, inverse: bool = False):
    """Multiply by i = omega_4 = 2^48; inverse direction i^-1 = -2^48."""
    return mul_by_pow2_lazy(a, 48, negate=inverse)


def mul_const_lazy(a, k: int):
    """Multiply by a compile-time python-int constant (lazy residue out)."""
    return mul_lazy(a, jnp.full_like(a, np.uint64(k % P)))


def canon(a):
    """Canonicalize an arbitrary u64 residue (valid for all u64: 2^64 < 2p)."""
    return jnp.where(a >= _P64, a - _P64, a)


def mul(a, b):
    """Canonical-output multiply."""
    return canon(mul_lazy(a, b))


def add(a, b):
    return canon(add_lazy(a, b))


def sub(a, b):
    return canon(sub_lazy(a, b))
