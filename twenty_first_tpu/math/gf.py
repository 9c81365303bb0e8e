"""Goldilocks field (p = 2^64 - 2^32 + 1) arithmetic on 32-bit limb planes.

This is the foundation of the library: every field element is a *canonical*
residue in [0, p), held as two ``uint32`` limb planes ``(lo, hi)``, so that
every op is a 32-bit vector op. Unlike the reference implementation, which
uses Montgomery form because x86 has a 64x64->128 multiplier (reference:
twenty-first/src/math/b_field_element.rs:84-86, :356-370), we use the direct
Goldilocks reduction identity

    x2 * 2^64 + x1 * 2^32 + x0  ==  (x1 + x2) * 2^32 + x0 - x2   (mod p)

which the reference's own AVX-512 backend also relies on
(tip5/avx512.rs:224-262).  Bit-exactness with the reference is defined on
canonical values, so all golden test vectors port unchanged.

All functions are pure, shape-polymorphic, and jit/vmap/shard_map-safe; they
work on any equal-shaped pair of uint32 arrays (they only use elementwise
jnp ops).
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Constants
# ---------------------------------------------------------------------------

P = 0xFFFF_FFFF_0000_0001  # 2^64 - 2^32 + 1
P_LO = np.uint32(P & 0xFFFF_FFFF)  # 0x0000_0001
P_HI = np.uint32(P >> 32)  # 0xFFFF_FFFF
EPSILON = np.uint32(0xFFFF_FFFF)  # 2^32 - 1 == 2^64 mod p
MAX = P - 1

# Montgomery radix helpers — only needed to reproduce Tip5's S-box, which is
# *specified* on the byte decomposition of the Montgomery representative
# (reference: tip5/mod.rs:197-207).
R = (1 << 64) % P  # == 2^32 - 1
R_INV = pow(1 << 64, -1, P)  # 2^-64 mod p

# Multiplicative generator of the field (b_field_element.rs:311-314).
GENERATOR = 7

_U32 = jnp.uint32


def _c(x: int):
    """A uint32 scalar constant."""
    return np.uint32(x & 0xFFFF_FFFF)


# ---------------------------------------------------------------------------
# Host-side conversions
# ---------------------------------------------------------------------------


def to_limbs(values) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Convert host integers (array-like of python ints / np.uint64) to limb planes."""
    arr = np.asarray(values, dtype=np.uint64)
    lo = (arr & np.uint64(0xFFFF_FFFF)).astype(np.uint32)
    hi = (arr >> np.uint64(32)).astype(np.uint32)
    return jnp.asarray(lo), jnp.asarray(hi)


def from_limbs(x) -> np.ndarray:
    """Convert limb planes back to a host np.uint64 array."""
    lo, hi = x
    lo = np.asarray(lo, dtype=np.uint64)
    hi = np.asarray(hi, dtype=np.uint64)
    return lo | (hi << np.uint64(32))


def const_limbs(value: int):
    """Split a python-int constant into uint32 scalar limbs (lo, hi)."""
    return _c(value), _c(value >> 32)


# ---------------------------------------------------------------------------
# 64-bit primitive ops on (lo, hi) uint32 pairs
# ---------------------------------------------------------------------------


def add64(a, b):
    """(a + b) mod 2^64 with carry-out bit. a, b: (lo, hi) pairs."""
    alo, ahi = a
    blo, bhi = b
    lo = alo + blo
    cl = (lo < alo).astype(_U32)
    hi0 = ahi + bhi
    c0 = (hi0 < ahi).astype(_U32)
    hi = hi0 + cl
    c1 = (hi < hi0).astype(_U32)
    return (lo, hi), c0 | c1


def sub64(a, b):
    """(a - b) mod 2^64 with borrow-out bit."""
    alo, ahi = a
    blo, bhi = b
    lo = alo - blo
    bl = (alo < blo).astype(_U32)
    hi0 = ahi - bhi
    b0 = (ahi < bhi).astype(_U32)
    hi = hi0 - bl
    b1 = (hi0 < bl).astype(_U32)
    return (lo, hi), b0 | b1


def mul32(a, b):
    """Full 32x32 -> 64-bit product as a (lo, hi) uint32 pair.

    Uses 16-bit digit products, all exact in uint32.
    """
    a0 = a & _c(0xFFFF)
    a1 = a >> 16
    b0 = b & _c(0xFFFF)
    b1 = b >> 16
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = p01 + p10  # < 2^33, may wrap
    midc = (mid < p01).astype(_U32)  # carry worth 2^32 at digit-16 position
    lo = p00 + (mid << 16)
    c = (lo < p00).astype(_U32)
    hi = p11 + (mid >> 16) + (midc << 16) + c
    return lo, hi


def mul64_wide(a, b):
    """Full 64x64 -> 128-bit product as four uint32 words (x0, x1, x2, x3)."""
    alo, ahi = a
    blo, bhi = b
    ll_lo, ll_hi = mul32(alo, blo)
    lh_lo, lh_hi = mul32(alo, bhi)
    hl_lo, hl_hi = mul32(ahi, blo)
    hh_lo, hh_hi = mul32(ahi, bhi)

    x0 = ll_lo
    t = ll_hi + lh_lo
    c1 = (t < ll_hi).astype(_U32)
    x1 = t + hl_lo
    c2 = (x1 < t).astype(_U32)
    # x2 accumulates: lh_hi + hl_hi + hh_lo + carries (c1 + c2)
    u = lh_hi + hl_hi
    d1 = (u < lh_hi).astype(_U32)
    v = u + hh_lo
    d2 = (v < u).astype(_U32)
    x2 = v + (c1 + c2)
    d3 = (x2 < v).astype(_U32)
    x3 = hh_hi + (d1 + d2 + d3)
    return x0, x1, x2, x3


# ---------------------------------------------------------------------------
# Goldilocks modular ops (canonical in -> canonical out)
# ---------------------------------------------------------------------------


def _ge_p(x):
    """x >= p for a (lo, hi) pair holding a value < 2^64."""
    lo, hi = x
    return (hi == P_HI) & (lo >= P_LO)


def _canon(x):
    """Subtract p once if x >= p. Valid for x < 2p (in particular any x < 2^64)."""
    sub, _ = sub64(x, (P_LO, P_HI))
    ge = _ge_p(x)
    return (jnp.where(ge, sub[0], x[0]), jnp.where(ge, sub[1], x[1]))


def add(a, b):
    """Modular addition; canonical inputs, canonical output."""
    s, c = add64(a, b)
    # If the 64-bit sum wrapped, the true sum is s + 2^64 ≡ s + EPSILON (mod p),
    # and s + EPSILON cannot wrap again (sum < 2p => wrapped s < 2^64 - 2^33 + 2).
    fix = _add_eps(s)
    lo = jnp.where(c.astype(bool), fix[0], s[0])
    hi = jnp.where(c.astype(bool), fix[1], s[1])
    return _canon((lo, hi))


def sub(a, b):
    """Modular subtraction; canonical inputs, canonical output."""
    d, br = sub64(a, b)
    # On borrow the true value is d - 2^64 + p = d - EPSILON; cannot borrow again.
    fix = _sub_eps(d)
    lo = jnp.where(br.astype(bool), fix[0], d[0])
    hi = jnp.where(br.astype(bool), fix[1], d[1])
    return lo, hi


def neg(a):
    """Modular negation; canonical input, canonical output."""
    z = jnp.zeros_like(a[0])
    return sub((z, z), a)


def reduce128(x0, x1, x2, x3):
    """Reduce a 128-bit value (four uint32 words, little-endian) mod p.

    Identity: with n = lo64 + 2^64*(x2 + 2^32*x3),
    2^64 ≡ 2^32 - 1 and 2^96 ≡ -1 (mod p), hence
    n ≡ lo64 + x2*(2^32-1) - x3 (mod p).
    Output is canonical.
    """
    # t = lo64 - x3 (wrap-corrected by -EPSILON on borrow)
    t, br = sub64((x0, x1), (x3, jnp.zeros_like(x3)))
    fix, _ = sub64(t, (EPSILON, _c(0)))
    t = (
        jnp.where(br.astype(bool), fix[0], t[0]),
        jnp.where(br.astype(bool), fix[1], t[1]),
    )
    # t += x2 * (2^32 - 1) == (x2 << 32) - x2
    m_lo = jnp.zeros_like(x2) - x2
    m_hi = x2 - (x2 != 0).astype(_U32)
    t2, c = add64(t, (m_lo, m_hi))
    fix, _ = add64(t2, (EPSILON, _c(0)))
    t2 = (
        jnp.where(c.astype(bool), fix[0], t2[0]),
        jnp.where(c.astype(bool), fix[1], t2[1]),
    )
    return _canon(t2)


def mul_u32(a, b):
    """Pure 2xu32 modular multiply (any u64 residues in, canonical out).

    The default `mul` dispatches here unless TWENTY_FIRST_TPU_W64_MUL=1."""
    return reduce128(*mul64_wide(a, b))


# ---------------------------------------------------------------------------
# Multiply backend dispatch: packed-u64 vs pure-u32 limbs
#
# The default multiply builds 64x64 products from 16-bit digit products in
# u32. TWENTY_FIRST_TPU_W64_MUL=1 routes multiplies through packed u64
# planes (math/gf64.py) instead, whose 32x32->64 partial products are the
# hardware's widening multiply on the GPU. Which is faster on the H100 is
# not measured yet (ROADMAP S2); `with gf.u32_ops():` forces the u32 path
# inside one trace.
# ---------------------------------------------------------------------------

_MUL_W64 = os.environ.get("TWENTY_FIRST_TPU_W64_MUL", "0") == "1"


@contextlib.contextmanager
def u32_ops():
    """Force pure-u32 limb implementations within this trace context."""
    global _MUL_W64
    prev = _MUL_W64
    _MUL_W64 = False
    try:
        yield
    finally:
        _MUL_W64 = prev


def mul(a, b):
    """Modular multiplication. Inputs may be any u64 residues; output canonical."""
    if _MUL_W64:
        from . import gf64
        return gf64.unpack(gf64.mul(gf64.pack(a), gf64.pack(b)))
    return mul_u32(a, b)


# ---------------------------------------------------------------------------
# Lazy (non-canonical) ops: values are arbitrary u64 residues (any x < 2^64
# with x ≡ value mod p). Used inside the NTT butterfly stages, where keeping
# every intermediate canonical costs an extra compare+select pass per op;
# one final `_canon` (valid for ALL u64, since 2^64 < 2p) restores canonical
# form at the end of the transform.
# ---------------------------------------------------------------------------


def _add_eps(x):
    """x + EPSILON mod 2^64 for a (lo, hi) pair.

    EPSILON = 2^32 - 1, so x + EPSILON == (lo - 1, hi + carry) with a carry
    into hi unless lo == 0 — 3 ops instead of a generic add64."""
    lo, hi = x
    return lo - _c(1), hi + (lo != 0).astype(_U32)


def _sub_eps(x):
    """x - EPSILON mod 2^64: (lo + 1, hi - borrow), borrow unless lo wraps."""
    lo, hi = x
    return lo + _c(1), hi - (lo != EPSILON).astype(_U32)


def reduce128_lazy(x0, x1, x2, x3):
    """Like reduce128 but returns a (possibly non-canonical) u64 residue."""
    # t = lo64 - x3 (specialized sub64: high word of subtrahend is 0)
    t_lo = x0 - x3
    bl = (x0 < x3).astype(_U32)
    t_hi = x1 - bl
    br = (x1 < bl)
    fix = _sub_eps((t_lo, t_hi))
    t = (jnp.where(br, fix[0], t_lo), jnp.where(br, fix[1], t_hi))
    # t += x2 * (2^32 - 1) == (x2 << 32) - x2
    m_lo = jnp.zeros_like(x2) - x2
    m_hi = x2 - (x2 != 0).astype(_U32)
    t2, c = add64(t, (m_lo, m_hi))
    fix = _add_eps(t2)
    return (
        jnp.where(c.astype(bool), fix[0], t2[0]),
        jnp.where(c.astype(bool), fix[1], t2[1]),
    )


def mul_lazy_u32(a, b):
    """Pure 2xu32 lazy multiply (see mul_u32)."""
    return reduce128_lazy(*mul64_wide(a, b))


def mul_lazy(a, b):
    """Modular multiply: arbitrary u64 residues in, u64 residue out."""
    if _MUL_W64:
        from . import gf64
        return gf64.unpack(gf64.mul_lazy(gf64.pack(a), gf64.pack(b)))
    return mul_lazy_u32(a, b)


def add_lazy(a, b):
    """Modular add on arbitrary u64 residues (u64 residue out).

    On 64-bit wrap the sum gains 2^64 ≡ EPSILON; with non-canonical inputs
    the EPSILON fix can wrap once more (exactly when s >= p), never a third
    time. Both fixes are applied in ONE pass: with wrap count k ∈ {0, 1, 2},
    s + k*EPSILON == (lo - k, hi + k - borrow) — 5 ops instead of two
    chained conditional add64 fixes.
    """
    s, c = add64(a, b)
    k = c + (c & _ge_p(s).astype(_U32))
    lo, hi = s
    nlo = lo - k
    nhi = hi + k - (lo < k).astype(_U32)
    return nlo, nhi


def sub_lazy(a, b):
    """Modular subtract on arbitrary u64 residues (u64 residue out).

    A 64-bit borrow costs -EPSILON; the -EPSILON fix borrows once more
    exactly when d < EPSILON (then only possible for b - a > p). With
    borrow count k ∈ {0, 1, 2}: d - k*EPSILON == (lo + k, hi - k + carry).
    """
    d, br = sub64(a, b)
    lo, hi = d
    lt_eps = ((hi == 0) & (lo != EPSILON)).astype(_U32)
    k = br + (br & lt_eps)
    nlo = lo + k
    nhi = hi - k + (nlo < k).astype(_U32)
    return nlo, nhi


def mul_by_pow2_lazy(a, e: int, negate: bool = False):
    """Multiply a u64 residue by ±2^e for 0 < e < 96 (lazy residue out).

    v * 2^e is at most a 160-bit value whose u32 words are pure shifts of
    the limbs; the 2^128 word folds via 2^128 ≡ -2^32 (mod p). This costs a
    handful of shifts + the 128-bit fold instead of a full 64x64 multiply —
    the power-of-two roots ω₄ = 2^48, ω₈ = -2^24, ω₈³ = -2^72 (inverses
    2^72 / 2^24) make the radix-4/8 internal butterfly factors cheap.
    """
    assert 0 < e < 96
    lo, hi = a
    z = jnp.zeros_like(lo)
    q, r = divmod(e, 32)
    if r == 0:
        w0, w1, w2 = lo, hi, None
    else:
        w0 = lo << r
        w1 = (hi << r) | (lo >> (32 - r))
        w2 = hi >> (32 - r)
    words = [z] * q + [w0, w1] + ([w2] if w2 is not None else []) + [z] * 3
    out = reduce128_lazy(words[0], words[1], words[2], words[3])
    if q == 2 and w2 is not None:
        # the 2^128 word: x4 * 2^128 ≡ -x4 * 2^32
        out = sub_lazy(out, (z, w2))
    if negate:
        out = sub_lazy((z, z), out)
    return out


def mul_by_i_lazy(a, inverse: bool = False):
    """Multiply a u64 residue by i = omega_4 = 2^48 (PRIMITIVE_ROOTS chain).

    For inverse transforms i^-1 = 2^-48; since 2^96 ≡ -1 (mod p),
    i^-1 = -2^48: same shift, then negate.
    """
    return mul_by_pow2_lazy(a, 48, negate=inverse)


def canon(x):
    """Canonicalize an arbitrary u64 residue (one conditional subtract of p,
    valid for all x < 2^64 because 2^64 < 2p)."""
    return _canon(x)


def square(a):
    return mul(a, a)


def mul_const(a, k: int):
    """Multiply by a compile-time python-int constant (canonical output)."""
    return mul(a, _broadcast_const(k, a))


def _broadcast_const(k: int, like):
    lo, hi = const_limbs(k % P)
    return (jnp.full_like(like[0], lo), jnp.full_like(like[1], hi))


def pow_const(a, e: int):
    """a ** e for a non-negative compile-time integer exponent (square & multiply)."""
    if e == 0:
        one = _broadcast_const(1, a)
        return one
    result = None
    base = a
    while e:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = square(base)
    return result


def inverse_or_zero(a):
    """Multiplicative inverse via the fixed addition chain for x^(p-2).

    Maps 0 -> 0 (0^k == 0 propagates through the chain).
    Chain mirrors the reference's (b_field_element.rs:252-284) — it is the
    standard Goldilocks chain and representation-independent.

    On the CPU backend the ~82 unrolled multiplies form a single ~8k-op
    fusion whose LLVM compile time explodes (minutes even at width 16), so
    CPU traces use a
    fori_loop square-and-multiply over the fixed exponent bits instead:
    same values, shallow graph, ~2x the (irrelevant on CPU) runtime ops.
    """
    import jax

    if jax.default_backend() == "cpu":
        return _inverse_or_zero_loop(a)

    def nsquare(x, n):
        for _ in range(n):
            x = square(x)
        return x

    x = a
    bin2 = mul(square(x), x)  # x^(2^2 - 1)
    bin3 = mul(square(bin2), x)  # x^(2^3 - 1)
    bin6 = mul(nsquare(bin3, 3), bin3)
    bin12 = mul(nsquare(bin6, 6), bin6)
    bin24 = mul(nsquare(bin12, 12), bin12)
    bin30 = mul(nsquare(bin24, 6), bin6)
    bin31 = mul(square(bin30), x)
    bin31_z = square(bin31)
    bin32 = mul(square(bin31), x)
    return mul(nsquare(bin31_z, 32), bin32)


# exponent bits of p - 2, MSB first (the MSB is 1: loop starts at acc = x)
_P_MINUS_2_BITS = np.array(
    [(P - 2) >> (63 - i) & 1 for i in range(64)], dtype=np.uint32)


def _inverse_or_zero_loop(a):
    """x^(p-2) as a 63-step fori_loop (square; conditionally multiply)."""
    import jax
    import jax.numpy as jnp_

    bits = jnp_.asarray(_P_MINUS_2_BITS)
    xlo, xhi = a

    def body(i, acc):
        acc = square(acc)
        withx = mul(acc, (xlo, xhi))
        bit = bits[i]
        return (jnp_.where(bit == 1, withx[0], acc[0]),
                jnp_.where(bit == 1, withx[1], acc[1]))

    return jax.lax.fori_loop(1, 64, body, a)


def batch_inversion(x, axis: int = -1):
    """Montgomery batch inversion along an axis: one inverse + 3n muls.

    Mirrors traits.rs:93-121 but as a prefix-product formulation.
    All elements must be nonzero (zero inputs produce garbage, as in the
    reference, which asserts).
    """
    lo, hi = x
    lo = jnp.moveaxis(lo, axis, -1)
    hi = jnp.moveaxis(hi, axis, -1)
    n = lo.shape[-1]
    # Inclusive prefix products. Sequential scan over the axis; for the sizes
    # used in interpolation (<= a few thousand) an unrolled-by-log scan
    # (Hillis-Steele) keeps the graph shallow.
    plo, phi = _prefix_prod((lo, hi))
    total = (plo[..., -1], phi[..., -1])
    inv_total = inverse_or_zero(total)
    # suffix[i] = inverse of prefix[i] = inv_total * (prod of elements after i)
    # res[i] = prefix[i-1] * suffix_inv_from_right
    # Compute via reverse scan: r[i] = inv(prod_{j<=i} x_j) * prefix[i-1]
    # Standard trick: walk from the right accumulating acc = inv(prod up to i).
    # Vectorized equivalent: res[i] = prefix[i-1] * inv_total * suffix_prod(i+1..n)
    # where suffix_prod(i+1..n) = shifted reverse-prefix products.
    rlo = jnp.flip(lo, -1)
    rhi = jnp.flip(hi, -1)
    srlo, srhi = _prefix_prod((rlo, rhi))
    # suffix_excl[i] = product of x[i+1..n-1] = flip(exclusive reverse prefix)
    one_lo = jnp.ones_like(lo[..., :1])
    one_hi = jnp.zeros_like(hi[..., :1])
    suf_lo = jnp.flip(jnp.concatenate([one_lo, srlo[..., :-1]], -1), -1)
    suf_hi = jnp.flip(jnp.concatenate([one_hi, srhi[..., :-1]], -1), -1)
    pre_lo = jnp.concatenate([one_lo, plo[..., :-1]], -1)
    pre_hi = jnp.concatenate([one_hi, phi[..., :-1]], -1)
    res = mul(mul((pre_lo, pre_hi), (suf_lo, suf_hi)), (
        jnp.broadcast_to(inv_total[0][..., None], lo.shape),
        jnp.broadcast_to(inv_total[1][..., None], hi.shape),
    ))
    del n
    return (jnp.moveaxis(res[0], -1, axis), jnp.moveaxis(res[1], -1, axis))


def _prefix_prod(x):
    """Inclusive prefix product along the last axis (Hillis–Steele, log-depth)."""
    lo, hi = x
    n = lo.shape[-1]
    shift = 1
    while shift < n:
        slo = jnp.pad(lo[..., :-shift], [(0, 0)] * (lo.ndim - 1) + [(shift, 0)],
                      constant_values=1)
        shi = jnp.pad(hi[..., :-shift], [(0, 0)] * (hi.ndim - 1) + [(shift, 0)],
                      constant_values=0)
        lo, hi = mul((lo, hi), (slo, shi))
        shift *= 2
    return lo, hi


# ---------------------------------------------------------------------------
# Montgomery-representative helpers (Tip5 S-box support)
# ---------------------------------------------------------------------------


def to_montgomery(a):
    """canonical value v -> canonical Montgomery representative (v * 2^64) mod p."""
    return mul_const(a, R)


def from_montgomery(m):
    """Montgomery representative (any u64) -> canonical value (m * 2^-64) mod p."""
    return mul_const(m, R_INV)
