"""Batch-first polynomial ops on device (limb planes).

The scalar `Polynomial` class (math/polynomial.py) mirrors the reference's
object API; this module is the device throughput path operating on
whole batches of polynomials as uint64/limb arrays — the layer a STARK
prover actually drives (SURVEY §7: "batch-first APIs"):

  * batch_ntt / batch_intt            (rows, n) transforms
  * batch_coset_evaluate / interpolate  low-degree extension on a coset
  * batch_multiply                    pointwise-NTT products
  * batch_evaluate_barycentric        codeword-form evaluation at a point
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from . import gf
from . import gf_numpy as gfn
from . import ntt as ntt_mod
from .b_field_element import GENERATOR, P, PRIMITIVE_ROOTS


def _pow_row(base: int, n: int):
    return gfn.powers(base, n)


def batch_ntt(values: np.ndarray, inverse: bool = False) -> np.ndarray:
    """(rows, n) uint64 -> row-wise (i)NTT."""
    return ntt_mod.ntt_values(values, inverse=inverse)


def batch_intt(values: np.ndarray) -> np.ndarray:
    return ntt_mod.ntt_values(values, inverse=True)


def batch_coset_evaluate(coefficients: np.ndarray, order: int,
                         offset: int = GENERATOR) -> np.ndarray:
    """Row-wise low-degree extension: evaluate each row's polynomial on the
    coset offset * <omega_order>. coefficients: (rows, k) with k <= order."""
    coefficients = np.asarray(coefficients, dtype=np.uint64)
    rows, k = coefficients.shape
    assert k <= order and order & (order - 1) == 0
    scaled = gfn.mul(coefficients, _pow_row(offset, k)[None, :])
    padded = np.zeros((rows, order), dtype=np.uint64)
    padded[:, :k] = scaled
    return ntt_mod.ntt_values(padded)


def batch_coset_interpolate(codewords: np.ndarray,
                            offset: int = GENERATOR) -> np.ndarray:
    """Inverse of batch_coset_evaluate: (rows, order) -> coefficients."""
    codewords = np.asarray(codewords, dtype=np.uint64)
    order = codewords.shape[-1]
    coeffs = ntt_mod.ntt_values(codewords, inverse=True)
    offset_inv = pow(int(offset), P - 2, P)
    return gfn.mul(coeffs, _pow_row(offset_inv, order)[None, :])


def batch_multiply(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise polynomial products via NTT.

    a: (rows, da+1), b: (rows, db+1) -> (rows, da+db+1)."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    rows = a.shape[0]
    assert b.shape[0] == rows
    out_len = a.shape[1] + b.shape[1] - 1
    n = 1 << (out_len - 1).bit_length()
    pa = np.zeros((rows, n), dtype=np.uint64)
    pb = np.zeros((rows, n), dtype=np.uint64)
    pa[:, : a.shape[1]] = a
    pb[:, : b.shape[1]] = b
    fa = gf.to_limbs(ntt_mod.ntt_values(pa))
    fb = gf.to_limbs(ntt_mod.ntt_values(pb))
    prod = gf.from_limbs(gf.mul(fa, fb))
    return ntt_mod.ntt_values(prod, inverse=True)[:, :out_len]


def batch_evaluate_barycentric(codewords: np.ndarray, point: int) -> np.ndarray:
    """Evaluate each row's interpolant (over <omega_n>) at `point` using the
    barycentric formula (polynomial.rs:2587-2638), fully on device.

    Requires `point` outside the domain. codewords: (rows, n) -> (rows,)."""
    codewords = np.asarray(codewords, dtype=np.uint64)
    rows, n = codewords.shape
    domain = _pow_row(PRIMITIVE_ROOTS[n], n)
    z = np.full(n, point % P, dtype=np.uint64)
    diffs = gf.to_limbs(gfn.sub(z, domain))
    inv = gf.batch_inversion(diffs)
    weights = gf.mul(gf.to_limbs(domain), inv)  # d_i / (z - d_i)
    cw = gf.to_limbs(codewords)
    wl = jnp.broadcast_to(weights[0], cw[0].shape)
    wh = jnp.broadcast_to(weights[1], cw[1].shape)
    terms = gf.mul(cw, (wl, wh))
    # sum rows in the field: fold via prefix (log-depth) addition
    num = _row_field_sum(terms)
    den_all = _row_field_sum((weights[0][None, :], weights[1][None, :]))
    den_inv = gf.inverse_or_zero(den_all)
    out = gf.mul(num, (jnp.broadcast_to(den_inv[0], num[0].shape),
                       jnp.broadcast_to(den_inv[1], num[1].shape)))
    return gf.from_limbs(out)


def batch_coset_extrapolate(codewords: np.ndarray, offset: int,
                            points: np.ndarray,
                            point_chunk: int = 64,
                            use_jit: bool = True) -> np.ndarray:
    """Extrapolate codeword rows over the coset `offset * <omega_n>` to
    arbitrary points, fully on device — the STARK out-of-domain-sampling
    hot path (reference dispatch: polynomial.rs:2117-2331; the host
    object API's `Polynomial.coset_extrapolate` mirrors it).

    Coefficient route: ONE row-batched iNTT recovers g with
    g(omega^i) = c_i, and f(z) = g(z/offset) is evaluated by a
    log-doubling power table + weighted fold per point chunk. Per point
    this is n multiplies with NO inversions — the earlier closed-form
    barycentric kernel spent ~36 full-matrix passes in two Hillis-Steele
    prefix-product scans per chunk (see DESIGN.md §5); this form is
    ~10x faster at the bench shape (2^18 -> 2^10) and, unlike
    barycentric, is also exact AT in-domain points (no zero
    denominators). codewords: (rows, n); points: (m,) -> (rows, m).
    Bit-exact vs interpolate-then-evaluate."""
    cw = np.asarray(codewords, dtype=np.uint64)
    rows, n = cw.shape
    pts = np.asarray(points, dtype=np.uint64) % np.uint64(P)
    m = pts.shape[0]
    off = int(offset) % P
    # g = iNTT(codeword) interpolates over <omega_n>; f(z) = g(z/offset)
    coeffs = ntt_mod.ntt_values(cw, inverse=True)
    w = gfn.mul(pts, np.uint64(pow(off, P - 2, P)))
    b_dev = gf.to_limbs(coeffs)
    if use_jit and m > point_chunk:
        # ONE dispatch: lax.map over point chunks (each chunk's working
        # set stays bounded); pad the point count to a chunk multiple
        pad = (-m) % point_chunk
        wp = np.concatenate([w, np.zeros(pad, dtype=np.uint64)])
        nch = wp.shape[0] // point_chunk
        out = _coset_extrapolate_pow_mapped(
            b_dev, gf.to_limbs(wp.reshape(nch, point_chunk)))
        return gf.from_limbs(out)[:, :m]
    out = np.empty((rows, m), dtype=np.uint64)
    for start in range(0, m, point_chunk):
        wc = w[start: start + point_chunk]
        chunk = _coset_extrapolate_pow_chunk(b_dev, gf.to_limbs(wc),
                                             use_jit=use_jit)
        out[:, start: start + point_chunk] = gf.from_limbs(chunk)
    return out


def _coset_extrapolate_pow_core(bl, bh, wl, wh):
    """Device core: coefficient limb planes (rows, n), scaled point chunk
    (c,) -> (rows, c) values g(w_j) = sum_k b_k w_j^k.

    The power table W[j, k] = w_j^k is built by log-doubling
    (concat(W, W * w^width) per level: n total multiplies per point),
    then one weighted fold against the coefficients."""
    n = bl.shape[-1]
    pl = jnp.ones((wl.shape[0], 1), dtype=jnp.uint32)
    ph = jnp.zeros((wl.shape[0], 1), dtype=jnp.uint32)
    sl, sh = wl, wh                       # w^width, width = current table
    width = 1
    while width < n:
        tl, th = gf.mul((pl, ph), (sl[:, None], sh[:, None]))
        pl = jnp.concatenate([pl, tl], axis=-1)
        ph = jnp.concatenate([ph, th], axis=-1)
        width *= 2
        if width < n:
            sl, sh = gf.mul((sl, sh), (sl, sh))
    terms = gf.mul((bl[:, None, :], bh[:, None, :]),
                   (pl[None], ph[None]))  # (rows, c, n)
    return _row_field_sum(terms)


def batch_coset_extrapolate_xfe(codewords: np.ndarray, offset: int,
                                points: np.ndarray,
                                point_chunk: int = 16,
                                use_jit: bool = True) -> np.ndarray:
    """Extrapolate codeword rows to EXTENSION-FIELD points on device — the
    actual STARK out-of-domain-sampling shape (base-field trace columns
    sampled at an xfe challenge; x_field_element.rs lift semantics).

    codewords: (rows, n) base-field or (rows, n, 3) extension-field values;
    points: (m, 3) xfe values (in- or out-of-domain). Returns (rows, m, 3).
    Same coefficient route as batch_coset_extrapolate (ONE row-batched
    iNTT + log-doubling power tables), with the point powers and folds in
    the extension field (gf_ext); the coefficients stay base-field planes
    when the codewords are base-field (the reference's
    `MulAssign<BFieldElement>` structure)."""
    from . import xgf_numpy as xgf

    cw = np.asarray(codewords, dtype=np.uint64)
    cw_x = cw.ndim == 3
    rows, n = cw.shape[0], cw.shape[1]
    pts = np.asarray(points, dtype=np.uint64) % np.uint64(P)
    m = pts.shape[0]
    off = int(offset) % P
    # g = iNTT(codeword) over <omega_n> (componentwise for xfe rows);
    # f(z) = g(z/offset)
    if cw_x:
        coeffs = ntt_mod.ntt_values(
            np.ascontiguousarray(np.swapaxes(cw, 1, 2)), inverse=True)
    else:
        coeffs = ntt_mod.ntt_values(cw, inverse=True)
    b_dev = gf.to_limbs(coeffs)
    w = xgf.mul_base(pts, np.uint64(pow(off, P - 2, P)))
    pad = (-m) % point_chunk
    wp = np.concatenate([w, np.zeros((pad, 3), dtype=np.uint64)])
    nch = wp.shape[0] // point_chunk
    wcs = gf.to_limbs(wp.reshape(nch, point_chunk, 3))
    if use_jit:
        out = _coset_extrapolate_xfe_pow_mapped(b_dev, wcs, cw_x)
    else:
        chunks = [
            _coset_extrapolate_xfe_pow_core(
                b_dev[0], b_dev[1], wcs[0][i], wcs[1][i], cw_x)
            for i in range(nch)
        ]
        out = (jnp.concatenate([c[0] for c in chunks], axis=1),
               jnp.concatenate([c[1] for c in chunks], axis=1))
    vals = gf.from_limbs(out)  # (rows, nch*point_chunk, 3)
    return vals[:, :m]


def _coset_extrapolate_xfe_pow_core(bl, bh, wl, wh, cw_x: bool):
    """Device core, extension-field points: coefficient limb planes
    ((rows, n) base or (rows, 3, n) xfe), scaled point chunk (c, 3) ->
    (rows, c, 3) values via log-doubling xfe power tables."""
    from . import gf_ext

    n = bl.shape[-1]
    c = wl.shape[0]
    # power table (c, 3, width): starts at [w^0] = [1, 0, 0]
    pl = jnp.zeros((c, 3, 1), dtype=jnp.uint32).at[:, 0, :].set(1)
    ph = jnp.zeros((c, 3, 1), dtype=jnp.uint32)
    sl, sh = wl[..., None], wh[..., None]    # w^width as (c, 3, 1)
    width = 1
    while width < n:
        tl, th = gf_ext.mul((pl, ph), (sl, sh))
        pl = jnp.concatenate([pl, tl], axis=-1)
        ph = jnp.concatenate([ph, th], axis=-1)
        width *= 2
        if width < n:
            sl, sh = gf_ext.mul((sl, sh), (sl, sh))
    if cw_x:
        terms = gf_ext.mul((pl[None], ph[None]),
                           (bl[:, None], bh[:, None]))   # (rows, c, 3, n)
    else:
        terms = gf_ext.mul_base((pl[None], ph[None]),
                                (bl[:, None, :], bh[:, None, :]))
    return _row_field_sum(terms)                         # (rows, c, 3)


_coset_extrapolate_xfe_pow_map_jit = {}


def _coset_extrapolate_xfe_pow_mapped(b, wcs, cw_x: bool):
    """All xfe point chunks in one dispatch (lax.map over the chunk axis).
    wcs: (nch, c, 3) limb pair of scaled points -> (rows, nch*c, 3)."""
    key = bool(cw_x)
    if key not in _coset_extrapolate_xfe_pow_map_jit:
        import jax

        def run(bl, bh, wls, whs, _cw_x=key):
            def body(args):
                wl, wh = args
                return _coset_extrapolate_xfe_pow_core(bl, bh, wl, wh,
                                                       _cw_x)

            ol, oh = jax.lax.map(body, (wls, whs))
            # (nch, rows, c, 3) -> (rows, nch*c, 3)
            ol = jnp.moveaxis(ol, 0, 1)
            oh = jnp.moveaxis(oh, 0, 1)
            return (ol.reshape(ol.shape[0], -1, 3),
                    oh.reshape(oh.shape[0], -1, 3))

        _coset_extrapolate_xfe_pow_map_jit[key] = jax.jit(run)
    return _coset_extrapolate_xfe_pow_map_jit[key](
        b[0], b[1], wcs[0], wcs[1])


# one stable jit wrapper: per-shape executables cache inside it (a fresh
# jit object per call would recompile every chunk)
_coset_extrapolate_pow_jit = None
_coset_extrapolate_pow_map_jit = None


def _coset_extrapolate_pow_mapped(b, wcs):
    """All point chunks in one dispatch: lax.map over the chunk axis.

    wcs: (nch, c) limb pair of scaled points -> (rows, nch*c) limb pair."""
    global _coset_extrapolate_pow_map_jit
    if _coset_extrapolate_pow_map_jit is None:
        import jax

        def run(bl, bh, wls, whs):
            def body(args):
                wl, wh = args
                return _coset_extrapolate_pow_core(bl, bh, wl, wh)

            ol, oh = jax.lax.map(body, (wls, whs))
            # (nch, rows, c) -> (rows, nch*c)
            ol = jnp.moveaxis(ol, 0, 1)
            oh = jnp.moveaxis(oh, 0, 1)
            return (ol.reshape(ol.shape[0], -1),
                    oh.reshape(oh.shape[0], -1))

        _coset_extrapolate_pow_map_jit = jax.jit(run)
    return _coset_extrapolate_pow_map_jit(b[0], b[1], wcs[0], wcs[1])


def _coset_extrapolate_pow_chunk(b, wc, use_jit: bool = True):
    # use_jit=False runs the ops eagerly (CPU-backend tests); the jitted
    # path is for real accelerators
    global _coset_extrapolate_pow_jit
    if not use_jit:
        return _coset_extrapolate_pow_core(b[0], b[1], wc[0], wc[1])
    if _coset_extrapolate_pow_jit is None:
        import jax

        _coset_extrapolate_pow_jit = jax.jit(_coset_extrapolate_pow_core)
    return _coset_extrapolate_pow_jit(b[0], b[1], wc[0], wc[1])


def _row_field_sum(x):
    """Field sum along the last (power-of-two) axis via log-depth halving."""
    lo, hi = x
    n = lo.shape[-1]
    assert n & (n - 1) == 0 and n > 0
    while n > 1:
        half = n // 2
        lo, hi = gf.add(
            (lo[..., :half], hi[..., :half]),
            (lo[..., half:], hi[..., half:]),
        )
        n = half
    return lo[..., 0], hi[..., 0]
