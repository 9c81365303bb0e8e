"""Batched NTT / iNTT over the Goldilocks field on device limb planes.

Equivalent in values to the reference's in-place iterative radix-2 DIT
Cooley–Tukey transform (twenty-first/src/math/ntt.rs:67-214): bit-reverse
permutation followed by log2(n) butterfly stages with per-stage twiddles
omega^(n/2m)^j. The reference caches twiddles/swap indices in OnceLocks
(ntt.rs:71-79, :166-193); here the analogous caches are host-precomputed numpy
tables, uploaded once per (size, direction).

Design (batch-first, not a port):
  * batch-first: operates on limb planes of shape (..., n); the transform runs
    over the last axis and everything else is batch. Because twiddles are
    always *base-field* scalars (the reference's `MulAssign<BFieldElement>`
    bound), the same function transforms extension-field data laid out as
    (..., 3, n) — the three coefficient planes ride along as batch.
  * stages are static: the python loop over log2(n) stages unrolls into a
    fixed XLA graph; each stage is a reshape + elementwise modmul/add, which
    XLA fuses into a few passes over device memory.
  * the bit-reverse permutation is a single gather.

For multi-chip transforms see parallel/dist_ntt.py (four-step / Bailey
decomposition with an all-to-all transpose instead of cross-chip butterflies).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp

from . import gf
from . import gf64
from . import gf_numpy as gfn
from .b_field_element import PRIMITIVE_ROOTS, P


class NttDomainError(ValueError):
    pass


def _check_len(n: int) -> int:
    if n == 0:
        return 0
    if n & (n - 1) or n > (1 << 32):
        raise NttDomainError(
            f"NTT length must be 0 or a power of two <= 2^32, got {n}"
        )
    return int(n).bit_length() - 1


@functools.lru_cache(maxsize=None)
def _bit_reverse_permutation(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros(n, dtype=np.uint32)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _twiddles_host(log_n: int, inverse: bool) -> tuple[np.ndarray, ...]:
    """Per-stage twiddle tables: stage s holds m=2^s powers of omega^(n/2m).

    Matches ntt.rs:309-324. Returned as a single concatenated uint64 array of
    length n-1 plus per-stage offsets, to keep the device upload small.
    """
    n = 1 << log_n
    root = PRIMITIVE_ROOTS[n]
    if inverse:
        root = pow(root, P - 2, P)
    stages = []
    for s in range(log_n):
        m = 1 << s
        w_m = pow(root, n // (2 * m), P)
        stages.append(gfn.powers(w_m, m))
    return tuple(stages)


@functools.lru_cache(maxsize=None)
def _twiddles_radix4_host(log_n: int, inverse: bool):
    """Per-stage-PAIR twiddle tables (t, t^2, t^3) for true radix-4 DIT.

    For the fused pair of radix-2 stages (m, 2m), with t_j = omega_{4m}^j,
    the composed butterfly equals the radix-4 DFT butterfly
        u0=a, u1=t*c, u2=t^2*b, u3=t^3*d
        e0=u0+u2, e1=u0-u2, o0=u1+u3, o1=i*(u1-u3)
        y = (e0+o0, e1+o1, e0-o0, e1-o1)
    which needs 3 general multiplies + one multiply by i = omega_4 = 2^48
    (a shift) per 4 elements, instead of 4 general multiplies.
    Returns (first_radix2_stage_or_None, [(t, t2, t3), ...]) as uint64.
    """
    n = 1 << log_n
    root = PRIMITIVE_ROOTS[n]
    if inverse:
        root = pow(root, P - 2, P)
    first = None
    s = 0
    if log_n % 2 == 1:
        first = gfn.powers(pow(root, n // 2, P), 1)
        s = 1
    pairs = []
    while s < log_n:
        m = 1 << s
        w4m = pow(root, n // (4 * m), P)
        t = gfn.powers(w4m, m)
        t2 = gfn.mul(t, t)
        t3 = gfn.mul(t2, t)
        pairs.append((t, t2, t3))
        s += 2
    return first, tuple(pairs)


def _split_u32(tw: np.ndarray):
    return ((tw & np.uint64(0xFFFF_FFFF)).astype(np.uint32),
            (tw >> np.uint64(32)).astype(np.uint32))


@functools.lru_cache(maxsize=None)
def _device_tables_r4(log_n: int, inverse: bool):
    """Radix-4 host tables: (perm, first_radix2_limbpair_or_None,
    tuple of (t, t2, t3) limb pairs). numpy, safe to close over in traces."""
    first, pairs = _twiddles_radix4_host(log_n, inverse)
    first_dev = _split_u32(first) if first is not None else None
    pairs_dev = tuple(tuple(_split_u32(t) for t in pair) for pair in pairs)
    return _bit_reverse_permutation(log_n), first_dev, pairs_dev


# Stage-plan radix for the hot axis(-2) core. Radix-8 does fewer general
# multiplies per element (7/8 per 3 stages vs 3/4 per 2) and fewer butterfly
# layers, at the cost of extra shift-class rotations and wider live state.
# Radix-4 is the default; set TWENTY_FIRST_TPU_NTT_RADIX8=1 for the radix-8
# plan. Not yet measured on the H100 (ROADMAP D2).
_USE_RADIX8 = os.environ.get("TWENTY_FIRST_TPU_NTT_RADIX8", "0") == "1"


def _device_tables_mixed(log_n: int, inverse: bool, radix8: bool | None = None):
    """Mixed radix-8/4/2 stage plan for the hot axis(-2) core.

    With ``radix8`` (default from TWENTY_FIRST_TPU_NTT_RADIX8, off), stages
    are covered by radix-8 butterflies (3 radix-2 stages each, 7 general
    multiplies per 8 elements) after a mul-free lead stage fixing
    log_n mod 3; otherwise by true radix-4 butterflies after an optional
    mul-free radix-2 lead. Returns (perm, plan) where plan entries are
        ("r2", None, 1, True)
        ("r4", (t, t2, t3) limb pairs, m, trivial)
        ("r8", (t^1..t^7) limb pairs, m, trivial)
    """
    if radix8 is None:
        radix8 = _USE_RADIX8
    return _device_tables_mixed_cached(log_n, inverse, radix8)


@functools.lru_cache(maxsize=None)
def _device_tables_mixed_cached(log_n: int, inverse: bool, radix8: bool):
    n = 1 << log_n
    root = PRIMITIVE_ROOTS[n]
    if inverse:
        root = pow(root, P - 2, P)
    plan = []
    s = 0
    step = 3 if radix8 else 2
    rem = log_n % step
    if rem == 1:
        plan.append(("r2", None, 1, True))
        s = 1
    elif rem == 2:  # radix8 only; a trivial radix-4 lead covers 2 stages
        t = gfn.powers(pow(root, n // 4, P), 1)  # [1]
        t2 = gfn.mul(t, t)
        t3 = gfn.mul(t2, t)
        plan.append(("r4", tuple(_split_u32(v) for v in (t, t2, t3)), 1, True))
        s = 2
    while s < log_n:
        m = 1 << s
        r = 8 if radix8 else 4
        w = pow(root, n // (r * m), P)
        t1 = gfn.powers(w, m)
        tabs = [t1]
        for _ in range(r - 2):
            tabs.append(gfn.mul(tabs[-1], t1))
        plan.append((
            "r8" if radix8 else "r4",
            tuple(_split_u32(v) for v in tabs),
            m,
            m == 1,
        ))
        s += step
    return _bit_reverse_permutation(log_n), tuple(plan)


@functools.lru_cache(maxsize=None)
def _device_tables(log_n: int, inverse: bool):
    """Host-side (numpy) tables. Kept as numpy — not device arrays — so that
    traced code (jit / shard_map) can safely close over them as constants;
    caching device arrays created inside a trace would leak tracers."""
    stages = _twiddles_host(log_n, inverse)
    dev = []
    for tw in stages:
        lo = (tw & np.uint64(0xFFFF_FFFF)).astype(np.uint32)
        hi = (tw >> np.uint64(32)).astype(np.uint32)
        dev.append((lo, hi))
    perm = _bit_reverse_permutation(log_n)
    return perm, tuple(dev)


def _ntt_core(x, log_n: int, inverse: bool):
    """x: (lo, hi) with last axis n. Returns transformed limb planes.

    Same true-radix-4 lazy butterflies as the axis(-2) core (see below),
    over the last axis. An odd stage count starts with one (mul-free)
    radix-2 stage.
    """
    perm, first, pairs = _device_tables_r4(log_n, inverse)
    lo, hi = x
    n = lo.shape[-1]
    lo = jnp.take(lo, perm, axis=-1)
    hi = jnp.take(hi, perm, axis=-1)
    st = (lo, hi)
    s = 0
    if first is not None:
        st = _radix2_first(st, n)
        s = 1
    for t, t2, t3 in pairs:
        m = 1 << s
        st = _radix4_true(st, (t, t2, t3), m, n, inverse, trivial=(m == 1))
        s += 2
    return gf.canon(st)


def _radix2_first(x, n):
    """First radix-2 stage (m=1): its only twiddle is 1, so it is mul-free."""
    lo, hi = x
    batch_shape = lo.shape[:-1]
    shape = batch_shape + (n // 2, 2)
    lo = lo.reshape(shape)
    hi = hi.reshape(shape)
    u = (lo[..., 0], hi[..., 0])
    v = (lo[..., 1], hi[..., 1])
    top = gf.add_lazy(u, v)
    bot = gf.sub_lazy(u, v)
    return (
        jnp.stack([top[0], bot[0]], axis=-1).reshape(batch_shape + (n,)),
        jnp.stack([top[1], bot[1]], axis=-1).reshape(batch_shape + (n,)),
    )


def _radix4_true(x, tq, m, n, inverse: bool, trivial: bool):
    """True radix-4 DIT butterfly over the last axis (see _radix4_true_ax2)."""
    lo, hi = x
    batch_shape = lo.shape[:-1]
    shape = batch_shape + (n // (4 * m), 4, m)
    lo = lo.reshape(shape)
    hi = hi.reshape(shape)
    a = (lo[..., 0, :], hi[..., 0, :])
    b = (lo[..., 1, :], hi[..., 1, :])
    c = (lo[..., 2, :], hi[..., 2, :])
    d = (lo[..., 3, :], hi[..., 3, :])
    if trivial:
        u1, u2, u3 = c, b, d
    else:
        t, t2, t3 = tq
        u1 = gf.mul_lazy(c, t)
        u2 = gf.mul_lazy(b, t2)
        u3 = gf.mul_lazy(d, t3)
    e0 = gf.add_lazy(a, u2)
    e1 = gf.sub_lazy(a, u2)
    o0 = gf.add_lazy(u1, u3)
    o1 = gf.mul_by_i_lazy(gf.sub_lazy(u1, u3), inverse)
    y0 = gf.add_lazy(e0, o0)
    y2 = gf.sub_lazy(e0, o0)
    y1 = gf.add_lazy(e1, o1)
    y3 = gf.sub_lazy(e1, o1)
    return (
        jnp.stack([y0[0], y1[0], y2[0], y3[0]], axis=-2)
        .reshape(batch_shape + (n,)),
        jnp.stack([y0[1], y1[1], y2[1], y3[1]], axis=-2)
        .reshape(batch_shape + (n,)),
    )


# -- axis(-2) transform core -------------------------------------------------
#
# The four-step local transforms use this core: transforming over axis -2
# keeps the OTHER factor of the (n2, n1) matrix as the minor dimension, so
# every butterfly stage is a full-width (n1-wide) vector op — the last-axis
# core degrades at early stages where the within-block stride m is small.
#
# Butterflies are TRUE radix-4 DIT (not fused radix-2 pairs): 3 general
# multiplies + one multiply-by-i (i = omega_4 = 2^48, a shift) per 4
# elements instead of 4 general multiplies. Intermediates use the lazy
# (non-canonical u64 residue) gf ops; one conditional subtract at the end
# restores canonical form.


def _ntt_core_ax2(x, log_n: int, inverse: bool):
    """NTT over axis -2 of (..., n, w) limb planes. Values match _ntt_core."""
    perm, _ = _device_tables_mixed(log_n, inverse)
    lo, hi = x
    lo = jnp.take(lo, perm, axis=-2)
    hi = jnp.take(hi, perm, axis=-2)
    return _ntt_stages_ax2((lo, hi), log_n, inverse, canon_out=True)


@functools.lru_cache(maxsize=None)
def _stage_tw_flat(log_n: int, inverse: bool):
    """Stage-plan twiddles flattened into one (L, 1) limb-plane pair, plus
    per-layer metadata (kind, table_offset_or_None, m, trivial). Built for
    Pallas kernels, which cannot capture numpy constants — the flat pair is
    passed as a kernel input ref and sliced statically per layer."""
    _, plan = _device_tables_mixed(log_n, inverse)
    los, his, metas = [], [], []
    off = 0
    for kind, tabs, m, trivial in plan:
        if kind == "r2" or trivial:
            metas.append((kind, None, m, trivial))
            continue
        for tlo, thi in tabs:
            los.append(tlo)
            his.append(thi)
        metas.append((kind, off, m, trivial))
        off += len(tabs) * m
    lo = np.concatenate(los) if los else np.zeros(0, np.uint32)
    hi = np.concatenate(his) if his else np.zeros(0, np.uint32)
    pad = (-len(lo)) % 8 or 8
    lo = np.concatenate([lo, np.zeros(pad, np.uint32)])
    hi = np.concatenate([hi, np.zeros(pad, np.uint32)])
    return lo.reshape(-1, 1), hi.reshape(-1, 1), tuple(metas)


def _ntt_stages_ax2_tw(st, log_n: int, inverse: bool, twl, twh):
    """Butterfly stages on BIT-REVERSED (..., n, w) input with twiddles read
    from a flat (L, 1) pair (see _stage_tw_flat); lazy output. Safe inside
    Pallas kernels (no captured numpy arrays)."""
    _, _, metas = _stage_tw_flat(log_n, inverse)
    n = st[0].shape[-2]
    for kind, off, m, trivial in metas:
        if kind == "r2":
            st = _radix2_first_ax2(st, n)
            continue
        ntab = 3 if kind == "r4" else 7
        tq = None
        if not trivial:
            tq = tuple(
                (twl[off + j * m: off + (j + 1) * m, :],
                 twh[off + j * m: off + (j + 1) * m, :])
                for j in range(ntab)
            )
        if kind == "r4":
            st = _radix4_true_ax2(st, tq, m, n, inverse, trivial=trivial)
        else:
            st = _radix8_true_ax2(st, tq, m, n, inverse, trivial=trivial)
    return st


def _ntt_stages_ax2(st, log_n: int, inverse: bool, canon_out: bool = False):
    """Butterfly stages of the axis(-2) core on BIT-REVERSED input; lazy
    (non-canonical) output unless ``canon_out`` folds the final
    canonicalization into the last butterfly layer's fusion (saving the
    standalone canon pass over device memory).

    With TWENTY_FIRST_TPU_NTT_PIECES=1, consecutive radix-4 layers run
    PAIRED in "piece" form (_r4_pair_pieces): the four butterfly outputs
    stay separate tensors through the next layer (whose inputs are strided
    row-slices of the pieces) and are reassembled with ONE concat per pair,
    for a compiler that materializes every `concatenate`."""
    _, plan = _device_tables_mixed(log_n, inverse)
    n = st[0].shape[-2]
    if _USE_PIECES and n >= 256:
        i = 0
        while i < len(plan):
            kind, tabs, m, trivial = plan[i]
            if (kind == "r4" and i + 1 < len(plan) and plan[i + 1][0] == "r4"):
                st = _r4_pair_pieces(st, plan[i], plan[i + 1], n, inverse)
                i += 2
                continue
            if kind == "r2":
                st = _radix2_first_ax2(st, n)
            elif kind == "r4":
                st = _radix4_true_ax2(st, tabs, m, n, inverse, trivial=trivial)
            else:
                st = _radix8_true_ax2(st, tabs, m, n, inverse,
                                      trivial=trivial)
            i += 1
        return gf.canon(st) if canon_out else st
    for idx, (kind, tabs, m, trivial) in enumerate(plan):
        last = canon_out and idx == len(plan) - 1
        if kind == "r2":
            st = _radix2_first_ax2(st, n, canon_out=last)
        elif kind == "r4":
            st = _radix4_true_ax2(st, tabs, m, n, inverse, trivial=trivial,
                                  canon_out=last)
        else:
            st = _radix8_true_ax2(st, tabs, m, n, inverse, trivial=trivial,
                                  canon_out=last)
    return st


# -- native-u64 (w64) stage core ---------------------------------------------
#
# Same true-radix-4 lazy butterflies as the u32 limb-plane core, on single
# uint64 planes (math/gf64.py). Opt-in (TWENTY_FIRST_TPU_NTT_W64=1);
# bit-exact vs the host oracle at 2^17/2^18/2^20. Whether it beats the
# limb-plane core on the H100 is not measured yet (ROADMAP S2).

_USE_W64 = os.environ.get("TWENTY_FIRST_TPU_NTT_W64", "0") == "1"


@functools.lru_cache(maxsize=None)
def _device_tables_r4_w64(log_n: int, inverse: bool):
    """Radix-4 stage plan with host-numpy uint64 twiddle tables.

    Entries: ("r2", None, 1, True) or ("r4", (t, t2, t3), m, trivial).
    Tables are small (sum 3*(4^k) < n elements) and safe to close over as
    trace constants."""
    n = 1 << log_n
    root = PRIMITIVE_ROOTS[n]
    if inverse:
        root = pow(root, P - 2, P)
    plan = []
    s = 0
    if log_n % 2 == 1:
        plan.append(("r2", None, 1, True))
        s = 1
    while s < log_n:
        m = 1 << s
        w = pow(root, n // (4 * m), P)
        t1 = gfn.powers(w, m)
        t2 = gfn.mul(t1, t1)
        t3 = gfn.mul(t2, t1)
        plan.append(("r4", (t1, t2, t3), m, m == 1))
        s += 2
    return _bit_reverse_permutation(log_n), tuple(plan)


def _radix2_first_ax2_w64(x, n, canon_out: bool = False):
    """First radix-2 stage (m=1, mul-free) on a single u64 plane, axis -2."""
    batch = x.shape[:-2]
    w = x.shape[-1]
    v = x.reshape(batch + (n // 2, 2, w))
    u, vv = v[..., 0, :], v[..., 1, :]
    top = gf64.add_lazy(u, vv)
    bot = gf64.sub_lazy(u, vv)
    if canon_out:
        top, bot = gf64.canon(top), gf64.canon(bot)
    return jnp.stack([top, bot], axis=-2).reshape(batch + (n, w))


def _radix4_true_ax2_w64(x, tq, m, n, inverse: bool, trivial: bool,
                         canon_out: bool = False):
    """True radix-4 DIT butterfly on a single u64 plane (axis -2).

    Identical math to _radix4_true_ax2 (see its docstring)."""
    batch = x.shape[:-2]
    w = x.shape[-1]
    v = x.reshape(batch + (n // (4 * m), 4, m, w))
    a, b, c, d = (v[..., q, :, :] for q in range(4))
    if trivial:
        u1, u2, u3 = c, b, d
    else:
        t, t2, t3 = (jnp.asarray(tt)[:, None] for tt in tq)
        u1 = gf64.mul_lazy(c, t)
        u2 = gf64.mul_lazy(b, t2)
        u3 = gf64.mul_lazy(d, t3)
    e0 = gf64.add_lazy(a, u2)
    e1 = gf64.sub_lazy(a, u2)
    o0 = gf64.add_lazy(u1, u3)
    o1 = gf64.mul_by_i_lazy(gf64.sub_lazy(u1, u3), inverse)
    y0 = gf64.add_lazy(e0, o0)
    y2 = gf64.sub_lazy(e0, o0)
    y1 = gf64.add_lazy(e1, o1)
    y3 = gf64.sub_lazy(e1, o1)
    if canon_out:
        y0, y1, y2, y3 = (gf64.canon(y) for y in (y0, y1, y2, y3))
    return jnp.stack([y0, y1, y2, y3], axis=-3).reshape(batch + (n, w))


def _ntt_stages_ax2_w64(x, log_n: int, inverse: bool,
                        canon_out: bool = False):
    """Butterfly stages on BIT-REVERSED (..., n, w) u64 input; lazy output
    unless canon_out folds the final canonicalization into the last layer."""
    _, plan = _device_tables_r4_w64(log_n, inverse)
    n = x.shape[-2]
    for idx, (kind, tabs, m, trivial) in enumerate(plan):
        last = canon_out and idx == len(plan) - 1
        if kind == "r2":
            x = _radix2_first_ax2_w64(x, n, canon_out=last)
        else:
            x = _radix4_true_ax2_w64(x, tabs, m, n, inverse, trivial=trivial,
                                     canon_out=last)
    return x


def _ntt_core_ax2_w64(x, log_n: int, inverse: bool, canon_out: bool = False):
    """NTT over axis -2 of a (..., n, w) u64 plane; LAZY output by default
    (the four-step keeps everything lazy until the very end)."""
    perm, _ = _device_tables_r4_w64(log_n, inverse)
    x = jnp.take(x, perm, axis=-2)
    return _ntt_stages_ax2_w64(x, log_n, inverse, canon_out=canon_out)


def _local_pass_w64(x, log_len: int, inverse: bool, diag=None,
                    post_const=None, transpose_in: bool = False,
                    canon_out: bool = False):
    """u64 mirror of _local_pass: slab-mapped NTT over axis -2 with the
    diagonal / 1-n-scaling multiplies fused into the same pass. All values
    stay LAZY between passes; `canon_out` canonicalizes once at the end."""
    w = x.shape[-1] if not transpose_in else x.shape[-2]

    def run(v, d):
        if transpose_in:
            v = jnp.swapaxes(v, -1, -2)
        out = _ntt_core_ax2_w64(v, log_len, inverse,
                                canon_out=canon_out and d is None
                                and post_const is None)
        if d is not None:
            out = gf64.mul_lazy(out, d)
        if post_const is not None:
            out = gf64.mul_const_lazy(out, post_const)
        if canon_out and (d is not None or post_const is not None):
            out = gf64.canon(out)
        return out

    if w % _SLAB or x.size < _SLAB_MIN_ELEMS:
        return run(x, diag)
    nslab = w // _SLAB

    def to_slabs(a):
        if transpose_in:
            a = a.reshape(a.shape[:-2] + (nslab, _SLAB) + a.shape[-1:])
            return jnp.moveaxis(a, -3, 0)  # (nslab, ..., _SLAB, n)
        a = a.reshape(a.shape[:-1] + (nslab, _SLAB))
        return jnp.moveaxis(a, -2, 0)  # (nslab, ..., n, _SLAB)

    operands = [to_slabs(x)]
    if diag is not None:
        operands.append(to_slabs(diag))

    def body(args):
        return run(args[0], args[1] if diag is not None else None)

    out = jax.lax.map(body, tuple(operands))
    out = jnp.moveaxis(out, 0, -2)
    return out.reshape(out.shape[:-2] + (w,))


@functools.lru_cache(maxsize=None)
def _four_step_diag_device_w64(log_n: int, inverse: bool):
    lo, hi = _four_step_diag_host(log_n, inverse, False)
    return jnp.asarray(lo.astype(np.uint64) | (hi.astype(np.uint64) << 32))


def four_step_ntt_w64(x, log_n: int, inverse: bool, diag):
    """Four-step NTT over the last axis of a (..., n) u64 plane.

    Same structure as four_step_ntt_traceable's DIT path: column NTTs fused
    with the diagonal twiddle, then row NTTs with the transpose riding the
    slab map. Everything between the first gather and the final butterfly
    layer stays in lazy (non-canonical) residues."""
    log_n1, log_n2 = _four_step_split(log_n)
    n1, n2 = 1 << log_n1, 1 << log_n2
    batch = x.shape[:-1]
    x = x.reshape(batch + (n2, n1))
    y = _local_pass_w64(x, log_n2, inverse, diag=diag)
    n_inv = pow(1 << log_n, P - 2, P) if inverse else None
    z = _local_pass_w64(y, log_n1, inverse, post_const=n_inv,
                        transpose_in=True, canon_out=True)
    return z.reshape(batch + (n1 * n2,))


@functools.lru_cache(maxsize=None)
def _jitted_four_step_w64(log_n: int, inverse: bool):
    @jax.jit
    def run(lo, hi, diag):
        out = four_step_ntt_w64(gf64.pack((lo, hi)), log_n, inverse, diag)
        olo, ohi = gf64.unpack(out)
        return olo, ohi

    return run


# Piece-paired radix-4 layers (see _ntt_stages_ax2 docstring); opt-in, not
# yet measured on the H100 (ROADMAP D2).
_USE_PIECES = os.environ.get("TWENTY_FIRST_TPU_NTT_PIECES", "0") == "1"

# DIF four-step: replaces the two per-pass bit-reverse input gathers with
# one final combined un-reverse gather (see four_step_ntt_traceable).
_USE_DIF = os.environ.get("TWENTY_FIRST_TPU_NTT_DIF", "0") == "1"


def _r4_butterfly_parts(a, b, c, d, tq, inverse: bool):
    """The radix-4 DIT combine on four equal-shape limb pairs; tq is either
    None (trivial: all twiddles 1) or ((tlo, thi), ...) broadcast-ready."""
    if tq is None:
        u1, u2, u3 = c, b, d
    else:
        u1 = gf.mul_lazy(c, tq[0])
        u2 = gf.mul_lazy(b, tq[1])
        u3 = gf.mul_lazy(d, tq[2])
    e0 = gf.add_lazy(a, u2)
    e1 = gf.sub_lazy(a, u2)
    o0 = gf.add_lazy(u1, u3)
    o1 = gf.mul_by_i_lazy(gf.sub_lazy(u1, u3), inverse)
    return (gf.add_lazy(e0, o0), gf.add_lazy(e1, o1),
            gf.sub_lazy(e0, o0), gf.sub_lazy(e1, o1))


def _r4_pair_pieces(st, layer_a, layer_b, n, inverse: bool):
    """Two consecutive radix-4 layers with the intermediate interleave never
    materialized. Layer A emits four piece tensors (logical block offset
    q*m); layer B's butterfly inputs are strided row-slices of each piece,
    and its 16 outputs are reassembled by a single concatenate."""
    _, tabs_a, m0, trivial_a = layer_a
    _, tabs_b, m1, _ = layer_b
    assert m1 == 4 * m0
    lo, hi = st
    batch = lo.shape[:-2]
    w = lo.shape[-1]

    def view(x, blocks, m):
        return x.reshape(batch + (blocks, 4, m, w))

    def tw(pair, lo_idx, hi_idx):
        return (jnp.asarray(pair[0][lo_idx:hi_idx])[:, None],
                jnp.asarray(pair[1][lo_idx:hi_idx])[:, None])

    # layer A: (R0, 4, m0) blocks -> four pieces of shape (R0, m0)
    r0 = n // (4 * m0)
    la, ha = view(lo, r0, m0), view(hi, r0, m0)
    abcd = [(la[..., q, :, :], ha[..., q, :, :]) for q in range(4)]
    tq_a = None if trivial_a else tuple(
        tw(t, 0, m0) for t in tabs_a)
    pieces = _r4_butterfly_parts(*abcd, tq_a, inverse)

    # layer B: per piece q1, butterfly inputs are row-groups [q::4] of the
    # piece; twiddle slice is t[q1*m0:(q1+1)*m0]. Outputs keyed (q_out, q1).
    r1 = r0 // 4
    out = [None] * 16
    for q1, piece in enumerate(pieces):
        plo = piece[0].reshape(batch + (r1, 4, m0, w))
        phi = piece[1].reshape(batch + (r1, 4, m0, w))
        abcd = [(plo[..., q, :, :], phi[..., q, :, :]) for q in range(4)]
        tq_b = tuple(tw(t, q1 * m0, (q1 + 1) * m0) for t in tabs_b)
        ys = _r4_butterfly_parts(*abcd, tq_b, inverse)
        for q_out, y in enumerate(ys):
            out[q_out * 4 + q1] = y

    # ONE concat: interleave the 16 pieces as (R1, 16, m0) -> (n,)
    out_shape = batch + (n, w)
    return (
        jnp.concatenate([y[0][..., :, None, :, :] for y in out],
                        axis=-3).reshape(out_shape),
        jnp.concatenate([y[1][..., :, None, :, :] for y in out],
                        axis=-3).reshape(out_shape),
    )


def _tw_ax2(tw):
    """Reshape a stage-twiddle plane pair for axis(-2) broadcast: (m,) -> (m, 1).

    Pairs already shaped (m, 1) — e.g. slices of a Pallas twiddle ref —
    pass through unchanged."""
    lo, hi = tw
    if lo.ndim == 2:
        return lo, hi
    return lo[:, None], hi[:, None]


def _radix2_first_ax2(x, n, canon_out: bool = False):
    """First radix-2 stage (m=1): its only twiddle is 1, so it is mul-free."""
    lo, hi = x
    batch = lo.shape[:-2]
    w = lo.shape[-1]
    shape = batch + (n // 2, 2, w)
    lo = lo.reshape(shape)
    hi = hi.reshape(shape)
    u = (lo[..., 0, :], hi[..., 0, :])
    v = (lo[..., 1, :], hi[..., 1, :])
    top = gf.add_lazy(u, v)
    bot = gf.sub_lazy(u, v)
    if canon_out:
        top, bot = gf.canon(top), gf.canon(bot)
    out_shape = batch + (n, w)
    return (
        jnp.stack([top[0], bot[0]], axis=-2).reshape(out_shape),
        jnp.stack([top[1], bot[1]], axis=-2).reshape(out_shape),
    )


def _radix8_true_ax2(x, tabs, m, n, inverse: bool, trivial: bool,
                     canon_out: bool = False):
    """True radix-8 DIT butterfly over blocks of 8m (axis -2).

    Scaled-DIT factorization: with t_j = omega_{8m}^j, pre-scale
    u_q = x_q * t^{bitrev3(q)} (7 general multiplies per 8 elements;
    exponents (0,4,2,6,1,5,3,7)), then three mul-free DFT-2 layers whose
    internal factors are the 8-point DFT twiddles — i = 2^48 on layer 2
    and (omega_8, i, omega_8^3) = (-2^24, 2^48, -2^72) on layer 3
    (inverse direction: (2^72, -2^48, 2^24)) — all shift-class multiplies.
    """
    lo, hi = x
    batch = lo.shape[:-2]
    w = lo.shape[-1]
    shape = batch + (n // (8 * m), 8, m, w)
    lo = lo.reshape(shape)
    hi = hi.reshape(shape)
    xq = [(lo[..., q, :, :], hi[..., q, :, :]) for q in range(8)]
    if trivial:
        u = xq
    else:
        tw = [_tw_ax2(t) for t in tabs]  # tw[e-1] = t^e
        exps = (None, 4, 2, 6, 1, 5, 3, 7)  # bitrev3(q)
        u = [xq[0]]
        for q in range(1, 8):
            u.append(gf.mul_lazy(xq[q], tw[exps[q] - 1]))
    # layer 1: adjacent pairs, factor 1
    v = []
    for q in range(0, 8, 2):
        v.append(gf.add_lazy(u[q], u[q + 1]))
        v.append(gf.sub_lazy(u[q], u[q + 1]))
    # layer 2: stride 2, factors (1, i)
    iv3 = gf.mul_by_i_lazy(v[3], inverse)
    iv7 = gf.mul_by_i_lazy(v[7], inverse)
    wv = [
        gf.add_lazy(v[0], v[2]), gf.add_lazy(v[1], iv3),
        gf.sub_lazy(v[0], v[2]), gf.sub_lazy(v[1], iv3),
        gf.add_lazy(v[4], v[6]), gf.add_lazy(v[5], iv7),
        gf.sub_lazy(v[4], v[6]), gf.sub_lazy(v[5], iv7),
    ]
    # layer 3: stride 4, factors (1, w8, i, w8^3)
    if inverse:
        s5 = gf.mul_by_pow2_lazy(wv[5], 72)            # w8^-1 = 2^72
        s7 = gf.mul_by_pow2_lazy(wv[7], 24)            # w8^-3 = 2^24
    else:
        s5 = gf.mul_by_pow2_lazy(wv[5], 24, negate=True)   # w8 = -2^24
        s7 = gf.mul_by_pow2_lazy(wv[7], 72, negate=True)   # w8^3 = -2^72
    s6 = gf.mul_by_i_lazy(wv[6], inverse)
    y = [
        gf.add_lazy(wv[0], wv[4]), gf.add_lazy(wv[1], s5),
        gf.add_lazy(wv[2], s6), gf.add_lazy(wv[3], s7),
        gf.sub_lazy(wv[0], wv[4]), gf.sub_lazy(wv[1], s5),
        gf.sub_lazy(wv[2], s6), gf.sub_lazy(wv[3], s7),
    ]
    if canon_out:
        y = [gf.canon(p) for p in y]
    out_shape = batch + (n, w)
    return (
        jnp.stack([p[0] for p in y], axis=-3).reshape(out_shape),
        jnp.stack([p[1] for p in y], axis=-3).reshape(out_shape),
    )


def _radix4_true_ax2(x, tq, m, n, inverse: bool, trivial: bool,
                     canon_out: bool = False):
    """True radix-4 DIT butterfly over blocks of 4m (see module comment).

    With t_j = omega_{4m}^j the composition of the two radix-2 stages
    (m, 2m) equals
        u0 = a, u1 = t*c, u2 = t^2*b, u3 = t^3*d
        e0 = u0+u2, e1 = u0-u2, o0 = u1+u3, o1 = i*(u1-u3)
        (y0, y1, y2, y3) = (e0+o0, e1+o1, e0-o0, e1-o1)
    where (a, b, c, d) sit at offsets (0, m, 2m, 3m). When m == 1 all three
    twiddles are 1 (`trivial`), leaving only the i-multiply.
    """
    lo, hi = x
    batch = lo.shape[:-2]
    w = lo.shape[-1]
    shape = batch + (n // (4 * m), 4, m, w)
    lo = lo.reshape(shape)
    hi = hi.reshape(shape)
    a = (lo[..., 0, :, :], hi[..., 0, :, :])
    b = (lo[..., 1, :, :], hi[..., 1, :, :])
    c = (lo[..., 2, :, :], hi[..., 2, :, :])
    d = (lo[..., 3, :, :], hi[..., 3, :, :])
    if trivial:
        u1, u2, u3 = c, b, d
    else:
        t, t2, t3 = (_tw_ax2(v) for v in tq)
        u1 = gf.mul_lazy(c, t)
        u2 = gf.mul_lazy(b, t2)
        u3 = gf.mul_lazy(d, t3)
    e0 = gf.add_lazy(a, u2)
    e1 = gf.sub_lazy(a, u2)
    o0 = gf.add_lazy(u1, u3)
    o1 = gf.mul_by_i_lazy(gf.sub_lazy(u1, u3), inverse)
    y0 = gf.add_lazy(e0, o0)
    y2 = gf.sub_lazy(e0, o0)
    y1 = gf.add_lazy(e1, o1)
    y3 = gf.sub_lazy(e1, o1)
    if canon_out:
        y0, y1, y2, y3 = (gf.canon(y) for y in (y0, y1, y2, y3))
    out_shape = batch + (n, w)
    return (
        jnp.stack([y0[0], y1[0], y2[0], y3[0]], axis=-3).reshape(out_shape),
        jnp.stack([y0[1], y1[1], y2[1], y3[1]], axis=-3).reshape(out_shape),
    )


@functools.lru_cache(maxsize=None)
def _jitted_ntt(log_n: int, inverse: bool):
    n_inv = pow(1 << log_n, P - 2, P)

    @jax.jit
    def run(lo, hi):
        out_lo, out_hi = _ntt_core((lo, hi), log_n, inverse)
        if inverse:
            out_lo, out_hi = gf.mul_const((out_lo, out_hi), n_inv)
        return out_lo, out_hi

    return run


def ntt_limbs_traceable(x, inverse: bool = False, four_step_diag=None):
    """Trace-composable last-axis NTT (no jit wrapper; tables are numpy
    constants closed over by the caller's trace).

    Above the four-step threshold pass ``four_step_diag`` (the matching
    `_four_step_diag_device(log_n, inverse)` pair, fetched OUTSIDE jit and
    threaded through as arguments rather than captured as a 32 MB
    constant at 2^22) to run the slab-mapped four-step instead of the
    plain last-axis core; without it, large traced transforms fall back to
    the last-axis core, whose every butterfly layer is a pass over device
    memory."""
    lo, hi = x
    log_n = _check_len(lo.shape[-1])
    if lo.shape[-1] <= 1:
        return x
    if four_step_diag is not None and log_n >= FOUR_STEP_THRESHOLD_LOG2:
        return four_step_ntt_traceable(x, log_n, inverse, four_step_diag)
    out = _ntt_core((lo, hi), log_n, inverse)
    if inverse:
        out = gf.mul_const(out, pow(1 << log_n, P - 2, P))
    return out


# -- public table helpers (reference ntt.rs:239-324 parity) -----------------


def swap_indices(length: int) -> list:
    """Bit-reversal swap targets, reference semantics (ntt.rs:239-284):
    entry k is rev(k) when k < rev(k) — i.e. the pairs an in-place
    implementation would swap — else None. The batched device path uses
    the full permutation (one gather) instead; this helper exists for
    API parity and host-side tooling."""
    log_n = _check_len(length)
    if length <= 1:
        return [None] * length
    rev = _bit_reverse_permutation(log_n)
    return [int(rev[k]) if k < int(rev[k]) else None for k in range(length)]


def twiddle_factors(slice_len: int, root_of_unity: int) -> list:
    """Per-stage twiddle tables: stage s holds m=2^s powers of root^(n/2m)
    (ntt.rs:309-324). `root_of_unity` is a canonical value (int or
    BFieldElement); returns a list of numpy uint64 arrays."""
    root = int(getattr(root_of_unity, "value", lambda: root_of_unity)())
    log_n = _check_len(slice_len)
    out = []
    for s in range(log_n):
        m = 1 << s
        w_m = pow(root, slice_len // (2 * m), P)
        out.append(gfn.powers(w_m, m))
    return out


# Above this size the four-step (Bailey) decomposition wins: two small
# batched local transforms instead of log2(n) full-array butterfly passes —
# far less XLA compile time and fewer device-memory round trips.
FOUR_STEP_THRESHOLD_LOG2 = 17


def _four_step_split(log_n: int) -> tuple[int, int]:
    log_n1 = log_n // 2
    return log_n1, log_n - log_n1


@functools.lru_cache(maxsize=None)
def _four_step_diag_host(log_n: int, inverse: bool, dif: bool = False,
                         split: tuple[int, int] | None = None,
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Diagonal twiddles w^(j1*k2) as an (n2, n1) uint32 limb pair.

    With ``dif`` the rows are bit-reverse permuted to match the DIF first
    pass, whose physical row r holds k2 = bitrev(r). ``split`` overrides
    the default square (log_n1, log_n2) factorization."""
    from . import gf_numpy as gfn

    log_n1, log_n2 = split if split is not None else _four_step_split(log_n)
    n1, n2 = 1 << log_n1, 1 << log_n2
    root = PRIMITIVE_ROOTS[1 << log_n]
    if inverse:
        root = pow(root, P - 2, P)
    j1 = gfn.powers(root, n1)
    out = np.empty((n2, n1), dtype=np.uint64)
    out[0] = 1
    for k2 in range(1, n2):
        out[k2] = gfn.mul(out[k2 - 1], j1)
    if dif:
        out = out[_bit_reverse_permutation(log_n2)]
    return ((out & np.uint64(0xFFFF_FFFF)).astype(np.uint32),
            (out >> np.uint64(32)).astype(np.uint32))


@functools.lru_cache(maxsize=None)
def _four_step_diag_device(log_n: int, inverse: bool, dif: bool | None = None):
    if dif is None:
        dif = _USE_DIF
    lo, hi = _four_step_diag_host(log_n, inverse, dif)
    return jnp.asarray(lo), jnp.asarray(hi)


# Lane width of one slab in the slab-mapped local passes, and the minimum
# transform size at which slabbing is used. Each lax.map step runs the full
# butterfly pipeline of one (n, _SLAB) slab, so the slab's stages stay in
# fast memory between layers. On an NVIDIA H100 (400 W limit) the 2^24
# four-step forward transform takes 9.30 ms slab-mapped against 13.90 ms
# unslabbed, so slabbing stays the path for large transforms.
_SLAB = 128
_SLAB_MIN_ELEMS = 1 << 22


def _local_pass(x, log_len: int, inverse: bool, diag=None, post_const=None,
                transpose_in: bool = False, dif: bool = False,
                norev: bool = False):
    """NTT over axis -2 of (..., n, w) limb planes, slab-mapped over the lane
    axis when the matrix is large. Optionally fuses a pointwise multiply by
    ``diag`` ((n, w) limb planes) and/or by a python-int ``post_const`` into
    the same pass, saving full device-memory round trips.

    With ``transpose_in=True`` the input is (..., w, n) — the *rows* are
    slabbed and each slab is transposed inside the map body, so the matrix
    transpose between the two four-step passes costs no separate round
    trip through device memory.

    ``dif`` selects the Gentleman-Sande core (natural input, bit-reversed
    output, no gather); ``norev`` the gatherless DIT core (bit-reversed
    input, natural output, no gather) — the two halves of the orderless
    convolution path."""
    lo, hi = x
    w = lo.shape[-1] if not transpose_in else lo.shape[-2]

    def finish(out):
        if diag is not None:
            out = gf.mul(out, diag)
        if post_const is not None:
            out = gf.mul_const(out, post_const)
        return out

    if dif:
        core = _ntt_core_ax2_dif
    elif norev:
        core = _ntt_core_ax2_norev
    else:
        core = _ntt_core_ax2
    if w % _SLAB or lo.size < _SLAB_MIN_ELEMS:
        if transpose_in:
            lo, hi = jnp.swapaxes(lo, -1, -2), jnp.swapaxes(hi, -1, -2)
        return finish(core((lo, hi), log_len, inverse))
    nslab = w // _SLAB

    batch = lo.shape[:-2]
    bsz = int(np.prod(batch)) if batch else 1
    if bsz > 1:
        # Batched matrices: fold the batch into the slab-map axis so each
        # map body stays a single (len, _SLAB) matrix. Leaving the batch
        # inside the body multiplies its working set by the batch.
        # Index-free operands (diag/post_const) apply OUTSIDE the map as
        # one full-array pass (diag cannot ride the map: it has no batch
        # axis, and tiling it would materialize batch copies).
        n_len = lo.shape[-2] if not transpose_in else lo.shape[-1]

        def to_slabs_b(a):
            if transpose_in:
                a = a.reshape(bsz, nslab, _SLAB, n_len)
                return a.reshape(bsz * nslab, _SLAB, n_len)
            a = a.reshape(bsz, n_len, nslab, _SLAB)
            a = jnp.transpose(a, (0, 2, 1, 3))
            return a.reshape(bsz * nslab, n_len, _SLAB)

        def from_slabs_b(a):
            a = a.reshape(bsz, nslab, n_len, _SLAB)
            a = jnp.transpose(a, (0, 2, 1, 3))
            return a.reshape(batch + (n_len, w))

        def body_b(args):
            slo, shi = args
            if transpose_in:
                slo = jnp.swapaxes(slo, -1, -2)
                shi = jnp.swapaxes(shi, -1, -2)
            return core((slo, shi), log_len, inverse)

        olo, ohi = jax.lax.map(body_b, (to_slabs_b(lo), to_slabs_b(hi)))
        return finish((from_slabs_b(olo), from_slabs_b(ohi)))

    def to_slabs(a):
        if transpose_in:
            # (..., w, n): split rows w into slabs; the body transposes
            a = a.reshape(a.shape[:-2] + (nslab, _SLAB) + a.shape[-1:])
            return jnp.moveaxis(a, -3, 0)  # (nslab, ..., _SLAB, n)
        a = a.reshape(a.shape[:-1] + (nslab, _SLAB))
        return jnp.moveaxis(a, -2, 0)  # (nslab, ..., n, _SLAB)

    def from_slabs(a):
        a = jnp.moveaxis(a, 0, -2)
        return a.reshape(a.shape[:-2] + (w,))

    def to_slabs_out(a):
        # diag contract: given in the pass's OUTPUT layout (n, w), slabbed
        # over the lane axis regardless of transpose_in (whose reshape is
        # for the differently-shaped input)
        a = a.reshape(a.shape[:-1] + (nslab, _SLAB))
        return jnp.moveaxis(a, -2, 0)

    operands = [to_slabs(lo), to_slabs(hi)]
    if diag is not None:
        operands += [to_slabs_out(diag[0]), to_slabs_out(diag[1])]

    def body(args):
        slo, shi = args[0], args[1]
        if transpose_in:
            slo = jnp.swapaxes(slo, -1, -2)
            shi = jnp.swapaxes(shi, -1, -2)
        out = core((slo, shi), log_len, inverse)
        if diag is not None:
            out = gf.mul(out, (args[2], args[3]))
        if post_const is not None:
            out = gf.mul_const(out, post_const)
        return out

    olo, ohi = jax.lax.map(body, tuple(operands))
    return from_slabs(olo), from_slabs(ohi)


# -- DIF (Gentleman-Sande) stages: natural-order input, bit-reversed output,
# NO input gather. Used by the DIF four-step (one final combined un-reverse
# gather instead of two per-pass input gathers) and by NTT-domain
# convolution paths, where the bit-reversed intermediate order cancels
# entirely (pointwise products are order-agnostic and the DIT stages accept
# bit-reversed input without a gather).


def _radix4_dif_ax2(x, tq, m, n, inverse: bool, trivial: bool,
                    canon_out: bool = False):
    """Radix-4 DIF butterfly at stride m over axis -2 (blocks of 4m).

    Transpose of the DIT butterfly with the same (t, t2, t3) tables. The
    DIT butterfly reads its q-indexed inputs from slots (0, 2, 1, 3); the
    DIF adjoint therefore WRITES its q-indexed outputs to slots (0, 2, 1, 3):
        s0 = a + c, s1 = b + d, d0 = a - c, d1 = i*(b - d)
        slot0 = s0 + s1         (q=0)
        slot1 = (s0 - s1) * t2  (q=2)
        slot2 = (d0 + d1) * t   (q=1)
        slot3 = (d0 - d1) * t3  (q=3)
    """
    lo, hi = x
    batch = lo.shape[:-2]
    w = lo.shape[-1]
    shape = batch + (n // (4 * m), 4, m, w)
    lo = lo.reshape(shape)
    hi = hi.reshape(shape)
    a = (lo[..., 0, :, :], hi[..., 0, :, :])
    b = (lo[..., 1, :, :], hi[..., 1, :, :])
    c = (lo[..., 2, :, :], hi[..., 2, :, :])
    d = (lo[..., 3, :, :], hi[..., 3, :, :])
    s0 = gf.add_lazy(a, c)
    s1 = gf.add_lazy(b, d)
    d0 = gf.sub_lazy(a, c)
    d1 = gf.mul_by_i_lazy(gf.sub_lazy(b, d), inverse)
    y0 = gf.add_lazy(s0, s1)
    y1 = gf.sub_lazy(s0, s1)
    y2 = gf.add_lazy(d0, d1)
    y3 = gf.sub_lazy(d0, d1)
    if not trivial:
        t, t2, t3 = (_tw_ax2(v) for v in tq)
        y1 = gf.mul_lazy(y1, t2)
        y2 = gf.mul_lazy(y2, t)
        y3 = gf.mul_lazy(y3, t3)
    if canon_out:
        y0, y1, y2, y3 = (gf.canon(y) for y in (y0, y1, y2, y3))
    out_shape = batch + (n, w)
    return (
        jnp.stack([y0[0], y1[0], y2[0], y3[0]], axis=-3).reshape(out_shape),
        jnp.stack([y0[1], y1[1], y2[1], y3[1]], axis=-3).reshape(out_shape),
    )


def _radix2_last_dif_ax2(x, n, canon_out: bool = False):
    """Mul-free radix-2 DIF stage at m=1 (odd stage counts end with it)."""
    lo, hi = x
    batch = lo.shape[:-2]
    w = lo.shape[-1]
    shape = batch + (n // 2, 2, w)
    lo = lo.reshape(shape)
    hi = hi.reshape(shape)
    u = (lo[..., 0, :], hi[..., 0, :])
    v = (lo[..., 1, :], hi[..., 1, :])
    top = gf.add_lazy(u, v)
    bot = gf.sub_lazy(u, v)
    if canon_out:
        top, bot = gf.canon(top), gf.canon(bot)
    out_shape = batch + (n, w)
    return (
        jnp.stack([top[0], bot[0]], axis=-2).reshape(out_shape),
        jnp.stack([top[1], bot[1]], axis=-2).reshape(out_shape),
    )


def _ntt_stages_ax2_dif(st, log_n: int, inverse: bool,
                        canon_out: bool = False):
    """DIF butterfly stages on NATURAL-order axis(-2) input; output in
    bit-reversed order. Same (t, t2, t3) tables as the DIT plan, processed
    in reverse (m descending)."""
    _, plan = _device_tables_mixed(log_n, inverse, radix8=False)
    n = st[0].shape[-2]
    rev = list(reversed(plan))
    for idx, (kind, tabs, m, trivial) in enumerate(rev):
        last = canon_out and idx == len(rev) - 1
        if kind == "r2":
            st = _radix2_last_dif_ax2(st, n, canon_out=last)
        else:
            st = _radix4_dif_ax2(st, tabs, m, n, inverse, trivial,
                                 canon_out=last)
    return st


def _ntt_core_ax2_dif(x, log_n: int, inverse: bool):
    """Axis(-2) NTT core, DIF variant: NO input gather; canonical output in
    BIT-REVERSED order along axis -2."""
    return _ntt_stages_ax2_dif(x, log_n, inverse, canon_out=True)


def _ntt_core_ax2_norev(x, log_n: int, inverse: bool):
    """Axis(-2) NTT core on input ALREADY in bit-reversed order: the DIT
    butterfly stages without their input gather. Natural-order output."""
    return _ntt_stages_ax2(x, log_n, inverse, canon_out=True)


@functools.lru_cache(maxsize=None)
def _four_step_unreverse_idx(log_n: int) -> np.ndarray:
    """Flat int32 gather index mapping the DIF four-step's physical output
    Z[r1, r2] = X[bitrev(r1), bitrev(r2)] back to natural order: position
    k = k2 + n2*k1 reads flat Z index bitrev(k1)*n2 + bitrev(k2)."""
    log_n1, log_n2 = _four_step_split(log_n)
    n1, n2 = 1 << log_n1, 1 << log_n2
    r1 = _bit_reverse_permutation(log_n1).astype(np.int64)
    r2 = _bit_reverse_permutation(log_n2).astype(np.int64)
    idx = (r1[:, None] * n2 + r2[None, :]).reshape(-1)
    return idx.astype(np.int32)


def four_step_ntt_traceable(x, log_n: int, inverse: bool, diag):
    """Trace-composable four-step NTT over the last axis of (..., n) planes.

    X[k2 + n2*k1] = NTT_n1( w^(j1*k2) * NTT_n2( x[j1 + n1*j2] )_{j2} )_{j1}

    Both local transforms run over axis -2 (the _ntt_core_ax2 core) so the
    other factor of the (n2, n1) matrix stays the minor (lane) dimension —
    full VPU width at every butterfly stage, no tiny-stride early stages,
    and only ONE physical transpose in the whole pipeline. Large passes are
    slab-mapped (see _local_pass) with the diagonal twiddle multiply fused
    into the first pass and the iNTT 1/n scaling into the second.
    """
    lo, hi = x
    log_n1, log_n2 = _four_step_split(log_n)
    n1, n2 = 1 << log_n1, 1 << log_n2
    batch = lo.shape[:-1]
    if _USE_W64 and not _USE_DIF:
        # native-u64 core: pack the planes (fuses into the first gather),
        # run the same four-step on one u64 plane, unpack at the end.
        d64 = diag if not isinstance(diag, tuple) else gf64.pack(
            (diag[0].reshape(n2, n1), diag[1].reshape(n2, n1)))
        out = four_step_ntt_w64(gf64.pack((lo, hi)), log_n, inverse, d64)
        return gf64.unpack(out)
    lo = lo.reshape(batch + (n2, n1))
    hi = hi.reshape(batch + (n2, n1))
    if _USE_DIF:
        # DIF passes: no input gathers; output lands bit-reversed on BOTH
        # matrix axes; ONE combined flat gather restores natural order.
        # `diag` must come from _four_step_diag_device with dif=True
        # (bit-reverse-permuted rows).
        y = _local_pass((lo, hi), log_n2, inverse, diag=diag, dif=True)
        n_inv = pow(1 << log_n, P - 2, P) if inverse else None
        z = _local_pass(y, log_n1, inverse, post_const=n_inv,
                        transpose_in=True, dif=True)
        idx = _four_step_unreverse_idx(log_n)
        zlo = jnp.take(z[0].reshape(batch + (n1 * n2,)), idx, axis=-1)
        zhi = jnp.take(z[1].reshape(batch + (n1 * n2,)), idx, axis=-1)
        return zlo, zhi
    # column NTTs (over j2 = axis -2, lanes = n1) -> Y[k2, j1], fused with
    # the diagonal twiddle w^(j1*k2), laid out (n2, n1) to match Y
    y = _local_pass((lo, hi), log_n2, inverse, diag=diag)
    # row NTTs over j1 -> Z[k1, k2], which flattens to natural order
    # k2 + n2*k1. transpose_in slabs the rows of Y and transposes each slab
    # in the map body, so the four-step's matrix transpose rides the same
    # pass.
    n_inv = pow(1 << log_n, P - 2, P) if inverse else None
    z = _local_pass(y, log_n1, inverse, post_const=n_inv, transpose_in=True)
    zlo = z[0].reshape(batch + (n1 * n2,))
    zhi = z[1].reshape(batch + (n1 * n2,))
    return zlo, zhi


@functools.lru_cache(maxsize=None)
def _jitted_four_step(log_n: int, inverse: bool):
    @functools.partial(jax.jit)
    def run(lo, hi, diag_lo, diag_hi):
        return four_step_ntt_traceable((lo, hi), log_n, inverse,
                                       (diag_lo, diag_hi))

    return run


# -- orderless (scrambled-order) convolution path ----------------------------
#
# In NTT-domain convolution — forward transform, pointwise combine, inverse
# transform — the order of the intermediate values is irrelevant, so every
# bit-reverse gather cancels (DESIGN.md §8):
#
#   * forward: DIF (Gentleman-Sande) local passes, NO input gathers; the
#     output lands in "scrambled" order — both axes of the four-step's
#     (n1, n2) output matrix bit-reverse permuted:
#         scrambled[n2*r1 + r2] = natural[n2*brev(r1) + brev(r2)]
#     This permutation is its own inverse (brev is an involution on each
#     factor), and equals _four_step_unreverse_idx.
#   * inverse: the DIT butterfly stages natively EXPECT bit-reversed input,
#     so feeding them the scrambled layout without their input gather
#     produces natural-order output — again NO gathers.
#
# Matches the round-trip structure of the reference's fast multiply /
# clean divide / NTT-friendly reduction (polynomial.rs:900-932, 2334-2413,
# 1087-1142), which pay the bit-reversal twice per transform instead.


def scrambled_index(log_n: int) -> np.ndarray:
    """The scrambled<->natural permutation of the orderless convolution
    domain (an involution): natural[k] = scrambled[scrambled_index[k]] and
    vice versa. Identity semantics only for log_n >= 2 (four-step layout)."""
    return _four_step_unreverse_idx(log_n)


@functools.lru_cache(maxsize=None)
def _scrambled_diag_host(log_n: int, inverse: bool):
    if not inverse:
        # forward: DIF pass-1 rows are bit-reversed k2 (dif=True layout)
        return _four_step_diag_host(log_n, False, dif=True)
    # inverse: the diagonal multiplies AFTER the first (n1-axis) inverse
    # pass, where the matrix is (j1 natural, r2 = brev(k2)): table value at
    # (j1, r2) is w^-(j1 * brev(r2)) — the transpose of the dif-permuted
    # (n2, n1) inverse table.
    lo, hi = _four_step_diag_host(log_n, True, dif=True)
    return np.ascontiguousarray(lo.T), np.ascontiguousarray(hi.T)


@functools.lru_cache(maxsize=None)
def _scrambled_diag_device(log_n: int, inverse: bool):
    lo, hi = _scrambled_diag_host(log_n, inverse)
    return jnp.asarray(lo), jnp.asarray(hi)


def four_step_ntt_scrambled(x, log_n: int, inverse: bool, diag):
    """Trace-composable four-step NTT with NO bit-reverse gathers.

    Forward: natural-order (..., n) input -> scrambled-order output.
    Inverse: scrambled-order input -> natural-order output (incl. 1/n).
    ``diag`` must come from _scrambled_diag_device(log_n, inverse).
    Composes with any elementwise combine in between: the scrambled order
    cancels exactly (see module comment above)."""
    lo, hi = x
    log_n1, log_n2 = _four_step_split(log_n)
    n1, n2 = 1 << log_n1, 1 << log_n2
    batch = lo.shape[:-1]
    if not inverse:
        lo = lo.reshape(batch + (n2, n1))
        hi = hi.reshape(batch + (n2, n1))
        # DIF column pass (over j2; diag rows pre-permuted to brev(k2)),
        # then DIF row pass over j1: output (n1, n2) with both axes brev.
        y = _local_pass((lo, hi), log_n2, False, diag=diag, dif=True)
        z = _local_pass(y, log_n1, False, transpose_in=True, dif=True)
    else:
        # input matrix (n1, n2): rows brev(k1), columns brev(k2)
        lo = lo.reshape(batch + (n1, n2))
        hi = hi.reshape(batch + (n1, n2))
        # gatherless DIT pass over the k1 axis -> j1 natural; fuse the
        # inverse diagonal w^-(j1*brev(k2)); then gatherless DIT pass over
        # the k2 axis -> j2 natural. Output (n2, n1) flattens naturally.
        w = _local_pass((lo, hi), log_n1, True, diag=diag, norev=True)
        n_inv = pow(1 << log_n, P - 2, P)
        z = _local_pass(w, log_n2, True, post_const=n_inv,
                        transpose_in=True, norev=True)
    return (z[0].reshape(batch + (n1 * n2,)),
            z[1].reshape(batch + (n1 * n2,)))


# -- split-generalized scrambled entries --------------------------------------
#
# The scrambled-interior LDE (DESIGN.md §8, pipeline.trace_lde_commit_scrambled)
# needs the DIF/norev four-step passes with (a) the twiddle
# direction decoupled from the order direction (an iNTT whose output stays
# scrambled), (b) an explicit non-square split, and (c) elementwise
# multiplies fused into the second pass. Key identity: choosing the big
# transform's split as (log_n1 + log_expansion, log_n2) makes zero-padding
# in scrambled order a pure reshape+pad row interleave —
#     brev_{L1+e}(r1 * 2^e) = brev_{L1}(r1), and padding occupies exactly
#     the rows r1' with nonzero low e bits —
# so the whole interpolate→extend→evaluate chain runs with ZERO gathers.


@functools.lru_cache(maxsize=None)
def _diag_device_general(log_n: int, inverse: bool, dif: bool,
                         split: tuple[int, int]):
    lo, hi = _four_step_diag_host(log_n, inverse, dif, split)
    return jnp.asarray(lo), jnp.asarray(hi)


@functools.lru_cache(maxsize=None)
def _norev_diag_host(log_n: int, inverse: bool, split: tuple[int, int]):
    """Diagonal for the gatherless-DIT (norev) first pass at an explicit
    split: (n1, n2) table, value[j1, r2] = root^(±j1 * brev_{log_n2}(r2))
    — the transpose of the dif-permuted (n2, n1) table."""
    lo, hi = _four_step_diag_host(log_n, inverse, dif=True, split=split)
    return np.ascontiguousarray(lo.T), np.ascontiguousarray(hi.T)


@functools.lru_cache(maxsize=None)
def _norev_diag_device(log_n: int, inverse: bool, split: tuple[int, int]):
    lo, hi = _norev_diag_host(log_n, inverse, split)
    return jnp.asarray(lo), jnp.asarray(hi)


def four_step_dif_general(x, log_n: int, inverse: bool, diag,
                          split=None, post_diag=None, post_const=None):
    """Natural-order (..., n) input -> scrambled output (matrix (n1, n2)
    flattened, both axes bit-reversed: flat position r1*n2 + r2 holds
    natural index brev(r2) + n2*brev(r1)).

    ``inverse`` selects the TWIDDLE direction only (no 1/n scaling, no
    reordering — fuse 1/n via post_const or post_diag). ``diag`` must be
    _diag_device_general(log_n, inverse, dif=True, split). ``post_diag``
    ((n1, n2) output-layout device pair) and ``post_const`` fuse
    elementwise multiplies into the second pass."""
    lo, hi = x
    log_n1, log_n2 = split if split is not None else _four_step_split(log_n)
    n1, n2 = 1 << log_n1, 1 << log_n2
    batch = lo.shape[:-1]
    lo = lo.reshape(batch + (n2, n1))
    hi = hi.reshape(batch + (n2, n1))
    y = _local_pass((lo, hi), log_n2, inverse, diag=diag, dif=True)
    z = _local_pass(y, log_n1, inverse, diag=post_diag,
                    post_const=post_const, transpose_in=True, dif=True)
    return (z[0].reshape(batch + (n1 * n2,)),
            z[1].reshape(batch + (n1 * n2,)))


def four_step_norev_general(x, log_n: int, inverse: bool, diag,
                            split=None, post_const=None):
    """Scrambled (..., n) input (four_step_dif_general's layout at the
    same split) -> NATURAL-order output; twiddle direction = ``inverse``;
    ``diag`` = _norev_diag_device(log_n, inverse, split). NO gathers in
    either pass."""
    lo, hi = x
    log_n1, log_n2 = split if split is not None else _four_step_split(log_n)
    n1, n2 = 1 << log_n1, 1 << log_n2
    batch = lo.shape[:-1]
    lo = lo.reshape(batch + (n1, n2))
    hi = hi.reshape(batch + (n1, n2))
    w = _local_pass((lo, hi), log_n1, inverse, diag=diag, norev=True)
    z = _local_pass(w, log_n2, inverse, post_const=post_const,
                    transpose_in=True, norev=True)
    return (z[0].reshape(batch + (n1 * n2,)),
            z[1].reshape(batch + (n1 * n2,)))


def _cpu_fusion_break(x):
    """LLVM's backend is superlinear on XLA:CPU's giant fused u32 chains:
    the conv-divide graph at 2^17 took minutes to compile in one fusion.
    Breaking the fusion at stage boundaries keeps CPU compiles fast; no-op
    on accelerator backends, so device graphs keep full fusion (chip_smoke
    phase 2 prints this graph's compile time on the GPU)."""
    if jax.default_backend() == "cpu":
        return jax.lax.optimization_barrier(x)
    return x


# Which in-graph transform the convolution path uses above the four-step
# threshold: the natural-order round trip by default; the scrambled
# (gather-free) variant with TWENTY_FIRST_TPU_CONV_SCRAMBLED=1. Not yet
# compared on the H100 (ROADMAP D2).
def _conv_scrambled() -> bool:
    return os.environ.get("TWENTY_FIRST_TPU_CONV_SCRAMBLED") == "1"


def _conv_diag_args(log_n: int, scrambled: bool):
    """Forward/inverse diagonal limb pairs as a flat 4-tuple of device
    arrays — passed as jit ARGUMENTS, not captured as constants (32 MB at
    2^22). Below the four-step threshold the graph needs no diagonals;
    tiny zero placeholders keep one signature."""
    if log_n >= FOUR_STEP_THRESHOLD_LOG2:
        if scrambled:
            dfwd = _scrambled_diag_device(log_n, False)
            dinv = _scrambled_diag_device(log_n, True)
        else:
            dfwd = _four_step_diag_device(log_n, False)
            dinv = _four_step_diag_device(log_n, True)
        return (dfwd[0], dfwd[1], dinv[0], dinv[1])
    z = jnp.zeros((1,), jnp.uint32)
    return (z, z, z, z)


def _conv_fwd_inv(log_n: int, scrambled: bool, dfl, dfh, dil, dih):
    """(forward, inverse) traceable transforms for the convolution graph:
    four-step above the threshold (natural order by default; scrambled
    gather-free order behind TWENTY_FIRST_TPU_CONV_SCRAMBLED=1), the
    plain last-axis core below it. Diagonal operands come in as traced
    arguments (see _conv_diag_args)."""
    if log_n >= FOUR_STEP_THRESHOLD_LOG2:
        if scrambled:
            return (lambda t: four_step_ntt_scrambled(t, log_n, False,
                                                      (dfl, dfh)),
                    lambda t: four_step_ntt_scrambled(t, log_n, True,
                                                      (dil, dih)))
        return (lambda t: four_step_ntt_traceable(t, log_n, False,
                                                  (dfl, dfh)),
                lambda t: four_step_ntt_traceable(t, log_n, True,
                                                  (dil, dih)))
    return (lambda t: ntt_limbs_traceable(t, inverse=False),
            lambda t: ntt_limbs_traceable(t, inverse=True))


@functools.lru_cache(maxsize=None)
def _jitted_conv(log_n: int, xfield: bool, divide: bool,
                 scrambled: bool = False):
    @jax.jit
    def run(alo, ahi, blo, bhi, dfl, dfh, dil, dih):
        from . import gf_ext

        fwd, inv = _conv_fwd_inv(log_n, scrambled, dfl, dfh, dil, dih)
        fa = _cpu_fusion_break(fwd((alo, ahi)))
        fb = _cpu_fusion_break(fwd((blo, bhi)))
        if xfield:
            if divide:
                fb = _cpu_fusion_break(gf_ext.batch_inversion(fb))
            prod = gf_ext.mul(fa, fb)
        else:
            if divide:
                fb = _cpu_fusion_break(gf.batch_inversion(fb))
            prod = gf.mul(fa, fb)
        return inv(_cpu_fusion_break(prod))

    return run


@functools.lru_cache(maxsize=None)
def _jitted_conv_table(log_n: int, xfield: bool, table_xfield: bool,
                       scrambled: bool = False):
    @jax.jit
    def run(alo, ahi, tlo, thi, dfl, dfh, dil, dih):
        from . import gf_ext

        fwd, inv = _conv_fwd_inv(log_n, scrambled, dfl, dfh, dil, dih)
        fa = _cpu_fusion_break(fwd((alo, ahi)))
        if xfield and table_xfield:
            prod = gf_ext.mul(fa, (tlo, thi))
        else:
            # base-field table broadcasts over the (3, n) component axis
            prod = gf.mul(fa, (tlo, thi))
        return inv(_cpu_fusion_break(prod))

    return run


# One-shot convolutions: up to this many elements the host-native round
# trip runs, above it one jitted device graph (3 transfers instead of the
# 6 of three ntt_values calls). The value dates from an earlier accelerator
# and is not yet measured on the H100 (ROADMAP S6); override with
# TWENTY_FIRST_TPU_HOST_CONV_MAX_ELEMS.
HOST_CONV_MAX_ELEMS = int(os.environ.get(
    "TWENTY_FIRST_TPU_HOST_CONV_MAX_ELEMS",
    os.environ.get("TWENTY_FIRST_TPU_HOST_NTT_MAX_ELEMS", str(1 << 22))))


def _conv_host(a: np.ndarray, b, xfield: bool, divide: bool,
               table=None) -> np.ndarray:
    """Host-numpy/native form of conv_values / conv_table_values: plain
    natural-order NTT round trip through ntt_host (which itself routes to
    the native C++ row kernel when available)."""
    if xfield:
        from . import xgf_numpy as xgfn

        fa = np.swapaxes(ntt_host(np.swapaxes(a, -1, -2)), -1, -2)
        if table is not None:
            ft = table
            prod = xgfn.mul(fa, ft) if ft.ndim >= 2 and ft.shape[-1] == 3 \
                else xgfn.mul_base(fa, ft)
        else:
            fb = np.swapaxes(ntt_host(np.swapaxes(b, -1, -2)), -1, -2)
            if divide:
                fb = xgfn.inverse(fb)
            prod = xgfn.mul(fa, fb)
        return np.swapaxes(
            ntt_host(np.swapaxes(prod, -1, -2), inverse=True), -1, -2)
    fa = ntt_host(a)
    if table is not None:
        prod = gfn.mul(fa, table)
    else:
        fb = ntt_host(b)
        if divide:
            fb = gfn.inverse(fb)
        prod = gfn.mul(fa, fb)
    return ntt_host(prod, inverse=True)


def conv_values(a: np.ndarray, b: np.ndarray, *, xfield: bool = False,
                divide: bool = False) -> np.ndarray:
    """Full NTT-domain convolution: intt(ntt(a) * ntt(b)) — or
    `* ntt(b)^-1` with ``divide``.

    Large inputs run on device in ONE jitted graph: one host->device
    transfer per operand and one device->host for the result (vs three
    round trips through ntt_values). The in-graph transform is the
    natural-order four-step (see _conv_scrambled); small inputs stay
    on the host-native kernel (same crossover rationale as ntt_values).
    a, b: equal-shape uint64 arrays — (..., n) base-field, or (..., n, 3)
    extension-field when ``xfield``. Cyclic convolution over the last
    value axis; callers zero-pad."""
    from . import gf_ext

    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    if a.size <= HOST_CONV_MAX_ELEMS:
        _check_len(a.shape[-2] if xfield else a.shape[-1])
        return _conv_host(a, b, xfield, divide)
    scr = _conv_scrambled()
    if xfield:
        al, bl = gf_ext.to_limbs(a), gf_ext.to_limbs(b)
        log_n = _check_len(a.shape[-2])
        out = _jitted_conv(log_n, True, divide, scr)(
            al[0], al[1], bl[0], bl[1], *_conv_diag_args(log_n, scr))
        return gf_ext.from_limbs(out)
    log_n = _check_len(a.shape[-1])
    al, bl = gf.to_limbs(a), gf.to_limbs(b)
    out = _jitted_conv(log_n, False, divide, scr)(
        al[0], al[1], bl[0], bl[1], *_conv_diag_args(log_n, scr))
    return gf.from_limbs(out)


def conv_table_prepare(table_values: np.ndarray, *, xfield: bool = False):
    """Natural-order NTT values -> a prepared table for repeated
    conv_table_values calls (the reference's reduce_by_ntt_friendly_modulus
    pattern, polynomial.rs:1087-1142). Large tables become device limb
    planes in the convolution domain's order (natural by default;
    pre-permuted when the scrambled experiment is enabled); small tables
    stay natural-order host arrays for the host-native round trip.
    table_values: (n,) base-field or (n, 3) extension-field."""
    from . import gf_ext

    arr = np.asarray(table_values, dtype=np.uint64)
    n = arr.shape[-2] if xfield else arr.shape[-1]
    log_n = _check_len(n)
    if arr.size <= HOST_CONV_MAX_ELEMS:
        return ("host", arr, False)
    scr = _conv_scrambled()
    if scr and log_n >= FOUR_STEP_THRESHOLD_LOG2:
        idx = scrambled_index(log_n)
        arr = arr[idx] if not xfield else arr[idx, :]
    return ("dev", gf_ext.to_limbs(arr) if xfield else gf.to_limbs(arr),
            scr)


def conv_table_values(a: np.ndarray, table, *, xfield: bool = False,
                      table_xfield: bool = False) -> np.ndarray:
    """intt(ntt(a) * table) with ``table`` from conv_table_prepare —
    one jitted graph on device (no gathers above the four-step threshold),
    or the host-native round trip for small prepared tables.
    a: (..., n) base-field or (..., n, 3) extension-field."""
    from . import gf_ext

    kind, payload, scr = table
    if kind == "host":
        a = np.asarray(a, dtype=np.uint64)
        return _conv_host(a, None, xfield, False, table=payload)
    if xfield:
        al = gf_ext.to_limbs(a)
        log_n = _check_len(a.shape[-2])
        out = _jitted_conv_table(log_n, True, table_xfield, scr)(
            al[0], al[1], payload[0], payload[1],
            *_conv_diag_args(log_n, scr))
        return gf_ext.from_limbs(out)
    a = np.asarray(a, dtype=np.uint64)
    log_n = _check_len(a.shape[-1])
    al = gf.to_limbs(a)
    out = _jitted_conv_table(log_n, False, False, scr)(
        al[0], al[1], payload[0], payload[1], *_conv_diag_args(log_n, scr))
    return gf.from_limbs(out)


# -- three-factor (Bailey) decomposition -------------------------------------
#
# Splitting into THREE factors n = C*B*A keeps every local transform
# <= 2^11:
#
#   x[j1 + A*jb + A*B*jc]   (tensor view (C, B, A), j1 minor)
#   1a. NTT_C over jc (axis -3, lanes B*A)               -> Y[kc, jb, j1]
#   1b. per-kc: mul T1[kc, jb] = w_{BC}^{jb*kc};
#       NTT_B over jb (axis -2, lanes A);
#       mul outer diag D[k2, j1] = w_n^{j1*k2}           -> Z[kc, kb, j1]
#       (inner NTT_{BC} output index k2 = kc + C*kb lives at physical row
#        r = kb + B*kc — D is stored host-permuted to this row order)
#   2.  gather rows in k2-natural order (row_perm), transpose each 128-row
#       slab, NTT_A over j1, scale by n^-1 (inverse)
#                                                        -> X[k2 + BC*k1]
#
# Correct and oracle-tested; the dispatcher does not use it (ROADMAP D2).
THREE_STEP_THRESHOLD_LOG2 = None  # disabled for the XLA path (see above)


def _three_step_split(log_n: int) -> tuple[int, int, int]:
    """(log_a, log_b, log_c) with A the lane factor; all <= 2^11 for n <= 2^33."""
    log_a = (log_n + 2) // 3
    rem = log_n - log_a
    log_b = (rem + 1) // 2
    return log_a, log_b, rem - log_b


@functools.lru_cache(maxsize=None)
def _three_step_tables_host(log_n: int, inverse: bool):
    """(t1, diag, row_perm): inner diag (C, B), outer diag (B*C, A) in
    physical row order r = kb + B*kc, and row_perm[k2] = physical row of k2."""
    log_a, log_b, log_c = _three_step_split(log_n)
    a, b, c = 1 << log_a, 1 << log_b, 1 << log_c
    root = PRIMITIVE_ROOTS[1 << log_n]
    if inverse:
        root = pow(root, P - 2, P)
    # T1[kc, jb] = (root^A)^(jb*kc)
    w_bc = pow(root, a, P)
    row = gfn.powers(w_bc, b)
    t1 = np.empty((c, b), dtype=np.uint64)
    t1[0] = 1
    for kc in range(1, c):
        t1[kc] = gfn.mul(t1[kc - 1], row)
    # D[k2, j1] = root^(j1*k2), built in natural k2 order then permuted to
    # physical rows r = kb + B*kc (k2 = kc + C*kb).
    j1 = gfn.powers(root, a)
    d = np.empty((b * c, a), dtype=np.uint64)
    d[0] = 1
    for k2 in range(1, b * c):
        d[k2] = gfn.mul(d[k2 - 1], j1)
    k2_arr = np.arange(b * c, dtype=np.int64)
    row_perm = (k2_arr // c) + b * (k2_arr % c)  # physical row of natural k2
    d_phys = np.empty_like(d)
    d_phys[row_perm] = d
    return (_split_u32(t1), _split_u32(d_phys),
            row_perm.astype(np.int32))


@functools.lru_cache(maxsize=None)
def _three_step_tables_device(log_n: int, inverse: bool):
    t1, diag, row_perm = _three_step_tables_host(log_n, inverse)
    return ((jnp.asarray(t1[0]), jnp.asarray(t1[1])),
            (jnp.asarray(diag[0]), jnp.asarray(diag[1])),
            row_perm)


# Rows per slab in the final (transposed) pass of the three-step NTT.
_ROW_SLAB = 128


def three_step_ntt_traceable(x, log_n: int, inverse: bool, t1, diag, row_perm):
    """Trace-composable three-factor NTT over the last axis (see above)."""
    lo, hi = x
    log_a, log_b, log_c = _three_step_split(log_n)
    a, b, c = 1 << log_a, 1 << log_b, 1 << log_c
    batch = lo.shape[:-1]
    # pass 1a: NTT_C over axis -2, lanes B*A (slab-mapped)
    lo = lo.reshape(batch + (c, b * a))
    hi = hi.reshape(batch + (c, b * a))
    lo, hi = _local_pass((lo, hi), log_c, inverse)
    # pass 1b: map over kc; T1 row on the input side, outer diag on the output
    lo = lo.reshape(batch + (c, b, a))
    hi = hi.reshape(batch + (c, b, a))
    lo, hi = _pass1b((lo, hi), log_b, inverse, t1, diag)
    # pass 2: row-gathered transposed pass, NTT_A over j1
    lo = lo.reshape(batch + (b * c, a))
    hi = hi.reshape(batch + (b * c, a))
    n_inv = pow(1 << log_n, P - 2, P) if inverse else None
    zlo, zhi = _pass2_rows((lo, hi), log_a, inverse, row_perm, n_inv)
    return (zlo.reshape(batch + (a * b * c,)),
            zhi.reshape(batch + (a * b * c,)))


def _pass1b(x, log_b, inverse: bool, t1, diag):
    """Map over axis -3 (kc): input-side T1 mul, NTT over axis -2, output-side
    outer-diag mul. Leading batch dims ride inside the map body (the local
    matrices are small)."""
    lo, hi = x  # (..., C, B, A)
    c = lo.shape[-3]
    b, a = lo.shape[-2], lo.shape[-1]
    t1lo = jnp.asarray(t1[0]).reshape(c, b, 1)
    t1hi = jnp.asarray(t1[1]).reshape(c, b, 1)
    dlo = diag[0].reshape(c, b, a)
    dhi = diag[1].reshape(c, b, a)
    lo3 = jnp.moveaxis(lo, -3, 0)  # (C, ..., B, A); identity when batch = ()
    hi3 = jnp.moveaxis(hi, -3, 0)

    def body(args):
        slo, shi, st1l, st1h, sdl, sdh = args
        st = gf.mul((slo, shi), (st1l, st1h))
        st = _ntt_core_ax2(st, log_b, inverse)
        olo, ohi = gf.mul(st, (sdl, sdh))
        return olo, ohi

    olo, ohi = jax.lax.map(body, (lo3, hi3, t1lo, t1hi, dlo, dhi))
    return jnp.moveaxis(olo, 0, -3), jnp.moveaxis(ohi, 0, -3)


def _pass2_rows(x, log_a, inverse: bool, row_perm, post_const):
    """Final pass: gather rows in k2-natural order slab by slab, transpose
    each slab, transform over the (former) lane axis, and assemble
    lanes back in natural order."""
    lo, hi = x  # (..., R, A)
    r = lo.shape[-2]
    if r % _ROW_SLAB:
        # small/test shapes: single gather + transpose, no slab map
        glo = jnp.take(lo, jnp.asarray(row_perm), axis=-2)
        ghi = jnp.take(hi, jnp.asarray(row_perm), axis=-2)
        out = _ntt_core_ax2((jnp.swapaxes(glo, -1, -2),
                             jnp.swapaxes(ghi, -1, -2)), log_a, inverse)
        if post_const is not None:
            out = gf.mul_const(out, post_const)
        return out
    perm_slabs = jnp.asarray(row_perm.reshape(r // _ROW_SLAB, _ROW_SLAB))

    def body(idx):
        slo = jnp.take(lo, idx, axis=-2)  # (..., _ROW_SLAB, A)
        shi = jnp.take(hi, idx, axis=-2)
        out = _ntt_core_ax2((jnp.swapaxes(slo, -1, -2),
                             jnp.swapaxes(shi, -1, -2)), log_a, inverse)
        if post_const is not None:
            out = gf.mul_const(out, post_const)
        return out

    olo, ohi = jax.lax.map(body, perm_slabs)  # (nslab, ..., A, _ROW_SLAB)
    olo = jnp.moveaxis(olo, 0, -2)
    ohi = jnp.moveaxis(ohi, 0, -2)
    return (olo.reshape(olo.shape[:-2] + (r,)),
            ohi.reshape(ohi.shape[:-2] + (r,)))


@functools.lru_cache(maxsize=None)
def _jitted_three_step(log_n: int, inverse: bool):
    _, _, row_perm = _three_step_tables_host(log_n, inverse)

    @jax.jit
    def run(lo, hi, t1lo, t1hi, dlo, dhi):
        return three_step_ntt_traceable(
            (lo, hi), log_n, inverse, (t1lo, t1hi), (dlo, dhi), row_perm)

    return run


def ntt_limbs(x, inverse: bool = False):
    """NTT over the last axis of limb planes (lo, hi). Shape-preserving."""
    lo, hi = x
    log_n = _check_len(lo.shape[-1])
    if lo.shape[-1] <= 1:
        return x
    if THREE_STEP_THRESHOLD_LOG2 and log_n >= THREE_STEP_THRESHOLD_LOG2:
        t1, diag, _ = _three_step_tables_device(log_n, inverse)
        return _jitted_three_step(log_n, inverse)(
            lo, hi, t1[0], t1[1], diag[0], diag[1])
    if log_n >= FOUR_STEP_THRESHOLD_LOG2:
        if _USE_W64 and not _USE_DIF:
            diag = _four_step_diag_device_w64(log_n, inverse)
            return _jitted_four_step_w64(log_n, inverse)(lo, hi, diag)
        diag = _four_step_diag_device(log_n, inverse)
        return _jitted_four_step(log_n, inverse)(lo, hi, diag[0], diag[1])
    return _jitted_ntt(log_n, inverse)(lo, hi)


def intt_limbs(x):
    return ntt_limbs(x, inverse=True)


# -- host-convenience wrappers ---------------------------------------------

# Below this total element count a one-shot host-array transform stays on
# the host (native C++ row NTT); above it, it pays the device round trip.
# This is the library's host-vs-device crossover knob (SURVEY §2a: the
# reference's seq/par cutoffs become host/device thresholds here). The
# value dates from an earlier accelerator behind a slow link and is not yet
# measured on the H100 (ROADMAP S6); override with
# TWENTY_FIRST_TPU_HOST_NTT_MAX_ELEMS. Device-resident pipelines
# (ntt_limbs*, poly_batch, parallel/*) never consult this: they have no
# transfer to amortize.
HOST_NTT_MAX_ELEMS = int(os.environ.get(
    "TWENTY_FIRST_TPU_HOST_NTT_MAX_ELEMS", str(1 << 22)))


@functools.lru_cache(maxsize=64)
def _host_stage_tw_flat(log_n: int, inverse: bool) -> np.ndarray:
    """Concatenated per-stage twiddles (length n-1) for the native core."""
    return np.ascontiguousarray(
        np.concatenate(_twiddles_host(log_n, inverse)))


def _ntt_host_native(values: np.ndarray, log_n: int, inverse: bool):
    """Route host transforms through the native row-batched C++ NTT —
    one call replacing ~3*log_n broadcast/strided numpy passes; measured
    severalfold faster from ~2^8 up. Returns None to use the numpy form
    (small inputs, native unavailable, TWENTY_FIRST_TPU_NATIVE_HOST=0)."""
    import os

    if values.size < (1 << 8) or \
            os.environ.get("TWENTY_FIRST_TPU_NATIVE_HOST") == "0":
        return None
    from .. import native

    if not native.available():
        return None
    n = 1 << log_n
    out = np.ascontiguousarray(values, dtype=np.uint64).reshape(-1, n).copy()
    n_inv = pow(n, P - 2, P) if inverse else 0
    native.ntt_rows_inplace(out, _host_stage_tw_flat(log_n, inverse), n_inv)
    return out.reshape(values.shape)


def ntt_host(values: np.ndarray, inverse: bool = False) -> np.ndarray:
    """Vectorized host-numpy NTT over the last axis (radix-2 stages).

    Same values as the device path; used for small transforms where the
    host<->device round trip dominates, and as an independent oracle."""
    values = np.asarray(values, dtype=np.uint64)
    n = values.shape[-1]
    log_n = _check_len(n)
    if n <= 1:
        return values.copy()
    fast = _ntt_host_native(values, log_n, inverse)
    if fast is not None:
        return fast
    perm = _bit_reverse_permutation(log_n)
    stages = _twiddles_host(log_n, inverse)
    x = values[..., perm]
    batch = x.shape[:-1]
    for s in range(log_n):
        m = 1 << s
        x = x.reshape(batch + (n // (2 * m), 2, m))
        u = x[..., 0, :]
        v = gfn.mul(x[..., 1, :], stages[s])
        x = np.stack([gfn.add(u, v), gfn.sub(u, v)], axis=-2)
    x = x.reshape(batch + (n,))
    if inverse:
        n_inv = np.uint64(pow(n, P - 2, P))
        x = gfn.mul(x, n_inv)
    return x


def ntt_values(values, inverse: bool = False) -> np.ndarray:
    """NTT of a host uint64 array (last axis = transform axis).

    Dispatches between the host-numpy kernel (small transforms) and the
    device kernels (large), both bit-exact."""
    values = np.asarray(values, dtype=np.uint64)
    if values.shape[-1] <= 1:
        _check_len(values.shape[-1])
        return values.copy()
    if values.size <= HOST_NTT_MAX_ELEMS:
        return ntt_host(values, inverse=inverse)
    out = ntt_limbs(gf.to_limbs(values), inverse=inverse)
    return gf.from_limbs(out)


def intt_values(values) -> np.ndarray:
    return ntt_values(values, inverse=True)


def ntt(elements, inverse: bool = False):
    """Scalar-object API: list of BFieldElement/XFieldElement, like ntt.rs:67.

    Returns a new list (this library is functional; no in-place slices).
    """
    from .b_field_element import BFieldElement
    from .x_field_element import XFieldElement

    if not elements:
        return []
    if isinstance(elements[0], XFieldElement):
        coeffs = np.array(
            [[c.value() for c in e.coefficients] for e in elements], dtype=np.uint64
        )  # (n, 3)
        out = ntt_values(coeffs.T, inverse=inverse)  # (3, n)
        return [XFieldElement((int(out[0, i]), int(out[1, i]), int(out[2, i])))
                for i in range(out.shape[1])]
    vals = np.array([e.value() for e in elements], dtype=np.uint64)
    out = ntt_values(vals, inverse=inverse)
    return [BFieldElement(int(v)) for v in out]


def intt(elements):
    return ntt(elements, inverse=True)
