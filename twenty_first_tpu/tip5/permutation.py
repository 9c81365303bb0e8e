"""Batched Tip5 permutation on device (jnp limb planes).

The reference applies the permutation to one 16-word state at a time with
AVX-512 lanes inside one state (tip5/avx512.rs). Here the natural layout is
the transpose: a *batch* of states, shape (..., 16) per limb plane,
vectorized across the batch. This XLA form is the reference for the GPU
kernel (tip5/kernel.py) and the path on every other backend.

Layers (reference tip5/mod.rs:175-253):
  * S-box: words 0..4 pass through the byte-wise lookup applied to the
    Montgomery representative's bytes (the LUT *is specified* on Montgomery
    bytes, mod.rs:197-207); the lookup itself is evaluated arithmetically as
    the offset Fermat cube map (x+1)^3 - 1 mod 257, with no gather. Words
    4..16 are raised to the 7th power.
  * MDS: 16x16 circulant matrix with 16-bit entries, evaluated as an exact
    integer matvec on 16-bit digit planes with split lo/hi accumulation, then
    one 128-bit Goldilocks reduction. (The reference evaluates the same
    integer convolution via a generated 16-point FFT, mod.rs:256-506; here
    a broadcast-multiply-reduce keeps the graph short.)
  * Round-constant addition.

Degenerate-representation note: the reference's raw Montgomery pipeline can
transiently hold values >= p inside a round (mod.rs:210-241); our canonical-
value pipeline cannot, and because the reference corrects them before any
representation-dependent step (the S-box), the two agree on all values. The
permutation snapshot test pins this.
"""

from __future__ import annotations


import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..math import gf
from .constants import (
    MDS_MATRIX,
    NUM_ROUNDS,
    NUM_SPLIT_AND_LOOKUP,
    RATE,
    ROUND_CONSTANTS,
    STATE_SIZE,
)

_U32 = jnp.uint32
_MASK16 = np.uint32(0xFFFF)
_MASK8 = np.uint32(0xFF)

# Host-side constants (traced code closes over them as XLA constants).
_MDS_NP = np.asarray(MDS_MATRIX)  # (16, 16) uint32 circulant
_RC_NP = ROUND_CONSTANTS.reshape(NUM_ROUNDS, STATE_SIZE)
_RC_LO = (_RC_NP & np.uint64(0xFFFF_FFFF)).astype(np.uint32)
_RC_HI = (_RC_NP >> np.uint64(32)).astype(np.uint32)


def _fermat_cube_map(b):
    """Offset Fermat cube map on byte values held in uint32: (b+1)^3 - 1 mod 257."""
    t = b + np.uint32(1)
    t2 = (t * t) % np.uint32(257)
    t3 = (t2 * t) % np.uint32(257)
    return t3 - np.uint32(1)


_BYTE_SHIFTS = np.array([0, 8, 16, 24], dtype=np.uint32)


def _split_and_lookup(words):
    """Byte-wise LUT on the Montgomery representative of the first 4 words.

    All 8 bytes of both limbs are processed in one widened tensor op
    (minimizes HLO op count — these graphs get chained dozens of times in
    Merkle commits and compile time scales with op count)."""
    mlo, mhi = gf.to_montgomery(words)
    m = jnp.stack([mlo, mhi], axis=-1)  # (..., 2)
    b = (m[..., None] >> _BYTE_SHIFTS) & _MASK8  # (..., 2, 4)
    f = _fermat_cube_map(b)
    out = jnp.sum(f << _BYTE_SHIFTS, axis=-1, dtype=_U32)  # (..., 2)
    return gf.from_montgomery((out[..., 0], out[..., 1]))


def _pow7(x):
    # lazy residues throughout (mul64_wide accepts any u64; one canon at
    # the end of the permutation restores canonical form)
    sq = gf.mul_lazy(x, x)
    qu = gf.mul_lazy(sq, sq)
    return gf.mul_lazy(gf.mul_lazy(qu, sq), x)


def _sbox(state):
    lo, hi = state
    first = _split_and_lookup((lo[..., :NUM_SPLIT_AND_LOOKUP],
                               hi[..., :NUM_SPLIT_AND_LOOKUP]))
    rest = _pow7((lo[..., NUM_SPLIT_AND_LOOKUP:], hi[..., NUM_SPLIT_AND_LOOKUP:]))
    return (
        jnp.concatenate([first[0], rest[0]], axis=-1),
        jnp.concatenate([first[1], rest[1]], axis=-1),
    )


def _mds(state):
    """Exact circulant matvec over the integers, then one Goldilocks reduction.

    Each state word splits into four 16-bit digits; each digit plane is
    convolved with the 16-bit MDS column. Products fit u32 exactly; sums of
    their 16-bit halves over 16 taps fit u32 with huge margin (< 2^20).
    Accepts arbitrary (lazy) u64 residues: a non-canonical representative
    changes the integer matvec by a multiple of p, which the final
    Goldilocks reduction absorbs.
    """
    lo, hi = state
    digits = (
        lo & _MASK16,
        lo >> 16,
        hi & _MASK16,
        hi >> 16,
    )
    # Broadcast-multiply-reduce: XLA fuses the (.., 16, 16) product into the
    # sums without materializing it, and the widened formulation keeps the
    # HLO op count small (compile time scales with op count — these rounds
    # get chained ~100x in Merkle commit graphs).
    sums = []
    for d in digits:
        prod = _MDS_NP * d[..., None, :]
        s_lo = jnp.sum(prod & _MASK16, axis=-1, dtype=_U32)
        s_hi = jnp.sum(prod >> 16, axis=-1, dtype=_U32)
        sums.append((s_lo, s_hi))
    g0 = sums[0][0]
    g1 = sums[0][1] + sums[1][0]
    g2 = sums[1][1] + sums[2][0]
    g3 = sums[2][1] + sums[3][0]
    g4 = sums[3][1]
    # Assemble value = g0 + g1*2^16 + g2*2^32 + g3*2^48 + g4*2^64 into 128-bit
    # words x0..x2 (x3 == 0 since the value < 2^84).
    x0 = g0 + (g1 << 16)
    c0 = (x0 < g0).astype(_U32)
    t = g2 + (g1 >> 16) + c0
    x1 = t + (g3 << 16)
    c1 = (x1 < t).astype(_U32)
    x2 = g4 + (g3 >> 16) + c1
    x3 = jnp.zeros_like(x2)
    return gf.reduce128_lazy(x0, x1, x2, x3)


def _round(state, round_index: int):
    """One round on (possibly lazy) u64 residue planes; lazy residue out.

    Lazy round states are safe: the S-box's to_montgomery is a fully
    reducing multiply (same Montgomery bytes for any representative), x^7
    and the MDS integer convolution accept arbitrary u64 residues.
    """
    state = _sbox(state)
    state = _mds(state)
    rc = (jnp.asarray(_RC_LO[round_index]), jnp.asarray(_RC_HI[round_index]))
    return gf.add_lazy(state, rc)


def permutation(state):
    """Apply the full 5-round Tip5 permutation to limb planes (..., 16)."""
    for i in range(NUM_ROUNDS):
        state = _round(state, i)
    return gf.canon(state)


def permutation_batch(state):
    """STANDALONE batched permutation: (B, 16) limb planes -> permuted.

    On the GPU, batches of at least one kernel block run the Pallas kernel
    (tip5/kernel.py) on word-major planes, with one transpose each way;
    everything else takes the XLA form. The choice depends on the backend
    and the batch size only (kernel.use_kernel)."""
    from . import kernel

    lo, hi = state
    if lo.ndim == 2 and kernel.use_kernel(lo.shape[0]):
        out = kernel.permutation_wm((lo.T, hi.T))
        return out[0].T, out[1].T
    return permutation(state)


def trace(state):
    """Permutation trace: (1 + NUM_ROUNDS) states, stacked on a new axis -2.

    Matches Tip5::trace (tip5/mod.rs:538-548): trace[0] is the initial state,
    trace[1+i] the state after round i. Output limb planes have shape
    (..., 6, 16) — ready for STARK arithmetization.
    """
    states = [state]
    for i in range(NUM_ROUNDS):
        # each exposed round state must be canonical (AIR arithmetization)
        states.append(gf.canon(_round(states[-1], i)))
    lo = jnp.stack([s[0] for s in states], axis=-2)
    hi = jnp.stack([s[1] for s in states], axis=-2)
    return lo, hi


# ---------------------------------------------------------------------------
# Batched hash entry points (jitted per input shape)
# ---------------------------------------------------------------------------


def _fixed_length_state(rate_input):
    """State for the FixedLength domain: rate words from input, capacity = 1s."""
    lo, hi = rate_input
    batch = lo.shape[:-1]
    cap_lo = jnp.ones(batch + (STATE_SIZE - RATE,), _U32)
    cap_hi = jnp.zeros(batch + (STATE_SIZE - RATE,), _U32)
    return (
        jnp.concatenate([lo, cap_lo], axis=-1),
        jnp.concatenate([hi, cap_hi], axis=-1),
    )


@jax.jit
def hash_10(rate_input):
    """Batched hash_10: limb planes (..., 10) -> (..., 5)."""
    state = permutation(_fixed_length_state(rate_input))
    return state[0][..., :5], state[1][..., :5]


@jax.jit
def hash_pair(left, right):
    """Batched hash_pair: two (..., 5) digests -> (..., 5)."""
    lo = jnp.concatenate([left[0], right[0]], axis=-1)
    hi = jnp.concatenate([left[1], right[1]], axis=-1)
    return hash_10((lo, hi))


def hash_varlen_padded(padded):
    """Batched variable-length hash of already-padded equal-length inputs.

    padded: limb planes (..., k*RATE) that already carry the 1,0,...,0
    padding. Absorbs chunk-wise (overwrite + permute) starting from the
    all-zero VariableLength state. Trace-composable (plain function).
    """
    lo, hi = padded
    batch = lo.shape[:-1]
    total = lo.shape[-1]
    k = total // RATE
    state = (
        jnp.zeros(batch + (STATE_SIZE,), _U32),
        jnp.zeros(batch + (STATE_SIZE,), _U32),
    )
    if k <= 8:
        # short inputs: unroll (fuses fully, no scan-carry overhead)
        for start in range(0, total, RATE):
            state = (
                jnp.concatenate(
                    [lo[..., start:start + RATE], state[0][..., RATE:]], -1),
                jnp.concatenate(
                    [hi[..., start:start + RATE], state[1][..., RATE:]], -1),
            )
            state = permutation(state)
        return state[0][..., :5], state[1][..., :5]

    # long inputs: lax.scan over absorption chunks — ONE compiled permutation
    # body instead of k unrolled copies (a 2^14-word input unrolls ~1.6k
    # permutations otherwise, a multi-minute XLA compile)
    chunks_lo = jnp.moveaxis(lo.reshape(batch + (k, RATE)), -2, 0)
    chunks_hi = jnp.moveaxis(hi.reshape(batch + (k, RATE)), -2, 0)
    # derive the zero state from the input so its sharding/varying type
    # matches the scan body output under shard_map
    zero = lo[..., :1] * jnp.uint32(0)
    state = (state[0] + zero, state[1] + zero)

    def body(st, xs):
        clo, chi = xs
        st = permutation((
            jnp.concatenate([clo, st[0][..., RATE:]], -1),
            jnp.concatenate([chi, st[1][..., RATE:]], -1),
        ))
        return st, None

    state, _ = jax.lax.scan(body, state, (chunks_lo, chunks_hi))
    return state[0][..., :5], state[1][..., :5]


def pad_for_varlen(x):
    """Append the 1,0,...,0 sponge padding to limb planes (..., L) in-graph."""
    lo, hi = x
    length = lo.shape[-1]
    pad_to = ((length + 1) + RATE - 1) // RATE * RATE
    batch = lo.shape[:-1]
    marker_lo = jnp.ones(batch + (1,), _U32)
    zeros_lo = jnp.zeros(batch + (pad_to - length - 1,), _U32)
    zeros_hi = jnp.zeros(batch + (pad_to - length,), _U32)
    return (
        jnp.concatenate([lo, marker_lo, zeros_lo], axis=-1),
        jnp.concatenate([hi, zeros_hi], axis=-1),
    )


@jax.jit
def _hash_varlen_padded(padded):
    return hash_varlen_padded(padded)


def hash_varlen(values) -> np.ndarray:
    """Hash a batch of equal-length inputs: host uint64 (..., L) -> (..., 5)."""
    values = np.asarray(values, dtype=np.uint64)
    length = values.shape[-1]
    pad_to = ((length + 1) + RATE - 1) // RATE * RATE
    padded = np.zeros(values.shape[:-1] + (pad_to,), dtype=np.uint64)
    padded[..., :length] = values
    padded[..., length] = 1
    out = _hash_varlen_padded(gf.to_limbs(padded))
    return gf.from_limbs(out)


# ---------------------------------------------------------------------------
# Ragged (mixed-length) batched hashing
# ---------------------------------------------------------------------------
#
# The reference hashes variable-length inputs one at a time through the
# sponge (tip5/mod.rs:617-623, sponge.rs:32-56). The batched equivalent
# batches inputs of DIFFERENT lengths: inputs are grouped into power-of-two
# chunk-count buckets, each bucket runs ONE compiled graph — a lax.scan over
# absorption chunks where lanes whose input is exhausted keep their state
# (masked select). Power-of-two bucketing of both the chunk count and the
# batch height bounds the number of distinct compilations at O(log^2).


@functools.lru_cache(maxsize=None)
def _ragged_bucket_graph(num_chunks: int, group: int):
    @jax.jit
    def run(lo, hi, counts):
        chunks_lo = lo.reshape(group, num_chunks, RATE).transpose(1, 0, 2)
        chunks_hi = hi.reshape(group, num_chunks, RATE).transpose(1, 0, 2)
        state = (
            jnp.zeros((group, STATE_SIZE), _U32),
            jnp.zeros((group, STATE_SIZE), _U32),
        )

        def body(carry, xs):
            slo, shi = carry
            clo, chi, i = xs
            new = permutation((
                jnp.concatenate([clo, slo[:, RATE:]], axis=-1),
                jnp.concatenate([chi, shi[:, RATE:]], axis=-1),
            ))
            active = (i < counts)[:, None]
            return (
                jnp.where(active, new[0], slo),
                jnp.where(active, new[1], shi),
            ), None

        (slo, shi), _ = jax.lax.scan(
            body, state,
            (chunks_lo, chunks_hi, jnp.arange(num_chunks, dtype=jnp.int32)))
        return slo[:, : 5], shi[:, : 5]

    return run


def hash_varlen_ragged(inputs) -> np.ndarray:
    """Hash a batch of variable-length inputs on device: list of uint64
    arrays (any lengths, including 0) -> (N, 5) uint64 digests.

    Bit-exact with the scalar sponge (pad 1,0,...,0 then absorb chunk-wise,
    tip5/mod.rs:617-623); lengths are mixed freely within one call."""
    from collections import defaultdict

    arrs = [np.asarray(v, dtype=np.uint64).ravel() for v in inputs]
    n = len(arrs)
    out = np.empty((n, 5), dtype=np.uint64)
    if n == 0:
        return out
    chunk_counts = [(a.size + 1 + RATE - 1) // RATE for a in arrs]
    buckets: dict[int, list[int]] = defaultdict(list)
    for idx, k in enumerate(chunk_counts):
        b = 1 << (k - 1).bit_length() if k > 1 else 1
        buckets[b].append(idx)
    for b, idxs in sorted(buckets.items()):
        g = len(idxs)
        group = 1 << (g - 1).bit_length() if g > 1 else 1
        padded = np.zeros((group, b * RATE), dtype=np.uint64)
        counts = np.zeros(group, dtype=np.int32)
        for row, i in enumerate(idxs):
            a = arrs[i]
            padded[row, : a.size] = a
            padded[row, a.size] = 1
            counts[row] = chunk_counts[i]
        lo, hi = gf.to_limbs(padded)
        res = _ragged_bucket_graph(b, group)(lo, hi, jnp.asarray(counts))
        vals = gf.from_limbs(res)
        out[idxs] = vals[:g]
    return out


def permutation_values(states) -> np.ndarray:
    """Host-convenience: uint64 (..., 16) -> permuted uint64 (..., 16).

    Always the XLA form (the tests' oracle for the kernel); the entry for
    standalone batches is `permutation_batch_values`."""
    out = jax.jit(permutation)(gf.to_limbs(np.asarray(states, dtype=np.uint64)))
    return gf.from_limbs(out)


def permutation_batch_values(states) -> np.ndarray:
    """Host-convenience over `permutation_batch` (the GPU kernel for 2-D
    batches of at least one kernel block)."""
    out = jax.jit(permutation_batch)(
        gf.to_limbs(np.asarray(states, dtype=np.uint64)))
    return gf.from_limbs(out)


def trace_values(states) -> np.ndarray:
    out = jax.jit(trace)(gf.to_limbs(np.asarray(states, dtype=np.uint64)))
    return gf.from_limbs(out)
