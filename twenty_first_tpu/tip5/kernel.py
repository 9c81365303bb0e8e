"""Tip5 permutation as one Pallas kernel on the Triton route (GPU).

The XLA form (permutation.py) holds a batch as (B, 16) limb planes: its MDS
is a broadcast multiply-reduce over the 16-wide minor axis and its S-box
stacks byte planes, so on the GPU the five rounds split into several
fusions that each send (B, 16) planes through device memory. This kernel
keeps one state per lane in registers through all five rounds:

  * word-major input: word w of a block of states is one contiguous
    (BLOCK,) vector, so each of the 16 loads and stores is coalesced;
  * native u64 field arithmetic (math/gf64.py), whose 32x32->64 partial
    products are the hardware's widening multiply;
  * the circulant MDS unrolled into constant multiply-adds on the 32-bit
    halves of each word (each sum < 2^52, so no carries inside the sums),
    then one 96-bit reduction per word;
  * the S-box as the XLA form computes it: the offset Fermat cube map
    (b+1)^3 - 1 mod 257 on the bytes of the Montgomery representative.

Three entry points share the body and differ only in how a state is
assembled and what is written back:

  permutation_wm   (16, B) -> (16, B)          standalone permutations
  hash_rows_wm     (W, B), W <= 10 -> (5, B)   fixed-length hash of rows
  merkle_layers    heap-ordered (5, 2n) node   Merkle layers, all from one
                   planes -> the same planes   compiled kernel

All take and return (lo, hi) uint32 limb planes. `use_kernel` is the one
place that decides, from the backend and the batch size, whether a caller
runs this kernel or the XLA form.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..math import gf, gf64
from .constants import (
    MDS_MATRIX_FIRST_COLUMN,
    NUM_ROUNDS,
    NUM_SPLIT_AND_LOOKUP,
    RATE,
    ROUND_CONSTANTS,
    STATE_SIZE,
)

# States per program: one state per thread (32 lanes x NUM_WARPS warps), so
# a state's 16 words and the MDS sums stay in registers.
NUM_WARPS = 4
BLOCK = 32 * NUM_WARPS
# Programs per Merkle layer call: a few per SM; each walks its share of the
# layer's blocks, so the launch size does not grow with the tree.
TREE_PROGRAMS = 1024

DIGEST_LEN = 5

_U64 = jnp.uint64
_U32 = jnp.uint32
_M32 = np.uint64(0xFFFF_FFFF)
_EPS = np.uint64(0xFFFF_FFFF)  # 2^64 mod p
_R = np.uint64(gf.R)
_R_INV = np.uint64(gf.R_INV)
_MDS_COL = [int(c) for c in MDS_MATRIX_FIRST_COLUMN]
_RC = np.asarray(ROUND_CONSTANTS).reshape(NUM_ROUNDS, STATE_SIZE)
_RC_HI = (_RC >> np.uint64(32)).tolist()
_RC_LO = (_RC & _M32).tolist()


def use_kernel(batch: int, platform: str | None = None) -> bool:
    """Whether a batch of `batch` permutations runs this kernel: on the GPU
    backend, for batches of at least one full block. Smaller batches and
    other backends take the XLA form."""
    platform = jax.default_backend() if platform is None else platform
    return platform == "gpu" and batch >= BLOCK


# ---------------------------------------------------------------------------
# The permutation on a list of 16 u64 word vectors
# ---------------------------------------------------------------------------


def _u64(zero, value: int):
    """The u64 `value` as a vector like `zero` (all zeros). The Triton
    lowering takes integer literals below 2^63 only, so larger constants
    are assembled from 32-bit halves; the compiler folds them back."""
    return (((zero | np.uint64(value >> 32)) << 32)
            | np.uint64(value & 0xFFFF_FFFF))


def _add(a, b, p):
    """gf64.add_lazy with the modulus `p` passed in (see _u64)."""
    s = a + b
    c = (s < a).astype(_U64)
    k = c + (c & (s >= p).astype(_U64))
    return s + (k << 32) - k


def _canon(a, p):
    return jnp.where(a >= p, a - p, a)


def _lookup(x, p):
    """S-box for words 0..3: byte-wise LUT on the Montgomery representative,
    evaluated as (b+1)^3 - 1 mod 257 (the LUT's defining map)."""
    m = _canon(gf64.mul_lazy(x, _R), p)
    out = jnp.zeros_like(m)
    for k in range(8):
        t = ((m >> (8 * k)) & np.uint64(0xFF)).astype(_U32) + np.uint32(1)
        t2 = (t * t) % np.uint32(257)
        t3 = (t2 * t) % np.uint32(257)
        out = out | ((t3 - np.uint32(1)).astype(_U64) << (8 * k))
    return gf64.mul_lazy(out, _R_INV)


def _pow7(x):
    sq = gf64.mul_lazy(x, x)
    qu = gf64.mul_lazy(sq, sq)
    return gf64.mul_lazy(gf64.mul_lazy(qu, sq), x)


def _mds(words):
    """Circulant matvec over the integers on 32-bit halves, then one
    reduction of (L + 2^32 H) < 2^85 per output word. Lazy residues in."""
    lo = [w & _M32 for w in words]
    hi = [w >> 32 for w in words]
    out = []
    for i in range(STATE_SIZE):
        s_lo = s_hi = None
        for j in range(STATE_SIZE):
            c = np.uint64(_MDS_COL[(i - j) % STATE_SIZE])
            s_lo = lo[j] * c if s_lo is None else s_lo + lo[j] * c
            s_hi = hi[j] * c if s_hi is None else s_hi + hi[j] * c
        low = s_lo + (s_hi << 32)
        high = (s_hi >> 32) + (low < s_lo).astype(_U64)
        # low + 2^64 * high with high < 2^32:  2^64 == EPS (mod p)
        r = low + ((high << 32) - high)
        out.append(jnp.where(r < low, r + _EPS, r))
    return out


def _round_constant(zero, r, w: int):
    """Round constant (r, w) for a traced round index r: select chains over
    the 32-bit halves (a kernel body may close over scalars only)."""
    hi, lo = np.uint64(_RC_HI[-1][w]), np.uint64(_RC_LO[-1][w])
    for k in range(NUM_ROUNDS - 2, -1, -1):
        hi = jnp.where(r == k, np.uint64(_RC_HI[k][w]), hi)
        lo = jnp.where(r == k, np.uint64(_RC_LO[k][w]), lo)
    return ((zero | hi) << 32) | lo


def _permute(words):
    """Five rounds on 16 word vectors (any u64 residues in, canonical out).
    The rounds are a loop, not unrolled: one round body keeps the compiled
    kernel (and its interpreter graph) a fifth of the size."""
    zero = jnp.zeros_like(words[0])
    p = _u64(zero, gf.P)

    def round_(r, words):
        words = ([_lookup(w, p) for w in words[:NUM_SPLIT_AND_LOOKUP]]
                 + [_pow7(w) for w in words[NUM_SPLIT_AND_LOOKUP:]])
        words = _mds(words)
        return tuple(_add(v, _round_constant(zero, r, w), p)
                     for w, v in enumerate(words))

    words = jax.lax.fori_loop(0, NUM_ROUNDS, round_, tuple(words))
    return [_canon(w, p) for w in words]


# ---------------------------------------------------------------------------
# Kernel bodies: assemble states, permute, write back
# ---------------------------------------------------------------------------


def _load(lo_ref, hi_ref, w):
    return lo_ref[w, :].astype(_U64) | (hi_ref[w, :].astype(_U64) << 32)


def _store(lo_ref, hi_ref, words):
    for w, v in enumerate(words):
        lo_ref[w, :] = (v & _M32).astype(_U32)
        hi_ref[w, :] = (v >> 32).astype(_U32)


def _permutation_kernel(lo_ref, hi_ref, olo_ref, ohi_ref):
    words = [_load(lo_ref, hi_ref, w) for w in range(STATE_SIZE)]
    _store(olo_ref, ohi_ref, _permute(words))


def _fixed_length_state(rate_words):
    """Fixed-length domain: rate words (zero-filled to RATE), capacity 1s."""
    zero = jnp.zeros_like(rate_words[0])
    one = zero + np.uint64(1)
    return (rate_words + [zero] * (RATE - len(rate_words))
            + [one] * (STATE_SIZE - RATE))


def _rows_kernel(lo_ref, hi_ref, olo_ref, ohi_ref, *, width: int):
    words = [_load(lo_ref, hi_ref, w) for w in range(width)]
    out = _permute(_fixed_length_state(words))
    _store(olo_ref, ohi_ref, out[:DIGEST_LEN])


def _tree_layer_kernel(count_ref, lo_ref, hi_ref, olo_ref, ohi_ref, *,
                       programs: int):
    """Nodes [count, 2 count) of heap-ordered node planes from their
    children 2q, 2q+1: one contiguous load of both children per word, split
    in registers. The output planes alias the input planes, so every other
    node keeps its value."""
    count = count_ref[0]
    pid = pl.program_id(0)
    lane = jnp.arange(2 * BLOCK, dtype=jnp.int32)
    nblocks = jax.lax.div(count + (BLOCK - 1), jnp.int32(BLOCK))

    def block(k, carry):
        first = (pid + k * programs) * BLOCK
        node = count + first
        mask = 2 * first + lane < 2 * count
        left, right = [], []
        for w in range(DIGEST_LEN):
            at = (np.int32(w), pl.ds(2 * node, 2 * BLOCK))
            lo = plgpu.load(lo_ref.at[at], mask=mask, other=0)
            hi = plgpu.load(hi_ref.at[at], mask=mask, other=0)
            pair = (lo.astype(_U64) | (hi.astype(_U64) << 32)).reshape(
                BLOCK, 2)
            l, r = jnp.split(pair, 2, axis=1)
            left.append(l.reshape(BLOCK))
            right.append(r.reshape(BLOCK))
        out = _permute(_fixed_length_state(left + right))
        mask = first + jnp.arange(BLOCK, dtype=jnp.int32) < count
        for w in range(DIGEST_LEN):
            at = (np.int32(w), pl.ds(node, BLOCK))
            plgpu.store(olo_ref.at[at], (out[w] & _M32).astype(_U32),
                        mask=mask)
            plgpu.store(ohi_ref.at[at], (out[w] >> 32).astype(_U32),
                        mask=mask)
        return carry

    steps = jax.lax.div(nblocks + (programs - 1) - pid, jnp.int32(programs))
    jax.lax.fori_loop(0, steps, block, 0)


def _pallas_call(body, name: str, grid: int, out_shape, interpret: bool,
                 **kwargs):
    """pallas_call on the Triton route with this module's launch shape."""
    return pl.pallas_call(
        body,
        out_shape=out_shape,
        grid=(grid,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name=name,
        **kwargs,
    )


def _call(kernel, name: str, ins, out_words: int, batch: int,
          interpret: bool):
    """One program per BLOCK states; `ins` are (words, batch) planes with
    batch a multiple of BLOCK (_padded)."""
    out = jax.ShapeDtypeStruct((out_words, batch), _U32)
    return _pallas_call(
        kernel, name, batch // BLOCK, (out, out), interpret,
        in_specs=[pl.BlockSpec((x.shape[0], BLOCK), lambda i: (0, i))
                  for x in ins],
        out_specs=[pl.BlockSpec((out_words, BLOCK), lambda i: (0, i))] * 2,
    )(*ins)


def _padded(planes, batch: int):
    """Zero-pad (words, batch) planes along the batch to a multiple of
    BLOCK; returns (planes, padded batch)."""
    full = -(-batch // BLOCK) * BLOCK
    if full == batch:
        return planes, batch
    return tuple(jnp.pad(p, ((0, 0), (0, full - batch))) for p in planes), full


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def permutation_wm(state, interpret: bool = False):
    """(16, B) word-major limb planes -> permuted (16, B), canonical."""
    batch = state[0].shape[1]
    ins, full = _padded(state, batch)
    lo, hi = _call(_permutation_kernel, "tip5_permutation", ins, STATE_SIZE,
                   full, interpret)
    return lo[:, :batch], hi[:, :batch]


def hash_rows_wm(rows, interpret: bool = False):
    """(W, B) word-major rows, W <= RATE -> (5, B) fixed-length digests
    (hash_10 of each column, zero-filled to RATE words)."""
    width, batch = rows[0].shape
    if not 0 < width <= RATE:
        raise ValueError(f"row width {width} not in 1..{RATE}")
    ins, full = _padded(rows, batch)
    lo, hi = _call(functools.partial(_rows_kernel, width=width),
                   "tip5_hash_rows", ins, DIGEST_LEN, full, interpret)
    return lo[:, :batch], hi[:, :batch]


def tree_planes(leafs):
    """(5, n) word-major leaf planes -> heap-ordered (5, 2n + 2 BLOCK) node
    planes with the leafs at columns [n, 2n). Node q's children are 2q and
    2q+1, the root is column 1; the tail pad keeps every block load of
    the small top layers inside the planes."""
    n = leafs[0].shape[1]
    return tuple(jnp.pad(p, ((0, 0), (n, 2 * BLOCK))) for p in leafs)


def merkle_layers(nodes, n: int, num_layers: int, interpret: bool = False):
    """Run `num_layers` Merkle layers on heap-ordered node planes holding n
    leafs (tree_planes): afterwards layer k (1..num_layers) fills columns
    [n >> k, 2n >> k). One kernel, compiled once, serves every layer: the
    layer's node count is a runtime operand."""
    programs = max(1, min(TREE_PROGRAMS, n // 2 // BLOCK))
    call = _pallas_call(
        functools.partial(_tree_layer_kernel, programs=programs),
        "tip5_merkle_layer", programs,
        tuple(jax.ShapeDtypeStruct(p.shape, _U32) for p in nodes), interpret,
        input_output_aliases={1: 0, 2: 1})

    def layer(i, planes):
        count = jnp.right_shift(jnp.int32(n // 2), i)
        return call(count[None], *planes)

    return jax.lax.fori_loop(0, num_layers, layer, tuple(nodes))
