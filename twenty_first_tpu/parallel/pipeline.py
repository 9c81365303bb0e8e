"""STARK LDE + commit pipeline — the framework's flagship end-to-end step.

Single-chip and mesh-sharded variants of the standard STARK workload this
library exists for (BASELINE.json config 4): low-degree-extend a trace
(coset/plain NTT) and commit to it with a Tip5 Merkle tree.

The distributed variant chains, in two device programs:
  1. the four-step NTT (dist_ntt): local NTTs + diagonal twiddles + one
     all-to-all transpose over the mesh axis;
  2. row hashing: each chip Tip5-hashes its rows of the evaluation matrix
     into leaf digests (pure local compute), then the sharded Merkle
     reduction (dist_merkle): local subtree roots, one small all-gather,
     redundant top tree.

Compute is chip-local; the only collectives are the NTT transpose and the
root gather.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..math import gf
from ..math import ntt as ntt_mod
from ..tip5 import permutation as tip5_dev
from ..tip5.digest import Digest
from .mesh import AXIS
from . import dist_ntt
from . import dist_merkle


def lde_commit_diags(n: int, expansion: int = 4):
    """Four-step diagonal device tables for trace_lde_commit at trace
    length n: (inv_diag_pair_or_None, fwd_diag_pair_or_None). Fetch this
    OUTSIDE jit and thread the arrays through as arguments, so the graph
    does not carry the tables (32 MB at 2^22) as constants."""
    inv_d = fwd_d = None
    if n.bit_length() - 1 >= ntt_mod.FOUR_STEP_THRESHOLD_LOG2:
        inv_d = ntt_mod._four_step_diag_device(n.bit_length() - 1, True)
    big = n * expansion
    if big.bit_length() - 1 >= ntt_mod.FOUR_STEP_THRESHOLD_LOG2:
        fwd_d = ntt_mod._four_step_diag_device(big.bit_length() - 1, False)
    return inv_d, fwd_d


def trace_lde_commit(trace, expansion: int = 4,
                     offset: int | None = None, ntt_diags=None):
    """Single-chip STARK trace commitment (BASELINE config 4 shape).

    trace: limb planes (W, n) — W <= 10 trace columns given as evaluations
    over the size-n trace domain. Steps, all in one trace-composable graph:
      1. interpolate each column (iNTT over the trace domain);
      2. low-degree-extend onto the coset offset * <omega_{expansion*n}>;
      3. hash each row of the (expansion*n, W) evaluation matrix into a
         leaf digest — W <= RATE, so ONE Tip5 permutation per row
         (fixed-length domain, like the reference's hash_10);
      4. reduce the leafs to a Merkle root.
    Returns (1, 5) limb planes holding the root digest.

    ntt_diags: pass lde_commit_diags(n, expansion) (threaded through the
    caller's jit as arguments) so the two transforms run the slab-mapped
    four-step above the threshold; without it they fall back to the plain
    last-axis core.
    """
    from ..math.b_field_element import GENERATOR

    import jax.numpy as jnp

    lo, hi = trace
    w, n = lo.shape
    assert w <= 10 and n & (n - 1) == 0
    big_n = n * expansion
    assert expansion & (expansion - 1) == 0
    offset = GENERATOR if offset is None else offset
    inv_diag, fwd_diag = ntt_diags if ntt_diags is not None else (None, None)
    # 1. interpolate columns
    coeff = ntt_mod.ntt_limbs_traceable((lo, hi), inverse=True,
                                        four_step_diag=inv_diag)
    # 2. scale by offset powers and zero-pad to the extended domain
    from ..math import gf_numpy as gfn

    pw = gfn.powers(offset, n)
    pw_lo = (pw & np.uint64(0xFFFF_FFFF)).astype(np.uint32)
    pw_hi = (pw >> np.uint64(32)).astype(np.uint32)
    scaled = gf.mul(coeff, (pw_lo[None, :], pw_hi[None, :]))
    pad = ((0, 0), (0, big_n - n))
    padded = (jnp.pad(scaled[0], pad), jnp.pad(scaled[1], pad))
    evals = ntt_mod.ntt_limbs_traceable(padded,
                                        four_step_diag=fwd_diag)  # (W, big_n)
    # 3 + 4. leaf digests + Merkle root
    return _hash_rows_commit(evals, w, big_n)


def _hash_rows_commit(evals, w: int, big_n: int):
    """Shared pipeline tail: (W, big_n) evaluation planes -> (1, 5) root.

    Each evaluation row is hashed fixed-length-domain in ONE Tip5
    permutation (W <= RATE), then reduced layer-wise to the Merkle root.
    The evaluation planes are already word-major, so on the GPU the leaf
    hashing and the whole Merkle reduction run the Tip5 kernel with no
    transpose; otherwise the rows become row-major (big_n, 16) states for
    the XLA form."""
    from ..tip5 import kernel
    from ..tip5.constants import STATE_SIZE

    import jax.numpy as jnp

    log_rows = big_n.bit_length() - 1
    if kernel.use_kernel(big_n):
        leafs = kernel.hash_rows_wm(evals)
        return dist_merkle.reduce_layers_wm(leafs, log_rows)
    rows_lo = jnp.transpose(evals[0])  # (big_n, W)
    rows_hi = jnp.transpose(evals[1])
    state_lo = jnp.concatenate(
        [rows_lo,
         jnp.zeros((big_n, 10 - w), jnp.uint32),
         jnp.ones((big_n, STATE_SIZE - 10), jnp.uint32)], axis=1)
    state_hi = jnp.concatenate(
        [rows_hi, jnp.zeros((big_n, STATE_SIZE - w), jnp.uint32)], axis=1)
    perm = tip5_dev.permutation((state_lo, state_hi))
    leafs = (perm[0][:, :5], perm[1][:, :5])
    return dist_merkle._reduce_layers(leafs, log_rows)


def lde_scrambled_tables(n: int, expansion: int = 4, offset: int | None = None):
    """Device tables for trace_lde_commit_scrambled: (dif_inv_diag,
    pw_scr, norev_fwd_diag) pairs. Fetch OUTSIDE jit, thread as args."""
    from ..math import gf_numpy as gfn
    from ..math.b_field_element import GENERATOR, P as FIELD_P

    import jax.numpy as jnp

    assert expansion & (expansion - 1) == 0 and expansion > 0
    log_n = n.bit_length() - 1
    log_e = expansion.bit_length() - 1
    log_n1, log_n2 = ntt_mod._four_step_split(log_n)
    n1, n2 = 1 << log_n1, 1 << log_n2
    offset = GENERATOR if offset is None else offset
    d1 = ntt_mod._diag_device_general(log_n, True, True, (log_n1, log_n2))
    d4 = ntt_mod._norev_diag_device(log_n + log_e, False,
                                    (log_n1 + log_e, log_n2))
    # pw_scr[r1, r2] = offset^j / n with j = brev(r2) + n2*brev(r1): the
    # offset-power scaling AND the iNTT's 1/n, in the scrambled layout,
    # fused into the interpolation's second pass
    pw = gfn.powers(offset, n)
    n_inv = pow(n, FIELD_P - 2, FIELD_P)
    b1 = ntt_mod._bit_reverse_permutation(log_n1).astype(np.int64)
    b2 = ntt_mod._bit_reverse_permutation(log_n2).astype(np.int64)
    jidx = (b2[None, :] + n2 * b1[:, None]).reshape(-1)
    pw_scr = gfn.mul(pw[jidx], np.full(n, n_inv, dtype=np.uint64))
    pw_scr = pw_scr.reshape(n1, n2)
    pw_dev = (jnp.asarray((pw_scr & np.uint64(0xFFFF_FFFF)).astype(np.uint32)),
              jnp.asarray((pw_scr >> np.uint64(32)).astype(np.uint32)))
    return d1, pw_dev, d4


def trace_lde_commit_scrambled(trace, expansion: int = 4, tables=None):
    """trace_lde_commit with a scrambled (gather-free) transform interior.

    Same result bit-for-bit (the final norev pass restores natural
    evaluation order, so leaf order and root match trace_lde_commit);
    different data movement (DESIGN.md §8):
      1. DIF iNTT: natural -> scrambled coefficients, ZERO gathers, with
         the offset-power scaling AND 1/n fused into its second pass
         (saves the standalone gf.mul materialization);
      2. zero-padding in scrambled order = reshape + pad row interleave
         (brev_{L1+e}(r1 * 2^e) = brev_{L1}(r1)) — no gather, and the
         extended transform's split is (log_n1+log_e, log_n2);
      3. gatherless-DIT forward NTT: scrambled -> NATURAL evaluations,
         ZERO gathers.
    """
    lo, hi = trace
    w, n = lo.shape
    assert w <= 10 and n & (n - 1) == 0
    assert expansion & (expansion - 1) == 0 and expansion > 0
    log_n = n.bit_length() - 1
    log_e = expansion.bit_length() - 1
    big_n = n * expansion
    log_n1, log_n2 = ntt_mod._four_step_split(log_n)
    n1, n2 = 1 << log_n1, 1 << log_n2
    d1, pw_dev, d4 = tables if tables is not None else \
        lde_scrambled_tables(n, expansion)

    import jax.numpy as jnp

    c_scr = ntt_mod.four_step_dif_general(
        (lo, hi), log_n, True, d1, split=(log_n1, log_n2), post_diag=pw_dev)

    def embed(a):
        a = a.reshape(w, n1, 1, n2)
        a = jnp.pad(a, ((0, 0), (0, 0), (0, expansion - 1), (0, 0)))
        return a.reshape(w, big_n)

    evals = ntt_mod.four_step_norev_general(
        (embed(c_scr[0]), embed(c_scr[1])), log_n + log_e, False, d4,
        split=(log_n1 + log_e, log_n2))
    return _hash_rows_commit(evals, w, big_n)


def lde_commit(x):
    """Single-chip LDE + commit on limb planes (rows, n).

    NTT each row, Tip5-hash each evaluation row into a leaf digest, reduce
    to a Merkle root over the `rows` leafs. Returns (1, 5) limb planes.
    Trace-composable; `rows` must be a power of two.
    """
    z = ntt_mod.ntt_limbs_traceable(x)
    leafs = tip5_dev.hash_varlen_padded(tip5_dev.pad_for_varlen(z))
    log_rows = leafs[0].shape[0].bit_length() - 1
    return dist_merkle._reduce_layers(leafs, log_rows)


@functools.lru_cache(maxsize=None)
def _make_dist_commit_tail(mesh, log_n: int):
    """Jitted (n2, n1) row-sharded evaluations -> (1, 5) root planes: leaf
    hashing per shard, then the sharded Merkle root."""
    _, n2 = dist_ntt._split_sizes(log_n)

    def hash_rows(lo, hi):
        # (n2/d, n1) local evaluation rows -> (n2/d, 5) leaf digests
        return tip5_dev.hash_varlen_padded(tip5_dev.pad_for_varlen((lo, hi)))

    hash_fn = shard_map(
        hash_rows, mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS, None)),
        out_specs=(P(AXIS, None), P(AXIS, None)),
    )
    merkle_fn = dist_merkle._make_distributed_root(mesh, n2.bit_length() - 1)

    @jax.jit
    def run(zlo, zhi):
        rlo, rhi = merkle_fn(*hash_fn(zlo, zhi))
        return rlo[:1], rhi[:1]

    return run


@functools.lru_cache(maxsize=None)
def make_dist_lde_commit(mesh, log_n: int, a2a_chunks: int | None = None):
    """Distributed LDE+commit: (n2, n1) column-sharded coefficient matrix
    -> replicated (1, 5) Merkle root limb planes. Two device programs, the
    distributed NTT and the commit tail, so NTTs that differ only in
    `a2a_chunks` (the transpose's overlap factor, dist_ntt.distributed_ntt)
    share one compiled tail."""
    ntt_run = dist_ntt._make_distributed_ntt(mesh, log_n, False, False,
                                             a2a_chunks)
    tail = _make_dist_commit_tail(mesh, log_n)

    def run(lo, hi):
        tw_lo, tw_hi = dist_ntt._twiddle_device(mesh, log_n, False)
        return tail(*ntt_run(lo, hi, tw_lo, tw_hi))

    return run


def dist_lde_commit_values(values: np.ndarray, mesh,
                           a2a_chunks: int | None = None) -> Digest:
    """Host-convenience: coefficient vector (n,) -> committed Merkle root."""
    values = np.asarray(values, dtype=np.uint64)
    n = values.shape[-1]
    log_n = n.bit_length() - 1
    n1, n2 = dist_ntt._split_sizes(log_n)
    lo, hi = make_dist_lde_commit(mesh, log_n, a2a_chunks)(
        *gf.to_limbs(values.reshape(n2, n1))
    )
    return Digest.from_array(gf.from_limbs((lo, hi))[0])
