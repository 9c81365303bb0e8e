"""Distributed NTT: four-step (Bailey) decomposition over a device mesh.

The reference's NTT is a single-threaded in-place butterfly loop
(ntt.rs:195-214) that callers parallelize *across many independent NTTs*. To
scale ONE transform across chips — the "tensor parallelism" of this library —
we use the classic four-step factorization n = n1 * n2:

    with j = j1 + n1*j2,  k = k2 + n2*k1:
    X[k2 + n2*k1] = NTT_n1( w^(j1*k2) * NTT_n2( x[j1 + n1*j2] )_{over j2} )_{over j1}

  1. view x as an (n2, n1) matrix (row-major), shard columns j1 over chips;
  2. each chip runs *local* length-n2 NTTs over its column block;
  3. multiply by the diagonal twiddles w^(j1*k2) (chip-local block);
  4. one all-to-all transpose re-shards rows k2 over chips (the only
     communication; NVLink between the cards of one host);
  5. each chip runs local length-n1 NTTs;

Output is the natural-order X viewed as an (n2, n1) matrix holding X^T
(entry [k2, k1] = X[k2 + n2*k1]), sharded over rows k2 — i.e. X is sharded
*cyclically*. `distributed_ntt` returns this transposed layout by default
(pipelines that follow with an elementwise step don't care); pass
`natural_output=True` to pay a second all-to-all for block-contiguous
natural order.

All arithmetic is the same gf limb-plane code as the single-chip path, so
multi-chip results are bit-exact by construction.
"""

from __future__ import annotations

import functools

import numpy as np
import jax

from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..math import gf
from ..math import gf_numpy as gfn
from ..math import ntt as ntt_mod
from ..math.b_field_element import PRIMITIVE_ROOTS
from ..math.b_field_element import P as FIELD_P
from .mesh import AXIS


def _split_sizes(log_n: int) -> tuple[int, int]:
    """n1 (outer/natural-row) and n2 (inner) with n1 * n2 = 2^log_n."""
    log_n1 = log_n // 2
    return 1 << log_n1, 1 << (log_n - log_n1)


@functools.lru_cache(maxsize=None)
def _twiddle_matrix(log_n: int, inverse: bool) -> np.ndarray:
    """w^(j1*k2) as an (n2, n1) uint64 matrix (rows k2, cols j1)."""
    n = 1 << log_n
    n1, n2 = _split_sizes(log_n)
    root = PRIMITIVE_ROOTS[n]
    if inverse:
        root = pow(root, FIELD_P - 2, FIELD_P)
    j1 = gfn.powers(root, n1)  # w^j1
    # rows: w^(j1*k2) = (w^j1)^k2 — build by repeated Hadamard products
    out = np.empty((n2, n1), dtype=np.uint64)
    out[0] = 1
    for k2 in range(1, n2):
        out[k2] = gfn.mul(out[k2 - 1], j1)
    return out


def _local_ntt(x, log_m: int, inverse: bool):
    """Local last-axis NTT using the single-chip tables (no collectives)."""
    return ntt_mod._ntt_core(x, log_m, inverse)


def _a2a_chunks_default() -> int:
    """Transpose/compute overlap factor.

    The all-to-all is the distributed NTT's ONLY collective; splitting it
    into per-destination-row chunks interleaved with the second local pass
    lets XLA's latency-hiding scheduler overlap communication chunk i+1
    with compute chunk i, hiding up to (C-1)/C of the transpose. Default 4
    (chosen from a ring-network model; C=1 against C=4 on four H100s is in
    PERF.md). Set TWENTY_FIRST_TPU_A2A_CHUNKS=1 to disable."""
    import os

    return max(1, int(os.environ.get("TWENTY_FIRST_TPU_A2A_CHUNKS", "4")))


@functools.lru_cache(maxsize=None)
def _make_distributed_ntt(mesh, log_n: int, inverse: bool,
                          natural_output: bool, a2a_chunks: int | None = None):
    n1, n2 = _split_sizes(log_n)
    d = mesh.shape[AXIS]
    if n1 % d or n2 % d:
        raise ValueError(f"n1={n1}, n2={n2} must be divisible by mesh size {d}")
    log_n1 = n1.bit_length() - 1
    log_n2 = n2.bit_length() - 1
    n_inv = pow(1 << log_n, FIELD_P - 2, FIELD_P)
    chunks = _a2a_chunks_default() if a2a_chunks is None else a2a_chunks
    if n2 % (d * chunks) or (n2 // d) % chunks:
        chunks = 1  # indivisible: monolithic transpose

    def _a2a(t):
        return jax.lax.all_to_all(t, AXIS, split_axis=0, concat_axis=1,
                                  tiled=True)

    def local(lo, hi, tw_lo, tw_hi):
        # lo, hi: (n2, n1/d) — this chip's column block (j1 sharded).
        # Step 2: local NTTs over j2 = axis -2 (slab-mapped when large),
        # with this chip's diagonal-twiddle block fused into the same pass.
        y = ntt_mod._local_pass((lo, hi), log_n2, inverse,
                                diag=(tw_lo, tw_hi))
        if chunks == 1:
            # all-to-all transpose: shard rows k2, gather all columns j1
            z = _local_ntt((_a2a(y[0]), _a2a(y[1])), log_n1, inverse)
        else:
            # Chunked transpose overlapped with the second local pass.
            # Chunks are taken WITHIN each destination's row block: viewing
            # the (n2, n1/d) matrix as (d, chunks, B/chunks, n1/d) with
            # B = n2/d, chunk i's all-to-all hands chip p exactly the
            # global rows [p*B + i*B/chunks, p*B + (i+1)*B/chunks), so
            # concatenating the per-chunk NTT results reassembles the same
            # block row-sharding as the monolithic transpose — bit-exact
            # by construction. The chunks carry no data dependence between
            # chunk i's collective and chunk j's butterflies, which is
            # what lets the scheduler run them concurrently.
            import jax.numpy as jnp

            b = n2 // d

            def sel(t, i):
                return t.reshape(d, chunks, b // chunks, -1)[:, i].reshape(
                    n2 // chunks, -1)

            zs = [
                _local_ntt((_a2a(sel(y[0], i)), _a2a(sel(y[1], i))),
                           log_n1, inverse)
                for i in range(chunks)
            ]
            z = (jnp.concatenate([zz[0] for zz in zs], axis=0),
                 jnp.concatenate([zz[1] for zz in zs], axis=0))
        if inverse:
            z = gf.mul_const(z, n_inv)
        return z[0], z[1]

    in_specs = (P(None, AXIS), P(None, AXIS), P(None, AXIS), P(None, AXIS))
    out_specs = (P(AXIS, None), P(AXIS, None))
    fn = shard_map(local, mesh=mesh, in_specs=in_specs, out_specs=out_specs)

    def natural(zlo, zhi):
        # z is (n2, n1) holding X^T sharded over rows; a second all-to-all
        # plus local transpose yields natural-order (n1, n2) sharded rows.
        def tr(lo, hi):
            lo = jax.lax.all_to_all(lo, AXIS, split_axis=1, concat_axis=0,
                                    tiled=True)
            hi = jax.lax.all_to_all(hi, AXIS, split_axis=1, concat_axis=0,
                                    tiled=True)
            return lo.T, hi.T

        return shard_map(tr, mesh=mesh, in_specs=(P(AXIS, None), P(AXIS, None)),
                         out_specs=(P(AXIS, None), P(AXIS, None)))(zlo, zhi)

    @jax.jit
    def run(lo, hi, tw_lo, tw_hi):
        # The (n2, n1) diagonal-twiddle matrix is a runtime argument, not a
        # baked constant: at 2^26 it is half a gigabyte of table.
        zlo, zhi = fn(lo, hi, tw_lo, tw_hi)
        if natural_output:
            zlo, zhi = natural(zlo, zhi)
        return zlo, zhi

    return run


@functools.lru_cache(maxsize=None)
def _twiddle_device(mesh, log_n: int, inverse: bool):
    """Column-sharded device copy of the diagonal twiddle matrix.

    Uses shard_host_array so each process only materializes its own
    column block (multi-process safe)."""
    from .mesh import shard_host_array

    tw = _twiddle_matrix(log_n, inverse)
    lo = (tw & np.uint64(0xFFFF_FFFF)).astype(np.uint32)
    hi = (tw >> np.uint64(32)).astype(np.uint32)
    return (shard_host_array(mesh, (None, AXIS), lo),
            shard_host_array(mesh, (None, AXIS), hi))


def distributed_ntt(x, mesh, inverse: bool = False,
                    natural_output: bool = False,
                    a2a_chunks: int | None = None):
    """Distributed NTT of limb planes shaped (n2, n1) (see module docstring).

    Input: the coefficient vector x viewed as matrix M[j2, j1] = x[j1 + n1*j2]
    (i.e. `x.reshape(n2, n1)`). Output: (n2, n1) matrix Z with
    Z[k2, k1] = X[k2 + n2*k1]; pass natural_output=True for an (n1, n2)
    matrix holding X in row-major natural order.

    a2a_chunks: transpose/compute overlap factor (None = the
    TWENTY_FIRST_TPU_A2A_CHUNKS default, 4); bit-exact for any value.
    """
    lo, hi = x
    n2, n1 = lo.shape
    log_n = (n1 * n2).bit_length() - 1
    if (1 << log_n) != n1 * n2:
        raise ValueError("total size must be a power of two")
    expect_n1, expect_n2 = _split_sizes(log_n)
    if (n1, n2) != (expect_n1, expect_n2):
        raise ValueError(
            f"input must be shaped (n2, n1) = ({expect_n2}, {expect_n1})"
        )
    tw_lo, tw_hi = _twiddle_device(mesh, log_n, inverse)
    return _make_distributed_ntt(mesh, log_n, inverse, natural_output,
                                 a2a_chunks)(
        lo, hi, tw_lo, tw_hi
    )


def distributed_ntt_values(values: np.ndarray, mesh, inverse: bool = False,
                           a2a_chunks: int | None = None) -> np.ndarray:
    """Host-convenience: uint64 vector (n,) -> natural-order NTT via the mesh."""
    values = np.asarray(values, dtype=np.uint64)
    n = values.shape[-1]
    log_n = n.bit_length() - 1
    n1, n2 = _split_sizes(log_n)
    x = gf.to_limbs(values.reshape(n2, n1))
    zlo, zhi = distributed_ntt(x, mesh, inverse=inverse, natural_output=True,
                               a2a_chunks=a2a_chunks)
    return gf.from_limbs((zlo, zhi)).reshape(-1)


def distributed_ntt_xfe_values(values: np.ndarray, mesh,
                               inverse: bool = False) -> np.ndarray:
    """Distributed extension-field NTT of (n, 3) canonical values.

    The NTT is base-field-linear with base-field twiddles (the reference's
    single generic path, ntt.rs:34-82, covers both fields for the same
    reason), so an xfe transform is three independent base-field plane
    transforms; each plane rides the same sharded four-step graph and
    twiddle shards (cached after the first call)."""
    values = np.asarray(values, dtype=np.uint64)
    if values.ndim != 2 or values.shape[1] != 3:
        raise ValueError("expected (n, 3) extension-field values")
    planes = [distributed_ntt_values(values[:, i], mesh, inverse=inverse)
              for i in range(3)]
    return np.stack(planes, axis=1)
