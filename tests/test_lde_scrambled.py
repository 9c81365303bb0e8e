"""Scrambled-interior LDE pipeline vs the natural-order pipeline and the
host oracle (DESIGN.md §8).

The variant must be bit-exact INCLUDING the Merkle root — its final
gatherless-DIT pass restores natural evaluation order, so the leaf
contract is unchanged.
"""

import numpy as np
import pytest

import jax

from twenty_first_tpu.math import gf, gf_numpy as gfn, ntt
from twenty_first_tpu.math.b_field_element import GENERATOR, P
from twenty_first_tpu.parallel.pipeline import (
    lde_commit_diags,
    lde_scrambled_tables,
    trace_lde_commit,
    trace_lde_commit_scrambled,
)

RNG = np.random.default_rng(0x1DE)


@pytest.mark.parametrize("log_n,w,expansion", [(6, 3, 4), (8, 8, 4),
                                               (7, 1, 2)])
def test_scrambled_transform_chain_matches_oracle(log_n, w, expansion):
    n, e = 1 << log_n, expansion
    x = RNG.integers(0, P, size=(w, n), dtype=np.uint64)
    coeff = np.stack([ntt.ntt_host(r, inverse=True) for r in x])
    pw = gfn.powers(GENERATOR, n)
    padded = np.zeros((w, n * e), dtype=np.uint64)
    padded[:, :n] = gfn.mul(coeff, pw[None, :])
    want = np.stack([ntt.ntt_host(r) for r in padded])

    log_e = e.bit_length() - 1
    log_n1, log_n2 = ntt._four_step_split(log_n)
    d1, pw_dev, d4 = lde_scrambled_tables(n, e)
    lo, hi = gf.to_limbs(x)
    c_scr = ntt.four_step_dif_general((lo, hi), log_n, True, d1,
                                      split=(log_n1, log_n2),
                                      post_diag=pw_dev)

    import jax.numpy as jnp

    n1, n2 = 1 << log_n1, 1 << log_n2

    def embed(a):
        a = a.reshape(w, n1, 1, n2)
        a = jnp.pad(a, ((0, 0), (0, 0), (0, e - 1), (0, 0)))
        return a.reshape(w, n * e)

    ev = ntt.four_step_norev_general((embed(c_scr[0]), embed(c_scr[1])),
                                     log_n + log_e, False, d4,
                                     split=(log_n1 + log_e, log_n2))
    got = gf.from_limbs((np.asarray(ev[0]), np.asarray(ev[1])))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("log_n,w", [(6, 3), (8, 8)])
def test_scrambled_pipeline_root_matches_natural(log_n, w):
    n = 1 << log_n
    x = RNG.integers(0, P, size=(w, n), dtype=np.uint64)
    lo, hi = gf.to_limbs(x)
    diags = lde_commit_diags(n, 4)
    want = jax.jit(lambda a, b: trace_lde_commit((a, b), ntt_diags=diags))(
        lo, hi)
    tables = lde_scrambled_tables(n, 4)
    got = jax.jit(lambda a, b: trace_lde_commit_scrambled(
        (a, b), tables=tables))(lo, hi)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
