"""Slab-mapped _local_pass branches, forced at small sizes.

On hardware the slab-mapped four-step branches only engage at
>= _SLAB_MIN_ELEMS (2^22) elements with a lane axis divisible by _SLAB
(128) — sizes the CPU-backend suite never reaches, so until this module
the production 2^22+ code paths (single-matrix slab map, the bsz>1
batch-fold, and the transposed slabs) had no in-suite coverage.
Here the module constants are monkeypatched down so every branch runs at
toy sizes against the host oracle. All calls are EAGER (no jit wrappers):
the slab dispatch is Python-level, and the jitted entry points cache
traces made under the real constants.
"""

import numpy as np
import pytest

from twenty_first_tpu.math import gf, ntt
from twenty_first_tpu.math.b_field_element import P

RNG = np.random.default_rng(0x51AB)


@pytest.fixture
def slab_forced(monkeypatch):
    """Force the slab-mapped branch of _local_pass / _local_pass_w64."""
    monkeypatch.setattr(ntt, "_SLAB", 4)
    monkeypatch.setattr(ntt, "_SLAB_MIN_ELEMS", 1)


def _host_ntt_rows(x, inverse=False):
    if x.ndim == 1:
        return ntt.ntt_host(x, inverse=inverse)
    return np.stack([_host_ntt_rows(r, inverse) for r in x])


@pytest.mark.parametrize("batch", [(), (3,)])
@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_slab_branch_matches_oracle(slab_forced, batch, inverse):
    # log 8 -> split (4, 4): both passes have 16 lanes, divisible by the
    # forced _SLAB=4. batch=(3,) drives the bsz>1 batch-fold branch.
    log_n = 8
    n = 1 << log_n
    x = RNG.integers(0, P, size=batch + (n,), dtype=np.uint64)
    lo, hi = gf.to_limbs(x)
    diag = ntt._four_step_diag_device(log_n, inverse)
    got = gf.from_limbs(
        ntt.four_step_ntt_traceable((lo, hi), log_n, inverse, diag))
    want = _host_ntt_rows(x, inverse=inverse)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_scrambled_slab_branch_roundtrip_and_oracle(slab_forced, batch):
    log_n = 8
    n = 1 << log_n
    x = RNG.integers(0, P, size=batch + (n,), dtype=np.uint64)
    lo, hi = gf.to_limbs(x)
    dfwd = ntt._scrambled_diag_device(log_n, False)
    dinv = ntt._scrambled_diag_device(log_n, True)
    fwd = ntt.four_step_ntt_scrambled((lo, hi), log_n, False, dfwd)
    # forward output is scrambled; the inverse restores natural order —
    # the roundtrip checks both gatherless cores (dif + norev) slab-mapped
    back = ntt.four_step_ntt_scrambled(fwd, log_n, True, dinv)
    np.testing.assert_array_equal(gf.from_limbs(back), x)
    # and the scrambled layout itself is the documented permutation
    log_n1, log_n2 = ntt._four_step_split(log_n)
    n1, n2 = 1 << log_n1, 1 << log_n2
    r1 = ntt._bit_reverse_permutation(log_n1).astype(np.int64)
    r2 = ntt._bit_reverse_permutation(log_n2).astype(np.int64)
    natural = _host_ntt_rows(x)
    perm = (r2[None, :] + n2 * r1[:, None]).reshape(-1)
    np.testing.assert_array_equal(
        gf.from_limbs(fwd).reshape(batch + (n,)), natural[..., perm])


def test_general_split_slab_branch_lde_chain(slab_forced):
    """The scrambled-interior LDE chain (dif_general -> pad -> norev
    _general with a non-square split) on the slab-mapped branch — the
    exact interior trace_lde_commit_scrambled runs at 2^22 on hardware."""
    import jax.numpy as jnp

    from twenty_first_tpu.math import gf_numpy as gfn
    from twenty_first_tpu.math.b_field_element import GENERATOR
    from twenty_first_tpu.parallel.pipeline import lde_scrambled_tables

    log_n, w, e = 8, 3, 4
    n = 1 << log_n
    log_e = e.bit_length() - 1
    x = RNG.integers(0, P, size=(w, n), dtype=np.uint64)

    coeff = _host_ntt_rows(x, inverse=True)
    pw = gfn.powers(GENERATOR, n)
    padded_host = np.zeros((w, n * e), dtype=np.uint64)
    padded_host[:, :n] = gfn.mul(coeff, pw[None, :])
    want = _host_ntt_rows(padded_host)

    log_n1, log_n2 = ntt._four_step_split(log_n)
    n1, n2 = 1 << log_n1, 1 << log_n2
    d1, pw_dev, d4 = lde_scrambled_tables(n, e)
    lo, hi = gf.to_limbs(x)
    c_scr = ntt.four_step_dif_general((lo, hi), log_n, True, d1,
                                      split=(log_n1, log_n2),
                                      post_diag=pw_dev)

    def embed(a):
        a = a.reshape(w, n1, 1, n2)
        a = jnp.pad(a, ((0, 0), (0, 0), (0, e - 1), (0, 0)))
        return a.reshape(w, n * e)

    ev = ntt.four_step_norev_general((embed(c_scr[0]), embed(c_scr[1])),
                                     log_n + log_e, False, d4,
                                     split=(log_n1 + log_e, log_n2))
    got = gf.from_limbs((np.asarray(ev[0]), np.asarray(ev[1])))
    np.testing.assert_array_equal(got, want)


def test_w64_slab_branch_matches_oracle(slab_forced):
    import jax.numpy as jnp

    log_n = 8
    n = 1 << log_n
    x = RNG.integers(0, P, size=n, dtype=np.uint64)
    for inverse in (False, True):
        diag = ntt._four_step_diag_device_w64(log_n, inverse)
        got = np.asarray(
            ntt.four_step_ntt_w64(jnp.asarray(x), log_n, inverse, diag))
        want = ntt.ntt_host(x, inverse=inverse)
        np.testing.assert_array_equal(got, want)
