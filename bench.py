"""Benchmark harness: prints ONE JSON line with the headline metric.

Headline: Goldilocks NTT 2^24 throughput (elements/s) on one chip.
Extras mirror the reference's criterion bench suite
(twenty-first/benches/*.rs): Tip5 hash_10 / hash_pair / hash_varlen /
65536-batch, Merkle commit heights 16/20 (parallel analogue) + host-object
new/frugal_root rows (benches/merkle_tree.rs:10-40) + auth-structure
open/verify, polynomial evaluate/interpolate/extrapolate/multiply/
clean-divide/zerofier/mod-reduce/coset, xfe NTT (benches/ntt.rs:48-82),
batch inversion (benches/inverses.rs), bfe/xfe/mixed muls
(benches/various_muls.rs), lattice KEM roundtrip, codec roundtrip, and the
orderless-convolution delta rows (gather cancellation, DESIGN.md §8).

Timing: device kernels are timed as k-fold chained applications inside
one jit with an in-graph scalar checksum, interleaving the k_lo / k_hi
calls, and reporting the MEDIAN of the per-round differences
(t_hi - t_lo)/(k_hi - k_lo). Host-side benches (the polynomial object API,
host Merkle, KEM, codec) use plain wall timing — they ARE host code.

Every protocol row that cannot run inside the time budget is emitted as
"dropped:budget" instead of silently vanishing. The persistent XLA
compilation cache (config.enable_compilation_cache) makes repeat runs skip
compilation.

Two profiles:
  * driver profile (default): the headline + ~10 key rows, sized to
    finish inside BENCH_BUDGET_S=480 warm. Everything else is recorded as
    "skipped:driver-profile" in the file artifact.
  * BENCH_FULL=1: the complete criterion-protocol mirror.
In BOTH profiles stdout carries ONE SMALL JSON line (<= 2048 bytes,
asserted) with only the whitelisted key rows; the complete extras dict is
written to BENCH_full.json (full profile) / BENCH_driver.json (driver
profile) next to this script.

The reference publishes no absolute numbers (BASELINE.md), so vs_baseline
is 1.0 against the empty published set.
"""

import functools
import json
import os
import sys
import time

import numpy as np

_T0 = time.time()


def _p(msg):
    """Progress marker on stderr (stdout stays the single JSON line)."""
    print(f"[bench +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


# stdout whitelist: the key rows the driver's tail capture must always
# contain, most-important-last-dropped first. Everything else lives only
# in the file artifact.
_STDOUT_ROWS = (
    "ntt_2^24_s",
    "tip5_permutations_per_s",
    "merkle_2^20_commit_s",
    "lde_commit_2^22_rows_w8_s",
    "merkle_2^16_commit_s",
    "tip5_hash_varlen_16386_s",
    "xfe_ntt_2^18_s",
    "poly_multiply_deg_2^14_s",
    "device",
    "profile",
    "elapsed_s",
)

_STDOUT_LIMIT = 2048


def main():
    t_start = time.time()
    budget = float(os.environ.get("BENCH_BUDGET_S", "480"))
    full = os.environ.get("BENCH_FULL", "0") == "1"

    import jax
    import jax.numpy as jnp

    from twenty_first_tpu.config import enable_compilation_cache
    from twenty_first_tpu.math import gf, ntt
    from twenty_first_tpu.tip5 import permutation as tip5_dev

    enable_compilation_cache()
    rng = np.random.default_rng(0)
    p = (1 << 64) - (1 << 32) + 1
    import jaxlib

    extras = {
        "device": str(jax.devices()[0]),
        "device_kind": jax.devices()[0].device_kind,
        "profile": "full" if full else "driver",
        "versions": {"jax": jax.__version__,
                     "jaxlib": getattr(jaxlib, "__version__", "?")},
        "methodology": ("device rows: interleaved k-chain, median of "
                        "per-round differences; host rows: min wall-clock"),
    }
    dropped = []
    skipped_profile = []

    def remaining():
        return budget - (time.time() - t_start)

    def block(names, need):
        """Budget gate; on a drop, records every row the block would have
        produced as dropped:budget instead of silently omitting it."""
        if remaining() > need:
            return True
        if isinstance(names, str):
            names = [names]
        dropped.extend(names)
        return False

    def full_block(names, need):
        """Row(s) in the full protocol only: under the driver profile they
        are recorded as skipped:driver-profile in the file artifact."""
        if full:
            return block(names, need)
        if isinstance(names, str):
            names = [names]
        skipped_profile.extend(names)
        return False

    def timed_chain(fn, args, k_lo, k_hi, reps=3):
        """Median over reps of (t(k_hi)-t(k_lo))/(k_hi-k_lo), interleaved.

        Two executables per row (k_lo and k_hi; one where k is a dynamic
        fori_loop bound). A difference that comes out <= 0 (dispatch
        noise larger than the device time) is replaced by median(t_hi)/k_hi,
        an upper bound."""
        for k in (k_lo, k_hi):
            int(fn(*args, k=k))
        diffs, highs = [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            int(fn(*args, k=k_lo))
            tl = time.perf_counter() - t0
            t0 = time.perf_counter()
            int(fn(*args, k=k_hi))
            th = time.perf_counter() - t0
            diffs.append((th - tl) / (k_hi - k_lo))
            highs.append(th)
        diffs.sort()
        highs.sort()
        est = diffs[len(diffs) // 2]
        if est <= 0:
            est = highs[len(highs) // 2] / k_hi
        return est

    def timed_host(fn, reps=3):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best

    # ======================================================================
    # headline: NTT 2^24 (four-step)  [benches/ntt.rs bfe rows, scaled up]
    # ======================================================================
    log_n = int(os.environ.get("BENCH_NTT_LOG_N", "24"))
    n = 1 << log_n
    x = rng.integers(0, p, size=n, dtype=np.uint64)
    lo, hi = (jax.device_put(v) for v in gf.to_limbs(x))
    diag = ntt._four_step_diag_device(log_n, False)

    @functools.partial(jax.jit, static_argnames=("k",))
    def ntt_chain(a, b, dlo, dhi, k):
        # python-unrolled chain (NOT fori_loop): while-loop carries can
        # insert full-plane copies per iteration
        o = (a, b)
        for _ in range(k):
            o = ntt.four_step_ntt_traceable(o, log_n, False, (dlo, dhi))
        return jnp.sum(o[0], dtype=jnp.uint32) + jnp.sum(o[1], dtype=jnp.uint32)

    _p("headline ntt start")
    t_ntt = timed_chain(ntt_chain, (lo, hi, diag[0], diag[1]), 1, 3, reps=6)
    ntt_elems_per_s = n / t_ntt
    extras[f"ntt_2^{log_n}_s"] = t_ntt

    # ======================================================================
    # device protocol rows (cheap; run BEFORE the heavy hash/LDE blocks)
    # ======================================================================

    # --- xfe NTT 2^18 (benches/ntt.rs xfe rows) -----------------------------
    if block("xfe_ntt_2^18_s", 60):
        xlog = 18
        xdata = rng.integers(0, p, size=(3, 1 << xlog), dtype=np.uint64)
        xlo, xhi = (jax.device_put(v) for v in gf.to_limbs(xdata))
        xdiag = ntt._four_step_diag_device(xlog, False)

        @functools.partial(jax.jit, static_argnames=("k",))
        def xntt_chain(a, b, dlo, dhi, k):
            o = (a, b)
            for _ in range(k):
                o = ntt.four_step_ntt_traceable(o, xlog, False, (dlo, dhi))
            return (jnp.sum(o[0], dtype=jnp.uint32)
                    + jnp.sum(o[1], dtype=jnp.uint32))

        _p("xfe ntt start")
        t_xntt = timed_chain(xntt_chain, (xlo, xhi, xdiag[0], xdiag[1]), 1, 9)
        extras["xfe_ntt_2^18_s"] = t_xntt

    # --- device batch inversion 2^20 (benches/inverses.rs) ------------------
    if full_block("batch_inversion_2^20_s", 50):
        inv_vals = rng.integers(1, p, size=1 << 20, dtype=np.uint64)
        ilo, ihi = (jax.device_put(v) for v in gf.to_limbs(inv_vals))

        @jax.jit
        def inv_chain(a, b, k):
            def body(i, st):
                return gf.batch_inversion(st)
            o = jax.lax.fori_loop(0, k, body, (a, b))
            return (jnp.sum(o[0], dtype=jnp.uint32)
                    + jnp.sum(o[1], dtype=jnp.uint32))

        _p("batch inversion start")
        t_inv = timed_chain(inv_chain, (ilo, ihi), 1, 9)
        extras["batch_inversion_2^20_s"] = t_inv

    # --- device muls 2^20: bfe*bfe / xfe*xfe / xfe*bfe ----------------------
    # (benches/various_muls.rs)
    if full_block(["bfe_mul_2^20_per_s", "xfe_mul_2^20_per_s",
                   "xfe_bfe_mul_2^20_per_s"], 60):
        from twenty_first_tpu.math import gf_ext

        ba = rng.integers(0, p, size=1 << 20, dtype=np.uint64)
        blo2, bhi2 = (jax.device_put(v) for v in gf.to_limbs(ba))
        xa = rng.integers(0, p, size=(3, 1 << 20), dtype=np.uint64)
        xb = rng.integers(0, p, size=(3, 1 << 20), dtype=np.uint64)
        alo, ahi = (jax.device_put(v) for v in gf.to_limbs(xa))
        blo, bhi = (jax.device_put(v) for v in gf.to_limbs(xb))

        @jax.jit
        def bmul_chain(al, ah, bl, bh, k):
            def body(i, st):
                return gf.mul(st, (bl, bh))
            o = jax.lax.fori_loop(0, k, body, (al, ah))
            return (jnp.sum(o[0], dtype=jnp.uint32)
                    + jnp.sum(o[1], dtype=jnp.uint32))

        @jax.jit
        def xmul_chain(al, ah, bl, bh, k):
            def body(i, st):
                return gf_ext.mul(st, (bl, bh))
            o = jax.lax.fori_loop(0, k, body, (al, ah))
            return (jnp.sum(o[0], dtype=jnp.uint32)
                    + jnp.sum(o[1], dtype=jnp.uint32))

        @jax.jit
        def xbmul_chain(al, ah, bl, bh, k):
            def body(i, st):
                return gf_ext.mul_base(st, (bl, bh))
            o = jax.lax.fori_loop(0, k, body, (al, ah))
            return (jnp.sum(o[0], dtype=jnp.uint32)
                    + jnp.sum(o[1], dtype=jnp.uint32))

        _p("muls start")
        t_bmul = timed_chain(bmul_chain, (blo2, bhi2, blo2, bhi2), 1, 17)
        extras["bfe_mul_2^20_per_s"] = (1 << 20) / t_bmul
        t_xmul = timed_chain(xmul_chain, (alo, ahi, blo, bhi), 1, 9)
        extras["xfe_mul_2^20_per_s"] = (1 << 20) / t_xmul
        t_xbmul = timed_chain(xbmul_chain, (alo, ahi, blo2, bhi2), 1, 17)
        extras["xfe_bfe_mul_2^20_per_s"] = (1 << 20) / t_xbmul

    # ======================================================================
    # Tip5 permutation / hash_10 / hash_pair throughput (benches/tip5.rs)
    # ======================================================================
    if block(["tip5_permutations_per_s", "tip5_hash_10_batch_65536_s",
              "tip5_hash_pair_per_s"], 100):
        batch = 1 << 16  # the reference's parallel bench batch (tip5.rs)
        states = rng.integers(0, p, size=(batch, 16), dtype=np.uint64)
        slo, shi = (jax.device_put(v) for v in gf.to_limbs(states))

        @jax.jit
        def perm_chain(a, b, k):
            def body(i, st):
                return tip5_dev.permutation(st)
            o = jax.lax.fori_loop(0, k, body, (a, b))
            return (jnp.sum(o[0], dtype=jnp.uint32)
                    + jnp.sum(o[1], dtype=jnp.uint32))

        _p("tip5 perm start")
        t_perm = timed_chain(perm_chain, (slo, shi), 2, 18, reps=8)
        # hash_10 / hash_pair report the fused-pipeline rate (one
        # permutation each)
        extras["tip5_hash_10_batch_65536_s"] = t_perm
        extras["tip5_hash_pair_per_s"] = batch / t_perm

        @jax.jit
        def perm_chain_standalone(a, b, k):
            def body(i, st):
                return tip5_dev.permutation_batch(st)
            o = jax.lax.fori_loop(0, k, body, (a, b))
            return (jnp.sum(o[0], dtype=jnp.uint32)
                    + jnp.sum(o[1], dtype=jnp.uint32))

        _p("tip5 standalone start")
        t_standalone = timed_chain(perm_chain_standalone, (slo, shi), 2, 18,
                                   reps=8)
        extras["tip5_permutation_batch_2^16_s"] = t_standalone
        extras["tip5_permutations_per_s"] = batch / t_standalone

    # --- Tip5 hash_varlen (length 16386, reference bench shape) ------------
    if block("tip5_hash_varlen_16386_s", 80):
        rows = 64
        data = rng.integers(0, p, size=(rows, 16386), dtype=np.uint64)
        padded = np.zeros((rows, 16390), dtype=np.uint64)
        padded[:, :16386] = data
        padded[:, 16386] = 1
        vlo, vhi = (jax.device_put(v) for v in gf.to_limbs(padded))

        @jax.jit
        def varlen_chain(a, b, k):
            # carry-dependent input: prevents loop-invariant hoisting
            def body(i, acc):
                o = tip5_dev.hash_varlen_padded((a ^ acc[0], b))
                return (acc[0] ^ jnp.sum(o[0], dtype=jnp.uint32),
                        acc[1] + jnp.sum(o[1], dtype=jnp.uint32))
            o = jax.lax.fori_loop(
                0, k, body,
                (jnp.zeros((), jnp.uint32), jnp.zeros((), jnp.uint32)))
            return o[0] + o[1]

        _p("tip5 varlen start")
        t_varlen = timed_chain(varlen_chain, (vlo, vhi), 1, 9)
        extras["tip5_hash_varlen_16386_batch_s"] = t_varlen
        extras["tip5_hash_varlen_16386_s"] = t_varlen / rows

    # ======================================================================
    # Merkle (benches/merkle_tree.rs:10-40 + auth structure)
    # ======================================================================

    # --- device in-graph commit heights 16/20: par_new analogue ------------
    if True:
        from twenty_first_tpu.parallel import dist_merkle

        # height 16 is full-profile-only; the driver profile keeps 2^20
        for height in (16, 20):
            gate = block if height == 20 else full_block
            if not gate(f"merkle_2^{height}_commit_s",
                        60 if height == 16 else 90):
                continue
            leafs = rng.integers(0, p, size=(1 << height, 5), dtype=np.uint64)
            llo, lhi = (jax.device_put(v) for v in gf.to_limbs(leafs))

            @functools.partial(jax.jit, static_argnames=("height",))
            def merkle_chain(a, b, k, height=height):
                # the input must DEPEND on the carry or XLA hoists the
                # whole reduction out of the loop (loop-invariant code
                # motion) and the k-chain measures one iteration
                def body(i, acc):
                    r = dist_merkle._reduce_layers((a ^ acc[0], b), height)
                    return (acc[0] ^ jnp.sum(r[0], dtype=jnp.uint32),
                            acc[1] + jnp.sum(r[1], dtype=jnp.uint32))
                o = jax.lax.fori_loop(
                    0, k, body,
                    (jnp.zeros((), jnp.uint32), jnp.zeros((), jnp.uint32)))
                return o[0] + o[1]

            _p(f"merkle {height} start")
            t_merkle = timed_chain(merkle_chain, (llo, lhi), 1, 5, reps=3)
            extras[f"merkle_2^{height}_commit_s"] = t_merkle

    # --- host object API: new / frugal_root (the reference's 4 bench
    #     groups; par_* == sequential_* here — the native layer hashing is
    #     OpenMP-parallel, the device path is batch-parallel) ---------------
    if full_block(["merkle_new_2^16_s", "merkle_root_frugal_2^16_s"], 40):
        from twenty_first_tpu.util_types.merkle_tree import MerkleTree

        leafs16 = rng.integers(0, p, size=(1 << 16, 5), dtype=np.uint64)
        _p("merkle host 16 start")
        extras["merkle_new_2^16_s"] = timed_host(
            lambda: MerkleTree.new(leafs16), reps=2)
        extras["merkle_root_frugal_2^16_s"] = timed_host(
            lambda: MerkleTree.frugal_root(leafs16), reps=2)

    if full_block(["merkle_new_2^20_s", "merkle_root_frugal_2^20_s"], 40):
        from twenty_first_tpu.util_types.merkle_tree import MerkleTree

        leafs20 = rng.integers(0, p, size=(1 << 20, 5), dtype=np.uint64)
        _p("merkle host 20 start")
        extras["merkle_new_2^20_s"] = timed_host(
            lambda: MerkleTree.new(leafs20), reps=1)
        extras["merkle_root_frugal_2^20_s"] = timed_host(
            lambda: MerkleTree.frugal_root(leafs20), reps=1)

    # --- Merkle auth-structure open + verify (host path) -------------------
    if full_block("merkle_2^10_auth_open_verify_s", 30):
        from twenty_first_tpu.util_types.merkle_tree import MerkleTree

        leafs_o = rng.integers(0, p, size=(1 << 10, 5), dtype=np.uint64)
        tree = MerkleTree.new(leafs_o)
        indices = list(range(0, 1 << 10, 37))

        def open_and_verify():
            proof = tree.inclusion_proof_for_leaf_indices(indices)
            assert proof.verify(tree.root())

        _p("merkle auth start")
        extras["merkle_2^10_auth_open_verify_s"] = timed_host(open_and_verify)

    # --- Merkle auth-structure size (benches/..._auth_structure_size.rs) ---
    if full_block("merkle_2^12_auth_structure_digests_32idx", 25):
        from twenty_first_tpu.util_types.merkle_tree import MerkleTree

        leafs_a = rng.integers(0, p, size=(1 << 12, 5), dtype=np.uint64)
        tree_a = MerkleTree.new(leafs_a)
        idxs = list(range(0, 1 << 12, 1 << 7))  # 32 spread-out openings
        proof_a = tree_a.inclusion_proof_for_leaf_indices(idxs)
        extras["merkle_2^12_auth_structure_digests_32idx"] = len(
            proof_a.authentication_structure)

    # ======================================================================
    # polynomial suite (host object API over vectorized arrays)
    # ======================================================================
    # multiply is the driver profile's representative poly row; the rest
    # of the suite is full-profile
    if block("poly_multiply_deg_2^14_s", 25):
        from twenty_first_tpu.math.polynomial import Polynomial

        deg = (1 << 14) - 1
        pa = Polynomial.from_array(
            rng.integers(0, p, size=deg + 1, dtype=np.uint64))
        pb = Polynomial.from_array(
            rng.integers(0, p, size=deg + 1, dtype=np.uint64))
        _p("poly multiply start")
        extras["poly_multiply_deg_2^14_s"] = timed_host(
            lambda: pa.fast_multiply(pb))

    if full_block(["poly_interpolate_2^9_s", "poly_interpolate_2^10_s",
                   "poly_interpolate_2^15_s",
                   "poly_batch_evaluate_2^14_on_2^14_s",
                   "poly_batch_evaluate_2^12_on_2^9_s", "poly_zerofier_2^9_s",
                   "poly_clean_divide_2^12_s"], 50):
        from twenty_first_tpu.math.polynomial import Polynomial
        from twenty_first_tpu.math.b_field_element import bfe

        _p("poly suite start")
        dom = rng.integers(1, p, size=1 << 10, dtype=np.uint64)
        dom = np.unique(dom)[: 1 << 9]
        vals = rng.integers(0, p, size=dom.shape[0], dtype=np.uint64)
        extras["poly_interpolate_2^9_s"] = timed_host(
            lambda: Polynomial.fast_interpolate(dom, vals), reps=2)

        # reference interpolation.rs sizes (benches/interpolation.rs:13-14)
        # and the evaluation.rs headline shape (benches/evaluation.rs:13)
        for lg in (10, 15):
            domb = np.unique(rng.integers(
                1, p, size=(1 << lg) + (1 << (lg - 2)),
                dtype=np.uint64))[: 1 << lg]
            valsb = rng.integers(0, p, size=1 << lg, dtype=np.uint64)
            extras[f"poly_interpolate_2^{lg}_s"] = timed_host(
                lambda d=domb, v=valsb: Polynomial.fast_interpolate(d, v),
                reps=2)
        dom14 = np.unique(rng.integers(
            1, p, size=(1 << 14) + (1 << 12),
            dtype=np.uint64))[: 1 << 14]
        p14 = Polynomial.from_array(
            rng.integers(0, p, size=1 << 14, dtype=np.uint64))
        extras["poly_batch_evaluate_2^14_on_2^14_s"] = timed_host(
            lambda: p14._remainder_tree_eval(dom14), reps=2)

        pdeg = Polynomial.from_array(
            rng.integers(0, p, size=1 << 12, dtype=np.uint64))
        extras["poly_batch_evaluate_2^12_on_2^9_s"] = timed_host(
            lambda: pdeg.batch_evaluate([bfe(int(v)) for v in dom]), reps=2)

        extras["poly_zerofier_2^9_s"] = timed_host(
            lambda: Polynomial.zerofier([bfe(int(v)) for v in dom]), reps=2)

        divisor = Polynomial.zerofier([bfe(int(v)) for v in dom[:64]])
        product = pdeg * divisor
        extras["poly_clean_divide_2^12_s"] = timed_host(
            lambda: product.clean_divide(divisor), reps=2)

    # --- coset extrapolation (polynomial.rs:2117-2331) ----------------------
    if full_block(["device_coset_extrapolate_2^18_to_2^10_s",
                   "poly_coset_extrapolate_dispatch_2^18_to_2^10_s"], 60):
        from twenty_first_tpu.math.polynomial import Polynomial
        from twenty_first_tpu.math.b_field_element import bfe

        codeword = rng.integers(0, p, size=1 << 18, dtype=np.uint64)
        # 2^10 points: the reference-parity extrapolation shape
        points = [bfe(int(v)) for v in
                  np.unique(rng.integers(1, p, size=1 << 11,
                                         dtype=np.uint64))[: 1 << 10]]
        _p("coset extrapolate start")
        # the device kernel (poly_batch coefficient route) — also warms the
        # kernel the object API dispatches to on accelerator backends
        from twenty_first_tpu.math import poly_batch

        pts_arr = np.array([q.value() for q in points], dtype=np.uint64)
        extras["device_coset_extrapolate_2^18_to_2^10_s"] = timed_host(
            lambda: poly_batch.batch_coset_extrapolate(
                codeword[None, :], 7, pts_arr), reps=2)

        # same computation through the object API: measures the dispatch +
        # conversion overhead over the device row above, not a second kernel
        extras["poly_coset_extrapolate_dispatch_2^18_to_2^10_s"] = timed_host(
            lambda: Polynomial.coset_extrapolate(bfe(7), codeword, points),
            reps=1)

    # --- poly scale / scalar-mul / fps inverse / mod-reduce / coset --------
    if full_block(["poly_scale_2^14_s", "poly_scalar_mul_2^14_s",
                   "poly_fps_inverse_2^10_s", "poly_mod_reduce_2^14_by_2^9_s",
                   "poly_fast_coset_evaluate_2^16_s",
                   "poly_fast_coset_interpolate_2^16_s"], 45):
        from twenty_first_tpu.math.polynomial import Polynomial
        from twenty_first_tpu.math.b_field_element import bfe

        ps = Polynomial.from_array(
            rng.integers(0, p, size=1 << 14, dtype=np.uint64))
        alpha = bfe(1234567891011)
        _p("poly scale start")
        extras["poly_scale_2^14_s"] = timed_host(lambda: ps.scale(alpha))
        extras["poly_scalar_mul_2^14_s"] = timed_host(
            lambda: ps.scalar_mul(alpha))
        extras["poly_fps_inverse_2^10_s"] = timed_host(
            lambda: ps.formal_power_series_inverse_newton(1 << 10), reps=2)

        # mod-reduce (benches/poly_mod_reduce.rs shape)
        modp = Polynomial.from_array(
            rng.integers(0, p, size=(1 << 9) + 1, dtype=np.uint64))
        extras["poly_mod_reduce_2^14_by_2^9_s"] = timed_host(
            lambda: ps.reduce(modp), reps=2)

        # coset evaluate / interpolate (benches/polynomial_coset.rs)
        cofs = rng.integers(0, p, size=1 << 16, dtype=np.uint64)
        pco = Polynomial.from_array(cofs)
        extras["poly_fast_coset_evaluate_2^16_s"] = timed_host(
            lambda: pco.fast_coset_evaluate(bfe(7), 1 << 16), reps=2)
        cw16 = rng.integers(0, p, size=1 << 16, dtype=np.uint64)
        extras["poly_fast_coset_interpolate_2^16_s"] = timed_host(
            lambda: Polynomial.fast_coset_interpolate(bfe(7), cw16), reps=2)

    # --- NTT table precompute (benches/ntt.rs:33-46) ------------------------
    if full_block("ntt_table_precompute_2^20_s", 25):
        _p("ntt precompute start")

        def precompute_2_20():
            ntt._bit_reverse_permutation.cache_clear()
            ntt._twiddles_host.cache_clear()
            ntt._bit_reverse_permutation(20)
            ntt._twiddles_host(20, False)

        extras["ntt_table_precompute_2^20_s"] = timed_host(precompute_2_20,
                                                           reps=2)

    # --- lattice KEM roundtrip ---------------------------------------------
    if full_block("kem_roundtrip_s", 25):
        from twenty_first_tpu.math import lattice

        seed = bytes(rng.integers(0, 256, size=32, dtype=np.uint8))

        def kem_roundtrip():
            sk, pk = lattice.keygen(seed)
            shared, ct = lattice.enc(pk, seed)
            assert lattice.dec(sk, ct) == shared

        _p("kem start")
        extras["kem_roundtrip_s"] = timed_host(kem_roundtrip)

    # --- codec roundtrip -----------------------------------------------------
    if full_block("codec_roundtrip_2^10_s", 15):
        from twenty_first_tpu.math.bfield_codec import BFE, Vec_, encode
        from twenty_first_tpu.math.b_field_element import bfe

        vec = [bfe(int(v)) for v in
               rng.integers(0, p, size=1 << 10, dtype=np.uint64)]
        vec_codec = Vec_(BFE)

        def codec_roundtrip():
            enc = encode(vec)
            assert vec_codec.decode(vec_codec.encode(vec)) == vec
            assert enc is not None

        _p("codec start")
        extras["codec_roundtrip_2^10_s"] = timed_host(codec_roundtrip)

    # ======================================================================
    # orderless-convolution delta (DESIGN.md §8): full NTT round
    # trip with a prepared table, natural order (pays the bit-reverse
    # gathers) vs scrambled order (pays none); production conv uses
    # natural order, and these rows keep the comparison in every artifact.
    # ======================================================================
    if full_block(["ntt_conv_2^22_natural_s", "ntt_conv_2^22_scrambled_s"], 60):
        clog = 22
        ca = rng.integers(0, p, size=1 << clog, dtype=np.uint64)
        cb = rng.integers(0, p, size=1 << clog, dtype=np.uint64)
        calo, cahi = (jax.device_put(v) for v in gf.to_limbs(ca))
        fb_nat = ntt.ntt_values(cb)
        tnlo, tnhi = (jax.device_put(v) for v in gf.to_limbs(fb_nat))
        idx = ntt.scrambled_index(clog)
        tslo, tshi = (jax.device_put(v) for v in gf.to_limbs(fb_nat[idx]))
        cdiag_f = ntt._four_step_diag_device(clog, False)
        cdiag_i = ntt._four_step_diag_device(clog, True)
        sdiag_f = ntt._scrambled_diag_device(clog, False)
        sdiag_i = ntt._scrambled_diag_device(clog, True)

        # diag tables as jit arguments, not captured constants
        @functools.partial(jax.jit, static_argnames=("k",))
        def conv_nat_chain(al, ah, tl, th, dfl, dfh, dil, dih, k):
            o = (al, ah)
            for _ in range(k):
                f = ntt.four_step_ntt_traceable(o, clog, False, (dfl, dfh))
                o = ntt.four_step_ntt_traceable(
                    gf.mul(f, (tl, th)), clog, True, (dil, dih))
            return (jnp.sum(o[0], dtype=jnp.uint32)
                    + jnp.sum(o[1], dtype=jnp.uint32))

        @functools.partial(jax.jit, static_argnames=("k",))
        def conv_scr_chain(al, ah, tl, th, dfl, dfh, dil, dih, k):
            o = (al, ah)
            for _ in range(k):
                f = ntt.four_step_ntt_scrambled(o, clog, False, (dfl, dfh))
                o = ntt.four_step_ntt_scrambled(
                    gf.mul(f, (tl, th)), clog, True, (dil, dih))
            return (jnp.sum(o[0], dtype=jnp.uint32)
                    + jnp.sum(o[1], dtype=jnp.uint32))

        _p("conv delta start")
        t_nat = timed_chain(
            conv_nat_chain,
            (calo, cahi, tnlo, tnhi, cdiag_f[0], cdiag_f[1],
             cdiag_i[0], cdiag_i[1]), 1, 5)
        t_scr = timed_chain(
            conv_scr_chain,
            (calo, cahi, tslo, tshi, sdiag_f[0], sdiag_f[1],
             sdiag_i[0], sdiag_i[1]), 1, 5)
        extras["ntt_conv_2^22_natural_s"] = t_nat
        extras["ntt_conv_2^22_scrambled_s"] = t_scr

    # ======================================================================
    # STARK LDE + commit pipeline (BASELINE config 4: 2^22-row commit)
    # ======================================================================
    if block("lde_commit_2^22_rows_w8_s", 70):
        from twenty_first_tpu.parallel.pipeline import (
            lde_commit_diags, trace_lde_commit)

        # extended-domain rows (default: trace n = 2^20 x 4 = 2^22 rows)
        lde_log_rows = int(os.environ.get("BENCH_LDE_LOG_ROWS", "22"))
        lde_w = 8                  # trace columns (<= RATE)
        lde_n = 1 << (lde_log_rows - 2)
        tr = rng.integers(0, p, size=(lde_w, lde_n), dtype=np.uint64)
        tlo, thi = (jax.device_put(v) for v in gf.to_limbs(tr))
        # four-step diagonals as jit arguments
        inv_d, fwd_d = lde_commit_diags(lde_n, 4)
        z1 = jnp.zeros((1,), jnp.uint32)
        inv_d = inv_d or (z1, z1)
        fwd_d = fwd_d or (z1, z1)

        @functools.partial(jax.jit,
                           static_argnames=("use_inv", "use_fwd"))
        def lde_chain(a, b, il, ih, fl, fh, k, use_inv=True, use_fwd=True):
            diags = ((il, ih) if use_inv else None,
                     (fl, fh) if use_fwd else None)
            # carry-dependent input: prevents loop-invariant hoisting
            def body(i, acc):
                r = trace_lde_commit((a ^ acc[0], b), expansion=4,
                                     ntt_diags=diags)
                return (acc[0] ^ jnp.sum(r[0], dtype=jnp.uint32),
                        acc[1] + jnp.sum(r[1], dtype=jnp.uint32))
            o = jax.lax.fori_loop(
                0, k, body,
                (jnp.zeros((), jnp.uint32), jnp.zeros((), jnp.uint32)))
            return o[0] + o[1]

        _p("lde commit start")
        from twenty_first_tpu.parallel.pipeline import lde_commit_diags as _d
        real_inv, real_fwd = _d(lde_n, 4)
        t_lde = timed_chain(
            functools.partial(lde_chain, use_inv=real_inv is not None,
                              use_fwd=real_fwd is not None),
            (tlo, thi, inv_d[0], inv_d[1], fwd_d[0], fwd_d[1]), 1, 3)
        extras[f"lde_commit_2^{lde_log_rows}_rows_w8_s"] = t_lde

    for name in dropped:
        if name and name not in extras:
            extras[name] = "dropped:budget"
    for name in skipped_profile:
        if name and name not in extras:
            extras[name] = "skipped:driver-profile"

    elapsed = time.time() - t_start
    extras["elapsed_s"] = round(elapsed, 1)
    extras["budget_s"] = budget

    # Complete extras -> file artifact (the stdout line must stay small).
    here = os.path.dirname(os.path.abspath(__file__))
    artifact = "BENCH_full.json" if full else "BENCH_driver.json"
    full_result = {
        "metric": f"ntt_2^{log_n}_goldilocks_elems_per_s_per_chip",
        "value": ntt_elems_per_s,
        "unit": "elements/s",
        "vs_baseline": 1.0,
        "extras": extras,
    }
    try:
        with open(os.path.join(here, artifact), "w") as f:
            json.dump(full_result, f, indent=1)
            f.write("\n")
        _p(f"full extras written to {artifact}")
    except OSError as e:
        _p(f"could not write {artifact}: {e}")

    # Small stdout line: whitelisted key rows only, trimmed (least
    # important first) until it fits the driver's tail-capture window.
    stdout_rows = (f"ntt_2^{log_n}_s",) + _STDOUT_ROWS[1:] \
        if log_n != 24 else _STDOUT_ROWS
    small_extras = {k: extras[k] for k in stdout_rows if k in extras}
    small_extras["full_extras_file"] = artifact
    result = dict(full_result, extras=small_extras)
    line = json.dumps(result)
    for k in reversed(stdout_rows):
        if len(line) <= _STDOUT_LIMIT:
            break
        small_extras.pop(k, None)
        line = json.dumps(result)
    assert len(line) <= _STDOUT_LIMIT, (
        f"stdout line {len(line)} B exceeds the {_STDOUT_LIMIT} B "
        f"tail-capture guarantee even after trimming")
    if not full and elapsed > budget:
        _p(f"WARNING: run time {elapsed:.0f}s exceeded the driver "
           f"budget — tighten the driver profile")
    _p(f"done; emitting {len(line)} B")
    print(line)


if __name__ == "__main__":
    main()
