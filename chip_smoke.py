"""Run the prover's commit path once on one NVIDIA GPU and check it bit-exact.

    python chip_smoke.py                # phases 1-6 on one card
    python chip_smoke.py --xla-ab       # and phases 4-5 again on the XLA form
    python chip_smoke.py --four-cards   # only the 4-card distributed phase

Phases, each printing one line with its result and times (compile time
apart from run time; run times are medians of warm calls, each ended with
`block_until_ready`):

  1. device and card: JAX must see a GPU (never falls back to the CPU), the
     card's name and power limit from nvidia-smi, the native host core;
  2. golden anchors on the device: size-4 NTT, a fixed mul, the Tip5
     chained hash_10 snapshot;
  3. NTT 2^24 forward and inverse through `ntt.ntt_values`;
  4. Merkle commit of 2^22 leaf digests through `MerkleTree.new`;
  5. the prover commit: `trace_lde_commit` of a 2^22 x 10 trace at
     expansion 4 (2^24 extended rows);
  6. the Tip5 kernel against the XLA permutation at 2^20 states; with
     --xla-ab also phases 4 and 5 again with every Tip5 caller on the XLA
     form (several minutes more of compilation).

Every result is compared with the native C++ host core, which never
touches JAX. Any failed phase ends the run with a non-zero exit code. The
last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

P = (1 << 64) - (1 << 32) + 1

NTT_LOG_N = 24
MERKLE_LOG_LEAFS = 22
COMMIT_LOG_N = 22
COMMIT_WIDTH = 10
COMMIT_EXPANSION = 4
KERNEL_LOG_BATCH = 20
FOUR_CARD_LOG_N = 26
REPS = 5

TIP5_SNAPSHOT = ("109cc2fe453bd9962f754b96d8f5b919"
                 "b60af030940a275f5540da195fef65ee651c1b6fa19b2c6a")


def check_device(count: int = 1):
    """JAX's devices, or SystemExit unless `count` GPUs are present."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX found no GPU (platform "
            f"{devices[0].platform!r}); refusing to run on it")
    if len(devices) < count:
        raise SystemExit(
            f"chip_smoke: needs {count} GPUs, JAX found {len(devices)}")
    return devices


def card_line() -> str:
    """Name and power limit of the cards, from a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().replace("\n", " | ")


def _say(phase: str, fields: dict) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {body}", flush=True)


def _run(fn):
    """fn() to completion; (result, seconds)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def _median(fn, reps: int) -> float:
    return statistics.median(_run(fn)[1] for _ in range(reps))


def _first_and_warm(fn, reps: int):
    """(result, first-call seconds, warm median seconds). The first call
    compiles: compile_s is reported as first minus warm."""
    out, first = _run(fn)
    return out, first, _median(fn, reps)


def _aot(fn, *args):
    """jit + lower + compile; (compiled, compile seconds)."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def _limbs_T(values):
    """uint64 (..., B, k) host array -> word-major (k, B) device planes."""
    from twenty_first_tpu.math import gf

    return gf.to_limbs(np.ascontiguousarray(np.swapaxes(values, -1, -2)))


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return stats.get("peak_bytes_in_use") if stats else "not-available"


@contextlib.contextmanager
def xla_tip5():
    """Route every Tip5 caller to the XLA form (kernel.use_kernel is the
    one dispatch point); jit caches are dropped on the way in and out."""
    import jax

    from twenty_first_tpu.tip5 import kernel

    saved = kernel.use_kernel
    kernel.use_kernel = lambda batch, platform=None: False
    jax.clear_caches()
    try:
        yield
    finally:
        kernel.use_kernel = saved
        jax.clear_caches()


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_anchors() -> dict:
    import jax

    from twenty_first_tpu.math import gf, ntt
    from twenty_first_tpu.tip5 import permutation as tip5_dev
    from twenty_first_tpu.tip5.digest import Digest

    out = gf.from_limbs(ntt.ntt_limbs(gf.to_limbs(
        np.array([1, 4, 0, 0], dtype=np.uint64))))
    assert out.tolist() == [5, 1125899906842625, 18446744069414584318,
                            18445618169507741698], out
    prod = gf.from_limbs(jax.jit(gf.mul)(
        gf.to_limbs(np.array([2779336007265862836], dtype=np.uint64)),
        gf.to_limbs(np.array([8146517303801474933], dtype=np.uint64))))
    assert int(prod[0]) == 1857758653037316764, prod
    preimage = np.zeros((1, 10), dtype=np.uint64)
    for i in range(6):
        digest = gf.from_limbs(tip5_dev.hash_10(gf.to_limbs(preimage)))
        preimage[0, i:i + 5] = digest[0]
    final = gf.from_limbs(tip5_dev.hash_10(gf.to_limbs(preimage)))[0]
    assert Digest.from_array(final).to_hex() == TIP5_SNAPSHOT
    return {"ntt4": "ok", "mul": "ok", "tip5_hash10_snapshot": "ok"}


def phase_ntt(log_n: int, rng, reps: int = REPS) -> dict:
    from twenty_first_tpu.math import gf, ntt

    x = rng.integers(0, P, size=1 << log_n, dtype=np.uint64)
    want = ntt.ntt_host(x)
    got, first, warm = _first_and_warm(lambda: ntt.ntt_values(x), reps)
    assert np.array_equal(got, want), "ntt_values != ntt_host"
    back, ifirst, iwarm = _first_and_warm(
        lambda: ntt.ntt_values(got, inverse=True), reps)
    assert np.array_equal(back, x), "inverse NTT round trip"
    planes = gf.to_limbs(x)
    dev = _median(lambda: ntt.ntt_limbs(planes), reps)
    return {"bit_exact": "ok",
            "fwd_compile_s": first - warm, "fwd_warm_s": warm,
            "inv_compile_s": ifirst - iwarm, "inv_warm_s": iwarm,
            "device_fwd_warm_s": dev}


def merkle_inputs(log_leafs: int, rng):
    """(leafs, expected root) with the root from the native core."""
    from twenty_first_tpu import native

    leafs = rng.integers(0, P, size=(1 << log_leafs, 5), dtype=np.uint64)
    return leafs, native.tip5_merkle_root(leafs)


def phase_merkle(leafs, want, reps: int = REPS) -> dict:
    from twenty_first_tpu.math import gf
    from twenty_first_tpu.parallel import dist_merkle
    from twenty_first_tpu.util_types.merkle_tree import MerkleTree

    tree, first, warm = _first_and_warm(lambda: MerkleTree.new(leafs), reps)
    assert np.array_equal(tree.root().to_array(), want), "MerkleTree root"
    height = leafs.shape[0].bit_length() - 1
    planes = gf.to_limbs(leafs)
    nodes = dist_merkle.tree_nodes(planes, height)
    assert np.array_equal(gf.from_limbs(nodes)[1], want), "tree_nodes"
    return {"bit_exact": "ok", "new_compile_s": first - warm,
            "new_warm_s": warm,
            "device_warm_s": _median(
                lambda: dist_merkle.tree_nodes(planes, height), reps)}


def commit_oracle(trace, expansion: int) -> np.ndarray:
    """Host root of trace_lde_commit: native iNTT, coset scale, native NTT,
    native permutation of the fixed-length row states, native Merkle."""
    from twenty_first_tpu import native
    from twenty_first_tpu.math import gf_numpy as gfn
    from twenty_first_tpu.math import ntt
    from twenty_first_tpu.math.b_field_element import GENERATOR

    w, n = trace.shape
    coeff = ntt.ntt_host(trace, inverse=True)
    scale = np.broadcast_to(gfn.powers(GENERATOR, n), (w, n)).copy()
    ext = np.zeros((w, n * expansion), dtype=np.uint64)
    ext[:, :n] = gfn.mul(coeff, scale)
    evals = ntt.ntt_host(ext)
    states = np.zeros((n * expansion, 16), dtype=np.uint64)
    states[:, :w] = evals.T
    states[:, 10:] = 1
    leafs = np.ascontiguousarray(native.tip5_permute_batch(states)[:, :5])
    return native.tip5_merkle_root(leafs)


def commit_inputs(log_n: int, width: int, expansion: int, rng):
    trace = rng.integers(0, P, size=(width, 1 << log_n), dtype=np.uint64)
    return trace, commit_oracle(trace, expansion)


def phase_commit(trace, want, expansion: int, reps: int = REPS) -> dict:
    from twenty_first_tpu.math import gf
    from twenty_first_tpu.parallel.pipeline import (
        lde_commit_diags, trace_lde_commit)

    n = trace.shape[1]
    inv_d, fwd_d = lde_commit_diags(n, expansion)
    planes = gf.to_limbs(trace)

    def commit(lo, hi, inv_d, fwd_d):
        return trace_lde_commit((lo, hi), expansion, ntt_diags=(inv_d, fwd_d))

    compiled, compile_s = _aot(commit, *planes, inv_d, fwd_d)
    root = gf.from_limbs(compiled(*planes, inv_d, fwd_d))[0]
    assert np.array_equal(root, want), "trace_lde_commit root"
    return {"bit_exact": "ok", "compile_s": compile_s,
            "run_s": _median(lambda: compiled(*planes, inv_d, fwd_d), reps),
            "peak_bytes_in_use": _peak_bytes()}


def phase_kernel(log_b: int, rng, reps: int = REPS,
                 interpret: bool = False) -> dict:
    """Tip5 kernel vs the XLA permutation vs the native core."""
    from twenty_first_tpu import native
    from twenty_first_tpu.math import gf
    from twenty_first_tpu.tip5 import kernel
    from twenty_first_tpu.tip5 import permutation as tip5_dev

    states = rng.integers(0, P, size=(1 << log_b, 16), dtype=np.uint64)
    want = native.tip5_permute_batch(states)
    wm = _limbs_T(states)
    rm = gf.to_limbs(states)
    kern, kernel_compile = _aot(
        lambda lo, hi: kernel.permutation_wm((lo, hi), interpret=interpret),
        *wm)
    xla, xla_compile = _aot(tip5_dev.permutation, rm)
    assert np.array_equal(gf.from_limbs(kern(*wm)).T, want), "kernel"
    assert np.array_equal(gf.from_limbs(xla(rm)), want), "xla permutation"
    return {"bit_exact": "ok",
            "kernel_compile_s": kernel_compile,
            "kernel_run_s": _median(lambda: kern(*wm), reps),
            "xla_compile_s": xla_compile,
            "xla_run_s": _median(lambda: xla(rm), reps)}


def phase_four_cards(log_n: int, mesh, rng, reps: int = 1) -> dict:
    """distributed_ntt_values and dist_lde_commit_values on the mesh, at
    both transpose chunkings, against the native host oracle."""
    from twenty_first_tpu import native
    from twenty_first_tpu.math import ntt
    from twenty_first_tpu.parallel.dist_ntt import (
        _split_sizes, distributed_ntt_values)
    from twenty_first_tpu.parallel.pipeline import dist_lde_commit_values

    x = rng.integers(0, P, size=1 << log_n, dtype=np.uint64)
    want = ntt.ntt_host(x)
    n1, n2 = _split_sizes(log_n)
    # dist_lde_commit contract: leaf k2 hashes the stride-n2 slice X[k2::n2]
    rows = np.ascontiguousarray(want.reshape(n1, n2).T)
    with ThreadPoolExecutor() as pool:
        leafs = np.array(list(pool.map(native.tip5_hash_varlen, rows)))
    want_root = native.tip5_merkle_root(leafs)
    res = {}
    for chunks in (1, 4):
        got, first, warm = _first_and_warm(
            lambda c=chunks: distributed_ntt_values(x, mesh, a2a_chunks=c),
            reps)
        assert np.array_equal(got, want), f"distributed NTT a2a={chunks}"
        root, cfirst, cwarm = _first_and_warm(
            lambda c=chunks: dist_lde_commit_values(x, mesh, a2a_chunks=c),
            reps)
        assert np.array_equal(root.to_array(), want_root), \
            f"dist LDE commit a2a={chunks}"
        res[f"a2a{chunks}_ntt_compile_s"] = first - warm
        res[f"a2a{chunks}_ntt_warm_s"] = warm
        res[f"a2a{chunks}_commit_compile_s"] = cfirst - cwarm
        res[f"a2a{chunks}_commit_warm_s"] = cwarm
    res["bit_exact"] = "ok"
    return res


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the 4-card distributed phase")
    parser.add_argument("--xla-ab", action="store_true",
                        help="also time phases 4 and 5 on the XLA form")
    args = parser.parse_args(argv)
    count = 4 if args.four_cards else 1

    devices = check_device(count)
    from twenty_first_tpu import native
    from twenty_first_tpu.config import enable_compilation_cache

    cache = enable_compilation_cache()
    if not native.available():
        raise SystemExit("chip_smoke: the native host core did not build")
    _say("phase 1 device", {
        "platform": devices[0].platform,
        "kind": repr(devices[0].device_kind), "count": len(devices),
        "compile_cache": cache})
    print(f"card: {card_line()}", flush=True)
    rng = np.random.default_rng(0)
    import jax

    if args.four_cards:
        from twenty_first_tpu.parallel import make_mesh

        _say("phase 7 four cards", phase_four_cards(
            FOUR_CARD_LOG_N, make_mesh(4), rng))
    else:
        _say("phase 2 anchors", phase_anchors())
        _say(f"phase 3 ntt 2^{NTT_LOG_N}", phase_ntt(NTT_LOG_N, rng))
        leafs, merkle_root = merkle_inputs(MERKLE_LOG_LEAFS, rng)
        _say(f"phase 4 merkle 2^{MERKLE_LOG_LEAFS}",
             phase_merkle(leafs, merkle_root))
        trace, commit_root = commit_inputs(
            COMMIT_LOG_N, COMMIT_WIDTH, COMMIT_EXPANSION, rng)
        _say(f"phase 5 commit 2^{COMMIT_LOG_N}x{COMMIT_WIDTH}",
             phase_commit(trace, commit_root, COMMIT_EXPANSION))
        _say(f"phase 6 tip5 kernel 2^{KERNEL_LOG_BATCH}",
             phase_kernel(KERNEL_LOG_BATCH, rng))
        if args.xla_ab:
            with xla_tip5():
                _say("phase 6 merkle on xla",
                     phase_merkle(leafs, merkle_root))
                _say("phase 6 commit on xla",
                     phase_commit(trace, commit_root, COMMIT_EXPANSION))
    print(json.dumps({"ok": True, "device": {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
