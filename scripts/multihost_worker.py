"""One process of a multi-host (multi-controller) validation run.

Launched by run_multihost.py: N processes on this machine, each with 4
virtual CPU devices, wired together with jax.distributed (Gloo CPU
collectives). Exercises the REAL multi-host seam — cross-process
all_to_all / all_gather through the distributed runtime, process-local
data materialization (shard_host_array), non-fully-addressable arrays —
exactly what a multi-host run needs.

Every process runs on the CPU backend (JAX_PLATFORMS=cpu below): several
JAX processes on one card would each reserve most of its memory, so this
check of the multi-host seam never touches an accelerator.

Checks, per process:
  * distributed NTT local output shards are bit-exact vs the host oracle;
  * the distributed LDE+commit root matches a single-process local-mesh
    run (process 0 only);
  * distributed MMR peaks-from-leafs + batch-append are bit-exact vs the
    host accumulator oracle (BASELINE config-5 MMR leg);
  * a cross-process lattice-KEM exchange: process 0's keygen, public key
    broadcast over the distributed runtime, per-process encapsulation,
    ciphertext gather, process-0 decapsulation of every ciphertext
    (BASELINE config-5 KEM leg).
Process 0 writes the JSON report when an output path is given.
"""

import json
import os
import sys
import time

PID = int(sys.argv[1])
NPROC = int(sys.argv[2])
PORT = sys.argv[3]
LOG_N = int(sys.argv[4]) if len(sys.argv) > 4 else 16
OUT = sys.argv[5] if len(sys.argv) > 5 else None

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

from twenty_first_tpu.config import enable_compilation_cache  # noqa: E402

# the 2^18 in-suite run recompiles the four-step + LDE graphs per process
# otherwise
enable_compilation_cache()

import numpy as np

from twenty_first_tpu.parallel.mesh import (
    initialize_distributed, make_mesh, shard_host_array)

initialize_distributed(f"localhost:{PORT}", NPROC, PID)
assert jax.process_count() == NPROC

from twenty_first_tpu.math import ntt as ntt_mod
from twenty_first_tpu.math import gf
from twenty_first_tpu.parallel import dist_ntt
from twenty_first_tpu.parallel.pipeline import make_dist_lde_commit

P = (1 << 64) - (1 << 32) + 1
mesh = make_mesh()  # all global devices
n_global = len(jax.devices())
rng = np.random.default_rng(42)
n1, n2 = dist_ntt._split_sizes(LOG_N)
x = rng.integers(0, P, size=(n2, n1), dtype=np.uint64)
lo = shard_host_array(mesh, (None, "shard"),
                      (x & np.uint64(0xFFFF_FFFF)).astype(np.uint32))
hi = shard_host_array(mesh, (None, "shard"),
                      (x >> np.uint64(32)).astype(np.uint32))

# -- distributed NTT, bit-exact vs host oracle on every local shard --------
run = dist_ntt._make_distributed_ntt(mesh, LOG_N, False, False, None)
tw = dist_ntt._twiddle_device(mesh, LOG_N, False)
t0 = time.perf_counter()
zlo, zhi = run(lo, hi, tw[0], tw[1])
jax.block_until_ready((zlo, zhi))
t_ntt = time.perf_counter() - t0

ref = ntt_mod.ntt_host(x.reshape(-1)).reshape(n1, n2).T  # Z[k2, k1]
ref_lo = (ref & np.uint64(0xFFFF_FFFF)).astype(np.uint32)
ref_hi = (ref >> np.uint64(32)).astype(np.uint32)
for plane, want in ((zlo, ref_lo), (zhi, ref_hi)):
    for sh in plane.addressable_shards:
        assert np.array_equal(np.asarray(sh.data), want[sh.index]), \
            f"[{PID}] NTT shard mismatch at {sh.index}"
print(f"[{PID}] dist NTT 2^{LOG_N} across {NPROC} processes: "
      f"bit-exact ({t_ntt*1e3:.1f} ms first run)", flush=True)

# -- distributed LDE + commit ----------------------------------------------
step = make_dist_lde_commit(mesh, LOG_N)
rlo, rhi = step(lo, hi)
jax.block_until_ready((rlo, rhi))
root = (np.asarray(rlo.addressable_data(0), dtype=np.uint64)
        | (np.asarray(rhi.addressable_data(0), dtype=np.uint64) << np.uint64(32)))
root = [int(v) for v in root.reshape(-1)[:5]]
print(f"[{PID}] dist LDE+commit root: {root[:2]}...", flush=True)

# -- distributed MMR peaks-from-leafs + batch-append (config-5 MMR leg) ----
from twenty_first_tpu.parallel.dist_mmr import (
    distributed_batch_append, distributed_peaks_from_leafs)
from twenty_first_tpu.util_types.mmr.mmr_accumulator import MmrAccumulator

mmr_log = max(2, min(LOG_N - 4, 18))  # clamp: small LOG_N smoke runs still get a valid (>=3 peak) MMR leg
n_mmr = (1 << mmr_log) + (1 << max(mmr_log - 3, 1)) + 3  # >= 3 peaks
mmr_leafs = rng.integers(0, P, size=(n_mmr, 5), dtype=np.uint64)
t0 = time.perf_counter()
got_peaks = distributed_peaks_from_leafs(mmr_leafs, mesh)
t_mmr = time.perf_counter() - t0
want_peaks = MmrAccumulator.peaks_from_leafs(mmr_leafs)
assert got_peaks == want_peaks, f"[{PID}] MMR peaks mismatch"

m_append = (1 << max(mmr_log - 2, 1)) + 11
batch = rng.integers(0, P, size=(m_append, 5), dtype=np.uint64)
new_peaks, new_count = distributed_batch_append(
    got_peaks, n_mmr, batch, mesh)
want_after = MmrAccumulator.peaks_from_leafs(
    np.concatenate([mmr_leafs, batch]))
assert new_count == n_mmr + m_append
assert new_peaks == want_after, f"[{PID}] MMR batch-append mismatch"
print(f"[{PID}] dist MMR: peaks({n_mmr} leafs) + batch-append({m_append}) "
      f"bit-exact ({t_mmr*1e3:.1f} ms peaks first run)", flush=True)

# -- cross-process lattice-KEM exchange (config-5 KEM leg) -------------------
import hashlib

from jax.experimental import multihost_utils

from twenty_first_tpu.math import lattice

kem_seed = np.frombuffer(hashlib.sha3_256(b"multihost-kem-keygen").digest(),
                         dtype=np.uint8)
if PID == 0:
    sk, pk = lattice.keygen(bytes(kem_seed))
    pk_arr = np.frombuffer(pk.to_bytes(), dtype=np.uint8)
else:
    sk = None
    # all processes know the wire size (seed 32 B + ga module element)
    _, _pk_tmp = lattice.keygen(bytes(kem_seed))
    pk_arr = np.zeros(len(_pk_tmp.to_bytes()), dtype=np.uint8)
pk_arr = np.asarray(multihost_utils.broadcast_one_to_all(pk_arr))
pk_recv = lattice.PublicKey.from_bytes(pk_arr.tobytes())

enc_rand = hashlib.sha3_256(f"multihost-kem-enc-{PID}".encode()).digest()
shared, ct = lattice.enc(pk_recv, enc_rand)
ct_arr = np.frombuffer(ct.to_bytes(), dtype=np.uint8)
all_cts = np.asarray(multihost_utils.process_allgather(ct_arr))
shared_fp = np.frombuffer(hashlib.sha3_256(shared).digest(), dtype=np.uint8)
all_fps = np.asarray(multihost_utils.process_allgather(shared_fp))
kem_ok = True
if PID == 0:
    for i in range(NPROC):
        ct_i = lattice.Ciphertext.from_bytes(all_cts[i].tobytes())
        dec_i = lattice.dec(sk, ct_i)
        # dec returns None on FO rejection — check BEFORE hashing, or the
        # intended diagnostic assert is shadowed by a TypeError
        assert dec_i is not None, f"KEM decapsulation rejected for process {i}"
        fp_i = np.frombuffer(hashlib.sha3_256(dec_i).digest(), dtype=np.uint8)
        assert np.array_equal(fp_i, all_fps[i]), \
            f"KEM decapsulation mismatch for process {i}"
print(f"[{PID}] cross-process KEM exchange ok", flush=True)

if PID == 0:
    # single-process comparison on a local-devices-only mesh
    local_mesh = make_mesh(devices=jax.local_devices())
    lo_l = shard_host_array(local_mesh, (None, "shard"),
                            (x & np.uint64(0xFFFF_FFFF)).astype(np.uint32))
    hi_l = shard_host_array(local_mesh, (None, "shard"),
                            (x >> np.uint64(32)).astype(np.uint32))
    rl, rh = make_dist_lde_commit(local_mesh, LOG_N)(lo_l, hi_l)
    root_local = (np.asarray(rl.addressable_data(0), dtype=np.uint64)
                  | (np.asarray(rh.addressable_data(0), dtype=np.uint64)
                     << np.uint64(32)))
    root_local = [int(v) for v in root_local.reshape(-1)[:5]]
    assert root == root_local, f"root mismatch: {root} vs {root_local}"
    print(f"[0] multi-process root == single-process root", flush=True)
    if OUT:
        with open(OUT, "w") as f:
            json.dump({
                "processes": NPROC,
                "devices_per_process": len(jax.local_devices()),
                "global_devices": n_global,
                "log_n": LOG_N,
                "collectives": "gloo (CPU multi-controller)",
                "ntt_bit_exact_vs_host_oracle": True,
                "lde_commit_root_matches_single_process": True,
                "mmr_peaks_bit_exact": True,
                "mmr_batch_append_bit_exact": True,
                "mmr_leafs": int(n_mmr),
                "mmr_batch_appended": int(m_append),
                "kem_roundtrip_ok": bool(kem_ok),
                "kem_processes": NPROC,
                "root_digest": root,
                "note": ("Validates the jax.distributed multi-host seam "
                         "(cross-process all_to_all/all_gather, process-"
                         "local sharding) on one machine; a multi-host "
                         "GPU run uses the same code."),
            }, f, indent=1)
print(f"[{PID}] OK", flush=True)
