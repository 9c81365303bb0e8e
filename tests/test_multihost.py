"""Multi-process (multi-host seam) validation inside the test suite.

Launches scripts/run_multihost.py: 2 separate processes x 4 virtual CPU
devices each, wired with jax.distributed (Gloo). Exercises cross-process
all_to_all / all_gather and process-local sharding — the exact seam a
multi-host run uses. The worker asserts bit-exactness of every
local NTT shard vs the host oracle and that the distributed LDE+commit
root matches a single-process run, plus the config-5 MMR batch-append
and cross-process KEM legs (see scripts/multihost_worker.py). Size 2^18
exercises the real four-step chunking, not a toy shape.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_distributed_ntt_and_commit(tmp_path):
    out = tmp_path / "multihost.json"
    env = dict(os.environ)
    # the workers configure their own platform/devices; scrub the
    # test-process CPU forcing so it does not double-apply
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "run_multihost.py"),
         "2", "18", str(out)],
        capture_output=True, text=True, timeout=900, cwd=REPO, env=env,
    )
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    report = json.loads(out.read_text())
    assert report["processes"] == 2
    assert report["global_devices"] == 8
    assert report["ntt_bit_exact_vs_host_oracle"] is True
    assert report["lde_commit_root_matches_single_process"] is True
    assert report["mmr_peaks_bit_exact"] is True
    assert report["mmr_batch_append_bit_exact"] is True
    assert report["kem_roundtrip_ok"] is True
