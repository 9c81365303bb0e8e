"""Launch an N-process multi-controller validation run on this machine.

Usage: python scripts/run_multihost.py [nproc] [log_n] [out.json]
Each process gets 4 virtual CPU devices (the workers pin themselves to the
CPU, see multihost_worker.py); collectives cross process boundaries
through the jax.distributed runtime (Gloo), exercising the same code paths
a multi-host run uses.
"""

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

if __name__ == "__main__":
    nproc = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    log_n = sys.argv[2] if len(sys.argv) > 2 else "16"
    out = sys.argv[3] if len(sys.argv) > 3 else ""
    port = "19851"
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "multihost_worker.py"),
             str(pid), str(nproc), port, log_n, out],
        )
        for pid in range(nproc)
    ]
    codes = [p.wait() for p in procs]
    print("exit codes:", codes)
    sys.exit(max(codes))
