"""Scaling-efficiency report on a CPU mesh: python scripts/run_scaling.py [log_n] [out.json]

On several cards, run twenty_first_tpu.parallel.scaling directly;
here the 8-virtual-device CPU mesh validates the sharding/communication
structure and records per-mesh-size timings.
"""

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + \
    " --xla_force_host_platform_device_count=8"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

from twenty_first_tpu.parallel.scaling import scaling_report

if __name__ == "__main__":
    log_n = int(sys.argv[1]) if len(sys.argv) > 1 else 18
    out_path = sys.argv[2] if len(sys.argv) > 2 else None
    report = scaling_report(log_n)
    report["platform"] = "cpu-virtual-8"
    report["note"] = (
        "Virtual CPU devices share physical host cores, so efficiency "
        "numbers here validate the sharding/communication STRUCTURE only "
        "(collective counts, bit-exactness vs single device); real "
        "scaling efficiency must be read from a multi-card run of "
        "twenty_first_tpu.parallel.scaling."
    )
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
