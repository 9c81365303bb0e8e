"""Device mesh setup for multi-chip/multi-host execution.

The reference has no distributed layer (its parallelism is rayon threads,
SURVEY.md §2a); this module is the equivalent layer: a named 1-D mesh over
all available devices, with shard_map-based kernels in dist_ntt.py /
dist_merkle.py communicating via XLA collectives. The mesh follows the
algorithm (one all-to-all, one all-gather), not a physical topology: the
cards of one host are joined all to all.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = "shard"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over the first n devices (default: all)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} available"
            )
        devices = devices[:n_devices]
    import numpy as np

    return Mesh(np.array(devices), (AXIS,))


def sharded(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))


def shard_host_array(mesh: Mesh, spec, arr):
    """Host numpy array -> global jax.Array with sharding P(*spec).

    Works identically in single- and multi-process runs: every process
    builds the full host array (deterministically cheap at these sizes)
    and materializes only its addressable shards via the callback —
    `jax.device_put` of a host array onto a sharding that spans
    non-addressable devices is invalid in multi-controller mode.
    """
    import numpy as np

    arr = np.asarray(arr)
    sharding = NamedSharding(mesh, P(*spec))
    return jax.make_array_from_callback(arr.shape, sharding,
                                        lambda idx: arr[idx])


def local_checksum(a) -> int:
    """u32 sum of the first addressable shard.

    A readback that works for non-fully-addressable (multi-process)
    arrays, used to force + fence device work in timing loops.
    """
    import numpy as np

    return int(np.asarray(a.addressable_data(0))
               .astype(np.uint64).sum() & 0xFFFFFFFF)


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None):
    """Multi-host initialization (jax.distributed). No-op on a single host."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
