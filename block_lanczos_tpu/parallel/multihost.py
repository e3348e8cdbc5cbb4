"""Multi-host (multi-process) execution support.

The reference scales across nodes with MPI: an mpiexec-launched process grid
whose root loads/scatters the matrix and re-collects vector blocks every
iteration (reference: mpi/lanczos_modp.c:505-566 grid init, :1054-1149
distributed SpMV; README.md:39-46 mpiexec usage).  The JAX-native analogue is
multi-controller SPMD: every process runs the SAME program, calls
jax.distributed.initialize() against a shared coordinator, and builds one
global mesh spanning every process's local devices (GPUs of a host over
NVLink, hosts over the network).  There is no root — each process materializes only
its addressable shards of the global arrays and the jitted solve step is a
single collective program.

Helpers here are the only multi-process-aware code in the framework; with
one process they degrade to plain device_put / device_get, so every solver
works unchanged in both modes.
"""

from __future__ import annotations

import jax
import numpy as np


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     local_device_count: int | None = None):
    """Connect this process to the multi-controller service.

    Mirrors the reference's MPI_Init + grid setup (mpi/lanczos_modp.c:520-566)
    — but where MPI ranks own private buffers and exchange messages, here the
    processes jointly own global arrays and XLA inserts the collectives.

    Must run before any backend-touching JAX call.  `local_device_count`
    forces N virtual CPU devices per process (testing without GPUs).  On
    one host with several GPUs, give each process its own cards with
    CUDA_VISIBLE_DEVICES.
    """
    if local_device_count is not None:
        import os
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count="
            f"{local_device_count}").strip()
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def is_root() -> bool:
    """True on the process that should own printing / file output."""
    return jax.process_index() == 0


def process_count() -> int:
    return jax.process_count()


def put_global(arr: np.ndarray, sharding) -> jax.Array:
    """Place a host array (identical on every process) as a global sharded
    jax.Array.  Each process materializes only its addressable shards — the
    multi-process-safe replacement for jax.device_put(host, sharding)."""
    if jax.process_count() == 1:
        return jax.device_put(arr, sharding)
    arr = np.asarray(arr)
    return jax.make_array_from_callback(arr.shape, sharding,
                                        lambda idx: arr[idx])


def fetch_global(arr) -> np.ndarray:
    """Fetch a (possibly non-fully-addressable) global array to every host.

    Single process / fully-replicated: a plain device_get.  Multi-process
    sharded: an allgather through the mesh, so every host gets the full
    value (used for the final kernel block and host-side final checks)."""
    if getattr(arr, "is_fully_addressable", True) or arr.is_fully_replicated:
        return np.asarray(jax.device_get(arr))
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(arr, tiled=True))


def barrier(name: str = "block_lanczos_barrier"):
    """Cross-process sync point (used to order checkpoint shard writes
    before the root's manifest write)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(name)


def addressable_shard_index_data(arr):
    """[(index_slices, np.ndarray)] for this process's unique shards."""
    out = []
    for s in arr.addressable_shards:
        if s.replica_id == 0:
            out.append((s.index, np.asarray(s.data)))
    return out
