"""Multi-process (multi-host) execution helpers for the SHIPPED
pipeline.

The reference is single-node; its closest analog is the per-scaffold
thread-pool dispatch (/root/reference/run_multi_threads_discordant.py:
135-138). Here the pipeline itself runs SPMD across processes
(jax.distributed): every process executes the same host program over
GLOBAL arrays; device stages shard records/gap-batches over the global
mesh (collectives ride ICI between real hosts, gloo in CPU tests);
host stages (merge, pick, rescue) compute redundantly-identically on
every process — deterministic, so no coordination is needed — and
file writes happen on process 0 only, with barriers at stage
boundaries so later stages can read them.

Initialization: cli.py --coordinator/--num-processes/--process-id (or
GAPPADDER_DIST_* env vars) -> init_distributed().
"""

from __future__ import annotations

import numpy as np

import jax


def process_count() -> int:
    try:
        return jax.process_count()
    except Exception:
        return 1


def is_primary() -> bool:
    try:
        return jax.process_index() == 0
    except Exception:
        return True


def barrier(tag: str) -> None:
    """Cross-process sync point (no-op single-process)."""
    if process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(tag)


def to_np(x) -> np.ndarray:
    """Global numpy view of a (possibly cross-process-sharded) array."""
    if process_count() > 1 and not x.is_fully_replicated:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def put_global(arr, sharding):
    """Place a host array with `sharding` over a (possibly
    multi-process) mesh; every process passes the same global value."""
    arr = np.asarray(arr)
    if process_count() == 1:
        return jax.device_put(arr, sharding)
    return jax.make_array_from_callback(
        arr.shape, sharding, lambda idx, _a=arr: _a[idx])


def init_distributed(coordinator: str, num_processes: int,
                     process_id: int, local_cpu_devices: int = 0) -> None:
    """Initialize jax.distributed for the pipeline.

    local_cpu_devices > 0 selects the CPU backend with that many
    virtual devices per process and gloo collectives (the CPU test
    path); 0 keeps JAX's default backend. Must be called before
    any JAX backend initialization."""
    if local_cpu_devices:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", local_cpu_devices)
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
