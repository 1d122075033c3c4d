"""Device mesh + sharding helpers.

The reference is single-node (SURVEY.md §2c): its parallelism is
thread pools over shell pipelines and process pools over gaps. The
device scale-out axes are:

  dp — data parallel over reads and gap batches (the only meaningful
       large axis: millions of reads, tens of thousands of gaps);
  sp — position/pair parallel: genome positions for the gap scan and
       all-pairs tiles for the overlap engine.

Collectives used by the sharded steps: psum for k-mer histograms and
classification counts, all_to_all for gap-home routing
(parallel/dist.py).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(shape=None, axes=("dp", "sp"), devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if shape is None:
        # favor dp; sp gets a factor of 2 when available
        sp = 2 if n % 2 == 0 and n > 1 else 1
        shape = (n // sp, sp)
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, axes)


def mesh_from_config(mesh_shape) -> Mesh | None:
    """The mesh `device.mesh_shape` asks for, or None for one device.

    Raises when the config asks for more devices than JAX has: a run
    configured for a mesh never quietly falls back to one device."""
    n = int(np.prod([int(d) for d in mesh_shape], dtype=np.int64))
    if n <= 1:
        return None
    have = len(jax.devices())
    if have < n:
        raise RuntimeError(
            f"device.mesh_shape {tuple(mesh_shape)} needs {n} devices, "
            f"JAX has {have} ({jax.default_backend()})")
    return make_mesh(devices=jax.devices()[:n])


def dp_sharding(mesh: Mesh):
    return NamedSharding(mesh, P("dp"))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())
