"""Multi-host (multi-process) mesh support.

The reference is strictly single-GPU; the sharded engines (domain.py)
scale over any ``jax.sharding.Mesh``.  This module makes MULTI-PROCESS
meshes first-class: a ``jax.distributed``
bootstrap, a mesh builder that spans every process's devices, and a
replicated-output runner so each host ends the run holding the global
result.

Multi-host GPU clusters need exactly this path (one process per host or
per card, NCCL collectives inserted by XLA under ``shard_map``); the CI
test exercises it with multi-process CPU backends (tests/test_multihost.py
+ tools/multihost_driver.py), which share the same code path modulo the
transport.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, **kw) -> None:
    """Bootstrap the multi-process runtime (idempotent).

    Pass ``coordinator_address='host:port'``, the process count and this
    process's id (nothing detects a cluster by itself).  Must run before
    any backend use."""
    if getattr(initialize, "_done", False):
        return
    # NOTE: jax.process_count()/jax.devices() would initialize the
    # backend and make distributed.initialize illegal -- don't probe
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id, **kw)
    except RuntimeError as e:
        if "already" not in str(e):
            raise
    initialize._done = True


def global_mesh(mesh_shape: Sequence[int],
                axis_names: Tuple[str, ...] = ("x", "y")) -> Mesh:
    """Mesh over every process's devices (= the single-process
    ``make_mesh`` when ``jax.process_count() == 1``).

    Uses ``mesh_utils.create_device_mesh`` for the platform's preferred
    device ordering where it has one, falling back to id-ordered
    ``jax.devices()`` (CPU multi-process)."""
    shape = tuple(int(s) for s in mesh_shape)
    n = int(np.prod(shape))
    devices = jax.devices()
    if len(devices) < n:
        raise ValueError(
            f"mesh {shape} needs {n} devices; the global device set has "
            f"{len(devices)} (over {jax.process_count()} processes)")
    try:
        from jax.experimental import mesh_utils

        arr = mesh_utils.create_device_mesh(shape,
                                            devices=devices[:n])
    except Exception:
        arr = np.array(devices[:n]).reshape(shape)
    return Mesh(arr, axis_names[: len(shape)])


def run_replicated(eng, padded, steps: int):
    """``eng.run`` with a fully-replicated output: every process passes
    the SAME global padded array (standard multi-controller SPMD
    contract) and receives the whole global result, so host-side code
    (checksums, checkpoints, verification) needs no gather.

    ``eng`` is any sharded engine from ``parallel.domain`` whose mesh
    may span processes."""
    key = ("_replicated_jit", int(steps))
    cache = getattr(eng, "_mh_cache", None)
    if cache is None:
        cache = eng._mh_cache = {}
    if key not in cache:
        cache[key] = jax.jit(
            lambda g: eng.from_sharded(eng._run(eng.to_sharded(g),
                                                steps=steps)),
            out_shardings=NamedSharding(eng.mesh, P()),
        )
    return cache[key](padded)
