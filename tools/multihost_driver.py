#!/usr/bin/env python
"""Multi-process CPU driver for the multi-host sharded-engine test.

Launched N times by tests/test_multihost.py (and usable by hand):

    python tools/multihost_driver.py PORT NUM_PROCS PROC_ID \
        [shape] [m] [n] [steps] [dx] [dy]

Each process contributes ``--xla_force_host_platform_device_count=2``
CPU devices to a global (dx, dy) mesh, runs the sharded engine on the
same seeded input, and process 0 checks the replicated result against
the fp64 ground truth, printing ``MULTIHOST_OK <maxrelerr>``.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
# overwrite (not append): an inherited device-count flag (e.g. the test
# suite's 8) would win over ours and skew the global device count
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    port, nprocs, pid = (int(a) for a in sys.argv[1:4])
    rest = sys.argv[4:]
    shape = rest[0] if rest else "star2d1r"
    m = int(rest[1]) if len(rest) > 1 else 96
    n = int(rest[2]) if len(rest) > 2 else 160
    steps = int(rest[3]) if len(rest) > 3 else 3
    dx = int(rest[4]) if len(rest) > 4 else 2
    dy = int(rest[5]) if len(rest) > 5 else 2

    from lorastencil.parallel import multihost

    multihost.initialize(f"localhost:{port}", num_processes=nprocs,
                         process_id=pid)
    assert jax.process_count() == nprocs, jax.process_count()
    assert len(jax.devices()) == 2 * nprocs

    import numpy as np

    from lorastencil.parallel import domain
    from lorastencil.utils import reference

    mesh = multihost.global_mesh((dx, dy))
    spec = __import__("lorastencil.models.shapes",
                      fromlist=["get_shape"]).get_shape(shape)
    cfg = domain.ShardedConfig(mesh_shape=(dx, dy))
    eng = domain.ShardedStencil2D(spec, (m, n), cfg, mesh=mesh)

    grid0 = reference.random_padded(spec, (m, n), seed=7)
    got = np.asarray(multihost.run_replicated(eng, grid0, steps),
                     dtype=np.float64)
    if pid == 0:
        want = reference.run(grid0, spec, steps)
        scale = max(1.0, float(np.abs(want).max()))
        rel = float(np.abs(got - want).max()) / scale
        ok = rel < 1e-5 and np.isfinite(rel)
        print(f"{'MULTIHOST_OK' if ok else 'MULTIHOST_FAIL'} {rel:.3e}",
              flush=True)
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
