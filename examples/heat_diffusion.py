"""Example: 2-D heat diffusion with a custom stencil, checkpointing, and
multi-device domain decomposition.

Runs on whatever JAX finds: the GPU, or the CPU with 8 virtual devices:

    python examples/heat_diffusion.py
    JAX_PLATFORMS=cpu python examples/heat_diffusion.py
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import jax
import numpy as np

from lorastencil import engine
from lorastencil.parallel import domain
from lorastencil.utils import checkpoint


def main():
    # a 5x5 diffusion kernel: outer product blur + anisotropic spikes.
    # The engine factorizes it automatically (pivot peel / SVD + residue).
    g = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    S = np.outer(g, g)
    S[0, 2] += 0.05   # extra vertical coupling
    S[4, 2] += 0.05

    m, n = 256, 512
    eng = engine.StencilEngine.for_coeffs(S, (m, n), name="heat5x5",
                                          fused_steps=2)
    print("factorized into", len(eng.spec.terms), "separable terms +",
          len(eng.spec.residue), "residue points")

    # hot spot in the middle of a cold plate
    grid = np.zeros(eng.spec.padded_shape((m, n)), np.float32)
    grid[m // 2 - 8: m // 2 + 8, n // 2 - 8: n // 2 + 8] = 100.0

    with tempfile.TemporaryDirectory() as tmp:
        out = checkpoint.run_with_checkpoints(
            eng, grid, steps=40, every=10,
            path=os.path.join(tmp, "heat_ck.npz"), resume=False,
        )
    total = float(np.asarray(out, np.float64).sum())
    print(f"after 40 steps: total heat {total:.2f}, "
          f"peak {float(out.max()):.3f}")

    # the same run domain-decomposed over all available devices
    ndev = len(jax.devices())
    if ndev >= 2 and m % 2 == 0:
        sh = domain.sharded_engine("star2d1r", (m, n), (2, ndev // 2))
        from lorastencil.utils import reference
        g0 = reference.random_padded(sh.spec, (m, n), seed=0)
        got = np.asarray(sh.run(g0, 3), np.float64)
        want = reference.run(g0, sh.spec, 3)
        err = np.abs(got - want).max() / np.abs(want).max()
        print(f"sharded star2d1r over {ndev} devices: rel err {err:.2e}")
    else:
        print(f"skipping sharded demo ({ndev} device(s))")


if __name__ == "__main__":
    main()
