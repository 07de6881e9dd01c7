"""Inverse problem via differentiable stencils (engine.run_diff).

Recover an unknown initial heat distribution from a LATE observation of
the diffused field: minimize ||run(x, K) - y_obs||^2 with gradients
flowing through the production step via the exact adjoint VJP (the
transpose of a linear stencil is the point-reflected stencil; no kernel
autodiff, no stored residuals).

    python examples/inverse_source.py

Runs on the GPU, or on the CPU (``JAX_PLATFORMS=cpu``) in a few seconds.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from lorastencil import engine

STEPS = 4
INTERIOR = (32, 128)

# a diffusion-like custom stencil (normalized 3x3, periodic domain)
S = np.array([[1.0, 2.0, 1.0],
              [2.0, 4.0, 2.0],
              [1.0, 2.0, 1.0]]) / 16.0
eng = engine.StencilEngine.for_coeffs(S, INTERIOR, halo=(1, 1),
                                      boundary="periodic")

# ground-truth source: two hot spots
rng = np.random.default_rng(0)
truth = np.zeros(eng.spec.padded_shape(INTERIOR), np.float32)
truth[8:12, 30:36] = 1.0
truth[22:26, 90:100] = 2.0
truth = jnp.asarray(truth)
y_obs = eng.run(truth, STEPS)


@jax.jit
@jax.value_and_grad
def loss(x):
    pred = eng.run_diff(x, STEPS)
    return jnp.sum((pred - y_obs) ** 2)


def main():
    x = jnp.zeros_like(truth)
    # f = ||Ax-y||^2 with ||A|| <= 1 (normalized stencil): L = 2||A^T A||
    # <= 2, so gradient descent is stable for lr < 0.5
    lr = 0.45
    for i in range(60):
        val, g = loss(x)
        x = x - lr * g
        if i % 10 == 0 or i == 59:
            err = float(jnp.abs(x - truth).max())
            print(f"iter {i:3d}  loss {float(val):.3e}  "
                  f"max|x-truth| {err:.3f}", flush=True)
    rec = np.asarray(x)
    # diffusion is smoothing, so the inversion is ill-posed: expect the
    # MASS of each hot spot to be recovered well before its sharp shape
    print("recovered hot-spot mass:",
          round(float(rec[6:14, 28:38].sum()), 2), "and",
          round(float(rec[20:28, 88:102].sum()), 2),
          "(truth: 24.0 and 80.0)")


if __name__ == "__main__":
    main()
