"""XLA fallback ops vs the NumPy fp64 ground truth, all 8 shapes,
single and multi step (the reference only verifies 1 step; we verify k)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lorastencil.models import shapes
from lorastencil.ops import xla_ref
from lorastencil.utils import reference

INTERIORS = {
    1: (96,),
    2: (24, 40),
    3: (6, 12, 24),
}


@pytest.mark.parametrize("name", shapes.ALL_SHAPES)
@pytest.mark.parametrize("steps", [1, 3])
def test_dense_step_matches_numpy(name, steps):
    spec = shapes.get_shape(name)
    g0 = reference.random_padded(spec, INTERIORS[spec.ndim], seed=7)
    want = reference.run(g0, spec, steps)
    g = jnp.asarray(g0, dtype=jnp.float64 if jax.config.read("jax_enable_x64")
                    else jnp.float32)
    for _ in range(steps):
        g = xla_ref.dense_step(g, spec)
    np.testing.assert_allclose(np.asarray(g, dtype=np.float64), want,
                               rtol=2e-4, atol=1e-2 * max(1.0, np.abs(want).max()) * 1e-4)


@pytest.mark.parametrize("name", shapes.ALL_SHAPES)
@pytest.mark.parametrize("steps", [1, 3])
def test_separable_step_matches_numpy(name, steps):
    spec = shapes.get_shape(name)
    g0 = reference.random_padded(spec, INTERIORS[spec.ndim], seed=11)
    want = reference.run(g0, spec, steps)
    g = jnp.asarray(g0, dtype=jnp.float32)
    for _ in range(steps):
        g = xla_ref.separable_step(g, spec)
    got = np.asarray(g, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=np.abs(want).max() * 1e-5)


@pytest.mark.parametrize("name", ["star2d1r", "box2d3r", "star3d1r"])
def test_separable_equals_dense(name):
    spec = shapes.get_shape(name)
    g0 = reference.random_padded(spec, INTERIORS[spec.ndim], seed=3)
    g = jnp.asarray(g0, dtype=jnp.float32)
    a = xla_ref.dense_step(g, spec)
    b = xla_ref.separable_step(g, spec)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                               atol=np.abs(np.asarray(a)).max() * 1e-6)
