"""Periodic boundary conditions (boundary='periodic'): the guard ring is
refreshed from the opposite interior edge before every pass; ground
truth is the np.roll wrap applied to the interior grid."""

import jax.numpy as jnp
import numpy as np
import pytest

from lorastencil import engine
from lorastencil.models import shapes


def periodic_reference(interior_grid, spec, steps):
    """out[p] = sum_o S[o] * in[(p + o) mod n] over the interior grid."""
    S = spec.dense_coeffs()
    r = spec.radius
    g = np.asarray(interior_grid, np.float64)
    for _ in range(steps):
        acc = np.zeros_like(g)
        for idx in np.argwhere(np.abs(S) > 0):
            off = tuple(int(i) - r for i in idx)
            acc += float(S[tuple(idx)]) * np.roll(
                g, tuple(-o for o in off), axis=tuple(range(g.ndim)))
        g = acc
    return g


INTERIORS = {1: (300,), 2: (24, 200), 3: (6, 16, 150)}


def _run_periodic(name, interior, steps, **kw):
    spec = shapes.get_shape(name)
    rng = np.random.default_rng(41)
    gi = rng.uniform(0, 0.01, interior)
    padded = np.zeros(spec.padded_shape(interior))
    it = tuple(slice(h, h + s) for h, s in zip(spec.halo, interior))
    padded[it] = gi
    eng = engine.StencilEngine.for_shape(name, interior,
                                         boundary="periodic", **kw)
    out = np.asarray(eng.run(jnp.asarray(padded, jnp.float32), steps),
                     np.float64)[it]
    want = periodic_reference(gi, spec, steps)
    return np.abs(out - want).max() / max(1e-30, np.abs(want).max())


@pytest.mark.parametrize("name", shapes.ALL_SHAPES)
@pytest.mark.parametrize("steps", [1, 3])
def test_periodic_all_shapes(name, steps):
    spec = shapes.get_shape(name)
    err = _run_periodic(name, INTERIORS[spec.ndim], steps)
    assert err < 1e-6, (name, steps, err)


def test_periodic_fused_2d():
    err = _run_periodic("star2d1r", (24, 200), 5, fused_steps=2)
    assert err < 1e-6, err


def test_periodic_1d_large_grid():
    # large 1-D grid, fused passes
    name, interior = "1d2r", (200_000,)
    err = _run_periodic(name, interior, 5, fused_steps=2)
    assert err < 1e-6, err


def test_periodic_on_xla_backend():
    # the plain XLA step honours the ghost ring like any step
    err = _run_periodic("star2d1r", (24, 200), 3, backend="xla")
    assert err < 1e-6, err


def test_periodic_rejects_tiny_interior():
    with pytest.raises(ValueError, match="ring depth"):
        engine.StencilEngine.for_shape("1d2r", (2,), boundary="periodic")


def reflect_reference(interior_grid, spec, steps):
    from lorastencil.utils import reference as _ref

    padded = np.zeros(spec.padded_shape(interior_grid.shape))
    it = tuple(slice(h, h + s)
               for h, s in zip(spec.halo, interior_grid.shape))
    padded[it] = interior_grid
    return _ref.run_reflect(padded, spec, steps)[it]


@pytest.mark.parametrize("name", ["1d1r", "star2d1r", "box2d3r",
                                  "box3d1r"])
@pytest.mark.parametrize("steps", [1, 3])
def test_reflect_shapes(name, steps):
    spec = shapes.get_shape(name)
    interior = INTERIORS[spec.ndim]
    rng = np.random.default_rng(43)
    gi = rng.uniform(0, 0.01, interior)
    padded = np.zeros(spec.padded_shape(interior))
    it = tuple(slice(h, h + s) for h, s in zip(spec.halo, interior))
    padded[it] = gi
    eng = engine.StencilEngine.for_shape(name, interior,
                                         boundary="reflect")
    out = np.asarray(eng.run(jnp.asarray(padded, jnp.float32), steps),
                     np.float64)[it]
    want = reflect_reference(gi, spec, steps)
    err = np.abs(out - want).max() / max(1e-30, np.abs(want).max())
    assert err < 1e-6, (name, steps, err)


def test_reflect_fused_symmetric_ok_nonsymmetric_rejected():
    # symmetric reference shape: fused reflect is exact
    spec = shapes.get_shape("star2d1r")
    rng = np.random.default_rng(44)
    gi = rng.uniform(0, 0.01, (24, 200))
    padded = np.zeros(spec.padded_shape((24, 200)))
    it = tuple(slice(h, h + s) for h, s in zip(spec.halo, (24, 200)))
    padded[it] = gi
    eng = engine.StencilEngine.for_shape("star2d1r", (24, 200),
                                         boundary="reflect",
                                         fused_steps=2)
    out = np.asarray(eng.run(jnp.asarray(padded, jnp.float32), 5),
                     np.float64)[it]
    want = reflect_reference(gi, spec, 5)
    assert np.abs(out - want).max() / np.abs(want).max() < 1e-6
    # non-symmetric custom taps: fused reflect is rejected loudly
    with pytest.raises(ValueError, match="symmetric"):
        engine.StencilEngine.for_coeffs(
            np.array([0.25, 0.5, 0.125]), (3000,), halo=(1,),
            boundary="reflect", fused_steps=2)
    # ...but k=1 works (ring refresh per step = np.pad per step)
    eng1 = engine.StencilEngine.for_coeffs(
        np.array([0.25, 0.5, 0.125]), (3000,), halo=(1,),
        boundary="reflect", fused_steps=1)
    gi = rng.uniform(0, 0.01, 3000)
    padded = np.zeros(3002)
    padded[1:-1] = gi
    out = np.asarray(eng1.run(jnp.asarray(padded, jnp.float32), 3),
                     np.float64)[1:-1]
    want = reflect_reference(gi, eng1.spec, 3)
    assert np.abs(out - want).max() / np.abs(want).max() < 1e-6


def test_periodic_mass_conservation():
    # a normalized stencil on a periodic domain conserves total mass
    taps = np.array([1.0, 2.0, 4.0, 2.0, 1.0]) / 10.0
    eng = engine.StencilEngine.for_coeffs(taps, (1280,), halo=(2,),
                                          boundary="periodic")
    rng = np.random.default_rng(9)
    padded = np.zeros(1284, np.float64)
    padded[2:-2] = rng.uniform(0, 1, 1280)
    out = np.asarray(eng.run(jnp.asarray(padded, jnp.float32), 10),
                     np.float64)
    assert abs(out[2:-2].sum() - padded[2:-2].sum()) < 1e-2