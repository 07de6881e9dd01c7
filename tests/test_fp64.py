"""fp64 tier: the reference is fp64 end-to-end with an absolute 1e-7
one-step check (``reference/src/2d/main.cu:318-326``,
``src/1d/main.cu:17,166``, ``src/3d/main.cu:15,237``).  With x64 the
plain step reproduces that regime exactly, on the CPU as on the GPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lorastencil import engine
from lorastencil.models import shapes
from lorastencil.utils import reference

INTERIORS = {1: (300,), 2: (40, 200), 3: (6, 20, 150)}


@pytest.fixture()
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("name", ["1d1r", "star2d1r", "box2d3r",
                                  "star3d1r", "box3d1r"])
def test_fp64_one_step_reference_check(name, x64):
    """The reference's CHECK_ERROR contract verbatim: one timestep,
    elementwise |naive - engine| <= 1e-7 absolute, interior only."""
    spec = shapes.get_shape(name)
    interior = INTERIORS[spec.ndim]
    g0 = reference.random_padded(spec, interior, seed=21)
    eng = engine.StencilEngine.for_shape(name, interior, dtype="float64")
    got = np.asarray(eng.run(jnp.asarray(g0, jnp.float64), 1), np.float64)
    want = reference.run(g0, spec, 1)
    it = reference.interior_slices(spec, g0.shape)
    assert np.abs(got[it] - want[it]).max() <= 1e-7


@pytest.mark.parametrize("name", ["1d2r", "star2d3r"])
def test_fp64_multi_step(name, x64):
    spec = shapes.get_shape(name)
    interior = INTERIORS[spec.ndim]
    g0 = reference.random_padded(spec, interior, seed=22)
    eng = engine.StencilEngine.for_shape(name, interior, dtype="float64",
                                         fused_steps=2)
    got = np.asarray(eng.run(jnp.asarray(g0, jnp.float64), 4), np.float64)
    want = reference.run(g0, spec, 4)
    assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) < 1e-13


def test_fp64_fused(x64):
    spec = shapes.get_shape("star2d1r")
    g0 = reference.random_padded(spec, (40, 200), seed=23)
    eng = engine.StencilEngine.for_shape(
        "star2d1r", (40, 200), dtype="float64", fused_steps=3)
    assert eng.backend == "xla"
    got = np.asarray(eng.run(jnp.asarray(g0, jnp.float64), 5), np.float64)
    want = reference.run(g0, spec, 5)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-13


def test_fp64_xla_backend(x64):
    spec = shapes.get_shape("star2d1r")
    g0 = reference.random_padded(spec, (40, 200), seed=24)
    eng = engine.StencilEngine.for_shape("star2d1r", (40, 200),
                                         dtype="float64", backend="xla")
    got = np.asarray(eng.run(jnp.asarray(g0, jnp.float64), 3), np.float64)
    want = reference.run(g0, spec, 3)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-13


def test_fp64_without_x64_raises():
    with pytest.raises(ValueError, match="x64"):
        engine.StencilEngine.for_shape("star2d1r", (40, 200),
                                       dtype="float64")


def test_fp64_cli_check(x64, capsys):
    # --check --dtype float64 (the reference's own regime)
    from lorastencil import cli

    rc = cli.main(["star2d1r", "40", "200", "2", "--dtype", "float64",
                   "--check", "--repeats", "1"])
    out = capsys.readouterr().out
    assert rc == 0 and "Correct!" in out
