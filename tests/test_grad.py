"""Differentiable stencils: engine.run_diff's exact custom VJP (adjoint
= point-reflected stencil) vs JAX autodiff through the pure-XLA backend.

The stencil operator is linear, so the VJP needs no residuals; the
backward pass is k-1 forward passes of the flipped-spec engine on the
interior-masked cotangent plus one unmasked correlation (which recovers
the gradient w.r.t. the input halo cells read by step one)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lorastencil import engine
from lorastencil.models import shapes
from lorastencil.utils import reference

INTERIORS = {1: (300,), 2: (24, 200), 3: (4, 16, 150)}


def _grad_pair(eng_diff, eng_xla, x, w, steps):
    def loss_diff(v):
        return jnp.sum(eng_diff.run_diff(v, steps) * w)

    def loss_xla(v):
        return jnp.sum(eng_xla.run(v, steps) * w)

    return (np.asarray(jax.grad(loss_diff)(x), np.float64),
            np.asarray(jax.grad(loss_xla)(x), np.float64))


@pytest.mark.parametrize("name", ["1d2r", "star2d1r", "box2d3r",
                                  "box3d1r"])
@pytest.mark.parametrize("steps", [0, 1, 3])
def test_run_diff_grad_matches_xla_autodiff(name, steps):
    spec = shapes.get_shape(name)
    interior = INTERIORS[spec.ndim]
    rng = np.random.default_rng(31)
    x = jnp.asarray(reference.random_padded(spec, interior, seed=31),
                    jnp.float32) * 0.01
    w = jnp.asarray(rng.normal(size=x.shape), jnp.float32)
    eng = engine.StencilEngine.for_shape(name, interior)
    engx = engine.StencilEngine.for_shape(name, interior, backend="xla")
    got, want = _grad_pair(eng, engx, x, w, steps)
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() / scale < 1e-5, (name, steps)


def test_run_diff_nonsymmetric_custom_2d():
    # asymmetric coefficients: the adjoint is genuinely the FLIP
    S = np.array([[0.0, 0.5, -0.25],
                  [1.0, 2.0, 0.0],
                  [0.0, -0.5, 0.125]])
    interior = (24, 200)
    eng = engine.StencilEngine.for_coeffs(S, interior, halo=(1, 1))
    # xla twin on the same (factorized) spec
    engx = engine.StencilEngine(eng.spec, interior,
                                engine.EngineConfig(backend="xla"))
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.normal(size=eng.spec.padded_shape(interior)),
                    jnp.float32) * 0.01
    w = jnp.asarray(rng.normal(size=x.shape), jnp.float32)
    got, want = _grad_pair(eng, engx, x, w, 3)
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() / scale < 1e-5


def test_run_diff_forward_values_match_run():
    eng = engine.StencilEngine.for_shape("star2d1r", (24, 200))
    x = jnp.asarray(
        reference.random_padded(eng.spec, (24, 200), seed=3), jnp.float32)
    np.testing.assert_array_equal(np.asarray(eng.run_diff(x, 2)),
                                  np.asarray(eng.run(x, 2)))


def test_run_diff_periodic_grad():
    """Periodic run_diff: the circulant transpose is the flipped
    periodic operator; compare against autodiff of a jnp.roll model."""
    spec = shapes.get_shape("star2d1r")
    interior = (24, 200)
    rng = np.random.default_rng(71)
    S = spec.dense_coeffs()
    r = spec.radius
    offs = [(tuple(int(i) - r for i in idx), float(S[tuple(idx)]))
            for idx in np.argwhere(np.abs(S) > 0)]
    it = tuple(slice(h, h + s) for h, s in zip(spec.halo, interior))
    w = jnp.asarray(rng.normal(size=spec.padded_shape(interior)),
                    jnp.float32)
    x = jnp.asarray(rng.uniform(0, 0.01, spec.padded_shape(interior)),
                    jnp.float32)
    x = jnp.zeros_like(x).at[it].set(x[it])
    eng = engine.StencilEngine.for_shape("star2d1r", interior,
                                         boundary="periodic")

    def loss_eng(v):
        return jnp.sum(eng.run_diff(v, 3) * w)

    def roll_model(v):
        g = v[it]
        for _ in range(3):
            acc = jnp.zeros_like(g)
            for off, wt in offs:
                acc = acc + wt * jnp.roll(g, tuple(-o for o in off),
                                          axis=(0, 1))
            g = acc
        return jnp.sum(g * w[it])

    got = np.asarray(jax.grad(loss_eng)(x), np.float64)
    want_i = np.asarray(jax.grad(roll_model)(x), np.float64)
    scale = max(1.0, np.abs(want_i).max())
    assert np.abs(got - want_i).max() / scale < 1e-5


@pytest.mark.parametrize("name,steps", [("star2d1r", 1),
                                        ("star2d1r", 3), ("1d2r", 2)])
def test_run_diff_reflect_grad(name, steps):
    """Reflect run_diff: fold-back adjoint (pad_sym^T) vs autodiff of a
    jnp pad-symmetric model."""
    spec = shapes.get_shape(name)
    interior = INTERIORS[spec.ndim]
    rng = np.random.default_rng(73)
    S = spec.dense_coeffs()
    r = spec.radius
    offs = [(tuple(int(i) for i in idx), float(S[tuple(idx)]))
            for idx in np.argwhere(np.abs(S) > 0)]
    it = tuple(slice(h, h + s) for h, s in zip(spec.halo, interior))
    shape = spec.padded_shape(interior)
    w = jnp.asarray(rng.normal(size=shape), jnp.float32)
    w = jnp.zeros_like(w).at[it].set(w[it])
    x = jnp.asarray(rng.uniform(0, 0.01, shape), jnp.float32)
    x = jnp.zeros_like(x).at[it].set(x[it])
    eng = engine.StencilEngine.for_shape(name, interior,
                                         boundary="reflect")

    def loss_eng(v):
        return jnp.sum(eng.run_diff(v, steps) * w)

    def pad_model(v):
        g = v[it]
        for _ in range(steps):
            gp = jnp.pad(g, r, mode="symmetric")
            acc = jnp.zeros_like(g)
            for idx, wt in offs:
                sl = tuple(slice(i, i + s)
                           for i, s in zip(idx, g.shape))
                acc = acc + wt * gp[sl]
            g = acc
        return jnp.sum(g * w[it])

    got = np.asarray(jax.grad(loss_eng)(x), np.float64)
    want = np.asarray(jax.grad(pad_model)(x), np.float64)
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() / scale < 1e-5, (name, steps)


def test_run_diff_reflect_nonsymmetric_k1():
    # non-symmetric custom taps at fused_steps=1: fold adjoint is exact
    taps = np.array([0.25, 0.5, 0.125])
    eng = engine.StencilEngine.for_coeffs(taps, (300,), halo=(1,),
                                          boundary="reflect",
                                          fused_steps=1)
    rng = np.random.default_rng(74)
    x = jnp.asarray(rng.uniform(0, 0.01, 302), jnp.float32)
    x = x.at[0].set(0).at[-1].set(0)
    w = jnp.asarray(rng.normal(size=302), jnp.float32)
    w = w.at[0].set(0).at[-1].set(0)

    def loss_eng(v):
        return jnp.sum(eng.run_diff(v, 2) * w)

    def pad_model(v):
        g = v[1:-1]
        for _ in range(2):
            gp = jnp.pad(g, 1, mode="symmetric")
            g = 0.25 * gp[:-2] + 0.5 * gp[1:-1] + 0.125 * gp[2:]
        return jnp.sum(g * w[1:-1])

    got = np.asarray(jax.grad(loss_eng)(x), np.float64)
    want = np.asarray(jax.grad(pad_model)(x), np.float64)
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() / scale < 1e-5


def test_run_vjp_matches_autodiff_fp32():
    """run_vjp (host-level adjoint product) is the same code path as
    run_diff's custom-VJP backward -- identical values to jax.grad."""
    spec = shapes.get_shape("star2d1r")
    interior = (24, 200)
    rng = np.random.default_rng(81)
    x = jnp.asarray(reference.random_padded(spec, interior, seed=81),
                    jnp.float32) * 0.01
    w = jnp.asarray(rng.normal(size=x.shape), jnp.float32)
    eng = engine.StencilEngine.for_shape("star2d1r", interior)

    def loss(v):
        return jnp.sum(eng.run_diff(v, 3) * w)

    want = np.asarray(jax.grad(loss)(x), np.float64)
    got = np.asarray(eng.run_vjp(w, 3), np.float64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("boundary", ["dirichlet0", "periodic",
                                      "reflect"])
@pytest.mark.parametrize("name", ["1d2r", "star2d1r"])
def test_df64_run_vjp_dot_identity(name, boundary):
    """fp64-grade adjoint: <A x, g> == <x, A^T g> at df64 accuracy
    (~1e-13), computed in fp64 on the host.  A = eng.run (linear),
    A^T g = eng.run_vjp."""
    spec = shapes.get_shape(name)
    interior = {1: (300,), 2: (40, 200)}[spec.ndim]
    rng = np.random.default_rng(83)
    shape = spec.padded_shape(interior)
    x = rng.standard_normal(shape) * np.pi
    g = rng.standard_normal(shape)
    eng = engine.StencilEngine.for_shape(name, interior, dtype="df64",
                                         boundary=boundary)
    ax = eng.run(x, 2)
    atg = eng.run_vjp(g, 2)
    assert ax.dtype == np.float64 and atg.dtype == np.float64
    lhs = float(np.vdot(ax, g))
    rhs = float(np.vdot(x, atg))
    scale = max(1.0, abs(lhs))
    assert abs(lhs - rhs) / scale < 1e-12, (name, boundary, lhs, rhs)


@pytest.mark.parametrize("boundary,runner", [
    ("dirichlet0", reference.run),
    ("periodic", reference.run_periodic),
    ("reflect", reference.run_reflect)])
def test_df64_run_vjp_matches_dense_matrix(boundary, runner):
    """Exactness against the explicit operator matrix: build A column
    by column from the fp64 ground-truth runner on basis vectors, then
    compare run_vjp(g) to A^T g (pure fp64)."""
    spec = shapes.get_shape("1d1r")
    interior = (24,)
    steps = 2
    shape = spec.padded_shape(interior)
    n = shape[0]
    A = np.zeros((n, n))
    for j in range(n):
        e = np.zeros(shape)
        e[j] = 1.0
        A[:, j] = runner(e, spec, steps)
    rng = np.random.default_rng(85)
    g = rng.standard_normal(shape)
    want = A.T @ g
    eng = engine.StencilEngine.for_shape("1d1r", interior, dtype="df64",
                                         boundary=boundary)
    got = eng.run_vjp(g, steps)
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() / scale < 1e-13, boundary


def test_df64_run_vjp_steps_zero_identity():
    eng = engine.StencilEngine.for_shape("star2d1r", (24, 200),
                                         dtype="df64")
    g = np.random.default_rng(86).standard_normal(
        eng.spec.padded_shape((24, 200)))
    np.testing.assert_array_equal(eng.run_vjp(g, 0), g)


def test_flipped_spec_roundtrip():
    spec = shapes.get_shape("box2d3r")
    S = spec.dense_coeffs()
    Sf = spec.flipped().dense_coeffs()
    np.testing.assert_allclose(Sf, S[::-1, ::-1])  # symmetric: equal too
    np.testing.assert_allclose(
        spec.flipped().flipped().dense_coeffs(), S)