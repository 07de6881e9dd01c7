"""Cross-feature interaction coverage: boundary modes x dtypes x custom
coefficients x gradients x sharding -- combinations the per-feature
modules don't exercise together."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lorastencil import engine
from lorastencil.models import shapes
from lorastencil.utils import reference


def _padded(spec, interior, seed, scale=0.01):
    rng = np.random.default_rng(seed)
    p = np.zeros(spec.padded_shape(interior))
    it = tuple(slice(h, h + s) for h, s in zip(spec.halo, interior))
    p[it] = rng.uniform(0, scale, interior)
    return p, it


def test_periodic_bf16_2d():
    spec = shapes.get_shape("star2d1r")
    p, it = _padded(spec, (24, 200), 101)
    eng = engine.StencilEngine.for_shape(
        "star2d1r", (24, 200), boundary="periodic", dtype="bfloat16")
    out = np.asarray(
        eng.run(jnp.asarray(p, jnp.bfloat16), 3).astype(jnp.float32),
        np.float64)[it]
    want = reference.run_periodic(p, spec, 3)[it]
    assert np.abs(out - want).max() / np.abs(want).max() < 5e-2


def test_reflect_custom_coeffs_2d():
    S = np.array([[0.0, 0.5, 0.0],
                  [0.25, 1.0, 0.25],
                  [0.0, 0.5, 0.0]]) / 3.0
    eng = engine.StencilEngine.for_coeffs(S, (24, 200), halo=(1, 1),
                                          boundary="reflect",
                                          fused_steps=1)
    p, it = _padded(eng.spec, (24, 200), 102)
    out = np.asarray(eng.run(jnp.asarray(p, jnp.float32), 3),
                     np.float64)[it]
    want = reference.run_reflect(p, eng.spec, 3)[it]
    assert np.abs(out - want).max() / np.abs(want).max() < 1e-6


def test_periodic_custom_coeffs_with_residue():
    S = np.outer([1.0, 2.0, 1.0], [1.0, 2.0, 1.0]) / 16.0
    S[0, 2] += 0.125  # non-separable spike -> residue path
    eng = engine.StencilEngine.for_coeffs(S, (24, 200), halo=(1, 1),
                                          boundary="periodic",
                                          fused_steps=2)
    assert eng.spec.residue  # the spike really went to the residue
    p, it = _padded(eng.spec, (24, 200), 103)
    out = np.asarray(eng.run(jnp.asarray(p, jnp.float32), 4),
                     np.float64)[it]
    want = reference.run_periodic(p, eng.spec, 4)[it]
    assert np.abs(out - want).max() / np.abs(want).max() < 1e-6


def test_run_diff_bf16_state():
    spec = shapes.get_shape("star2d1r")
    p, it = _padded(spec, (24, 200), 104)
    rng = np.random.default_rng(105)
    w = jnp.asarray(rng.normal(size=p.shape), jnp.float32)
    eng = engine.StencilEngine.for_shape("star2d1r", (24, 200),
                                         dtype="bfloat16")
    engx = engine.StencilEngine.for_shape("star2d1r", (24, 200),
                                          backend="xla")

    def loss(v):
        return jnp.sum(
            eng.run_diff(v.astype(jnp.bfloat16), 2).astype(jnp.float32)
            * w)

    def loss_ref(v):
        return jnp.sum(engx.run(v, 2) * w)

    x = jnp.asarray(p, jnp.float32)
    got = np.asarray(jax.grad(loss)(x), np.float64)
    want = np.asarray(jax.grad(loss_ref)(x), np.float64)
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() / scale < 5e-2


def test_fp64_periodic_cpu_tier():
    jax.config.update("jax_enable_x64", True)
    try:
        spec = shapes.get_shape("1d1r")
        p, _ = _padded(spec, (600,), 106, scale=1.0)
        eng = engine.StencilEngine.for_shape("1d1r", (600,),
                                             dtype="float64",
                                             boundary="periodic")
        out = np.asarray(eng.run(jnp.asarray(p), 3), np.float64)[4:-4]
        want = reference.run_periodic(p, spec, 3)[4:-4]
        assert np.abs(out - want).max() / np.abs(want).max() < 1e-12
    finally:
        jax.config.update("jax_enable_x64", False)


def test_sharded_periodic_bf16():
    if jax.device_count() < 4:
        pytest.skip("needs the 8-virtual-device mesh")
    from lorastencil.parallel import domain

    spec = shapes.get_shape("star2d1r")
    interior = (32, 512)
    p, it = _padded(spec, interior, 107)
    sh = domain.sharded_engine("star2d1r", interior, (2, 2),
                               tile=(8, 128), fused_steps=2,
                               boundary="periodic", dtype="bfloat16")
    got = np.asarray(sh.run(p, 4).astype(jnp.float32), np.float64)[it]
    want = reference.run_periodic(p, spec, 4)[it]
    assert np.abs(got - want).max() / np.abs(want).max() < 5e-2