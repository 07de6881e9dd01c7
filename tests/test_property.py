"""Property-style tests: random custom coefficient matrices through the
full factorize -> engine -> step pipeline vs a direct dense reference."""

import jax.numpy as jnp
import numpy as np
import pytest

from lorastencil import engine
from lorastencil.models import factorize
from lorastencil.models.shapes import SeparableTerm, StencilSpec
from lorastencil.utils import reference


def _dense_spec(S, halo):
    """Ground-truth spec: the matrix as pure residue points."""
    r = (S.shape[0] - 1) // 2
    return StencilSpec(
        name="dense", ndim=2, radius=r, halo=halo,
        terms=(), residue=tuple(
            (tuple(int(i) - r for i in idx), float(S[tuple(idx)]))
            for idx in np.argwhere(np.abs(S) > 0)
        ), fuse_factor=1,
    )


def _random_low_rank(rng, w, rank, spikes):
    S = np.zeros((w, w))
    for _ in range(rank):
        u = np.round(rng.normal(size=w), 2)
        v = np.round(rng.normal(size=w), 2)
        S += np.outer(u, v)
    for _ in range(spikes):
        i, j = rng.integers(0, w, 2)
        S[i, j] += round(float(rng.normal()), 2)
    return S


@pytest.mark.parametrize("seed", range(6))
def test_random_custom_stencils(seed):
    rng = np.random.default_rng(seed)
    w = int(rng.choice([3, 5, 7]))
    rank = int(rng.integers(1, 3))
    spikes = int(rng.integers(0, 4))
    S = _random_low_rank(rng, w, rank, spikes)
    r = (w - 1) // 2

    eng = engine.StencilEngine.for_coeffs(
        S, (24, 136), halo=(r, r), max_rank=4,
        fused_steps=int(rng.choice([1, 2, 4])),
    )
    g0 = rng.uniform(-1, 1, eng.spec.padded_shape((24, 136)))
    steps = int(rng.integers(1, 5))
    got = np.asarray(eng.run(jnp.asarray(g0, jnp.float32), steps),
                     np.float64)
    want = reference.run(g0, _dense_spec(S, (r, r)), steps)
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() / scale < 1e-5, (
        seed, w, rank, spikes, eng.config)


def test_undecomposable_matrix_raises():
    rng = np.random.default_rng(99)
    S = rng.normal(size=(7, 7))  # full rank, dense residue
    with pytest.raises(ValueError, match="cannot decompose"):
        factorize.decompose_2d(S, max_rank=2, residue_budget=4)


@pytest.mark.parametrize("seed", range(6, 12))
def test_random_custom_stencils_bf16_and_ghost(seed):
    """Random specs with bf16 state or a periodic boundary."""
    rng = np.random.default_rng(seed)
    w = int(rng.choice([3, 5, 7]))
    rank = int(rng.integers(1, 3))
    spikes = int(rng.integers(0, 4))
    S = _random_low_rank(rng, w, rank, spikes)
    r = (w - 1) // 2

    bf16 = bool(seed % 2)
    boundary = "dirichlet0" if bf16 else "periodic"
    eng = engine.StencilEngine.for_coeffs(
        S, (24, 136), halo=(r, r), max_rank=4,
        dtype="bfloat16" if bf16 else "float32", boundary=boundary,
        fused_steps=int(rng.choice([1, 2, 3])),
    )
    g0 = rng.uniform(-1, 1, eng.spec.padded_shape((24, 136)))
    steps = int(rng.integers(1, 5))
    x = jnp.asarray(g0, jnp.bfloat16 if bf16 else jnp.float32)
    got = np.asarray(eng.run(x, steps).astype(jnp.float32), np.float64)
    dense = _dense_spec(S, (r, r))
    if bf16:
        want = reference.run(np.asarray(x.astype(jnp.float32), np.float64),
                             dense, steps)
    else:
        want = reference.run_periodic(g0, dense, steps)
    scale = max(1.0, np.abs(want).max())
    tol = 4e-3 * steps if bf16 else 1e-5
    assert np.abs(got - want).max() / scale < tol, (
        seed, w, rank, spikes, bf16, steps)


@pytest.mark.parametrize("seed", range(4))
def test_random_wide_z_3d_specs(seed):
    """Random 3-D specs with z radius up to 3."""
    rng = np.random.default_rng(100 + seed)
    rz = int(rng.integers(1, 4))
    rp = int(rng.integers(1, 3))
    radius = max(rz, rp)

    def taps(rad):
        t = np.round(rng.normal(size=2 * rad + 1), 2)
        return tuple(float(x) for x in t)

    spec = StencilSpec(
        name=f"rz{rz}", ndim=3, radius=radius,
        halo=(radius, max(radius, 2), 4),
        terms=(
            SeparableTerm(taps=(taps(rz), None, None)),
            SeparableTerm(taps=(taps(min(rz, radius)), taps(rp),
                                taps(rp))),
        ),
        residue=(((int(rng.integers(-radius, radius + 1)),
                   int(rng.integers(-radius, radius + 1)),
                   int(rng.integers(-radius, radius + 1))),
                  round(float(rng.normal()), 2)),),
        fuse_factor=1)
    interior = (2 * radius * 2, 16, 140)
    eng = engine.StencilEngine(
        spec, interior,
        engine.EngineConfig(fused_steps=int(rng.integers(1, 3))))
    g0 = rng.uniform(-1, 1, spec.padded_shape(interior))
    steps = int(rng.integers(1, 4))
    got = np.asarray(eng.run(jnp.asarray(g0, jnp.float32), steps),
                     np.float64)
    want = reference.run(g0, spec, steps)
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() / scale < 1e-5, (seed, rz, rp, steps)
