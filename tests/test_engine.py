"""End-to-end engine tests: the engine's default path (the plain XLA
step on the CPU) vs the NumPy fp64 ground truth, for every shape,
multi-step, tile-unaligned sizes."""

import jax.numpy as jnp
import numpy as np
import pytest

from lorastencil import engine
from lorastencil.models import shapes
from lorastencil.utils import reference

INTERIORS = {1: (300,), 2: (40, 200), 3: (6, 20, 150)}


@pytest.mark.parametrize("name", shapes.ALL_SHAPES)
@pytest.mark.parametrize("steps", [0, 1, 3])
def test_engine_matches_reference(name, steps):
    spec = shapes.get_shape(name)
    interior = INTERIORS[spec.ndim]
    g0 = reference.random_padded(spec, interior, seed=9)
    eng = engine.StencilEngine.for_shape(name, interior)
    got = np.asarray(eng.run(jnp.asarray(g0, jnp.float32), steps), np.float64)
    want = reference.run(g0, spec, steps)
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() / scale < 1e-6


@pytest.mark.parametrize("name", ["1d2r", "star2d1r", "box3d1r"])
def test_engine_xla_backend(name):
    spec = shapes.get_shape(name)
    interior = INTERIORS[spec.ndim]
    g0 = reference.random_padded(spec, interior, seed=2)
    eng = engine.StencilEngine.for_shape(name, interior, backend="xla")
    got = np.asarray(eng.run(jnp.asarray(g0, jnp.float32), 2), np.float64)
    want = reference.run(g0, spec, 2)
    assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) < 1e-6


def test_engine_tile_aligned_2d():
    # exactly tile-aligned path (no interior mask)
    spec = shapes.get_shape("star2d1r")
    g0 = reference.random_padded(spec, (32, 256), seed=3)
    eng = engine.StencilEngine.for_shape("star2d1r", (32, 256),
                                         tile=(32, 256))
    got = np.asarray(eng.run(jnp.asarray(g0, jnp.float32), 2), np.float64)
    want = reference.run(g0, spec, 2)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


def test_layout_roundtrip():
    from lorastencil.ops.layout import Layout1D, Layout2D, Layout3D

    l2 = Layout2D(interior=(40, 200), halo=(4, 4), tile=(40, 256))
    x = np.arange(48 * 208, dtype=np.float32).reshape(48, 208)
    np.testing.assert_array_equal(
        np.asarray(l2.from_internal(l2.to_internal(x))), x)

    l1 = Layout1D(interior=300, halo=4, tile_rows=8)
    v = np.arange(308, dtype=np.float32)
    np.testing.assert_array_equal(
        np.asarray(l1.from_internal(l1.to_internal(v))), v)

    l3 = Layout3D(interior=(6, 20, 150), halo=(1, 2, 4), tile=(24, 256))
    w = np.arange(8 * 24 * 158, dtype=np.float32).reshape(8, 24, 158)
    np.testing.assert_array_equal(
        np.asarray(l3.from_internal(l3.to_internal(w))), w)


def test_default_tiles():
    """The layouts' round-up tiles: at most (256, 512) in 2-D and
    (64, 512) in-plane in 3-D, shrunk to small interiors."""
    from lorastencil.ops.layout import default_tile_2d, default_tile_3d

    assert default_tile_2d(8192, 8192) == (256, 512)
    assert default_tile_2d(40, 200) == (40, 256)
    assert default_tile_3d(512, 512) == (64, 512)
    assert default_tile_3d(20, 150) == (24, 256)
    e = engine.StencilEngine.for_shape("star3d1r", (256, 256, 256))
    assert e.layout.tile == (64, 256)
    e2 = engine.StencilEngine.for_shape("box2d3r", (300, 1000))
    assert e2.layout.tile == (256, 512) and e2.layout.grid == (2, 2)


# The plain step (ops/plain.py) over the cases the removed kernel tiers
# covered: shapes x dtype x fused depth x boundary x layout tile.
PLAIN_CASES = (
    [(n, "float32", k, "dirichlet0", t)
     for n in ("star2d1r", "star2d3r", "box2d3r")
     for k in (1, 2, 3, 4) for t in (None, (16, 128))]
    + [(n, d, k, "dirichlet0", None)
       for n in ("star2d1r", "box2d3r") for d in ("bfloat16",)
       for k in (1, 2)]
    + [("star2d1r", "float32", k, b, None)
       for b in ("periodic", "reflect") for k in (1, 2)]
    + [(n, "float32", k, "dirichlet0", None)
       for n in ("star3d1r", "box3d1r") for k in (1, 2)]
)


@pytest.mark.parametrize("name,dtype,k,boundary,tile", PLAIN_CASES)
def test_plain_step_cases(name, dtype, k, boundary, tile):
    """Engine runs through the plain step match the fp64 truth."""
    spec = shapes.get_shape(name)
    interior = INTERIORS[spec.ndim]
    g0 = reference.random_padded(spec, interior, seed=61)
    eng = engine.StencilEngine.for_shape(name, interior, dtype=dtype,
                                         fused_steps=k, boundary=boundary,
                                         tile=tile)
    assert eng.backend == "xla" and eng._fused_k() == k
    steps = 2 * k + 1  # whole passes plus a remainder pass
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    got = np.asarray(eng.run(jnp.asarray(g0, jdt), steps).astype(
        jnp.float32), np.float64)
    truth = {"dirichlet0": reference.run, "periodic": reference.run_periodic,
             "reflect": reference.run_reflect}[boundary]
    want = truth(g0, spec, steps)
    tol = 4e-3 * steps if dtype == "bfloat16" else 1e-6
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < tol, (name, dtype, k, boundary, tile, err)


@pytest.mark.parametrize("steps", [0, 1, 2, 4, 5])
def test_fused_step_counts(steps):
    """k=2 passes for any step count: none, a lone remainder pass, whole
    passes, and whole passes plus a remainder."""
    spec = shapes.get_shape("star2d1r")
    interior = (40, 200)
    g0 = reference.random_padded(spec, interior, seed=62)
    eng = engine.StencilEngine.for_shape("star2d1r", interior,
                                         fused_steps=2)
    got = np.asarray(eng.run(jnp.asarray(g0, jnp.float32), steps),
                     np.float64)
    want = reference.run(g0, spec, steps)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


def test_engine_float64_requires_x64():
    """Requesting fp64 without jax_enable_x64 must fail loudly (JAX would
    silently truncate to fp32)."""
    import jax

    if jax.config.read("jax_enable_x64"):
        pytest.skip("x64 enabled in this process")
    with pytest.raises(ValueError, match="x64"):
        engine.StencilEngine.for_shape("star2d1r", (24, 128),
                                       dtype="float64")


@pytest.mark.parametrize("name,interior", [
    ("1d1r", (128,)),            # single lane-row
    ("star2d1r", (8, 128)),      # single minimal tile
    ("box2d3r", (8, 128)),
    ("star3d1r", (1, 8, 128)),   # single plane
    ("box3d1r", (2, 8, 128)),
])
def test_engine_tiny_grids(name, interior):
    spec = shapes.get_shape(name)
    g0 = reference.random_padded(spec, interior, seed=12)
    eng = engine.StencilEngine.for_shape(name, interior)
    got = np.asarray(eng.run(jnp.asarray(g0, jnp.float32), 2), np.float64)
    want = reference.run(g0, spec, 2)
    assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) < 1e-6


@pytest.mark.parametrize("name", ["star3d1r", "box3d1r"])
@pytest.mark.parametrize("k", [2, 4])
def test_engine_3d_fused(name, k):
    """3-D temporal fusion: k steps per slab sweep with z lookback."""
    spec = shapes.get_shape(name)
    interior = (6, 20, 150)
    g0 = reference.random_padded(spec, interior, seed=9)
    eng = engine.StencilEngine.for_shape(name, interior, fused_steps=k)
    for steps in (k, 2 * k + 1):
        got = np.asarray(eng.run(jnp.asarray(g0, jnp.float32), steps),
                         np.float64)
        want = reference.run(g0, spec, steps)
        err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
        assert err < 1e-6, (name, k, steps, err)


class TestReviewRegressions:
    """Regressions found in review."""

    def test_fused_steps_clamped_to_guard(self):
        # k*radius may not exceed the 128-column guard (2-D) or the
        # 8-row in-plane guard (3-D); the engine clamps, not crashes
        e2 = engine.StencilEngine.for_shape("star2d1r", (40, 200),
                                            fused_steps=100)
        assert e2._fused_k() == 128 // 3
        e3 = engine.StencilEngine.for_shape("box3d1r", (6, 20, 150),
                                            fused_steps=100)
        assert e3._fused_k() == 8
        spec = shapes.get_shape("star2d1r")
        g0 = reference.random_padded(spec, (40, 200), seed=1)
        got = np.asarray(engine.StencilEngine.for_shape(
            "box3d1r", (6, 20, 150), fused_steps=100).run(
                jnp.zeros(shapes.get_shape("box3d1r").padded_shape(
                    (6, 20, 150)), jnp.float32), 9), np.float64)
        assert not got.any()
        del g0

    def test_module_run_uses_passed_spec(self):
        eng = engine.StencilEngine.for_coeffs(
            np.outer([1.0, 2, 1], [1.0, 2, 1]) / 16, (24, 128))
        out = engine.run(
            jnp.zeros(eng.spec.padded_shape((24, 128)), jnp.float32),
            eng.spec, 2)
        assert np.asarray(out).shape == (26, 130)

    def test_3d_wide_z_radius(self):
        # z-radius-2 custom 3-D stencils (SURVEY section 7
        # generalization)
        from lorastencil.models.shapes import (SeparableTerm,
                                                   StencilSpec)

        spec = StencilSpec(
            name="z2", ndim=3, radius=2, halo=(2, 2, 4),
            terms=(SeparableTerm(taps=((1.0, 2, 0, 2, 1), None, None)),
                   SeparableTerm(taps=((0.5, 1.0, 0.5),
                                       (1.0, 2.0, 1.0),
                                       (1.0, 0.0, 1.0))),),
            residue=(((2, 1, -2), 0.25),), fuse_factor=1)
        interior = (8, 16, 150)
        g0 = reference.random_padded(spec, interior, seed=91)
        for k3 in (1, 2):
            e = engine.StencilEngine(
                spec, interior,
                engine.EngineConfig(fused_steps=k3))
            got = np.asarray(
                e.run(jnp.asarray(g0, jnp.float32), 3), np.float64)
            want = reference.run(g0, spec, 3)
            err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
            assert err < 1e-6, (k3, err)

    def test_identity_residue(self):
        from lorastencil.models.shapes import (SeparableTerm,
                                                   StencilSpec)

        spec = StencilSpec(
            name="c1", ndim=2, radius=1, halo=(1, 1),
            terms=(SeparableTerm(taps=((1.0, 0, 1), (1.0, 0, 1))),),
            residue=(((0, 0), 1.0),), fuse_factor=1)
        eng = engine.StencilEngine(
            spec, (24, 128),
            engine.EngineConfig(fused_steps=1))
        g = np.random.default_rng(2).uniform(
            0, 1, spec.padded_shape((24, 128)))
        got = np.asarray(eng.run(jnp.asarray(g, jnp.float32), 2),
                         np.float64)
        want = reference.run(g, spec, 2)
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


class Test1DGenerality:
    def test_flat_layout_roundtrip_and_guard(self):
        # the 1-D layout stores the flat array row-major in (rows, 128);
        # its guard grows with the fused depth
        from lorastencil.ops.layout import Layout1D

        eng = engine.StencilEngine.for_shape("1d2r", (5000,),
                                             fused_steps=300)
        assert isinstance(eng.layout, Layout1D)
        assert eng.layout.origin >= 300 * 4
        v = np.arange(5008, dtype=np.float32)
        lay = eng.layout
        np.testing.assert_array_equal(
            np.asarray(lay.from_internal(lay.to_internal(v))), v)

    @pytest.mark.parametrize("k", [1, 2, 3, 5])
    def test_fused_matches_reference(self, k):
        spec = shapes.get_shape("1d2r")
        n = 33_001
        g0 = reference.random_padded(spec, (n,), seed=21)
        eng = engine.StencilEngine.for_shape("1d2r", (n,), fused_steps=k)
        got = np.asarray(eng.run(jnp.asarray(g0, jnp.float32), 2 * k + 1),
                         np.float64)
        want = reference.run(g0, spec, 2 * k + 1)
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-6

    def test_for_coeffs_1d_custom_taps(self):
        taps = np.array([0.5, -1.0, 2.0, -1.0, 0.25])
        eng = engine.StencilEngine.for_coeffs(taps, (400,))
        assert eng.spec.ndim == 1 and eng.spec.radius == 2
        g0 = reference.random_padded(eng.spec, (400,), seed=12)
        got = np.asarray(eng.run(jnp.asarray(g0, jnp.float32), 3),
                         np.float64)
        want = reference.run(g0, eng.spec, 3)
        assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) < 1e-6

    def test_1d_multi_term_residue_spec(self):
        # multi-term + residue 1-D specs collapse to dense taps
        from lorastencil.models.shapes import SeparableTerm, StencilSpec

        spec = StencilSpec(
            name="mt1d", ndim=1, radius=3, halo=(3,),
            terms=(SeparableTerm(taps=((1.0, 2.0, 1.0),)),
                   SeparableTerm(taps=((0.5, 0.0, 0.0, 0.0, 0.0, 0.0,
                                        0.5),)),),
            residue=(((-2,), 0.25), ((2,), -0.25)), fuse_factor=1)
        g0 = reference.random_padded(spec, (300,), seed=13)
        got = np.asarray(engine.run(jnp.asarray(g0, jnp.float32), spec, 2),
                         np.float64)
        want = reference.run(g0, spec, 2)
        assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) < 1e-6

    def test_1d_deep_fusion(self):
        # the guard grows with fused_steps; normalized taps keep values
        # bounded over the 2k+3 steps
        taps = np.array([1, 2, 3, 4, 5, 4, 3, 2, 1], np.float64) / 25.0
        k = 24
        eng = engine.StencilEngine.for_coeffs(taps, (600_000,), halo=(4,),
                                              fused_steps=k)
        assert eng.layout.origin >= k * 4
        g0 = reference.random_padded(eng.spec, (600_000,), seed=5)
        got = np.asarray(eng.run(jnp.asarray(g0, jnp.float32), 2 * k + 3),
                         np.float64)
        want = reference.run(g0, eng.spec, 2 * k + 3)
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err < 5e-6, err


def test_cpu_path_resolution():
    """The engine's path: XLA on the CPU for every dimensionality and
    dtype; the fused depth defaults to 1 there."""
    for name, kw in (("star2d1r", {}), ("box3d1r", {}), ("1d2r", {}),
                     ("star2d1r", {"dtype": "bfloat16"}),
                     ("star2d1r", {"dtype": "df64"})):
        interior = INTERIORS[shapes.get_shape(name).ndim]
        eng = engine.StencilEngine.for_shape(name, interior, **kw)
        assert eng.backend == "xla" and eng._fused_k() == 1, (name, kw)
    with pytest.raises(ValueError, match="GPU"):
        engine.StencilEngine.for_shape("star2d1r", (40, 200),
                                       backend="kernel")


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_bf16_state_throughput_tier(k):
    """bfloat16 state in device memory (half the traffic; computed in
    fp32): ~4e-3/step storage rounding."""
    spec = shapes.get_shape("star2d1r")
    g0 = reference.random_padded(spec, (40, 200), seed=77)
    eng = engine.StencilEngine.for_shape(
        "star2d1r", (40, 200), dtype="bfloat16", fused_steps=k)
    got = np.asarray(
        eng.run(jnp.asarray(g0, jnp.bfloat16), 4).astype(jnp.float32),
        np.float64)
    want = reference.run(g0, spec, 4)
    assert np.abs(got - want).max() / np.abs(want).max() < 5e-2


@pytest.mark.parametrize("name,interior", [
    ("1d2r", (300_000,)),
    ("1d1r", (700,)),
    ("box3d1r", (8, 16, 150)),
    ("star3d1r", (6, 20, 150)),
])
def test_bf16_state_1d_3d(name, interior):
    """The bf16 tier covers every dimensionality (compute is fp32; only
    the stored state rounds)."""
    spec = shapes.get_shape(name)
    g0 = reference.random_padded(spec, interior, seed=78)
    eng = engine.StencilEngine.for_shape(name, interior,
                                         dtype="bfloat16")
    got = np.asarray(
        eng.run(jnp.asarray(g0, jnp.bfloat16), 3).astype(jnp.float32),
        np.float64)
    want = reference.run(g0, spec, 3)
    assert np.abs(got - want).max() / np.abs(want).max() < 5e-2


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("name", ["star2d1r", "box3d1r"])
def test_plain_forms_agree(name, steps):
    """The plain step (dense form) against the low-rank separable form
    of the same steps (xla_ref.separable_step): the decomposition and the
    dense coefficients agree."""
    from lorastencil.ops import xla_ref

    spec = shapes.get_shape(name)
    interior = INTERIORS[spec.ndim]
    g0 = jnp.asarray(reference.random_padded(spec, interior, seed=7),
                     jnp.float32)
    eng = engine.StencilEngine.for_shape(name, interior)
    got = np.asarray(eng.run(g0, steps), np.float64)
    want = g0
    for _ in range(steps):
        want = xla_ref.separable_step(want, spec)
    want = np.asarray(want, np.float64)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


def test_bf16_state_on_xla_backend():
    """bf16 state runs on the XLA backend (stored bf16, computed
    fp32)."""
    spec = shapes.get_shape("box3d1r")
    g0 = reference.random_padded(spec, (8, 16, 128), seed=4)
    eng = engine.StencilEngine.for_shape("box3d1r", (8, 16, 128),
                                         dtype="bfloat16", backend="xla")
    out = eng.run(jnp.asarray(g0, jnp.bfloat16), 2)
    assert out.dtype == jnp.bfloat16
    want = reference.run(g0, spec, 2)
    got = np.asarray(out.astype(jnp.float32), np.float64)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-2


def test_explicit_tile_overrides():
    """An explicit tile reshapes the 2-D layout without changing
    results (the 1-D layout's tile rows follow the grid)."""
    spec = shapes.get_shape("star2d1r")
    g0 = reference.random_padded(spec, (40, 200), seed=13)
    want = reference.run(g0, spec, 3)
    for tile in (None, (8, 128), (16, 256), (48, 384)):
        eng = engine.StencilEngine.for_shape("star2d1r", (40, 200),
                                             tile=tile)
        if tile is not None:
            assert eng.layout.tile == tile
        got = np.asarray(eng.run(jnp.asarray(g0, jnp.float32), 3),
                         np.float64)
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err < 1e-6, (tile, err)


def test_kernel_constants():
    """The kernel's fused depth and block geometry are fixed constants
    (measured on the card, PERF.md); the engine applies the depth only
    on the kernel path."""
    from lorastencil.ops import hopper2d

    assert 1 <= engine.KERNEL_FUSED_STEPS <= engine.MAX_KERNEL_FUSED_STEPS
    tm, tn = hopper2d.TILE
    assert tm % hopper2d.V == 0 and tn % 4 == 0
    eng = engine.StencilEngine.for_shape("star2d1r", (40, 200))
    assert eng.backend == "xla" and eng._fused_k() == 1


@pytest.mark.parametrize("name", ["star3d1r", "box3d1r"])
def test_3d_reflect_fused(name):
    """3-D reflect boundaries through the plain step (fused, the
    reference shapes are mirror-symmetric)."""
    spec = shapes.get_shape(name)
    interior = (6, 20, 150)
    g0 = reference.random_padded(spec, interior, seed=9)
    eng = engine.StencilEngine.for_shape(name, interior, fused_steps=2,
                                         boundary="reflect")
    got = np.asarray(eng.run(jnp.asarray(g0, jnp.float32), 3), np.float64)
    want = reference.run_reflect(g0, spec, 3)
    assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) < 1e-6


def test_1d_custom_real_taps():
    """Arbitrary real 1-D taps through the plain step."""
    taps = np.array([0.11, -0.7, 1.3, 0.25, 1.3, -0.7, 0.11])
    eng = engine.StencilEngine.for_coeffs(taps, (300_000,))
    g0 = reference.random_padded(eng.spec, (300_000,), seed=6)
    got = np.asarray(eng.run(jnp.asarray(g0, jnp.float32), 3), np.float64)
    want = reference.run(g0, eng.spec, 3)
    assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) < 1e-6


def test_1d_small_grids_many_steps():
    """Small 1-D grids over many steps (values kept small)."""
    for name, n in [("1d1r", 4096), ("1d2r", 4096), ("1d1r", 300)]:
        spec = shapes.get_shape(name)
        eng = engine.StencilEngine.for_shape(name, (n,))
        g0 = reference.random_padded(spec, (n,), seed=33) * 1e-6
        got = np.asarray(eng.run(jnp.asarray(g0, jnp.float32), 11),
                         np.float64)
        want = reference.run(g0, spec, 11)
        err = np.abs(got - want).max() / max(1e-300, np.abs(want).max())
        assert err < 1e-6, (name, n, err)


def test_1d_periodic_small_grid():
    """Periodic 1-D runs refresh the ring before every pass."""
    spec = shapes.get_shape("1d2r")
    rng = np.random.default_rng(5)
    g0 = rng.uniform(0, 0.01, (4096,))
    padded = np.zeros(spec.padded_shape((4096,)))
    padded[4:-4] = g0
    eng = engine.StencilEngine.for_shape("1d2r", (4096,),
                                         boundary="periodic")
    got = np.asarray(eng.run(jnp.asarray(padded, jnp.float32), 5),
                     np.float64)[4:-4]
    it = (slice(4, -4),)
    want = reference.run_periodic(padded, spec, 5)[it]
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


@pytest.mark.parametrize("name", ["box2d3r", "star2d1r"])
def test_nondivisible_round_up_masked(name):
    """Non-divisible interiors: tile round-up cells stay masked to zero
    through fused passes."""
    spec = shapes.get_shape(name)
    g0 = reference.random_padded(spec, (41, 203), seed=61)
    eng = engine.StencilEngine.for_shape(name, (41, 203), fused_steps=3,
                                         tile=(16, 128))
    got = np.asarray(eng.run(jnp.asarray(g0, jnp.float32), 7), np.float64)
    want = reference.run(g0, spec, 7)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-6, (name, err)


def test_1d_edges():
    """1-D edges: bf16 state, arbitrary real taps, and a grid smaller
    than one 128-cell row."""
    # bf16 state (~4e-3/step storage rounding)
    spec = shapes.get_shape("1d2r")
    g0 = reference.random_padded(spec, (4096,), seed=8) * 1e-3
    eng = engine.StencilEngine.for_shape("1d2r", (4096,),
                                         dtype="bfloat16")
    got = np.asarray(
        eng.run(jnp.asarray(g0, jnp.bfloat16), 3).astype(jnp.float32),
        np.float64)
    want = reference.run(g0, spec, 3)
    assert np.abs(got - want).max() / np.abs(want).max() < 5e-2

    # arbitrary real taps
    taps = np.array([0.21, -0.4, 1.7, -0.4, 0.21])
    enc = engine.StencilEngine.for_coeffs(taps, (5000,))
    g0 = reference.random_padded(enc.spec, (5000,), seed=9)
    got = np.asarray(enc.run(jnp.asarray(g0, jnp.float32), 7), np.float64)
    want = reference.run(g0, enc.spec, 7)
    assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) < 1e-6

    # fewer cells than one row (single partial row)
    g0 = reference.random_padded(spec, (50,), seed=10)
    tiny = engine.StencilEngine.for_shape("1d2r", (50,))
    got = np.asarray(tiny.run(jnp.asarray(g0, jnp.float32), 4),
                     np.float64)
    want = reference.run(g0, spec, 4)
    assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) < 1e-6


@pytest.mark.parametrize("name,interior", [
    ("star2d1r", (512, 512)), ("box2d3r", (256, 384)),
    ("star2d3r", (200, 300)),
])
def test_2d_small_grid(name, interior):
    """Small 2-D grids: fp32 vs the fp64 reference, halo decays to
    zero; bf16 state too."""
    spec = shapes.get_shape(name)
    eng = engine.StencilEngine.for_shape(name, interior)
    g0 = reference.random_padded(spec, interior, seed=31)
    for steps in (1, 5):
        got = np.asarray(eng.run(jnp.asarray(g0, jnp.float32), steps),
                         np.float64)
        want = reference.run(g0, spec, steps)
        rel = np.abs(got - want).max() / max(1.0, np.abs(want).max())
        assert rel < 5e-6, (name, steps, rel)
    h = spec.halo
    assert np.all(got[: h[0]] == 0.0) and np.all(got[:, : h[1]] == 0.0)
    # bf16 state (fp32 compute, bf16 store)
    engb = engine.StencilEngine.for_shape(name, interior,
                                          dtype="bfloat16")
    gotb = np.asarray(engb.run(jnp.asarray(g0, jnp.bfloat16), 3),
                      np.float64)
    want = reference.run(g0, spec, 3)
    assert (np.abs(gotb - want).max() / max(1.0, np.abs(want).max())
            < 5e-2), name


def test_2d_periodic_ring_refresh():
    """Ghost boundaries refresh the ring before every pass: the run
    matches the periodic truth."""
    spec = shapes.get_shape("star2d1r")
    g0 = reference.random_padded(spec, (64, 256), seed=33)
    engg = engine.StencilEngine.for_shape("star2d1r", (64, 256),
                                          boundary="periodic")
    it = reference.interior_slices(spec, g0.shape)
    got = np.asarray(engg.run(jnp.asarray(g0, jnp.float32), 3),
                     np.float64)
    want = reference.run_periodic(g0, spec, 3)
    assert (np.abs(got[it] - want[it]).max()
            / max(1.0, np.abs(want).max()) < 5e-6)
