"""df64 tier: fp64-GRADE accuracy on the accelerator via double-float
fp32 pairs (ops/df64.py).

The reference computes in native fp64 (``DATA_TYPE double``,
``reference/src/1d/1d_utils.h:44``); this tier carries ~48 mantissa
bits as (hi, lo) fp32 pairs with error-free transformations, through the
plain pair step (ops/plain.py, ``pair=True``) on every path.  Ground
truth for every comparison is the NumPy fp64 reference
(utils/reference.py).
"""

import os
import sys

import jax
import numpy as np
import pytest

from lorastencil import cli, engine
from lorastencil.models import shapes
from lorastencil.ops import df64
from lorastencil.utils import reference

INTERIORS = {1: (300,), 2: (40, 200), 3: (6, 20, 150)}


def _padded_input(spec, interior, seed):
    # non-integer values with full fp64 mantissas: the reference's
    # integer fill is exactly representable in fp32 and would leave
    # every lo word zero for the first few steps
    return reference.random_padded(spec, interior, seed=seed) * (
        np.pi / 100.0)


# -- error-free transformation primitives ------------------------------------
def test_split_merge_roundtrip():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096) * 10.0 ** rng.integers(-20, 20, 4096)
    back = df64.merge_host(df64.split_host(x))
    assert np.abs(back - x).max() <= 1e-14 * np.abs(x).max()


def test_two_sum_exact():
    """TwoSum is EXACT: s + e == a + b in fp64 (fp32 inputs are exact
    fp64 values and their sum fits fp64)."""
    rng = np.random.default_rng(1)
    a = (rng.standard_normal(4096)
         * 10.0 ** rng.integers(-8, 8, 4096)).astype(np.float32)
    b = (rng.standard_normal(4096)
         * 10.0 ** rng.integers(-8, 8, 4096)).astype(np.float32)
    s, e = jax.jit(df64.two_sum)(a, b)
    s64 = np.asarray(s, np.float64) + np.asarray(e, np.float64)
    assert np.array_equal(s64, a.astype(np.float64) + b.astype(np.float64))


def test_two_prod_exact():
    """Dekker TwoProd is EXACT: p + e == a * b in fp64 (a 24x24-bit
    product has <= 48 bits -- exactly representable in fp64)."""
    rng = np.random.default_rng(2)
    a = (rng.standard_normal(4096)
         * 10.0 ** rng.integers(-8, 8, 4096)).astype(np.float32)
    b = (rng.standard_normal(4096)
         * 10.0 ** rng.integers(-8, 8, 4096)).astype(np.float32)
    p, e = jax.jit(df64.two_prod)(a, b)
    p64 = np.asarray(p, np.float64) + np.asarray(e, np.float64)
    assert np.array_equal(p64, a.astype(np.float64) * b.astype(np.float64))


# -- engine tier --------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(shapes.ALL_SHAPES))
def test_df64_matches_fp64_reference(name):
    """Every registry shape, multi-step, vs the fp64 ground truth at
    ~1e4x tighter than the fp32 tier's tolerance."""
    spec = shapes.get_shape(name)
    interior = INTERIORS[spec.ndim]
    g0 = _padded_input(spec, interior, seed=31)
    eng = engine.StencilEngine.for_shape(name, interior, dtype="df64")
    got = eng.run(g0, 3)
    assert got.dtype == np.float64
    want = reference.run(g0, spec, 3)
    rel = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert rel < 1e-12


def test_df64_beats_fp32_by_orders_of_magnitude():
    spec = shapes.get_shape("star2d1r")
    interior = INTERIORS[2]
    g0 = _padded_input(spec, interior, seed=32)
    want = reference.run(g0, spec, 5)
    scale = np.abs(want).max()
    f32 = np.asarray(
        engine.StencilEngine.for_shape(
            "star2d1r", interior, dtype="float32", backend="xla"
        ).run(g0.astype(np.float32), 5), np.float64)
    d64 = engine.StencilEngine.for_shape(
        "star2d1r", interior, dtype="df64").run(g0, 5)
    err32 = np.abs(f32 - want).max() / scale
    err_df = np.abs(d64 - want).max() / scale
    assert err32 > 1e-9  # fp32 visibly rounds at 5 steps
    assert err_df < 1e-4 * err32  # df64 is >= 4 orders tighter


def test_df64_first_step_sees_user_halo():
    """Reference halo-decay semantics: step one reads the supplied halo,
    the output halo is zero (SURVEY.md section 4)."""
    spec = shapes.get_shape("1d2r")
    interior = INTERIORS[1]
    g0 = _padded_input(spec, interior, seed=33)
    eng = engine.StencilEngine.for_shape("1d2r", interior, dtype="df64")
    got = eng.run(g0, 1)
    want = reference.run(g0, spec, 1)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    h = spec.halo[0]
    assert np.all(got[:h] == 0.0) and np.all(got[-h:] == 0.0)
    # zeroing the halo changes the answer => it was read
    g0z = g0.copy()
    g0z[:h] = 0.0
    assert np.abs(eng.run(g0z, 1) - want).max() > 0.0


def test_df64_checksum_and_internal_api():
    spec = shapes.get_shape("box2d3r")
    interior = INTERIORS[2]
    g0 = _padded_input(spec, interior, seed=34)
    eng = engine.StencilEngine.for_shape("box2d3r", interior, dtype="df64")
    out = eng.run(g0, 2)
    cs = eng.run_checksum(g0, 2)
    # checksum sums each fp32 plane on device -- fp32 reduction noise
    assert abs(cs - out.sum()) <= 1e-3 * max(1.0, abs(out.sum()))
    # internal round trip: the pair planes live on the internal layout
    state = eng.to_internal(g0)
    assert state.shape == (2,) + eng.layout.shape
    out2 = eng.from_internal(eng.run_internal(state, 2))
    assert np.abs(out2 - out).max() <= 1e-12 * max(1.0, np.abs(out).max())


def test_df64_config_guards():
    # a pure-center-tap spec (radius 4, one nonzero tap) runs like any
    center = np.zeros(9)
    center[4] = 1.5
    eng = engine.StencilEngine.for_coeffs(center, (4096,), dtype="df64")
    g0 = _padded_input(eng.spec, (4096,), seed=2)
    want = reference.run(g0, eng.spec, 2)
    assert np.abs(eng.run(g0, 2) - want).max() <= 1e-12 * np.abs(want).max()
    with pytest.raises(ValueError, match="backend"):
        engine.StencilEngine.for_shape(
            "star2d1r", (40, 200), dtype="df64", backend="mxu")
    with pytest.raises(ValueError, match="GPU"):
        # the CUDA kernel has no df64 path, and no interpret mode
        engine.StencilEngine.for_shape(
            "star2d1r", (40, 200), dtype="df64", backend="kernel")
    with pytest.raises(ValueError, match="run_diff"):
        engine.StencilEngine.for_shape(
            "star2d1r", (40, 200), dtype="df64").run_diff(
                np.zeros((46, 206)), 1)
    with pytest.raises(SystemExit):  # argparse p.error: no such flag
        cli.main(["star2d1r", "40", "200", "3", "--dtype", "df64",
                  "--autotune"])


@pytest.mark.parametrize("coeffs_shape", [(7,), (5, 5), (3, 3, 3)])
def test_df64_custom_coeffs(coeffs_shape):
    """for_coeffs + df64: arbitrary (non-integer-tap) stencils, where
    the tap lo halves are genuinely nonzero."""
    rng = np.random.default_rng(5)
    S = rng.standard_normal(coeffs_shape)
    if S.ndim == 2:
        S = S + S.T  # symmetric, like the reference's specs
    interior = INTERIORS[S.ndim]
    eng = engine.StencilEngine.for_coeffs(S, interior, dtype="df64")
    g0 = (reference.random_padded(eng.spec, interior, seed=36)
          * (np.e / 100.0))
    got = eng.run(g0, 3)
    want = reference.run(g0, eng.spec, 3)
    rel = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert rel < 1e-12


REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_suite_run_config_df64():
    """benchmarks.suite.run_config measures the df64 tier (pair-shaped
    state) and names the device; off the card no roofline share."""
    sys.path.insert(0, REPO_ROOT)
    from benchmarks.suite import run_config

    r = run_config("star2d1r", (64, 128), 2, dtype="df64", repeats=1)
    assert r["backend"] == "xla" and r["dtype"] == "df64"
    assert r["gcells_per_s"] > 0 and r["roofline_share"] is None
    r1 = run_config("1d1r", (4096,), 2, dtype="df64", repeats=1)
    assert r1["gcells_per_s"] > 0


def test_suite_rows_name_device():
    """Suite rows carry the device they ran on and the median and
    quartile times; chained runs report per-run times."""
    sys.path.insert(0, REPO_ROOT)
    from benchmarks import suite

    r = suite.run_config("1d1r", (4096,), 4, chain=3, repeats=3)
    assert r["device"]["platform"] == jax.devices()[0].platform
    assert r["device"]["count"] == len(jax.devices())
    assert r["q1_ms"] <= r["time_ms"] <= r["q3_ms"]
    assert r["chain"] == 3 and r["repeats"] == 3
    names = {n for n, *_ in suite.CONFIGS + suite.BF16 + suite.DF64}
    assert {"star2d1r", "box2d3r", "1d2r", "box3d1r"} <= names


def test_df64_cli_check(capsys):
    rc = cli.main(["star2d1r", "40", "200", "3", "--dtype", "df64",
                   "--check", "--repeats", "1"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Correct!" in out


# -- the pair step at fused depth k -----------------------------------------
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("name", ["star2d3r", "star2d1r", "box2d3r"])
def test_df64_pair_step_accuracy(name, k):
    """The pair step holds ~1e-14/step vs the fp64 ground truth on every
    2-D registry shape, unfused and fused."""
    spec = shapes.get_shape(name)
    interior = (48, 256)
    g0 = _padded_input(spec, interior, seed=41)
    eng = engine.StencilEngine.for_shape(
        name, interior, dtype="df64", fused_steps=k)
    assert eng._fused_k() == k
    got = eng.run(g0, 2 * k + 1)
    want = reference.run(g0, spec, 2 * k + 1)
    rel = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert rel < 1e-12, (name, k, rel)


def test_df64_pair_valid_matches_dense():
    """df64.pair_valid, the valid pair correlation, against the fp64
    dense correlation of the merged input."""
    spec = shapes.get_shape("star2d1r")
    x = _padded_input(spec, (40, 72), seed=9)
    hi, lo = df64.split_host(x)
    h, l_ = jax.jit(lambda a, b: df64.pair_valid(a, b, spec))(hi, lo)
    got = df64.merge_host(np.stack([np.asarray(h), np.asarray(l_)]))
    S, r = spec.dense_coeffs(), spec.radius
    out = tuple(n - 2 * r for n in x.shape)
    want = sum(S[i, j] * x[i: i + out[0], j: j + out[1]]
               for i, j in np.argwhere(S != 0))
    assert got.shape == tuple(s - 2 * spec.radius for s in x.shape)
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()


def test_df64_sep_asymmetric_coeffs():
    """A non-symmetric random 2-D stencil (asymmetric taps and residue)
    through for_coeffs stays fp64-grade."""
    rng = np.random.default_rng(43)
    S = rng.standard_normal((5, 5))  # NOT symmetrized
    interior = (40, 200)
    eng = engine.StencilEngine.for_coeffs(S, interior, dtype="df64")
    g0 = (reference.random_padded(eng.spec, interior, seed=44)
          * (np.e / 100.0))
    got = eng.run(g0, 3)
    want = reference.run(g0, eng.spec, 3)
    rel = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert rel < 1e-12, rel


def test_df64_pair_step_region():
    """The pair step writes only its region: a region call leaves the
    rest of the donor untouched."""
    import jax.numpy as jnp
    from lorastencil.ops import plain
    from lorastencil.ops.layout import Layout2D

    spec = shapes.get_shape("star2d1r")
    lay = Layout2D(interior=(32, 256), halo=spec.halo, tile=(8, 128))
    g0 = _padded_input(spec, (32, 256), seed=4)
    cur = jnp.stack([lay.to_internal(p) for p in df64.split_host(g0)])
    donor = jnp.full_like(cur, 7.0)
    out = np.asarray(plain.step(cur, donor, spec, lay, pair=True,
                                region=((1, 3), (0, 1))))
    r0, c0 = lay.origin
    assert (out[:, : r0 + 8] == 7.0).all()
    assert (out[:, r0 + 24:] == 7.0).all()
    assert (out[:, :, c0 + 128:] == 7.0).all()
    full = np.asarray(plain.step(cur, jnp.zeros_like(cur), spec, lay,
                                 pair=True))
    blk = (slice(None), slice(r0 + 8, r0 + 24), slice(c0, c0 + 128))
    np.testing.assert_array_equal(out[blk], full[blk])


def test_df64_unaligned_interior():
    """Tile round-up: interior not a multiple of the tile -- the bounds
    mask must zero the fake cells (they alias the output guard ring)."""
    spec = shapes.get_shape("box2d1r")
    interior = (40, 200)  # rounds up in both axes at any (8k, 128k) tile
    g0 = _padded_input(spec, interior, seed=42)
    eng = engine.StencilEngine.for_shape(
        "box2d1r", interior, dtype="df64", tile=(16, 128))
    got = eng.run(g0, 3)
    want = reference.run(g0, spec, 3)
    assert np.abs(got - want).max() <= 1e-12 * max(1.0, np.abs(want).max())
    h = spec.halo
    assert np.all(got[: h[0]] == 0.0) and np.all(got[:, : h[1]] == 0.0)
    assert np.all(got[-h[0]:] == 0.0) and np.all(got[:, -h[1]:] == 0.0)


def test_df64_3d_unaligned_interior():
    """3-D pair step: tile round-up in both plane axes + an odd z
    extent; the bounds mask must zero the fake cells and the output halo
    stays zero."""
    spec = shapes.get_shape("box3d1r")
    interior = (5, 20, 150)
    g0 = _padded_input(spec, interior, seed=45)
    eng = engine.StencilEngine.for_shape(
        "box3d1r", interior, dtype="df64", tile=(16, 128))
    assert eng.spec.ndim == 3
    got = eng.run(g0, 3)
    want = reference.run(g0, spec, 3)
    assert np.abs(got - want).max() <= 1e-12 * max(1.0, np.abs(want).max())
    h = spec.halo
    assert np.all(got[: h[0]] == 0.0) and np.all(got[-h[0]:] == 0.0)
    assert np.all(got[:, : h[1]] == 0.0) and np.all(got[:, -h[1]:] == 0.0)
    assert np.all(got[:, :, : h[2]] == 0.0)
    assert np.all(got[:, :, -h[2]:] == 0.0)


def test_df64_3d_custom_coeffs_separable_z():
    """3-D for_coeffs, fully-separable z profile (decompose_3d branch
    1) through the pair step."""
    S = np.einsum("i,j,k->ijk", [1.0, 3.0, 1.0], [1.0, 2.0, 1.0],
                  [0.5, 1.0, 0.5])
    interior = (6, 20, 150)
    eng = engine.StencilEngine.for_coeffs(S, interior, dtype="df64")
    g0 = (reference.random_padded(eng.spec, interior, seed=46)
          * (np.pi / 100.0))
    got = eng.run(g0, 3)
    want = reference.run(g0, eng.spec, 3)
    rel = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert rel < 1e-12, rel


def test_df64_3d_single_tile_grid():
    """Single-tile 3-D plane grids run the pair step exactly."""
    spec = shapes.get_shape("star3d1r")
    interior = (4, 8, 128)
    eng = engine.StencilEngine.for_shape("star3d1r", interior,
                                         dtype="df64")
    assert eng.layout.grid == (1, 1)
    g0 = _padded_input(spec, interior, seed=8)
    want = reference.run(g0, spec, 3)
    got = eng.run(g0, 3)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_df64_single_tile_grid():
    """Single-tile 2-D grids run the pair step exactly."""
    spec = shapes.get_shape("star2d1r")
    interior = (8, 128)
    eng = engine.StencilEngine.for_shape("star2d1r", interior,
                                         dtype="df64")
    assert eng.layout.grid == (1, 1)
    g0 = _padded_input(spec, interior, seed=8)
    want = reference.run(g0, spec, 3)
    got = eng.run(g0, 3)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


# -- 1-D pair step -------------------------------------------------------------
@pytest.mark.parametrize("name,n", [("1d1r", 4096), ("1d2r", 20000)])
def test_df64_1d_multi_tile(name, n):
    """Multi-tile 1-D grids stay fp64-grade."""
    spec = shapes.get_shape(name)
    g0 = _padded_input(spec, (n,), seed=46)
    eng = engine.StencilEngine.for_shape(name, (n,), dtype="df64")
    got = eng.run(g0, 4)
    want = reference.run(g0, spec, 4)
    rel = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert rel < 1e-12, (name, rel)
    h = spec.halo[0]
    assert np.all(got[:h] == 0.0) and np.all(got[-h:] == 0.0)


def test_df64_1d_many_steps():
    """Accuracy holds over many steps and fused passes with a
    remainder."""
    spec = shapes.get_shape("1d1r")
    g0 = _padded_input(spec, (4096,), seed=95)
    eng = engine.StencilEngine.for_shape("1d1r", (4096,), dtype="df64",
                                         fused_steps=4)
    for steps in (1, 8, 9, 17):
        got = eng.run(g0, steps)
        want = reference.run(g0, spec, steps)
        rel = np.abs(got - want).max() / max(1.0, np.abs(want).max())
        assert rel < 1e-12, (steps, rel)


def test_df64_1d_custom_asymmetric_coeffs():
    """Asymmetric taps, a zero center tap and +-1 weights."""
    taps = np.asarray([1.0, -0.75, 0.0, 0.5, -1.0])
    eng = engine.StencilEngine.for_coeffs(taps, (6000,), dtype="df64")
    g0 = (reference.random_padded(eng.spec, (6000,), seed=47)
          * (np.e / 100.0))
    got = eng.run(g0, 3)
    want = reference.run(g0, eng.spec, 3)
    rel = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert rel < 1e-12, rel


@pytest.mark.parametrize("r_eff", [33, 64, 100])
def test_df64_1d_wide_radius(r_eff):
    """Wide radii stay fp64-grade -- the tier is radius-uniform like
    the reference's fp64 band build (src/1d/gpu_1r.cu:94-99)."""
    taps = np.zeros(2 * r_eff + 1)
    taps[0] = taps[-1] = 0.5
    taps[r_eff] = 1.0
    taps[r_eff // 3] = -0.625
    eng = engine.StencilEngine.for_coeffs(taps, (2000,), dtype="df64")
    g0 = (reference.random_padded(eng.spec, (2000,), seed=48)
          * (np.pi / 100.0))
    got = eng.run(g0, 2)
    want = reference.run(g0, eng.spec, 2)
    rel = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert rel < 1e-12, rel


def test_df64_1d_wide_radius_ghost_boundaries():
    """Ghost rings at a wide radius (the ring refresh runs per pair
    plane on the flat 1-D layout)."""
    taps = np.zeros(81)  # radius 40
    taps[0] = taps[-1] = 1.0
    taps[40] = -2.0
    for boundary, truth in (("periodic", reference.run_periodic),
                            ("reflect", reference.run_reflect)):
        eng = engine.StencilEngine.for_coeffs(
            taps, (2000,), dtype="df64", boundary=boundary)
        g0 = (reference.random_padded(eng.spec, (2000,), seed=3)
              * 0.01)
        it = reference.interior_slices(eng.spec, g0.shape)
        got = eng.run(g0, 3)
        want = truth(g0, eng.spec, 3)
        rel = (np.abs(got[it] - want[it]).max()
               / max(1.0, np.abs(want).max()))
        assert rel < 1e-12, (boundary, rel)


@pytest.mark.parametrize("name", ["star2d1r", "box2d3r"])
def test_df64_2d_mid_grid(name):
    """Mid-size 2-D df64 grids over a few steps; fp64-grade, zero
    output halo."""
    spec = shapes.get_shape(name)
    interior = (256, 384)
    g0 = _padded_input(spec, interior, seed=61)
    eng = engine.StencilEngine.for_shape(name, interior, dtype="df64")
    for steps in (1, 4):
        got = eng.run(g0, steps)
        want = reference.run(g0, spec, steps)
        rel = np.abs(got - want).max() / max(1.0, np.abs(want).max())
        assert rel < 1e-12, (name, steps, rel)
    h = spec.halo
    assert np.all(got[: h[0]] == 0.0) and np.all(got[:, : h[1]] == 0.0)


# -- sharded df64 (pair state through the halo exchange) ---------------------
@pytest.mark.parametrize("name,mesh_shape", [
    ("star2d1r", (2, 2)), ("star2d3r", (1, 2)), ("box2d3r", (2, 2)),
    ("star2d1r", (4, 2)),
])
def test_sharded_df64_matches_fp64_reference(name, mesh_shape):
    """Domain-decomposed df64: the hi/lo planes ride the fp32 tier's
    two-phase ppermute exchange; accuracy must stay fp64-grade across
    device boundaries and corners."""
    from lorastencil.parallel import domain

    spec = shapes.get_shape(name)
    interior = (16 * mesh_shape[0], 128 * mesh_shape[1])
    g0 = _padded_input(spec, interior, seed=77)
    sh = domain.sharded_engine(name, interior, mesh_shape, dtype="df64")
    assert isinstance(sh, domain.ShardedStencilDF64)
    got = sh.run(g0, 3)
    assert got.dtype == np.float64
    want = reference.run(g0, spec, 3)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 1e-12, (name, mesh_shape, rel)


def test_sharded_df64_nondivisible_and_sequential():
    """Block-padded non-divisible grids, both dataflows (ring-in-output
    default and the explicit overlap=False sequential exchange)."""
    from lorastencil.parallel import domain

    spec = shapes.get_shape("star2d1r")
    interior = (30, 300)
    g0 = _padded_input(spec, interior, seed=3)
    want = reference.run(g0, spec, 4)
    for overlap in (True, False):
        sh = domain.sharded_engine("star2d1r", interior, (2, 2),
                                   dtype="df64", overlap=overlap)
        got = sh.run(g0, 4)
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel < 1e-12, (overlap, rel)


@pytest.mark.parametrize("name,boundary", [
    ("star2d1r", "periodic"), ("box2d3r", "reflect"),
    ("star2d3r", "reflect"),
    ("1d2r", "periodic"), ("1d1r", "reflect"),
    ("box3d1r", "periodic"), ("star3d1r", "reflect"),
])
def test_df64_ghost_boundaries(name, boundary):
    """periodic/reflect ghost rings on the df64 tier: every dim rides
    the pair step (per-plane ring refresh + ghost bounds).
    Ring copies and flips are exact on (hi, lo) pairs, so accuracy must
    stay fp64-grade vs the host ghost truths."""
    spec = shapes.get_shape(name)
    interior = INTERIORS[spec.ndim]
    g0 = _padded_input(spec, interior, seed=51)
    it = reference.interior_slices(spec, g0.shape)
    eng = engine.StencilEngine.for_shape(name, interior, dtype="df64",
                                         boundary=boundary)
    got = eng.run(g0, 3)
    assert got.dtype == np.float64
    truth = (reference.run_periodic if boundary == "periodic"
             else reference.run_reflect)
    want = truth(g0, spec, 3)
    rel = (np.abs(got[it] - want[it]).max()
           / max(1.0, np.abs(want).max()))
    assert rel < 1e-12, (name, boundary, rel)
    # fp64-grade beats the fp32 tier's rounding at the same config by
    # orders of magnitude (the tier's reason to exist)
    if spec.ndim == 2:
        f32 = np.asarray(engine.StencilEngine.for_shape(
            name, interior, boundary=boundary).run(
                g0.astype(np.float32), 3), np.float64)
        err32 = np.abs(f32[it] - want[it]).max() / max(
            1.0, np.abs(want).max())
        assert rel < 1e-3 * max(err32, 1e-30), (rel, err32)


def test_sharded_df64_ghost_boundaries():
    """Sharded df64 ghost rings: the base exchange's ppermute wrap /
    edge mirrors, vmapped over the pair planes, across a (2, 2) mesh."""
    from lorastencil.parallel import domain

    spec = shapes.get_shape("star2d1r")
    interior = (32, 256)
    g0 = _padded_input(spec, interior, seed=52)
    it = reference.interior_slices(spec, g0.shape)
    for boundary, truth in (("periodic", reference.run_periodic),
                            ("reflect", reference.run_reflect)):
        sh = domain.sharded_engine("star2d1r", interior, (2, 2),
                                   dtype="df64", boundary=boundary)
        got = np.asarray(sh.run(g0, 3))
        want = truth(g0, spec, 3)
        rel = (np.abs(got[it] - want[it]).max()
               / max(1.0, np.abs(want).max()))
        assert rel < 1e-12, (boundary, rel)


@pytest.mark.parametrize("boundary", ["periodic", "reflect"])
def test_sharded_df64_1d_tailed_ghost_blocks(boundary):
    """Non-divisible 1-D df64 blocks under ghost boundaries: the
    true-tail edge strips move through the flat layout's dynamic
    slices."""
    from lorastencil.parallel import domain

    spec = shapes.get_shape("1d1r")
    g0 = _padded_input(spec, (5000,), seed=21)
    it = reference.interior_slices(spec, g0.shape)
    truth = (reference.run_periodic if boundary == "periodic"
             else reference.run_reflect)
    want = truth(g0, spec, 3)
    for overlap in (True, False):
        sh = domain.sharded_engine("1d1r", 5000, (4,), dtype="df64",
                                   boundary=boundary, overlap=overlap)
        got = np.asarray(sh.run(g0, 3))
        rel = (np.abs(got[it] - want[it]).max()
               / max(1.0, np.abs(want).max()))
        assert rel < 1e-12, (boundary, overlap, rel)


def test_sharded_df64_1d_wide_radius():
    """Wide-radius sharded 1-D df64."""
    from lorastencil.parallel import domain

    wide = np.zeros(99)  # radius 49
    wide[0] = wide[-1] = 1.0
    wide[49] = -2.0
    sh = domain.sharded_engine_for_coeffs(wide, 8192, (4,),
                                          dtype="df64")
    g0 = (reference.random_padded(sh.spec, (8192,), seed=5) * 0.01)
    got = np.asarray(sh.run(g0, 2))
    want = reference.run(g0, sh.spec, 2)
    rel = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert rel < 1e-12, rel


def test_sharded_df64_1d_midband_radius():
    """Sharded 1-D df64 at radius 24 on divisible blocks."""
    from lorastencil.parallel import domain

    taps = np.zeros(49)  # r_eff 24
    taps[0] = taps[-1] = 0.25
    taps[24] = 1.0
    sh = domain.sharded_engine_for_coeffs(taps, 16384, (4,),
                                          dtype="df64")
    g0 = (reference.random_padded(sh.spec, (16384,), seed=11) * 0.01)
    got = np.asarray(sh.run(g0, 2))
    want = reference.run(g0, sh.spec, 2)
    rel = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert rel < 1e-12, rel


def test_sharded_df64_beats_sharded_fp32():
    """The sharded pair state must actually carry the extra mantissa
    bits end-to-end (a downcast anywhere would still pass a loose
    fp32-level comparison)."""
    from lorastencil.parallel import domain

    spec = shapes.get_shape("star2d1r")
    interior = (32, 256)
    g0 = _padded_input(spec, interior, seed=11)
    want = reference.run(g0, spec, 5)
    scale = np.abs(want).max()
    sh64 = domain.sharded_engine("star2d1r", interior, (2, 2),
                                 dtype="df64")
    err64 = np.abs(sh64.run(g0, 5) - want).max() / scale
    sh32 = domain.sharded_engine("star2d1r", interior, (2, 2))
    err32 = np.abs(np.asarray(sh32.run(g0, 5), np.float64)
                   - want).max() / scale
    assert err64 < 1e-12
    assert err32 > 1e-8  # fp32 noise floor for contrast
    assert err64 < err32 * 1e-3


def test_sharded_df64_checksum_matches_run():
    from lorastencil.parallel import domain

    spec = shapes.get_shape("star2d1r")
    interior = (32, 256)
    g0 = _padded_input(spec, interior, seed=13)
    sh = domain.sharded_engine("star2d1r", interior, (2, 2), dtype="df64")
    got = sh.run(g0, 2)
    assert np.isfinite(got).all()
    # the checksum is the timing/sync entry point (it sums the padded
    # pair state INCLUDING the exchanged guard rings, like the fp32
    # tier): finite and deterministic, not the interior sum
    cs = float(sh.run_checksum(g0, 2))
    assert np.isfinite(cs)
    assert cs == float(sh.run_checksum(g0, 2))


def test_sharded_df64_guards():
    """Direct base-class misuse raises; fused df64 sharded runs and a
    pure-center-tap spec work."""
    from lorastencil.parallel import domain

    with pytest.raises(ValueError, match="ShardedStencilDF64_1D"):
        domain.ShardedStencil1D(
            shapes.get_shape("1d1r"), 4096,
            domain.ShardedConfig(mesh_shape=(4,), dtype="df64"))
    with pytest.raises(ValueError, match="ShardedStencilDF64_3D"):
        domain.ShardedStencil3D(
            shapes.get_shape("star3d1r"), (6, 16, 256),
            domain.ShardedConfig(mesh_shape=(2, 2), dtype="df64"))
    with pytest.raises(ValueError, match="ShardedStencilDF64"):
        domain.ShardedStencil2D(
            shapes.get_shape("star2d1r"), (32, 256),
            domain.ShardedConfig(mesh_shape=(2, 2), dtype="df64"))
    spec = shapes.get_shape("star2d1r")
    g0 = _padded_input(spec, (32, 256), seed=5)
    sh = domain.sharded_engine("star2d1r", (32, 256), (2, 2),
                               dtype="df64", fused_steps=2)
    want = reference.run(g0, spec, 5)
    assert np.abs(sh.run(g0, 5) - want).max() <= 1e-12 * np.abs(want).max()
    center = np.zeros(9)
    center[4] = 1.5
    shc = domain.sharded_engine_for_coeffs(center, 8192, (4,),
                                           dtype="df64")
    gc = _padded_input(shc.spec, (8192,), seed=6)
    want = reference.run(gc, shc.spec, 2)
    assert np.abs(shc.run(gc, 2) - want).max() <= 1e-12 * np.abs(
        want).max()


def test_sharded_df64_cli_check(capsys):
    rc = cli.main(["star2d1r", "32", "256", "3", "--dtype", "df64",
                   "--mesh", "2", "2", "--check", "--repeats", "1"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Correct!" in out
    rc = cli.main(["1d2r", "4096", "3", "--dtype", "df64",
                   "--mesh", "4", "--check", "--repeats", "1"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Correct!" in out


@pytest.mark.parametrize("name,mesh_shape,interior,boundary", [
    ("star3d1r", (2, 2), (6, 32, 256), "dirichlet0"),
    ("star3d1r", (2, 2, 2), (7, 30, 300), "periodic"),
    ("star3d1r", (2, 2, 2), (8, 32, 256), "reflect"),
    ("box3d1r", (2, 2, 2), (8, 32, 256), "dirichlet0"),
])
def test_sharded_df64_3d(name, mesh_shape, interior, boundary):
    """Sharded 3-D df64 (ShardedStencilDF64_3D): the pair planes ride
    the multi-phase exchange (z ppermute included on 3-D meshes) and
    each device runs the pair step; fp64-grade across device
    boundaries, corner octants, non-divisible blocks and ghost modes."""
    from lorastencil.parallel import domain

    spec = shapes.get_shape(name)
    g0 = _padded_input(spec, interior, seed=91)
    sh = domain.sharded_engine(name, interior, mesh_shape, dtype="df64",
                               boundary=boundary)
    assert isinstance(sh, domain.ShardedStencilDF64_3D)
    got = sh.run(g0, 3)
    assert got.dtype == np.float64
    it = reference.interior_slices(spec, g0.shape)
    truth = {"dirichlet0": reference.run,
             "periodic": reference.run_periodic,
             "reflect": reference.run_reflect}[boundary]
    want = truth(g0, spec, 3)
    rel = (np.abs(got[it] - want[it]).max()
           / max(1.0, np.abs(want).max()))
    assert rel < 1e-12, (name, mesh_shape, boundary, rel)


def test_sharded_df64_3d_sequential_and_checksum():
    from lorastencil.parallel import domain

    spec = shapes.get_shape("box3d1r")
    interior = (8, 32, 256)
    g0 = _padded_input(spec, interior, seed=92)
    want = reference.run(g0, spec, 3)
    for overlap in (True, False):
        sh = domain.sharded_engine("box3d1r", interior, (2, 2, 2),
                                   dtype="df64", overlap=overlap)
        got = sh.run(g0, 3)
        rel = np.abs(got - want).max() / max(1.0, np.abs(want).max())
        assert rel < 1e-12, (overlap, rel)
    cs = float(sh.run_checksum(g0, 2))
    assert np.isfinite(cs)
    assert cs == float(sh.run_checksum(g0, 2))


def test_sharded_df64_3d_cli_check(capsys):
    rc = cli.main(["star3d1r", "8", "32", "256", "2", "--dtype", "df64",
                   "--mesh", "2", "2", "2", "--check", "--repeats", "1"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Correct!" in out


@pytest.mark.parametrize("mesh_shape,boundary", [
    ((4,), "dirichlet0"), ((8,), "periodic"), ((2,), "reflect"),
])
def test_sharded_df64_1d(mesh_shape, boundary):
    """Sharded 1-D df64: the pair planes ride the edge-strip ppermute
    exchange and each device runs the pair step;
    accuracy stays fp64-grade across device boundaries for every
    boundary condition."""
    from lorastencil.parallel import domain

    spec = shapes.get_shape("1d2r")
    n = 1024 * mesh_shape[0]  # lane-aligned divisible blocks
    g0 = _padded_input(spec, (n,), seed=93)
    sh = domain.sharded_engine("1d2r", n, mesh_shape, dtype="df64",
                               boundary=boundary)
    assert isinstance(sh, domain.ShardedStencilDF64_1D)
    got = sh.run(g0, 3)
    assert got.dtype == np.float64
    truth = {"dirichlet0": reference.run,
             "periodic": reference.run_periodic,
             "reflect": reference.run_reflect}[boundary]
    want = truth(g0, spec, 3)
    rel = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert rel < 1e-12, (mesh_shape, boundary, rel)


def test_sharded_df64_1d_nondivisible_and_sequential():
    """Non-divisible dirichlet0 blocks (bounds mask the fake tail) and
    the sequential (overlap=False) exchange; checksum is deterministic."""
    from lorastencil.parallel import domain

    spec = shapes.get_shape("1d1r")
    n = 5000
    g0 = _padded_input(spec, (n,), seed=94)
    want = reference.run(g0, spec, 3)
    for overlap in (True, False):
        sh = domain.sharded_engine("1d1r", n, (4,), dtype="df64",
                                   overlap=overlap)
        got = sh.run(g0, 3)
        rel = np.abs(got - want).max() / max(1.0, np.abs(want).max())
        assert rel < 1e-12, (overlap, rel)
    cs = float(sh.run_checksum(g0, 2))
    assert np.isfinite(cs)
    assert cs == float(sh.run_checksum(g0, 2))
