"""Sharded domain-decomposition tests on the 8-virtual-device CPU mesh:
halo exchange over ppermute must reproduce single-device reference
semantics exactly, including corners and the global-boundary decay."""

import jax.numpy as jnp
import numpy as np
import pytest

from lorastencil.models import shapes
from lorastencil.parallel import domain
from lorastencil.utils import reference


@pytest.mark.parametrize("name", ["star2d1r", "box2d3r", "star2d3r"])
@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2), (8, 1), (1, 8)])
def test_sharded_matches_reference(name, mesh_shape):
    spec = shapes.get_shape(name)
    interior = (8 * mesh_shape[0], 128 * mesh_shape[1])
    g0 = reference.random_padded(spec, interior, seed=21)
    sh = domain.sharded_engine(name, interior, mesh_shape, tile=(8, 128))
    got = np.asarray(sh.run(g0, 3), np.float64)
    want = reference.run(g0, spec, 3)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err < 1e-6, err


def test_sharded_multistep_corner_propagation():
    # after k steps, information crosses device corners; 2x2 mesh
    spec = shapes.get_shape("box2d3r")  # full 7x7 support exercises corners
    interior = (32, 256)
    g0 = reference.random_padded(spec, interior, seed=5)
    sh = domain.sharded_engine("box2d3r", interior, (2, 2), tile=(16, 128))
    got = np.asarray(sh.run(g0, 4), np.float64)
    want = reference.run(g0, spec, 4)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


def test_graft_entry_dryrun():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


@pytest.mark.parametrize("name", ["star3d1r", "box3d1r"])
def test_sharded_3d_matches_reference(name):
    spec = shapes.get_shape(name)
    interior = (5, 16, 256)
    g0 = reference.random_padded(spec, interior, seed=31)
    sh = domain.sharded_engine(name, interior, (2, 2), tile=(8, 128))
    got = np.asarray(sh.run(g0, 3), np.float64)
    want = reference.run(g0, spec, 3)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err < 1e-6, err


@pytest.mark.parametrize("name", ["1d1r", "1d2r"])
def test_sharded_1d_matches_reference(name):
    spec = shapes.get_shape(name)
    interior = 8 * 128 * 4  # 4096, lane-aligned per device
    g0 = reference.random_padded(spec, (interior,), seed=17)
    sh = domain.sharded_engine(name, interior, (8,))
    got = np.asarray(sh.run(g0, 3), np.float64)
    want = reference.run(g0, spec, 3)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err < 1e-6, err


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_fused_matches_reference(k):
    """One halo exchange per k fused steps (k*radius-deep halos)."""
    spec = shapes.get_shape("star2d1r")
    interior = (32, 512)
    g0 = reference.random_padded(spec, interior, seed=23)
    sh = domain.sharded_engine("star2d1r", interior, (2, 2),
                               tile=(16, 256), fused_steps=k)
    for steps in (k, 2 * k + 1):  # full passes and a remainder
        got = np.asarray(sh.run(g0, steps), np.float64)
        want = reference.run(g0, spec, steps)
        err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
        assert err < 1e-6, (k, steps, err)


def test_sharded_box_fused():
    spec = shapes.get_shape("box2d3r")
    interior = (32, 512)
    g0 = reference.random_padded(spec, interior, seed=41)
    sh = domain.sharded_engine("box2d3r", interior, (2, 2), tile=(16, 256),
                               fused_steps=2)
    assert sh.backend == "xla"
    got = np.asarray(sh.run(g0, 4), np.float64)
    want = reference.run(g0, spec, 4)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


@pytest.mark.parametrize("name,k", [("1d1r", 4), ("1d2r", 8)])
def test_sharded_1d_fused(name, k):
    """1-D fused sharded exchange: k timesteps per ppermute round."""
    spec = shapes.get_shape(name)
    interior = 8 * 128 * 4
    g0 = reference.random_padded(spec, (interior,), seed=18)
    sh = domain.sharded_engine(name, interior, (4,), fused_steps=k)
    for steps in (k, 2 * k + 1):
        got = np.asarray(sh.run(g0, steps), np.float64)
        want = reference.run(g0, spec, steps)
        err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
        assert err < 1e-6, (name, k, steps, err)


def test_sharded_1d_sequential_exchange():
    """1-D sharded path with the sequential exchange (overlap off) on
    large local blocks."""
    spec = shapes.get_shape("1d1r")
    interior = 4 * 170 * 1024  # local 174080 cells: beyond resident fit
    g0 = reference.random_padded(spec, (interior,), seed=82)
    sh = domain.sharded_engine("1d1r", interior, (4,), fused_steps=2,
                               overlap=False)
    for steps in (1, 5):
        got = np.asarray(sh.run(g0, steps), np.float64)
        want = reference.run(g0, spec, steps)
        err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
        assert err < 1e-6, (steps, err)


def test_sharded_fused_default_tile_divides_local_block():
    """A local block that the default tile does not divide falls back
    to a divisor tile (no wasted round-up), not an assert."""
    spec = shapes.get_shape("star2d1r")
    interior = (400, 1536)  # local (200, 768): the default (200, 512)
    # tile would pad 768 columns to 1024
    sh = domain.sharded_engine("star2d1r", interior, (2, 2),
                               fused_steps=2)
    lm, ln = sh.local_interior
    assert lm % sh.layout.tile[0] == 0 and ln % sh.layout.tile[1] == 0
    g0 = reference.random_padded(spec, interior, seed=55) * 0.01
    got = np.asarray(sh.run(g0, 3), np.float64)
    want = reference.run(g0, spec, 3)
    assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) < 1e-6


def _periodic_truth(spec, interior, g0, steps):
    padded = np.zeros(spec.padded_shape(interior))
    it = tuple(slice(h, h + s) for h, s in zip(spec.halo, interior))
    padded[it] = g0
    return reference.run_periodic(padded, spec, steps)[it]


@pytest.mark.parametrize("overlap", [False, True])
def test_sharded_periodic_2d(overlap):
    """Sharded periodic: the ppermute ring closes into a torus."""
    spec = shapes.get_shape("star2d1r")
    interior = (48, 768) if overlap else (32, 512)
    mesh = (2, 2)
    rng = np.random.default_rng(61)
    g0 = rng.uniform(0, 0.01, interior)
    padded = np.zeros(spec.padded_shape(interior))
    it = tuple(slice(h, h + s) for h, s in zip(spec.halo, interior))
    padded[it] = g0
    sh = domain.sharded_engine("star2d1r", interior, mesh,
                               tile=(8, 128), fused_steps=2,
                               boundary="periodic", overlap=overlap)
    assert sh._can_overlap() == overlap or not overlap
    got = np.asarray(sh.run(padded, 5), np.float64)[it]
    want = _periodic_truth(spec, interior, g0, 5)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-6, (overlap, err)


def test_sharded_periodic_1d():
    spec = shapes.get_shape("1d2r")
    interior = (4096,)
    rng = np.random.default_rng(62)
    g0 = rng.uniform(0, 0.01, interior)
    padded = np.zeros(spec.padded_shape(interior))
    padded[4:-4] = g0
    sh = domain.sharded_engine("1d2r", interior[0], (4,), fused_steps=2,
                               boundary="periodic")
    got = np.asarray(sh.run(padded, 5), np.float64)[4:-4]
    want = _periodic_truth(spec, interior, g0, 5)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


def test_sharded_periodic_3d():
    spec = shapes.get_shape("box3d1r")
    interior = (4, 16, 512)
    rng = np.random.default_rng(63)
    g0 = rng.uniform(0, 0.01, interior)
    padded = np.zeros(spec.padded_shape(interior))
    it = tuple(slice(h, h + s) for h, s in zip(spec.halo, interior))
    padded[it] = g0
    sh = domain.sharded_engine("box3d1r", interior, (2, 2),
                               tile=(8, 128), fused_steps=2,
                               boundary="periodic")
    got = np.asarray(sh.run(padded, 3), np.float64)[it]
    want = _periodic_truth(spec, interior, g0, 3)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-6, err


@pytest.mark.parametrize("overlap", [False, True])
def test_sharded_reflect_2d(overlap):
    """Sharded reflect: global-edge devices mirror their own edge."""
    spec = shapes.get_shape("star2d1r")
    interior = (48, 768) if overlap else (32, 512)
    rng = np.random.default_rng(64)
    g0 = rng.uniform(0, 0.01, interior)
    padded = np.zeros(spec.padded_shape(interior))
    it = tuple(slice(h, h + s) for h, s in zip(spec.halo, interior))
    padded[it] = g0
    sh = domain.sharded_engine("star2d1r", interior, (2, 2),
                               tile=(8, 128), fused_steps=2,
                               boundary="reflect", overlap=overlap)
    got = np.asarray(sh.run(padded, 5), np.float64)[it]
    want = reference.run_reflect(padded, spec, 5)[it]
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-6, (overlap, err)


def test_sharded_reflect_1d_and_3d():
    spec = shapes.get_shape("1d1r")
    rng = np.random.default_rng(65)
    padded = np.zeros(4104)
    padded[4:-4] = rng.uniform(0, 0.01, 4096)
    sh = domain.sharded_engine("1d1r", 4096, (4,), fused_steps=2,
                               boundary="reflect")
    got = np.asarray(sh.run(padded, 5), np.float64)[4:-4]
    want = reference.run_reflect(padded, spec, 5)[4:-4]
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6

    spec3 = shapes.get_shape("star3d1r")
    interior = (4, 16, 512)
    padded = np.zeros(spec3.padded_shape(interior))
    it = tuple(slice(h, h + s) for h, s in zip(spec3.halo, interior))
    padded[it] = rng.uniform(0, 0.01, interior)
    sh3 = domain.sharded_engine("star3d1r", interior, (2, 2),
                                tile=(8, 128), fused_steps=2,
                                boundary="reflect")
    got = np.asarray(sh3.run(padded, 3), np.float64)[it]
    want = reference.run_reflect(padded, spec3, 3)[it]
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


@pytest.mark.parametrize("name,interior,mesh,tile", [
    ("star2d1r", (32, 512), (2, 2), (8, 128)),
    ("1d2r", (4 * 170 * 1024,), (4,), None),
    ("box3d1r", (4, 16, 256), (2, 2), (8, 128)),
])
def test_sharded_bf16_state(name, interior, mesh, tile):
    """bf16 state for the sharded engines: half the traffic AND half
    the exchanged halo bytes (computed in fp32)."""
    spec = shapes.get_shape(name)
    g0 = reference.random_padded(spec, interior, seed=91) * 0.01
    kw = dict(fused_steps=2, dtype="bfloat16")
    if tile is not None:
        kw["tile"] = tile
    arg = interior[0] if spec.ndim == 1 else interior
    sh = domain.sharded_engine(name, arg, mesh, **kw)
    got = np.asarray(sh.run(g0, 3).astype(jnp.float32), np.float64)
    want = reference.run(g0, spec, 3)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err < 5e-2, (name, err)


def test_sharded_reflect_fused_nonsymmetric_rejected():
    S = np.array([[0.0, 0.5, -0.25],
                  [1.0, 2.0, 0.0],
                  [0.0, -0.5, 0.125]])
    with pytest.raises(ValueError, match="symmetric"):
        domain.sharded_engine_for_coeffs(
            S, (32, 512), (2, 2), halo=(1, 1), fused_steps=2,
            boundary="reflect")


@pytest.mark.parametrize("name,k", [("star3d1r", 2), ("box3d1r", 4)])
def test_sharded_3d_fused(name, k):
    """3-D fused sharded exchange (fused z-slab kernel per device)."""
    spec = shapes.get_shape(name)
    interior = (4, 16, 256)
    g0 = reference.random_padded(spec, interior, seed=32)
    sh = domain.sharded_engine(name, interior, (2, 2), tile=(8, 128),
                               fused_steps=k)
    for steps in (k, 2 * k + 1):
        got = np.asarray(sh.run(g0, steps), np.float64)
        want = reference.run(g0, spec, steps)
        err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
        assert err < 1e-6, (name, k, steps, err)


def test_sharded_custom_coeffs():
    """Sharded engine for user coefficients (factorize + decompose)."""
    S = np.outer([1.0, 2.0, 1.0], [1.0, 2.0, 1.0]) / 16.0
    S[0, 2] += 0.125
    sh = domain.sharded_engine_for_coeffs(
        S, (32, 256), (2, 2), tile=(16, 128), fused_steps=2)
    g0 = reference.random_padded(sh.spec, (32, 256), seed=44)
    got = np.asarray(sh.run(g0, 5), np.float64)
    want = reference.run(g0, sh.spec, 5)
    assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) < 1e-6


def test_sharded_custom_coeffs_1d():
    taps = np.array([0.25, -0.5, 1.0, -0.5, 0.25])
    sh = domain.sharded_engine_for_coeffs(
        taps, 4 * 1024, (4,), fused_steps=3)
    g0 = reference.random_padded(sh.spec, (4 * 1024,), seed=45)
    got = np.asarray(sh.run(g0, 7), np.float64)
    want = reference.run(g0, sh.spec, 7)
    assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) < 1e-6


@pytest.mark.parametrize("k,interior,tile", [
    (1, (48, 768), (8, 128)),    # local (24, 384) -> 3x3 tiles
    (2, (48, 768), (8, 128)),    # guard 8 == TM
    (3, (96, 768), (16, 128)),   # guard 16 == TM
])
def test_sharded_overlap_exchange(k, interior, tile):
    """Overlapped halo exchange (boundary-first + end-of-pass ppermute
    under interior compute) reproduces the reference exactly."""
    spec = shapes.get_shape("star2d1r")
    g0 = reference.random_padded(spec, interior, seed=51)
    sh = domain.sharded_engine("star2d1r", interior, (2, 2),
                               tile=tile, fused_steps=k)
    assert sh._can_overlap()
    for steps in (1, k, 2 * k + 1):
        got = np.asarray(sh.run(g0, steps), np.float64)
        want = reference.run(g0, spec, steps)
        err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
        assert err < 1e-6, (k, steps, err)


def test_sharded_overlap_off_matches():
    spec = shapes.get_shape("star2d1r")
    interior = (48, 768)
    g0 = reference.random_padded(spec, interior, seed=52)
    sh = domain.sharded_engine("star2d1r", interior, (2, 2),
                               tile=(8, 128), fused_steps=2, overlap=False)
    assert not sh._can_overlap()
    got = np.asarray(sh.run(g0, 5), np.float64)
    want = reference.run(g0, spec, 5)
    assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) < 1e-6


@pytest.mark.parametrize("k", [1, 2])
def test_sharded_3d_overlap_exchange(k):
    spec = shapes.get_shape("box3d1r")
    interior = (4, 48, 768)  # local (4, 24, 384) -> 3x3 tiles
    g0 = reference.random_padded(spec, interior, seed=71)
    sh = domain.sharded_engine("box3d1r", interior, (2, 2),
                               tile=(8, 128), fused_steps=k)
    assert sh._can_overlap()
    for steps in (1, 2 * k + 1):
        got = np.asarray(sh.run(g0, steps), np.float64)
        want = reference.run(g0, spec, steps)
        err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
        assert err < 1e-6, (k, steps, err)


@pytest.mark.parametrize("k", [1, 4])
def test_sharded_1d_overlap_exchange(k):
    spec = shapes.get_shape("1d2r")
    interior = 4 * 3 * 512 * 128  # 3 tiles of 512 rows per device
    g0 = reference.random_padded(spec, (interior,), seed=81) * 1e-20
    sh = domain.sharded_engine("1d2r", interior, (4,), fused_steps=k)
    assert sh._can_overlap()
    for steps in (1, 2 * k + 1):
        got = np.asarray(sh.run(g0, steps), np.float64)
        want = reference.run(g0, spec, steps)
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
        assert err < 1e-6, (k, steps, err)


def test_sharded_overlap_star2d3r():
    """star2d3r under the overlapped exchange with dynamic bounds
    (region windows + ring semantics)."""
    spec = shapes.get_shape("star2d3r")
    interior = (48, 768)
    g0 = reference.random_padded(spec, interior, seed=53)
    sh = domain.sharded_engine("star2d3r", interior, (2, 2),
                               tile=(8, 128), fused_steps=2)
    assert sh._can_overlap()
    got = np.asarray(sh.run(g0, 5), np.float64)
    want = reference.run(g0, spec, 5)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


def test_sharded_config_rejects_bad_backend():
    with pytest.raises(ValueError, match="backend"):
        domain.ShardedConfig(mesh_shape=(2, 2), backend="pallas")


# -- non-divisible global interiors ----------------------------------------
# dirichlet0 pads the local block to a tile multiple; padded fake cells
# are bounds-masked to zero every (sub)step, which IS the Dirichlet-0
# semantics their real neighbors expect.

@pytest.mark.parametrize("k", [1, 2])
def test_sharded_nondivisible_2d(k):
    spec = shapes.get_shape("star2d1r")
    interior = (100, 300)  # neither axis divides the 4x2 mesh
    g0 = reference.random_padded(spec, interior, seed=91)
    sh = domain.sharded_engine("star2d1r", interior, (4, 2), fused_steps=k)
    assert sh.local_interior[0] * 4 >= 100
    assert sh.local_interior[1] * 2 >= 300
    for steps in (1, 2 * k + 1):
        got = np.asarray(sh.run(g0, steps), np.float64)
        want = reference.run(g0, spec, steps)
        err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
        assert err < 1e-6, (k, steps, err)


def test_sharded_nondivisible_2d_overlap():
    """Non-divisible block padding under the overlapped exchange
    (>= 3x3 local tiles)."""
    spec = shapes.get_shape("box2d3r")
    interior = (100, 1000)
    g0 = reference.random_padded(spec, interior, seed=92)
    sh = domain.sharded_engine("box2d3r", interior, (2, 2),
                               tile=(24, 128), fused_steps=2)
    assert sh._can_overlap()
    got = np.asarray(sh.run(g0, 5), np.float64)
    want = reference.run(g0, spec, 5)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err < 1e-6, err


@pytest.mark.parametrize("k", [1, 2])
def test_sharded_nondivisible_3d(k):
    spec = shapes.get_shape("box3d1r")
    interior = (4, 20, 200)
    g0 = reference.random_padded(spec, interior, seed=93)
    sh = domain.sharded_engine("box3d1r", interior, (2, 2), fused_steps=k)
    for steps in (1, 2 * k + 1):
        got = np.asarray(sh.run(g0, steps), np.float64)
        want = reference.run(g0, spec, steps)
        err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
        assert err < 1e-6, (k, steps, err)


@pytest.mark.parametrize("name,n,k", [("1d1r", 1000, 1), ("1d2r", 3333, 2)])
def test_sharded_nondivisible_1d(name, n, k):
    spec = shapes.get_shape(name)
    g0 = reference.random_padded(spec, (n,), seed=94)
    sh = domain.sharded_engine(name, n, (4,), fused_steps=k)
    for steps in (1, 2 * k + 1):
        got = np.asarray(sh.run(g0, steps), np.float64)
        want = reference.run(g0, spec, steps)
        err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
        assert err < 1e-6, (name, k, steps, err)


def test_sharded_nondivisible_last_device_all_fake():
    """A global interior so small that trailing devices own only padded
    fake cells: they must compute zeros and stay silent."""
    spec = shapes.get_shape("star2d1r")
    interior = (20, 140)  # 8x1 mesh: lm=8 -> devices 3..7 past row 20
    g0 = reference.random_padded(spec, interior, seed=95)
    sh = domain.sharded_engine("star2d1r", interior, (8, 1), tile=(8, 128))
    got = np.asarray(sh.run(g0, 3), np.float64)
    want = reference.run(g0, spec, 3)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err < 1e-6, err


# -- non-divisible ghost boundaries ----------------------------------------
# periodic/reflect wrap or mirror at the TRUE global edge, which for the
# last device sits at its `tail` offset INSIDE the padded block; the
# exchange reads/writes the ghost ring there and fake cells beyond stay
# bounds-masked to zero.

def _ghost_truth(spec, interior, g0, steps, boundary):
    padded = np.zeros(spec.padded_shape(interior))
    it = tuple(slice(h, h + s) for h, s in zip(spec.halo, interior))
    padded[it] = g0
    fn = (reference.run_periodic if boundary == "periodic"
          else reference.run_reflect)
    return fn(padded, spec, steps)[it], padded, it


@pytest.mark.parametrize("boundary", ["periodic", "reflect"])
def test_sharded_nondivisible_ghost_2d(boundary):
    spec = shapes.get_shape("star2d1r")
    interior = (101, 300)  # neither axis divides the 4x2 mesh
    rng = np.random.default_rng(96)
    g0 = rng.uniform(0, 0.01, interior)
    want, padded, it = _ghost_truth(spec, interior, g0, 3, boundary)
    sh = domain.sharded_engine("star2d1r", interior, (4, 2),
                               boundary=boundary)
    got = np.asarray(sh.run(padded, 3), np.float64)[it]
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err < 1e-6, (boundary, err)


@pytest.mark.parametrize("boundary", ["periodic", "reflect"])
def test_sharded_nondivisible_ghost_2d_fused_overlap(boundary):
    """True tail inside the last tile row/col -> the overlapped engine
    handles the tailed ghost exchange, fused 2 substeps per pass."""
    spec = shapes.get_shape("star2d1r")
    interior = (140, 1000)
    rng = np.random.default_rng(97)
    g0 = rng.uniform(0, 0.01, interior)
    want, padded, it = _ghost_truth(spec, interior, g0, 4, boundary)
    sh = domain.sharded_engine("star2d1r", interior, (2, 2),
                               tile=(24, 128), fused_steps=2,
                               boundary=boundary)
    assert sh._can_overlap()
    got = np.asarray(sh.run(padded, 4), np.float64)[it]
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err < 1e-6, (boundary, err)


@pytest.mark.parametrize("name,boundary", [("1d1r", "periodic"),
                                           ("1d2r", "reflect")])
def test_sharded_nondivisible_ghost_1d(name, boundary):
    spec = shapes.get_shape(name)
    interior = (1001,)
    rng = np.random.default_rng(98)
    g0 = rng.uniform(0, 0.01, interior)
    want, padded, it = _ghost_truth(spec, interior, g0, 3, boundary)
    sh = domain.sharded_engine(name, interior[0], (4,), boundary=boundary)
    got = np.asarray(sh.run(padded, 3), np.float64)[it]
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err < 1e-6, (name, boundary, err)


@pytest.mark.parametrize("boundary", ["periodic", "reflect"])
def test_sharded_nondivisible_ghost_3d(boundary):
    spec = shapes.get_shape("box3d1r")
    interior = (4, 20, 200)
    rng = np.random.default_rng(99)
    g0 = rng.uniform(0, 0.01, interior)
    want, padded, it = _ghost_truth(spec, interior, g0, 2, boundary)
    sh = domain.sharded_engine("box3d1r", interior, (2, 2),
                               boundary=boundary)
    got = np.asarray(sh.run(padded, 2), np.float64)[it]
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err < 1e-6, (boundary, err)


def test_sharded_ghost_tail_smaller_than_depth_rejected():
    """(97, 300) on 8x1: lm=104 -> the last device's true tail is
    negative; the ghost ring has no real source strip."""
    with pytest.raises(ValueError, match="tail"):
        domain.sharded_engine("star2d1r", (97, 300), (8, 1),
                              boundary="periodic", fused_steps=2)


@pytest.mark.parametrize("boundary", ["periodic", "reflect"])
def test_small_grid_ringout_ghost_2d(boundary):
    """Ghost boundaries through the ring-in-output step (the mirror /
    wrap sources come from the freshly produced output)."""
    import jax.numpy as jnp

    from lorastencil.utils import reference

    sh = domain.sharded_engine("star2d1r", (16, 256), (2, 2),
                               tile=(8, 128), boundary=boundary)
    assert not sh._can_overlap()
    spec = sh.spec
    g0 = reference.random_padded(spec, (16, 256), seed=6)
    got = np.asarray(sh.run(jnp.asarray(g0, jnp.float32), 3), np.float64)
    truth = (reference.run_periodic if boundary == "periodic"
             else reference.run_reflect)
    want = truth(g0, spec, 3)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


def test_small_grid_ringout_1d():
    import jax.numpy as jnp

    from lorastencil.utils import reference

    sh = domain.sharded_engine("1d1r", (4000,), (4,))
    assert not sh._can_overlap()
    spec = sh.spec
    g0 = reference.random_padded(spec, (4000,), seed=7)
    got = np.asarray(sh.run(jnp.asarray(g0, jnp.float32), 4), np.float64)
    want = reference.run(g0, spec, 4)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


def test_small_grid_ringout_3d():
    import jax.numpy as jnp

    from lorastencil.utils import reference

    sh = domain.sharded_engine("star3d1r", (6, 16, 256), (2, 2),
                               tile=(8, 128))
    assert not sh._can_overlap()
    spec = sh.spec
    g0 = reference.random_padded(spec, (6, 16, 256), seed=8)
    got = np.asarray(sh.run(jnp.asarray(g0, jnp.float32), 3), np.float64)
    want = reference.run(g0, spec, 3)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


def test_small_grid_takes_ringout():
    """Sub-3x3 tile grids with overlap enabled take the ring-in-output
    step (the exchange-into-input sequential path and its full-buffer
    copies are reserved for explicit overlap=False), without warning,
    and stay exact."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sh = domain.sharded_engine("star2d1r", (16, 256), (2, 2),
                                   tile=(8, 128))
    assert not sh._can_overlap()
    import jax.numpy as jnp

    from lorastencil.utils import reference

    spec = sh.spec
    g0 = reference.random_padded(spec, (16, 256), seed=4)
    got = np.asarray(sh.run(jnp.asarray(g0, jnp.float32), 4), np.float64)
    want = reference.run(g0, spec, 4)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


# -- z-axis domain decomposition --------------------------------------------
# mesh_shape=(dz, dx, dy): a z-plane ppermute phase runs before the
# row/col phases; corner octants ride along because later phases' strips
# carry the earlier phases' received data.

@pytest.mark.parametrize("name", ["star3d1r", "box3d1r"])
def test_sharded_3d_zmesh_matches_reference(name):
    spec = shapes.get_shape(name)
    interior = (8, 16, 256)
    g0 = reference.random_padded(spec, interior, seed=131)
    sh = domain.sharded_engine(name, interior, (2, 2, 2), tile=(8, 128))
    assert sh.dz == 2
    got = np.asarray(sh.run(g0, 3), np.float64)
    want = reference.run(g0, spec, 3)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err < 1e-6, err


def test_sharded_3d_zmesh_fused():
    """Fused z-sharded exchange: zdepth = k*radius planes per ppermute."""
    spec = shapes.get_shape("star3d1r")
    interior = (8, 16, 256)
    g0 = reference.random_padded(spec, interior, seed=132)
    sh = domain.sharded_engine("star3d1r", interior, (2, 2, 2),
                               tile=(8, 128), fused_steps=2)
    for steps in (2, 5):
        got = np.asarray(sh.run(g0, steps), np.float64)
        want = reference.run(g0, spec, steps)
        err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
        assert err < 1e-6, (steps, err)


def test_sharded_3d_zmesh_nondivisible_and_zonly():
    spec = shapes.get_shape("star3d1r")
    g0 = reference.random_padded(spec, (7, 20, 200), seed=133)
    sh = domain.sharded_engine("star3d1r", (7, 20, 200), (2, 2, 2))
    got = np.asarray(sh.run(g0, 3), np.float64)
    want = reference.run(g0, spec, 3)
    assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) < 1e-6
    # a z-only mesh: all 8 devices along z (lz = 2 planes per device)
    g0 = reference.random_padded(spec, (16, 8, 128), seed=134)
    sh = domain.sharded_engine("star3d1r", (16, 8, 128), (8, 1, 1),
                               tile=(8, 128))
    got = np.asarray(sh.run(g0, 3), np.float64)
    want = reference.run(g0, spec, 3)
    assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) < 1e-6


def test_sharded_3d_zmesh_sequential_exchange():
    """overlap=False takes the exchange-into-input path with the
    z-phase ppermute first."""
    spec = shapes.get_shape("star3d1r")
    g0 = reference.random_padded(spec, (8, 16, 256), seed=135)
    sh = domain.sharded_engine("star3d1r", (8, 16, 256), (2, 2, 2),
                               tile=(8, 128), overlap=False)
    got = np.asarray(sh.run(g0, 3), np.float64)
    want = reference.run(g0, spec, 3)
    assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) < 1e-6


@pytest.mark.parametrize("boundary", ["periodic", "reflect"])
def test_sharded_3d_zmesh_ghost(boundary):
    """Ghost boundaries on a z-sharded mesh: the z ppermute ring closes
    into a torus (periodic) or mirrors at the global z edge (reflect),
    divisible and non-divisible, plus a fused pass."""
    spec = shapes.get_shape("box3d1r")
    rng = np.random.default_rng(136)
    for interior, k, steps in (((8, 16, 256), 1, 3),
                               ((7, 20, 200), 1, 3),
                               ((8, 16, 256), 2, 4)):
        g0 = rng.uniform(0, 0.01, interior)
        want, padded, it = _ghost_truth(spec, interior, g0, steps,
                                        boundary)
        sh = domain.sharded_engine("box3d1r", interior, (2, 2, 2),
                                   boundary=boundary, fused_steps=k)
        got = np.asarray(sh.run(padded, steps), np.float64)[it]
        err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
        assert err < 1e-6, (boundary, interior, k, err)


def test_sharded_3d_zmesh_bf16():
    spec = shapes.get_shape("box3d1r")
    g0 = reference.random_padded(spec, (8, 16, 256), seed=137) * 0.01
    sh = domain.sharded_engine("box3d1r", (8, 16, 256), (2, 2, 2),
                               dtype="bfloat16", fused_steps=2)
    got = np.asarray(sh.run(g0, 3).astype(jnp.float32), np.float64)
    want = reference.run(g0, spec, 3)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err < 5e-2, err


def test_sharded_3d_zmesh_depth_exceeds_block_rejected():
    """More z devices than the z extent supports must fail loudly."""
    with pytest.raises((ValueError, AssertionError),
                       match="z|tail|depth"):
        domain.sharded_engine("star3d1r", (4, 16, 256), (8, 1, 1),
                              boundary="periodic", fused_steps=4)


def test_overlap_engine_does_not_warn():
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sh = domain.sharded_engine("star2d1r", (48, 768), (2, 2),
                                   tile=(8, 128))
    assert sh._can_overlap()
