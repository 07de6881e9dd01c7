"""Shape registry tests: dense coefficient arrays must match the reference
driver formulas exactly (src/1d/main.cu:77-78, src/2d/main.cu:139-195,
src/3d/main.cu:112-125), and decompositions must reconstruct them."""

import numpy as np
import pytest

from lorastencil.models import factorize, shapes


def test_1d_taps():
    assert np.array_equal(
        shapes.get_shape("1d1r").dense_coeffs(),
        [0, 1, 2, 3, 4, 3, 2, 1, 0],
    )
    assert np.array_equal(
        shapes.get_shape("1d2r").dense_coeffs(),
        [1, 2, 3, 4, 5, 4, 3, 2, 1],
    )


def test_1d_taps_are_temporally_fused():
    # 1d1r = [1,1,1,1] self-convolved (2 convs = 3 fused radius-1 steps... the
    # reference counts x3); 1d2r = [1,1,1,1,1] (*) [1,1,1,1,1], counted x2.
    assert np.array_equal(
        np.convolve([1, 1, 1, 1], [1, 1, 1, 1]),
        shapes.get_shape("1d1r").dense_coeffs()[1:-1],
    )
    assert np.array_equal(
        np.convolve([1, 1, 1, 1, 1], [1, 1, 1, 1, 1]),
        shapes.get_shape("1d2r").dense_coeffs(),
    )


def test_star2d1r_matches_reference_pyramid():
    S = shapes.get_shape("star2d1r").dense_coeffs()
    expected = np.array(
        [
            [0, 0, 0, 1, 0, 0, 0],
            [0, 0, 2, 4, 2, 0, 0],
            [0, 2, 4, 8, 4, 2, 0],
            [1, 4, 8, 16, 8, 4, 1],
            [0, 2, 4, 8, 4, 2, 0],
            [0, 0, 2, 4, 2, 0, 0],
            [0, 0, 0, 1, 0, 0, 0],
        ],
        dtype=np.float64,
    )
    assert np.array_equal(S, expected)


def test_star2d1r_is_rank1_plus_sparse_residue():
    spec = shapes.get_shape("star2d1r")
    assert len(spec.terms) == 1
    u = np.array([0, 1, 2, 4, 2, 1, 0], dtype=np.float64)
    assert np.array_equal(spec.terms[0].dense(3), np.outer(u, u))
    # residue: +1 at (+-3,0),(0,+-3); -1 at (+-2,+-2)  [SURVEY section 0.5]
    res = dict(spec.residue)
    assert res[(3, 0)] == 1.0 and res[(-3, 0)] == 1.0
    assert res[(0, 3)] == 1.0 and res[(0, -3)] == 1.0
    for dr in (-2, 2):
        for dc in (-2, 2):
            assert res[(dr, dc)] == -1.0
    assert len(res) == 8


def test_box2d_matches_reference_and_is_exactly_rank3():
    spec = shapes.get_shape("box2d3r")
    S = spec.dense_coeffs()
    expected = np.array(
        [
            [1, 2, 3, 4, 3, 2, 1],
            [2, 5, 6, 7, 6, 5, 2],
            [3, 6, 8, 9, 8, 6, 3],
            [4, 7, 9, 8, 9, 7, 4],
            [3, 6, 8, 9, 8, 6, 3],
            [2, 5, 6, 7, 6, 5, 2],
            [1, 2, 3, 4, 3, 2, 1],
        ],
        dtype=np.float64,
    )
    assert np.array_equal(S, expected)
    assert len(spec.terms) == 3  # exactly rank 3, no residue
    assert spec.residue == ()


def test_box2d1r_aliases_box2d3r():
    a = shapes.get_shape("box2d1r")
    b = shapes.get_shape("box2d3r")
    assert np.array_equal(a.dense_coeffs(), b.dense_coeffs())
    assert a.fuse_factor == b.fuse_factor == 3


def test_star2d3r_cross():
    S = shapes.get_shape("star2d3r").dense_coeffs()
    expected = np.zeros((7, 7))
    for i, w in zip(range(-3, 4), [1, 2, 3, 4, 3, 2, 1]):
        expected[i + 3, 3] = w
        expected[3, i + 3] = w
    assert np.array_equal(S, expected)
    assert shapes.get_shape("star2d3r").residue == ()


def test_3d_shapes():
    s = shapes.get_shape("star3d1r").dense_coeffs()
    expected = np.array(
        [0, 0, 0, 0, 1, 0, 0, 0, 0,
         0, 1, 0, 1, 2, 1, 0, 1, 0,
         0, 0, 0, 0, 1, 0, 0, 0, 0], dtype=np.float64).reshape(3, 3, 3)
    assert np.array_equal(s, expected)
    b = shapes.get_shape("box3d1r").dense_coeffs()
    expected_b = np.array([[1, 2, 1]] * 9, dtype=np.float64).reshape(3, 3, 3)
    assert np.array_equal(b, expected_b)


def test_fuse_factors():
    expect = {"1d1r": 3, "1d2r": 2, "star2d1r": 3, "star2d3r": 1,
              "box2d1r": 3, "box2d3r": 3, "star3d1r": 1, "box3d1r": 1}
    for name, f in expect.items():
        assert shapes.get_shape(name).fuse_factor == f


def test_halos_match_reference():
    assert shapes.get_shape("1d1r").halo == (4,)
    assert shapes.get_shape("star2d1r").halo == (4, 4)
    assert shapes.get_shape("box3d1r").halo == (1, 2, 4)


@pytest.mark.parametrize("name", shapes.ALL_SHAPES)
def test_terms_plus_residue_reconstruct_dense(name):
    spec = shapes.get_shape(name)
    S = spec.dense_coeffs()
    acc = np.zeros_like(S)
    for t in spec.terms:
        acc += t.dense(spec.radius)
    for off, w in spec.residue:
        acc[tuple(spec.radius + o for o in off)] += w
    np.testing.assert_allclose(acc, S, atol=1e-12)


class TestFactorize:
    def test_pivot_peel_box_exact(self):
        S = shapes.get_shape("box2d3r").dense_coeffs()
        res = factorize.pivot_peel(S, pivots=((0, 0), (1, 1), (2, 2)))
        assert len(res.terms) == 3
        np.testing.assert_allclose(res.residual, 0.0, atol=1e-12)

    def test_pivot_peel_skips_zero_pivots(self):
        S = shapes.get_shape("star2d1r").dense_coeffs()  # S[0,0] == 0
        res = factorize.pivot_peel(S, pivots=((0, 0),))
        assert res.terms == ()

    def test_svd_fallback(self):
        rng = np.random.default_rng(0)
        u, v = rng.normal(size=7), rng.normal(size=7)
        S = np.outer(u, v)
        res = factorize.svd_decompose(S, max_rank=1)
        np.testing.assert_allclose(res.residual, 0.0, atol=1e-10)

    def test_decompose_2d_generic(self):
        # a generic symmetric rank-2 + spike matrix
        rng = np.random.default_rng(1)
        u, v = rng.normal(size=5), rng.normal(size=5)
        S = np.outer(u, u) + 0.5 * np.outer(v, v)
        S[0, 4] += 2.0
        terms, residue = factorize.decompose_2d(S, max_rank=3)
        acc = sum(np.outer(a, b) for a, b in terms)
        for off, w in residue:
            acc[tuple(2 + o for o in off)] += w
        np.testing.assert_allclose(acc, S, atol=1e-8)

    def test_decompose_3d_separable(self):
        # box3d1r structure: rank-1 z-unfolding -> one (tz, u, v) term,
        # z taps normalized so the largest is exactly 1.0
        S = np.einsum("i,j,k->ijk", [2.0, 4.0, 2.0], [1.0, 1.0, 1.0],
                      [1.0, 2.0, 1.0])
        terms, residue = factorize.decompose_3d(S)
        assert len(terms) == 1 and residue == ()
        tz, u, v = terms[0]
        assert tz[1] == 1.0  # largest z tap normalized to exactly 1
        acc = np.einsum("i,j,k->ijk", tz, u, v)
        np.testing.assert_allclose(acc, S, atol=1e-10)

    def test_decompose_3d_per_plane(self):
        # non-separable z: per-plane decomposition + residue points
        rng = np.random.default_rng(11)
        S = rng.standard_normal((3, 5, 5))
        terms, residue = factorize.decompose_3d(S)
        acc = np.zeros_like(S)
        for tz, u, v in terms:
            acc += np.einsum("i,j,k->ijk", tz, u, v)
        for (dz, dr, dc), w in residue:
            acc[1 + dz, 2 + dr, 2 + dc] += w
        np.testing.assert_allclose(acc, S, atol=1e-8)

    def test_decompose_3d_sparse_planes_to_residue(self):
        # near-single-point planes skip the 2-D decomposition
        S = np.zeros((3, 3, 3))
        S[0, 1, 1] = 2.0
        S[2, 0, 2] = -1.0
        S[1] = np.outer([1.0, 2.0, 1.0], [1.0, 2.0, 1.0])
        terms, residue = factorize.decompose_3d(S)
        offs = {off for off, _ in residue}
        assert (-1, 0, 0) in offs and (1, -1, 1) in offs
        acc = np.zeros_like(S)
        for tz, u, v in terms:
            acc += np.einsum("i,j,k->ijk", tz, u, v)
        for (dz, dr, dc), w in residue:
            acc[1 + dz, 1 + dr, 1 + dc] += w
        np.testing.assert_allclose(acc, S, atol=1e-10)

    def test_decompose_3d_near_rank1_keeps_machine_precision(self):
        # nearly-but-not-exactly separable (a ~1e-11 spike below the
        # SVD gap tol): the rank-1 branch must push the reconstruction
        # residual into the sparse residue instead of silently dropping
        # it -- the df64 tier advertises ~1e-14/step (advisor finding,
        # round 4)
        S = np.einsum("i,j,k->ijk", [1.0, 2.0, 1.0], [1.0, 2.0, 1.0],
                      [0.5, 1.0, 0.5])
        S[0, 2, 1] += 3e-11
        terms, residue = factorize.decompose_3d(S)
        assert len(terms) == 1  # still the shared-z-tap branch
        assert any(off == (-1, 1, 0) for off, _ in residue)
        acc = np.zeros_like(S)
        for tz, u, v in terms:
            acc += np.einsum("i,j,k->ijk", tz, u, v)
        for (dz, dr, dc), w in residue:
            acc[1 + dz, 1 + dr, 1 + dc] += w
        assert np.abs(acc - S).max() <= 1e-14 * np.abs(S).max()
        # a DENSE sub-tol deviation cannot ride the sparse residue:
        # falls back to the per-plane path (still within the documented
        # tol contract)
        rng = np.random.default_rng(0)
        S2 = np.einsum("i,j,k->ijk", [1.0, 2.0, 1.0], [1.0, 2.0, 1.0],
                       [0.5, 1.0, 0.5])
        S2 = S2 + 1e-11 * rng.standard_normal(S2.shape)
        terms2, residue2 = factorize.decompose_3d(S2)
        acc = np.zeros_like(S2)
        for tz, u, v in terms2:
            acc += np.einsum("i,j,k->ijk", tz, u, v)
        for (dz, dr, dc), w in residue2:
            acc[1 + dz, 1 + dr, 1 + dc] += w
        assert np.abs(acc - S2).max() <= 1e-10 * np.abs(S2).max()

    def test_fuse_taps(self):
        np.testing.assert_allclose(
            factorize.fuse_taps([1, 1, 1, 1], 2), [1, 2, 3, 4, 3, 2, 1]
        )

    def test_fuse_coeffs_2d_matches_repeated_apply(self):
        # fusing k steps == applying the stencil k times, on a grid wide
        # enough that the interior center never sees the halo decay
        from lorastencil.models.shapes import StencilSpec, SeparableTerm
        from lorastencil.utils import reference

        spec = shapes.get_shape("star2d1r")
        S2 = factorize.fuse_coeffs(spec.dense_coeffs(), 2)
        assert S2.shape == (13, 13)

        rng = np.random.default_rng(7)
        g0 = rng.normal(size=(41, 41))
        two_steps = reference.run(g0, spec, 2)
        # apply the fused stencil once (radius 6, halo 6 on the same grid:
        # re-center g0 in a radius-6 padded grid so interiors line up)
        fused_terms = ()
        offs = [(int(i) - 6, int(j) - 6) for i, j in np.argwhere(S2 != 0)]
        fused_spec = StencilSpec(
            name="star2d1r_k2", ndim=2, radius=6, halo=(6, 6),
            terms=fused_terms,
            residue=tuple(((di, dj), float(S2[6 + di, 6 + dj]))
                          for di, dj in offs),
            fuse_factor=6,
        )
        g0_wide = np.zeros((45, 45))
        g0_wide[2:-2, 2:-2] = g0
        one_fused = reference.run(g0_wide, fused_spec, 1)
        # compare interior points >= 3 cells from the interior boundary
        # (closer points see step-1 halo decay that the fused stencil
        # cannot represent); wide index = g0 index + 2
        np.testing.assert_allclose(
            one_fused[9:-9, 9:-9], two_steps[7:-7, 7:-7], rtol=1e-12)

    def test_banded_matrix(self):
        B = factorize.banded_matrix([1.0, 2.0, 3.0], 8, dtype=np.float64)
        assert B.shape == (10, 8)
        x = np.arange(10.0)
        out = x @ B
        expected = [x[c] * 1 + x[c + 1] * 2 + x[c + 2] * 3 for c in range(8)]
        np.testing.assert_allclose(out, expected)


class TestGreedyPeel:
    def test_star2d1r_residue_is_rank3_integer(self):
        spec = shapes.get_shape("star2d1r")
        R = np.zeros((7, 7))
        for off, w in spec.residue:
            R[3 + off[0], 3 + off[1]] += w
        res = factorize.greedy_peel(R, max_rank=6)
        assert len(res.terms) == 3
        np.testing.assert_allclose(res.residual, 0.0, atol=1e-12)
        for u, v in res.terms:
            assert np.allclose(u, np.round(u)) and np.allclose(v, np.round(v))

    def test_random_low_rank(self):
        rng = np.random.default_rng(4)
        u, v = rng.normal(size=5), rng.normal(size=5)
        S = np.outer(u, v)
        res = factorize.greedy_peel(S, max_rank=2)
        np.testing.assert_allclose(res.residual, 0.0, atol=1e-10)
