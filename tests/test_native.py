"""Native C++ core vs the NumPy implementations: exact agreement."""

import numpy as np
import pytest

from lorastencil import native
from lorastencil.models import factorize, shapes
from lorastencil.utils import reference

needs_native = pytest.mark.skipif(
    not native.available(), reason="native library not built"
)


@needs_native
def test_pivot_peel_matches_numpy():
    S = shapes.get_shape("box2d3r").dense_coeffs()
    piv = ((0, 0), (1, 1), (2, 2))
    a = factorize.pivot_peel(S, pivots=piv)
    b = native.pivot_peel(S, pivots=piv)
    assert len(a.terms) == len(b.terms) == 3
    for (u1, v1), (u2, v2) in zip(a.terms, b.terms):
        np.testing.assert_array_equal(u1, u2)
        np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(a.residual, b.residual)


@needs_native
def test_banded_matrix_matches_numpy():
    taps = [1.0, 2.0, 3.0, 2.0, 1.0]
    np.testing.assert_array_equal(
        factorize.banded_matrix(taps, 128, np.float64),
        native.banded_matrix(taps, 128, np.float64),
    )


@needs_native
def test_fuse_taps_matches_numpy():
    np.testing.assert_array_equal(
        factorize.fuse_taps([1, 1, 1, 1], 2), native.fuse_taps([1, 1, 1, 1], 2)
    )


@needs_native
def test_fuse_coeffs_2d_matches_numpy():
    S = shapes.get_shape("star2d1r").dense_coeffs()
    np.testing.assert_allclose(
        factorize.fuse_coeffs(S, 2), native.fuse_coeffs_2d(S, 2), atol=1e-12
    )


@needs_native
def test_dense_step_matches_numpy_reference():
    spec = shapes.get_shape("box2d3r")
    g0 = reference.random_padded(spec, (24, 40), seed=4)
    want = reference.dense_step(g0, spec, prefer_native=False)
    got = native.dense_step_2d(g0, spec.dense_coeffs(), spec.halo)
    np.testing.assert_allclose(got, want, atol=1e-9)


@needs_native
def test_dense_step_1d_3d_match_numpy_reference():
    # the threaded C++ stepper is the load-bearing --check ground truth
    # on big grids; parity with the NumPy definition must be exact
    for name, interior in (("1d1r", (500,)), ("1d2r", (300,)),
                           ("star3d1r", (6, 20, 150)),
                           ("box3d1r", (5, 16, 130))):
        spec = shapes.get_shape(name)
        g0 = reference.random_padded(spec, interior, seed=6)
        want = reference.dense_step(g0, spec, prefer_native=False)
        got = native.dense_step(g0, spec.dense_coeffs(), spec.halo)
        np.testing.assert_array_equal(got, want)


@needs_native
def test_reference_dispatches_to_native():
    spec = shapes.get_shape("star2d1r")
    g0 = reference.random_padded(spec, (40, 200), seed=7)
    np.testing.assert_array_equal(
        reference.dense_step(g0, spec, prefer_native=True),
        reference.dense_step(g0, spec, prefer_native=False))


@needs_native
def test_monotonic_ns():
    a = native.monotonic_ns()
    b = native.monotonic_ns()
    assert b >= a > 0


def test_stale_abi_falls_back_to_numpy(tmp_path, monkeypatch):
    """A round-1 (ABI v1) shared library must NOT be bound: load()
    returns None (NumPy fallback) instead of raising on missing
    symbols."""
    import subprocess
    import textwrap

    src = tmp_path / "stub.cc"
    src.write_text(textwrap.dedent("""
        extern "C" int ls_abi_version() { return 1; }
    """))
    so = tmp_path / "libstub.so"
    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(so), str(src)],
                   check=True)
    monkeypatch.setattr(native, "_LIB_PATH", str(so))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    assert native.load() is None
    assert not native.available()
    # and the ground-truth dispatch still works via NumPy
    spec = shapes.get_shape("star2d1r")
    g0 = reference.random_padded(spec, (16, 130), seed=1)
    out = reference.dense_step(g0, spec)
    np.testing.assert_array_equal(
        out, reference.dense_step(g0, spec, prefer_native=False))
