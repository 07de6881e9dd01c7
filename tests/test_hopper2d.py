"""The 2-D Hopper kernel's wrapper (ops/hopper2d.py): which stencils it
takes, the source it generates, its launch geometry and its guard
checks -- everything around the CUDA code that a CPU can check.  The
kernel itself has no interpret mode: the ``gpu`` tests run it on the
card against the fp64 truth (chip_smoke.py runs it at full size)."""

import re

import jax.numpy as jnp
import numpy as np
import pytest

from lorastencil import engine
from lorastencil.models import shapes
from lorastencil.ops import hopper2d
from lorastencil.ops.layout import Layout2D
from lorastencil.utils import reference


@pytest.mark.parametrize("name,dtype,want", [
    ("star2d1r", jnp.float32, True),
    ("box2d3r", jnp.bfloat16, True),
    ("star2d1r", jnp.float64, False),
    ("box3d1r", jnp.float32, False),
    ("1d2r", jnp.float32, False),
])
def test_applies(name, dtype, want):
    assert hopper2d.applies(shapes.get_shape(name), dtype) is want


def test_applies_radius_limit():
    wide = engine.StencilEngine.for_coeffs(np.ones((11, 11)), (64, 256))
    assert wide.spec.radius == 5
    assert not hopper2d.applies(wide.spec, jnp.float32)
    assert hopper2d.applies(
        engine.StencilEngine.for_coeffs(np.ones((9, 9)), (64, 256)).spec,
        jnp.float32)


@pytest.mark.parametrize("name", ["star2d1r", "box2d3r", "star2d3r"])
def test_header_emits_nonzero_taps_only(name):
    spec = shapes.get_shape(name)
    src = hopper2d.header(spec, jnp.float32, 2)
    nnz = int(np.count_nonzero(spec.dense_coeffs()))
    assert src.count("fmaf(") == 4 * nnz  # four output columns per tap
    assert f"#define LS_R {spec.radius}" in src
    assert "#define LS_K 2" in src and "typedef float State;" in src
    assert src.rstrip().endswith('#include "stencil2d.cuh"')


def test_header_state_type_and_literals():
    S = np.array([[0.1, 0.0, -1.0 / 3], [2.5, 1e-7, 0.0],
                  [0.0, 3.0, 0.25]])
    spec = engine.StencilEngine.for_coeffs(S, (64, 256)).spec
    src = hopper2d.header(spec, jnp.bfloat16, 1)
    assert "typedef __nv_bfloat16 State;" in src
    lits = [float(x) for x in re.findall(r"fmaf\(([-0-9.e]+)f", src)]
    dense = spec.dense_coeffs()
    # each literal is a tap rounded to fp32, exactly as the plain step
    for w in lits:
        assert np.float32(w) == w
    assert sorted(set(lits)) == sorted(
        set(float(np.float32(w)) for w in dense[dense != 0]))


def test_header_refuses_what_it_does_not_cover():
    with pytest.raises(ValueError, match="does not cover"):
        hopper2d.header(shapes.get_shape("box3d1r"), jnp.float32, 1)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_smem_bytes_fit_a_block(k):
    """The staged window (twice when fused) fits the 227 KB a block may
    use, for every radius the kernel covers."""
    for r in range(1, hopper2d.MAX_RADIUS + 1):
        spec = engine.StencilEngine.for_coeffs(
            np.ones((2 * r + 1,) * 2), (64, 256)).spec
        b = hopper2d.smem_bytes(spec, k)
        assert 0 < b <= 227 * 1024, (r, k, b)
    spec = shapes.get_shape("star2d1r")
    tm, tn = hopper2d.TILE
    h = k * 3
    pitch = -(-(tn + 2 * h + 4 + (4 - h % 4) % 4 + 8) // 4) * 4
    assert hopper2d.smem_bytes(spec, k) == (
        (2 if k > 1 else 1) * (tm + 2 * h + hopper2d.V) * pitch * 4)


def test_launch_grid_and_region():
    lay = Layout2D(interior=(8192, 8192), halo=(4, 4), tile=(256, 512),
                   guard=(16, 128))
    tm, tn = hopper2d.TILE
    assert hopper2d.launch_grid(lay) == (8192 // tn, 8192 // tm)
    # a region of tiles: rows [256, 512), cols [0, 1024)
    assert hopper2d.launch_grid(lay, ((1, 2), (0, 2))) == (1024 // tn,
                                                           256 // tm)
    odd = Layout2D(interior=(100, 300), halo=(4, 4), tile=(104, 384))
    assert hopper2d.launch_grid(odd) == (-(-384 // tn), -(-104 // tm))


def test_step_rejects_shallow_guard():
    spec = shapes.get_shape("star2d1r")
    lay = Layout2D(interior=(64, 256), halo=(4, 4), tile=(64, 256),
                   guard=(8, 128))
    x = jnp.zeros(lay.shape, jnp.float32)
    with pytest.raises(ValueError, match="guard"):
        hopper2d.step(x, x, spec, lay, fused_steps=3)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(hopper2d.os.path, "exists",
                        lambda p: False if "nvcc" in p else True)
    with pytest.raises(RuntimeError, match="nvcc"):
        hopper2d._nvcc()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["star2d1r", "box2d3r", "star2d3r"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_reference(gpu, name, k, dtype):
    spec = shapes.get_shape(name)
    interior = (200, 333)
    g0 = reference.random_padded(spec, interior, seed=5)
    eng = engine.StencilEngine.for_shape(name, interior, backend="kernel",
                                         fused_steps=k, dtype=dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    steps = 2 * k + 1
    got = np.asarray(eng.run(jnp.asarray(g0, jdt), steps).astype(
        jnp.float32), np.float64)
    want = reference.run(g0, spec, steps)
    tol = 4e-3 * steps if dtype == "bfloat16" else 1e-5
    assert np.abs(got - want).max() / np.abs(want).max() < tol


@pytest.mark.gpu
@pytest.mark.parametrize("boundary", ["periodic", "reflect"])
def test_kernel_ghost_boundaries(gpu, boundary):
    spec = shapes.get_shape("star2d1r")
    interior = (200, 333)
    g0 = reference.random_padded(spec, interior, seed=6)
    eng = engine.StencilEngine.for_shape("star2d1r", interior,
                                         backend="kernel",
                                         boundary=boundary)
    got = np.asarray(eng.run(jnp.asarray(g0, jnp.float32), 9), np.float64)
    truth = {"periodic": reference.run_periodic,
             "reflect": reference.run_reflect}[boundary]
    want = truth(g0, spec, 9)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5
