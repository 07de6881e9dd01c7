"""Aux subsystems: custom coefficient engine, checkpoint/resume,
roofline reporting, timing."""

import numpy as np
import jax.numpy as jnp
import pytest

from lorastencil import engine
from lorastencil.models import shapes
from lorastencil.utils import checkpoint, profiling, reference


def _custom_spec_reference(S, grid, steps, halo):
    """fp64 ground truth for an arbitrary coefficient matrix."""
    import dataclasses

    from lorastencil.models.shapes import SeparableTerm, StencilSpec

    r = (S.shape[0] - 1) // 2
    spec = StencilSpec(
        name="ref", ndim=2, radius=r, halo=halo,
        terms=(), residue=tuple(
            (tuple(int(i) - r for i in idx), float(S[tuple(idx)]))
            for idx in np.argwhere(np.abs(S) > 0)
        ),
        fuse_factor=1,
    )
    return reference.run(grid, spec, steps)


def test_custom_coeffs_engine():
    rng = np.random.default_rng(0)
    u, v = rng.normal(size=5), rng.normal(size=5)
    S = np.outer(u, u) + 0.25 * np.outer(v, v)
    S[0, 4] += 1.0
    S[4, 0] += 1.0
    eng = engine.StencilEngine.for_coeffs(S, (40, 200), halo=(4, 4))
    shape = eng.spec.padded_shape((40, 200))
    g0 = np.random.default_rng(1).uniform(0, 1, size=shape)
    got = np.asarray(eng.run(jnp.asarray(g0, jnp.float32), 2), np.float64)
    want = _custom_spec_reference(S, g0, 2, (4, 4))
    assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) < 1e-5


def test_custom_coeffs_fused():
    S = shapes.get_shape("box2d3r").dense_coeffs()
    eng = engine.StencilEngine.for_coeffs(S, (40, 200), halo=(4, 4),
                                          fused_steps=2)
    g0 = reference.random_padded(shapes.get_shape("box2d3r"), (40, 200),
                                 seed=2)
    got = np.asarray(eng.run(jnp.asarray(g0, jnp.float32), 3), np.float64)
    want = reference.run(g0, shapes.get_shape("box2d3r"), 3)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


def test_checkpoint_resume(tmp_path):
    spec = shapes.get_shape("star2d1r")
    g0 = reference.random_padded(spec, (24, 128), seed=7)
    eng = engine.StencilEngine.for_shape("star2d1r", (24, 128))
    path = str(tmp_path / "ck.npz")

    full = checkpoint.run_with_checkpoints(eng, g0, steps=6, every=2,
                                           path=path)
    snap = checkpoint.load(path)
    assert snap.step == 6

    # simulate crash after 4 steps: rewrite checkpoint at step 4, resume
    part = checkpoint.run_with_checkpoints(eng, g0, steps=4, every=2,
                                           path=path, resume=False)
    resumed = checkpoint.run_with_checkpoints(eng, g0, steps=6, every=2,
                                              path=path)
    np.testing.assert_allclose(resumed, full, rtol=1e-6, atol=1e-3)

    want = reference.run(g0, spec, 6)
    err = np.abs(full.astype(np.float64) - want).max() / np.abs(want).max()
    assert err < 1e-5


H100 = "NVIDIA H100 80GB HBM3"


def test_roofline_report():
    """star2d1r fp32 on an H100: 8 B per cell-step over 3.35 TB/s, 25
    taps x 2 FLOP over 67 TFLOP/s -> memory-bound at 418.75 GCells/s."""
    spec = shapes.get_shape("star2d1r")
    r = profiling.stencil_roofline(spec, H100)
    assert r.bytes_per_cell_step == 8.0
    assert r.flops_per_cell_step == 50.0
    assert r.bw_bound_gcells == pytest.approx(418.75)
    assert r.compute_bound_gcells == pytest.approx(1340.0)
    assert r.bound == "memory" and r.governing_gcells == r.bw_bound_gcells


def test_roofline_unknown_device():
    """An unknown device gets no share -- never an assumed peak."""
    spec = shapes.get_shape("star2d1r")
    assert profiling.peak("cpu") is None
    assert profiling.stencil_roofline(spec, "cpu") is None
    assert profiling.stencil_roofline(spec, "NVIDIA A100-SXM4-80GB") is None


def test_roofline_fused_and_dtypes():
    """Fused passes divide the bytes; bf16 halves them; float64 doubles
    them and uses the fp64 peak; the df64 pair chain has no model."""
    s3 = shapes.get_shape("box3d1r")
    r = profiling.stencil_roofline(s3, H100, fused_steps=4)
    assert r.bytes_per_cell_step == 2.0
    rb = profiling.stencil_roofline(s3, H100, dtype="bfloat16")
    assert rb.bytes_per_cell_step == 4.0
    r64 = profiling.stencil_roofline(s3, H100, dtype="float64")
    assert r64.bytes_per_cell_step == 16.0
    assert r64.compute_bound_gcells == pytest.approx(67e3 / 54.0)
    assert profiling.stencil_roofline(s3, H100, dtype="df64") is None
    s1 = shapes.get_shape("1d2r")
    assert profiling.stencil_roofline(s1, H100).flops_per_cell_step == 18.0


def test_peak_table_h100():
    """The peak table is the H100 SXM data sheet."""
    pk = profiling.peak(H100)
    assert (pk.hbm_gbps, pk.fp32_tflops, pk.fp64_tflops) == (3350.0, 67.0,
                                                             67.0)
    assert "data sheet" in pk.source


def test_flops_forms_and_share():
    """The separable form counts per-term taps plus residue taps; the
    dense form counts nonzero dense taps."""
    star = shapes.get_shape("star2d1r")
    assert profiling.flops_per_cell_step(star) == 50.0
    # two 5-tap convs (zero end taps skipped) + 8 residue points
    assert profiling.flops_per_cell_step(star, "separable") == 36.0
    box = shapes.get_shape("box2d3r")
    assert profiling.flops_per_cell_step(box) == 98.0
    r = profiling.stencil_roofline(star, H100)
    assert r.share(r.governing_gcells / 2) == pytest.approx(0.5)


def test_suite_rows_off_card():
    """Suite rows name the device; off the card (here) they carry no
    roofline share."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import benchmarks.suite as suite

    row = suite.run_config("star2d1r", (64, 256), 2, repeats=2)
    assert row["device"]["platform"] == "cpu"
    assert row["roofline_share"] is None and row["roofline_bound"] is None
    assert row["backend"] == "xla" and row["gcells_per_s"] > 0
    crow = suite.run_config("custom2d_asym5", (64, 256), 2, repeats=1)
    assert crow["shape"] == "custom2d_asym5"


def test_profiler_trace_smoke(tmp_path):
    import jax.numpy as jnp

    with profiling.trace(str(tmp_path)):
        _ = jnp.ones((8, 8)) @ jnp.ones((8, 8))
    import os
    found = []
    for root, _, files in os.walk(tmp_path):
        found += files
    assert found, "trace produced no files"


def test_orbax_sharded_checkpoint(tmp_path):
    """Async orbax checkpoint of sharded state: save, restore with the
    same sharding, bit-identical."""
    from lorastencil.utils import checkpoint

    if not checkpoint.orbax_available():
        import pytest

        pytest.skip("orbax not installed")
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lorastencil.parallel import domain

    mesh = domain.make_mesh((4, 2))
    x = jnp.arange(32 * 256, dtype=jnp.float32).reshape(32, 256)
    x = jax.device_put(x, NamedSharding(mesh, P("x", "y")))
    ck = checkpoint.ShardedCheckpointer(str(tmp_path / "ckpt"))
    try:
        ck.save(7, x, "star2d1r")
        ck.wait()
        assert ck.latest_step() == 7
        restored, meta = ck.restore(7, x)
        assert meta["shape"] == "star2d1r" and meta["step"] == 7
        assert restored.sharding.is_equivalent_to(x.sharding, x.ndim)
        np.testing.assert_array_equal(np.asarray(restored), np.asarray(x))
    finally:
        ck.close()


def test_timing_quartiles():
    """Timing statistics: median and quartiles of the samples."""
    from lorastencil.utils import metrics

    t = metrics.Timing.of([5.0, 1.0, 3.0, 2.0, 4.0])
    assert (t.median_s, t.q1_s, t.q3_s, t.runs) == (3.0, 2.0, 4.0, 5)


def test_time_run_counts():
    """time_run warms up once, then times ``repeats`` calls, each
    ending in block_until_ready."""
    from lorastencil.utils import metrics

    calls = []

    def fn(x):
        calls.append(x)
        return jnp.asarray(x) * 2

    t, out = metrics.time_run(fn, 3.0, repeats=6)
    assert len(calls) == 7 and t.runs == 6 and float(out) == 6.0
    assert 0 < t.q1_s <= t.median_s <= t.q3_s


def test_require_gpu_on_cpu():
    """The measurement entry points refuse the CPU: require_gpu exits
    non-zero and names what JAX found."""
    from lorastencil import backend

    with pytest.raises(SystemExit) as e:
        backend.require_gpu()
    assert "cpu" in str(e.value.code)


def test_card_info_without_nvidia_smi(monkeypatch):
    """card_info reports nvidia-smi's line, or why there is none."""
    from lorastencil import backend

    monkeypatch.setenv("PATH", "/nonexistent")
    assert backend.card_info().startswith("nvidia-smi unavailable")


def test_peak_table_entries():
    """Every roofline needs a known device; the table holds each entry's
    source."""
    for kind, pk in profiling.PEAKS.items():
        assert pk.hbm_gbps > 0 and pk.fp32_tflops > 0 and pk.source
        assert profiling.peak(kind) is pk
