"""CLI and metrics contract tests (CPU)."""

import json

import pytest

from lorastencil import cli
from lorastencil.models import shapes
from lorastencil.utils import metrics


def test_cli_check_2d(capsys):
    rc = cli.main(["star2d1r", "40", "200", "3", "--check", "--repeats", "1"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "GStencil/s" in out and "Correct!" in out


def test_cli_check_1d(capsys):
    rc = cli.main(["1d2r", "300", "2", "--check", "--repeats", "1"])
    assert rc == 0
    assert "Correct!" in capsys.readouterr().out


def test_cli_check_3d_json(capsys):
    rc = cli.main(["box3d1r", "4", "16", "150", "2", "--check", "--json",
                   "--repeats", "1"])
    out = capsys.readouterr().out
    assert rc == 0
    line = [l for l in out.splitlines() if l.startswith("{")][0]
    rec = json.loads(line)
    assert rec["shape"] == "box3d1r"
    assert rec["fuse_factor"] == 1
    assert rec["gstencil_per_s"] > 0


def test_cli_wrong_arity_exits():
    with pytest.raises(SystemExit):
        cli.main(["star2d1r", "40", "3"])


def test_cli_fill_modes():
    spec = shapes.get_shape("star2d1r")
    for fill in ("random", "index", "ones"):
        g = cli.make_input(spec, (8, 16), fill)
        assert g.shape == (16, 24)
        if fill != "random":
            # halo is zero for index/ones fills
            assert g[0, :].sum() == 0


def test_metric_contract_fuse_factors():
    spec = shapes.get_shape("star2d1r")
    res = metrics.bench_result(spec, (100, 100), 10, 0.001, "x", "y", 1)
    # GStencil/s = cells * steps * fuse / s / 1e9
    assert res.gstencil_per_s == pytest.approx(100 * 100 * 10 * 3 / 1e-3 / 1e9)
    assert res.gcells_per_s == pytest.approx(res.gstencil_per_s / 3)


def test_bench_refuses_cpu():
    """bench.py measures the GPU: without one it exits non-zero and
    prints no result."""
    import bench

    with pytest.raises(SystemExit) as e:
        bench.main()
    assert e.value.code not in (0, None)


def test_cli_backend_and_fused_flags(capsys):
    rc = cli.main(["star2d1r", "40", "200", "3", "--check", "--repeats", "1",
                   "--backend", "xla", "--fused-steps", "2"])
    out = capsys.readouterr().out
    assert rc == 0 and "Correct!" in out
    with pytest.raises(SystemExit):  # no such option
        cli.main(["star2d1r", "40", "200", "3", "--algorithm", "vpu"])


def test_cli_mesh_sharded_check(capsys):
    """The distribution layer is reachable from the driver -- sharded
    run + sharded --check on the virtual mesh."""
    rc = cli.main(["star2d1r", "100", "300", "3", "--mesh", "4", "2",
                   "--check", "--repeats", "1"])
    out = capsys.readouterr().out
    assert rc == 0 and "Correct!" in out
    assert "mesh = (4, 2)" in out


def test_cli_mesh_ghost_boundary_check(capsys):
    """Sharded periodic --check against the torus ground truth, on a
    mesh the interior does not divide."""
    rc = cli.main(["star2d1r", "101", "200", "3", "--mesh", "2", "2",
                   "--check", "--repeats", "1",
                   "--boundary", "periodic"])
    out = capsys.readouterr().out
    assert rc == 0 and "Correct!" in out


def test_cli_mesh_1d_and_arity(capsys):
    rc = cli.main(["1d1r", "1000", "2", "--mesh", "4", "--check",
                   "--repeats", "1"])
    out = capsys.readouterr().out
    assert rc == 0 and "Correct!" in out
    with pytest.raises(SystemExit):
        cli.main(["star2d1r", "64", "128", "2", "--mesh", "2", "2", "2"])
    with pytest.raises(SystemExit):
        cli.main(["star2d1r", "64", "128", "2", "--mesh", "2", "2",
                  "--autotune"])
