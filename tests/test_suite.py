"""benchmarks/suite.py and chip_smoke.py off the card: their
configurations compute the right answers, and both refuse to report a
number without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "benchmarks"))

import suite  # noqa: E402


@pytest.mark.parametrize("kind,interior", [
    ("custom2d_asym5", (24, 136)),
    ("custom3d_sep3", (6, 16, 136)),
])
def test_custom_suite_configs_are_correct(kind, interior):
    """The for_coeffs suite rows (CUSTOM) must compute the right answer
    before their device numbers mean anything: CPU golden at small size
    with the exact coefficients the suite measures."""
    from lorastencil.engine import StencilEngine
    from lorastencil.utils import reference

    eng = StencilEngine.for_coeffs(suite.custom_coeffs(kind), interior,
                                   name=kind)
    g0 = reference.random_padded(eng.spec, interior, seed=7)
    got = np.asarray(eng.run(g0.astype(np.float32), steps=3), np.float64)
    want = reference.run(g0, eng.spec, 3)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 5e-6, err


@pytest.mark.parametrize("tier", ["CONFIGS", "BF16", "DF64", "QUICK",
                                  "CUSTOM"])
def test_suite_config_lists_are_well_formed(tier):
    from lorastencil.models.shapes import ALL_SHAPES, get_shape

    for name, interior, steps, opts in getattr(suite, tier):
        ndim = (len(suite.custom_coeffs(name).shape)
                if name.startswith("custom") else get_shape(name).ndim)
        assert name.startswith("custom") or name in ALL_SHAPES
        assert len(interior) == ndim and steps > 0
        assert set(opts) <= {"chain", "dtype"}, opts


def test_suite_run_config_bf16_row():
    row = suite.run_config("star2d1r", (48, 256), 3, dtype="bfloat16",
                           repeats=2)
    assert row["dtype"] == "bfloat16" and row["steps"] == 3
    assert row["fused_steps"] == 1 and row["gcells_per_s"] > 0


def test_suite_main_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        suite.main(["--quick"])
    assert e.value.code not in (0, None)


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_cpu():
    """Without a GPU the smoke test exits non-zero and prints no
    result line."""
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py without the program beside it fails."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
