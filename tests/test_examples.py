"""examples/ under test: each script runs as a subprocess on the CPU
(JAX_PLATFORMS=cpu) and must exit 0 with its expected output marker.
"""

import os
import subprocess
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO_ROOT, "examples")


def _run_example(name: str) -> str:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # the examples add their own --xla_force_host_platform_device_count
    # when absent; drop any inherited flags so that path is exercised
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, name)],
        capture_output=True, text=True, timeout=900, env=env,
        cwd=REPO_ROOT,
    )
    assert proc.returncode == 0, (
        f"{name} exited {proc.returncode}\n--- stdout ---\n"
        f"{proc.stdout}\n--- stderr ---\n{proc.stderr}")
    return proc.stdout


def test_example_heat_diffusion():
    out = _run_example("heat_diffusion.py")
    assert "after 40 steps: total heat" in out, out
    # the script raises its own 8-device CPU mesh, so the sharded demo
    # (domain decomposition + checkpoint/resume) must actually run
    assert "sharded star2d1r over 8 devices: rel err" in out, out


def test_example_inverse_source():
    out = _run_example("inverse_source.py")
    assert "recovered hot-spot mass:" in out, out
    # the optimizer must have made progress (loss printed at iter 0 and
    # at the final iter; the marker line carries recovered masses)
    assert "iter  59" in out or "iter 59" in out, out


def test_example_precision_tiers():
    out = _run_example("precision_tiers.py")
    assert "max rel err vs fp64 ground truth" in out, out
    assert "df64 ~ 1e-14-grade" in out, out
