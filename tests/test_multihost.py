"""Multi-process mesh test: two CPU processes, four global devices, one
sharded run checked against the fp64 ground truth (PARITY.md's
"jax.distributed-ready" claim, as code).

Each subprocess runs tools/multihost_driver.py: ``jax.distributed``
bootstrap, a (2, 2) mesh spanning both processes, the sharded 2-D
engine, and a replicated-output gather; process 0 verifies and prints
``MULTIHOST_OK <err>``.
"""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVER = os.path.join(REPO, "tools", "multihost_driver.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _clean_env():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # the driver sets its own device count
    return env


def test_two_process_mesh_matches_ground_truth():
    port = _free_port()
    env = _clean_env()
    procs = [
        subprocess.Popen(
            [sys.executable, DRIVER, str(port), "2", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=REPO)
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert procs[0].returncode == 0, outs[0][-2000:]
    assert procs[1].returncode == 0, outs[1][-2000:]
    assert "MULTIHOST_OK" in outs[0], outs[0][-2000:]
