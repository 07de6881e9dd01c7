"""Checkpoint / resume for long stencil runs.

The reference has no checkpointing (final state is copied out once,
``reference/src/2d/gpu.cu:554``); this is new capability for
production runs: periodically snapshot the padded grid state + step
counter, resume bit-exactly.  Plain ``.npz`` by default; orbax (if
installed) for async multi-host checkpoints of sharded state.
"""

from __future__ import annotations

import dataclasses
import json
import os
import numpy as np


@dataclasses.dataclass
class Snapshot:
    shape_name: str
    step: int
    grid: np.ndarray  # user-layout padded array


def save(path: str, snap: Snapshot) -> None:
    tmp = path + ".tmp"
    np.savez(
        tmp if tmp.endswith(".npz") else tmp + ".npz",
        grid=snap.grid,
        meta=json.dumps({"shape": snap.shape_name, "step": snap.step}),
    )
    src = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(src, path)


def load(path: str) -> Snapshot:
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        return Snapshot(
            shape_name=meta["shape"], step=int(meta["step"]),
            grid=z["grid"],
        )


def run_with_checkpoints(
    eng, grid0, steps: int, every: int, path: str,
    resume: bool = True,
) -> np.ndarray:
    """Run ``steps`` total steps, snapshotting every ``every`` steps.
    If ``path`` exists and resume=True, continue from it."""
    start = 0
    grid = np.asarray(grid0)
    if resume and os.path.exists(path):
        snap = load(path)
        assert snap.shape_name == eng.spec.name
        start, grid = snap.step, snap.grid
    step = start
    while step < steps:
        chunk = min(every, steps - step)
        grid = np.asarray(eng.run(grid, chunk))
        step += chunk
        save(path, Snapshot(eng.spec.name, step, grid))
    return grid


# -- orbax tier: async checkpoints of SHARDED device state ---------------
def orbax_available() -> bool:
    try:
        import orbax.checkpoint  # noqa: F401
        return True
    except Exception:
        return False


class ShardedCheckpointer:
    """Async orbax checkpoints of sharded internal state.

    The npz path above round-trips through the host and is fine for
    single-chip grids; for domain-decomposed state (parallel/domain.py)
    this saves the device-sharded array directly (orbax gathers per
    shard, asynchronously -- compute continues while the snapshot
    drains), and restores with the same sharding.
    """

    def __init__(self, directory: str):
        import orbax.checkpoint as ocp

        self._ocp = ocp
        self.directory = os.path.abspath(directory)
        self._mngr = ocp.CheckpointManager(
            self.directory,
            options=ocp.CheckpointManagerOptions(
                max_to_keep=2, enable_async_checkpointing=True),
        )

    def save(self, step: int, state, shape_name: str) -> None:
        ocp = self._ocp
        self._mngr.save(
            step,
            args=ocp.args.Composite(
                state=ocp.args.StandardSave({"grid": state}),
                meta=ocp.args.JsonSave({"shape": shape_name, "step": step}),
            ),
        )

    def latest_step(self):
        return self._mngr.latest_step()

    def restore(self, step: int, like):
        """Restore the sharded state for ``step``; ``like`` is an
        abstract array (jax.ShapeDtypeStruct with sharding) or a
        concrete sharded array giving the target layout."""
        ocp = self._ocp
        import jax

        tgt = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype,
                                           sharding=x.sharding)
            if hasattr(x, "sharding") else x, {"grid": like})
        out = self._mngr.restore(
            step,
            args=ocp.args.Composite(
                state=ocp.args.StandardRestore(tgt),
                meta=ocp.args.JsonRestore(),
            ),
        )
        return out["state"]["grid"], out["meta"]

    def wait(self) -> None:
        self._mngr.wait_until_finished()

    def close(self) -> None:
        self._mngr.close()
