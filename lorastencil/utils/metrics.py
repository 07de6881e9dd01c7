"""Benchmark timing and the GStencil/s metric contract.

Matches the reference's emitted metrics (SURVEY.md section 6): wall-clock
``Time = N [ms]`` over the whole timestep loop plus ``GStencil/s`` where
cell-updates are multiplied by the shape's temporal-fusion equivalence
factor (x3 for 1d1r, x2 for 1d2r, x3 for star2d1r/box2d*, x1 otherwise --
e.g. ``reference/src/1d/gpu_1r.cu:131-132``, ``src/2d/gpu.cu:553``).
Also emits a machine-readable JSON record.

Times are host-clock wall times of whole jitted calls, each ending in
``block_until_ready`` (JAX returns before the device finishes), reported
as the median and quartiles of several runs after a warm-up run that
compiles.
"""

from __future__ import annotations

import dataclasses
import json
import time
import numpy as np

from ..models.shapes import StencilSpec


@dataclasses.dataclass
class Timing:
    median_s: float
    q1_s: float
    q3_s: float
    runs: int

    @classmethod
    def of(cls, samples) -> "Timing":
        q1, med, q3 = np.percentile(np.asarray(samples, float),
                                    [25, 50, 75])
        return cls(float(med), float(q1), float(q3), len(samples))


@dataclasses.dataclass
class BenchResult:
    shape: str
    interior: tuple
    steps: int
    time_ms: float          # median wall time of one run
    gstencil_per_s: float   # fused-equivalent cell updates / s / 1e9
    gcells_per_s: float     # raw cell updates / s / 1e9
    fuse_factor: int
    backend: str
    dtype: str
    repeats: int

    def human(self) -> str:
        return (
            f"LoRAStencil({self.shape}):\n"
            f"Time = {self.time_ms:.3f} [ms]\n"
            f"GStencil/s = {self.gstencil_per_s:f}"
        )

    def json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def time_run(run_fn, *args, repeats: int = 5, warmup: int = 1):
    """Time ``run_fn(*args)``: ``warmup`` untimed calls (compilation),
    then ``repeats`` timed calls, each ending in ``block_until_ready``.
    Returns ``(Timing, last_output)``."""
    out = None
    for _ in range(max(1, warmup)):
        out = _sync(run_fn(*args))
    samples = []
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        out = _sync(run_fn(*args))
        samples.append(time.perf_counter() - t0)
    return Timing.of(samples), out


def _sync(x):
    for leaf in (x if isinstance(x, (tuple, list)) else (x,)):
        if hasattr(leaf, "block_until_ready"):
            leaf.block_until_ready()
    return x


def bench_result(
    spec: StencilSpec, interior, steps: int, seconds: float,
    backend: str, dtype: str, repeats: int,
) -> BenchResult:
    cells = int(np.prod(interior))
    raw = cells * steps / seconds / 1e9
    return BenchResult(
        shape=spec.name,
        interior=tuple(interior),
        steps=steps,
        time_ms=seconds * 1e3,
        gstencil_per_s=raw * spec.fuse_factor,
        gcells_per_s=raw,
        fuse_factor=spec.fuse_factor,
        backend=backend,
        dtype=dtype,
        repeats=repeats,
    )
