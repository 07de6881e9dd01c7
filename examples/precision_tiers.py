"""Precision tiers side by side: bfloat16 / float32 / df64 vs fp64 truth.

The reference runs natively in fp64 on DMMA tensor cores
(reference/src/1d/1d_utils.h:44).  This example evolves the same
star2d1r grid through each state tier and prints the error growth
against the NumPy fp64 ground truth:

    python examples/precision_tiers.py

Runs on the GPU, or on the CPU with ``JAX_PLATFORMS=cpu`` (df64 =
double-float fp32 pairs, ops/df64.py).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from lorastencil import engine
from lorastencil.models import shapes
from lorastencil.utils import reference

SHAPE, INTERIOR, STEPS = "star2d1r", (64, 256), (1, 2, 4, 6)

spec = shapes.get_shape(SHAPE)
# non-integer values (full fp64 mantissas) scaled small enough that 6
# steps of sum|coeffs| growth stay well inside fp32 range
g0 = reference.random_padded(spec, INTERIOR, seed=3) * (np.pi / 1e4)

engines = {
    "bfloat16": engine.StencilEngine.for_shape(
        SHAPE, INTERIOR, dtype="bfloat16"),
    "float32": engine.StencilEngine.for_shape(SHAPE, INTERIOR),
    "df64": engine.StencilEngine.for_shape(SHAPE, INTERIOR, dtype="df64"),
}

print(f"{SHAPE} {INTERIOR}: max rel err vs fp64 ground truth")
print(f"{'steps':>6} | " + " | ".join(f"{n:>9}" for n in engines))
for k in STEPS:
    want = reference.run(g0, spec, k)
    scale = np.abs(want).max()
    row = []
    for name, eng in engines.items():
        got = np.asarray(eng.run(g0.astype(eng.dtype)
                                 if name != "df64" else g0, k),
                         np.float64)
        row.append(np.abs(got - want).max() / scale)
    print(f"{k:>6} | " + " | ".join(f"{e:9.2e}" for e in row))

print("\nbfloat16 ~ storage rounding per step; float32 ~ 1e-7-grade;")
print("df64 ~ 1e-14-grade (the reference's fp64 regime, from fp32 words).")
