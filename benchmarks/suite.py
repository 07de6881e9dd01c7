"""Benchmark suite over the BASELINE.md configurations, on the GPU.

    python benchmarks/suite.py [--quick] [--bf16 | --df64 | --custom |
                                          --all-tiers] [--out FILE]

Prints a table and one JSON line per configuration (to ``--out`` when
given).  Every row names the device it ran on and its median and
quartile times over 5 runs, and -- for devices in the peak table of
lorastencil/utils/profiling.py -- its share of the roofline bound.  The
suite refuses to run without a GPU: a CPU timing is not a device number.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from lorastencil import engine
from lorastencil.backend import require_gpu, setup_compile_cache
from lorastencil.utils import metrics, profiling

# (shape, interior, steps, options) per BASELINE.md; star2d1r also at the
# 8192^2 north-star size.  ``chain``: consecutive whole runs inside ONE
# device program, for configurations whose single run is short next to
# a dispatch (the reference's launch queue runs its sub-ms kernels back
# to back, src/1d/gpu_1r.cu:121-123).
CONFIGS = [
    ("1d1r", (4096,), 64, {"chain": 256}),
    ("1d2r", (1_000_000,), 256, {}),
    ("1d1r", (16 * 1024 * 1024,), 256, {}),
    ("1d2r", (16 * 1024 * 1024,), 256, {}),
    ("star2d1r", (4096, 4096), 256, {}),
    ("box2d1r", (4096, 4096), 256, {}),
    ("star2d3r", (8192, 8192), 64, {}),
    ("box2d3r", (8192, 8192), 64, {}),
    ("star2d1r", (8192, 8192), 256, {}),
    ("star2d1r", (512, 512), 64, {"chain": 64}),
    ("star3d1r", (256, 256, 256), 64, {}),
    ("box3d1r", (256, 256, 256), 64, {}),
]

BF16 = [(name, interior, steps, dict(opts, dtype="bfloat16"))
        for name, interior, steps, opts in CONFIGS]

DF64 = [
    ("1d1r", (4096,), 64, {"chain": 64, "dtype": "df64"}),
    ("1d2r", (16 * 1024 * 1024,), 64, {"dtype": "df64"}),
    ("star2d1r", (4096, 4096), 64, {"dtype": "df64"}),
    ("box2d3r", (4096, 4096), 32, {"dtype": "df64"}),
    ("star3d1r", (256, 256, 256), 64, {"dtype": "df64"}),
]

QUICK = [
    ("star2d1r", (1024, 1024), 64, {}),
    ("box3d1r", (32, 64, 256), 8, {}),
    ("1d1r", (4096,), 8, {"chain": 4}),
]


def custom_coeffs(kind: str):
    """Deterministic user stencils for the for_coeffs rows."""
    if kind == "custom2d_asym5":
        # non-symmetric rank-1 outer product + 3 off-pattern spikes ->
        # pivot peel + sparse residue (the decompose_2d general path)
        u = np.array([1.0, 2.0, 3.0, 1.0, 0.5])
        v = np.array([0.25, 1.0, 2.0, 0.5, 0.125])
        S = np.outer(u, v)
        S[0, 4] += 0.25
        S[4, 0] -= 0.125
        S[2, 2] += 1.0
        return S
    if kind == "custom3d_sep3":
        # exactly-separable 3x3x3 -> decompose_3d's rank-1 z-unfolding
        z = np.array([1.0, 2.0, 1.0])
        u = np.array([1.0, 2.0, 1.0])
        v = np.array([0.5, 1.0, 0.5])
        return np.einsum("i,j,k->ijk", z, u, v)
    raise KeyError(kind)


CUSTOM = [
    ("custom2d_asym5", (4096, 4096), 256, {}),
    ("custom3d_sep3", (256, 256, 256), 64, {}),
]


def build_engine(name, interior, **kw):
    if name.startswith("custom"):
        return engine.StencilEngine.for_coeffs(custom_coeffs(name),
                                               interior, name=name, **kw)
    return engine.StencilEngine.for_shape(name, interior, **kw)


def run_config(name, interior, steps, chain=1, repeats=5, **kw) -> dict:
    """Time one configuration; returns its JSON row."""
    eng = build_engine(name, interior, **kw)
    shape = ((2,) if eng.df64 else ()) + eng.layout.shape

    @jax.jit
    def f(key):
        # eng.dtype, not fp32: the state dtype selects the numerics tier
        state = jax.random.uniform(key, shape, eng.dtype, 0.0, 0.01)
        state = jax.lax.fori_loop(
            0, chain, lambda i, st: eng._run_internal(st, steps), state)
        return jnp.sum(state * 0.0)

    timing, _ = metrics.time_run(f, jax.random.PRNGKey(0),
                                 repeats=repeats)
    dtype = kw.get("dtype", "float32")
    res = metrics.bench_result(eng.spec, interior, steps,
                               timing.median_s / chain, eng.backend, dtype,
                               repeats)
    dev = jax.devices()[0]
    row = json.loads(res.json())
    row.update(chain=chain, fused_steps=eng._fused_k(),
               q1_ms=timing.q1_s / chain * 1e3,
               q3_ms=timing.q3_s / chain * 1e3,
               device={"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())})
    roof = profiling.stencil_roofline(eng.spec, dev.device_kind, dtype,
                                      eng._fused_k())
    row["roofline_share"] = (roof.share(res.gcells_per_s) if roof
                             else None)
    row["roofline_bound"] = roof.bound if roof else None
    return row


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    require_gpu()
    setup_compile_cache()
    configs = QUICK if "--quick" in argv else CONFIGS
    if "--bf16" in argv:
        configs = BF16
    elif "--df64" in argv:
        configs = DF64
    elif "--custom" in argv:
        configs = CUSTOM
    elif "--all-tiers" in argv:
        configs = CONFIGS + BF16 + DF64 + CUSTOM
    out = None
    if "--out" in argv:
        out = open(argv[argv.index("--out") + 1], "a")
    failed = 0
    for name, interior, steps, opts in configs:
        try:
            row = run_config(name, interior, steps, **opts)
        except Exception as e:  # report and go on with the next config
            failed += 1
            print(f"{name:14s} {str(interior):18s} FAILED: "
                  f"{type(e).__name__}: {e}", flush=True)
            continue
        share = row["roofline_share"]
        print(f"{name:14s} {str(interior):18s} x{steps:<4d} "
              f"{row['gcells_per_s']:8.2f} GCells/s  median "
              f"{row['time_ms']:.3f} ms [{row['q1_ms']:.3f}, "
              f"{row['q3_ms']:.3f}]"
              + (f"  {share:.0%} of {row['roofline_bound']} bound"
                 if share is not None else ""), flush=True)
        line = json.dumps(row)
        print(line, file=out or sys.stdout, flush=True)
    if out:
        out.close()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
