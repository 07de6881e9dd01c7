"""Headline benchmark: star2d1r (the north-star shape, BASELINE.md) at
8192^2 on the GPU, through the default engine.

Prints the card's name and power limit, then ONE JSON line: the median
GStencil/s (with the reference's x3 temporal-fusion factor,
src/2d/gpu.cu:553) over 5 runs of 256 steps, its quartiles, and
``vs_baseline`` = the engine over the naive XLA dense stencil (one
shifted slice-add per tap) measured in the same run.  Exits non-zero
without a GPU.

    python bench.py
"""

import json
import sys

import jax
import jax.numpy as jnp

from lorastencil.backend import card_info, require_gpu, setup_compile_cache


def main() -> int:
    kind = require_gpu()
    setup_compile_cache()
    from lorastencil import engine
    from lorastencil.models.shapes import get_shape
    from lorastencil.ops import xla_ref
    from lorastencil.utils import metrics

    spec = get_shape("star2d1r")
    m = n = 8192
    steps = 256
    eng = engine.StencilEngine.for_shape("star2d1r", (m, n))

    @jax.jit
    def run_engine(key):
        state = jax.random.uniform(key, eng.layout.shape, jnp.float32,
                                   0.0, 0.01)
        return jnp.sum(eng._run_internal(state, steps) * 0.0)

    pad_shape = spec.padded_shape((m, n))

    @jax.jit
    def run_naive(key):
        g = jax.random.uniform(key, pad_shape, jnp.float32, 0.0, 0.01)
        return jnp.sum(jax.lax.fori_loop(
            0, steps, lambda _, x: xla_ref.dense_step(x, spec), g) * 0.0)

    key = jax.random.PRNGKey(0)
    t, _ = metrics.time_run(run_engine, key, repeats=5)
    tb, _ = metrics.time_run(run_naive, key, repeats=5)
    cells = m * n * steps * spec.fuse_factor / 1e9

    print(card_info(), flush=True)
    print(json.dumps({
        "metric": f"star2d1r {m}x{n} GStencil/s (x3 fused, fp32), "
                  f"median of 5",
        "value": round(cells / t.median_s, 3),
        "q1": round(cells / t.q3_s, 3),
        "q3": round(cells / t.q1_s, 3),
        "unit": "GStencil/s",
        "backend": eng.backend,
        "fused_steps": eng._fused_k(),
        "vs_baseline": round(tb.median_s / t.median_s, 3),
        "device": {"platform": "gpu", "kind": kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
