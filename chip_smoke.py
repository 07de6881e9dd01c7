#!/usr/bin/env python3
"""Chip smoke test: every engine on the GPU at real widths, checked.

    python chip_smoke.py               # one card: every single-card phase
    python chip_smoke.py --four-cards  # four cards: the sharded phases only

Each phase runs a stencil through the entry points a user calls
(``StencilEngine.for_shape(...).run``, ``for_coeffs``, ``run_diff``,
``sharded_engine``) on grids larger than the card's 50 MB L2, compares
the result with a float64 yardstick, and prints one line: the error
relative to the yardstick's largest value, its tolerance, and the median
wall time of 5 runs, each ending in ``block_until_ready``.  The
yardstick is the plain dense stencil (ops/xla_ref.py) in float64 on the
card; it is itself checked against the NumPy ground truth
(utils/reference.py) on a small grid in the same run.  A further phase
times the 2-D kernel against the plain XLA step.

The card's name and power limit come first; the last line is one JSON
object ``{"ok": ..., "device": {"platform", "kind", "count"}}``.  The
script exits non-zero if any phase fails, and -- printing no result --
when JAX finds no GPU or the package is missing.
"""

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np

STEPS = 8
# tolerances against the float64 yardstick, relative to its largest value
TOL = {"float32": 1e-5, "bfloat16": 4e-3 * STEPS, "float64": 1e-12,
       "df64": 1e-13}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded phases, on four cards")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phase names to run (default all)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import jax
        from lorastencil.backend import (card_info, require_gpu,
                                         setup_compile_cache)
    except ImportError as e:
        print(f"chip_smoke: cannot import the program: {e}",
              file=sys.stderr)
        return 2
    require_gpu()  # exits non-zero without a GPU
    need = 4 if args.four_cards else 1
    if len(jax.devices()) < need:
        print(f"chip_smoke: needs {need} GPUs, JAX found "
              f"{len(jax.devices())}", file=sys.stderr)
        return 2
    setup_compile_cache()
    jax.config.update("jax_enable_x64", True)  # the float64 yardstick
    print(card_info(), flush=True)

    phases = FOUR_CARD if args.four_cards else ONE_CARD
    if not args.four_cards:
        # the 2-D kernels of the registry shapes the phases and the gpu
        # tests run, built side by side instead of one at first use each
        from lorastencil.ops import hopper2d

        t0 = time.perf_counter()
        hopper2d.prebuild(("star2d1r", "box2d3r", "star2d3r"))
        print(f"prebuild: 2-D kernels built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    if args.phases:
        keep = set(args.phases.split(","))
        phases = [p for p in phases if p.__name__ in keep]
    ok = True
    for phase in phases:
        t0 = time.perf_counter()
        try:
            for line in phase():
                print(f"{phase.__name__}: {line}", flush=True)
        except Exception as e:  # a failed phase fails the run
            ok = False
            traceback.print_exc()
            print(f"{phase.__name__}: FAILED {type(e).__name__}: {e}",
                  flush=True)
        print(f"{phase.__name__}: phase took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    dev = jax.devices()[0]
    devices = jax.devices()[:need]
    print(json.dumps({"ok": ok, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0 if ok else 1


# -- yardstick --------------------------------------------------------------
def _interior(spec, shape):
    return tuple(slice(h, s - h) for h, s in zip(spec.halo, shape))


def yardstick(x64, spec, steps, boundary="dirichlet0"):
    """``steps`` float64 dense steps on the card (ops/xla_ref.py), with
    the engine's boundary semantics; returns the padded result."""
    import jax
    import jax.numpy as jnp
    from lorastencil.ops import xla_ref

    r = spec.radius
    it = _interior(spec, x64.shape)

    @jax.jit
    def run(x):
        if boundary == "dirichlet0":
            return jax.lax.fori_loop(
                0, steps, lambda _, g: xla_ref.dense_step(g, spec), x)
        mode = {"periodic": "wrap", "reflect": "symmetric"}[boundary]
        g = jax.lax.fori_loop(
            0, steps, lambda _, g: xla_ref.dense_valid(
                jnp.pad(g, r, mode=mode), spec), x[it])
        return jnp.zeros_like(x).at[it].set(g)

    return run(x64)


def check_yardstick(spec, boundary="dirichlet0"):
    """The yardstick against the NumPy fp64 ground truth on a small
    grid (returns the relative error; must be ~0)."""
    import jax.numpy as jnp
    from lorastencil.utils import reference

    interior = {1: (4096,), 2: (96, 160), 3: (24, 40, 72)}[spec.ndim]
    g0 = reference.random_padded(spec, interior, seed=3)
    truth = {"dirichlet0": reference.run, "periodic": reference.run_periodic,
             "reflect": reference.run_reflect}[boundary]
    want = truth(g0, spec, STEPS)
    got = np.asarray(yardstick(jnp.asarray(g0, jnp.float64), spec, STEPS,
                               boundary))
    return float(np.abs(got - want).max() / np.abs(want).max())


def random_grid(spec, interior, seed=0):
    """Integer-valued fp64 padded grid (the reference's rand() % 100
    fill), made on the card."""
    import jax
    import jax.numpy as jnp

    shape = spec.padded_shape(interior)
    return jax.random.randint(jax.random.PRNGKey(seed), shape, 0,
                              100).astype(jnp.float64)


def rel_err(got, want):
    import jax.numpy as jnp

    got = jnp.asarray(got, jnp.float64)
    return float(jnp.max(jnp.abs(got - want)) / jnp.max(jnp.abs(want)))


def median_ms(fn, *args, repeats=5):
    from lorastencil.utils import metrics

    timing, out = metrics.time_run(fn, *args, repeats=repeats)
    return timing.median_s * 1e3, out


def engine_case(name, interior, dtype="float32", boundary="dirichlet0",
                coeffs=None, **kw):
    """One engine run against the yardstick; returns the phase line."""
    import jax.numpy as jnp
    from lorastencil.engine import StencilEngine

    if coeffs is not None:
        eng = StencilEngine.for_coeffs(coeffs, interior, name=name,
                                       dtype=dtype, boundary=boundary, **kw)
    else:
        eng = StencilEngine.for_shape(name, interior, dtype=dtype,
                                      boundary=boundary, **kw)
    spec = eng.spec
    x64 = random_grid(spec, interior)
    want = yardstick(x64, spec, STEPS, boundary)
    if dtype == "df64":
        x_in = np.asarray(x64)
    else:
        x_in = x64.astype(jnp.dtype(dtype))
    ms, got = median_ms(eng.run, x_in, STEPS)
    err = rel_err(got, want)
    tol = TOL[dtype]
    gcells = float(np.prod(interior)) * STEPS / ms / 1e6
    line = (f"{name} {'x'.join(map(str, interior))} {dtype} {boundary} "
            f"backend={eng.backend} k={eng._fused_k()}: err {err:.2e} "
            f"(tol {tol:.0e}), median {ms:.3f} ms for {STEPS} steps "
            f"({gcells:.1f} GCells/s end to end)")
    if not err <= tol:
        raise AssertionError(line)
    return line


# -- single-card phases -----------------------------------------------------
def yardsticks():
    from lorastencil.models.shapes import get_shape

    for name, boundary in (("star2d1r", "dirichlet0"),
                           ("star2d1r", "periodic"),
                           ("star2d1r", "reflect"), ("box3d1r", "dirichlet0"),
                           ("1d2r", "dirichlet0")):
        err = check_yardstick(get_shape(name), boundary)
        line = (f"fp64 yardstick vs NumPy truth {name} {boundary}: "
                f"err {err:.2e} (tol 1e-13)")
        if not err <= 1e-13:
            raise AssertionError(line)
        yield line


def star2d1r():
    for dtype in ("float32", "bfloat16", "float64", "df64"):
        yield engine_case("star2d1r", (8192, 8192), dtype)


def box2d3r():
    yield engine_case("box2d3r", (8192, 8192))


def star2d3r():
    yield engine_case("star2d3r", (8192, 8192))


def one_d():
    for dtype in ("float32", "bfloat16"):
        yield engine_case("1d2r", (64 * 1024 * 1024,), dtype)


def three_d():
    yield engine_case("star3d1r", (512, 512, 512))
    for dtype in ("float32", "bfloat16"):
        yield engine_case("box3d1r", (512, 512, 512), dtype)


def custom():
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "benchmarks"))
    from suite import custom_coeffs

    yield engine_case("custom2d_asym5", (4096, 4096),
                      coeffs=custom_coeffs("custom2d_asym5"))


def ghost():
    for boundary in ("periodic", "reflect"):
        yield engine_case("star2d1r", (8192, 8192), boundary=boundary)


def run_diff():
    """The differentiable entry point: forward values match run(), and
    the gradient of <run(x), c> is the adjoint product."""
    import jax
    import jax.numpy as jnp
    from lorastencil.engine import StencilEngine

    eng = StencilEngine.for_shape("star2d1r", (8192, 8192))
    x64 = random_grid(eng.spec, (8192, 8192))
    x = x64.astype(jnp.float32)
    c = random_grid(eng.spec, (8192, 8192), seed=1).astype(jnp.float32)
    steps = 2
    want = yardstick(x64, eng.spec, steps)
    fwd = rel_err(eng.run_diff(x, steps), want)
    grad = jax.jit(jax.grad(lambda x: jnp.sum(eng.run_diff(x, steps) * c)))
    ms, g = median_ms(grad, x)
    # <run(x), c> is linear in x: its gradient g satisfies
    # <g, x> == <run(x), c>, checked in float64
    lhs = float(jnp.sum(jnp.asarray(g, jnp.float64) * x64))
    rhs = float(jnp.sum(want * c.astype(jnp.float64)))
    gerr = abs(lhs - rhs) / abs(rhs)
    line = (f"star2d1r 8192x8192 run_diff {steps} steps: forward err "
            f"{fwd:.2e}, <grad, x> vs <run(x), c> err {gerr:.2e} (tol "
            f"1e-5), grad median {ms:.3f} ms")
    if not (fwd <= 1e-5 and gerr <= 1e-5):
        raise AssertionError(line)
    yield line


def kernel_vs_plain():
    """The 2-D kernel at fused_steps 1..4 against the plain XLA step,
    end to end at 8192^2 fp32 (48 steps: every k divides it)."""
    import jax
    import jax.numpy as jnp
    from lorastencil.engine import StencilEngine

    steps = 48
    for name in ("star2d1r", "box2d3r"):
        plain = StencilEngine.for_shape(name, (8192, 8192), backend="xla")
        engines = [("xla", 1, plain)] + [
            ("kernel", k, StencilEngine.for_shape(
                name, (8192, 8192), backend="kernel", fused_steps=k))
            for k in (1, 2, 3, 4)]
        x = random_grid(plain.spec, (8192, 8192)).astype(jnp.float32)
        ref = None
        for backend, k, eng in engines:
            run = jax.jit(lambda x, eng=eng: jnp.sum(
                eng.run(x, steps)[:8, :8]))
            ms, _ = median_ms(run, x)
            out = eng.run(x, 12)
            if ref is None:
                ref, err = out, 0.0
            else:
                err = float(jnp.max(jnp.abs(out - ref))
                            / jnp.max(jnp.abs(ref)))
            line = (f"{name} 8192x8192 fp32 {backend} k={k}: median "
                    f"{ms:.3f} ms for {steps} steps "
                    f"({8192 * 8192 * steps / ms / 1e6:.1f} GCells/s), "
                    f"vs xla err {err:.2e}")
            if not err <= 1e-5:
                raise AssertionError(line)
            yield line


def gpu_tests():
    """The tests marked ``gpu`` (the CUDA kernel at every fused k and
    state dtype, and under ghost boundaries, against the NumPy truth),
    run by pytest in this process: a second process could not reserve
    the card's memory."""
    import pytest

    class Outcomes:
        def __init__(self):
            self.counts = {"passed": 0, "failed": 0, "skipped": 0}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.counts[report.outcome] += 1

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests")
    seen = Outcomes()
    rc = pytest.main([tests, "-m", "gpu", "-q", "-n", "0",
                      "-p", "no:cacheprovider"], plugins=[seen])
    line = f"pytest -m gpu: exit {int(rc)}, {seen.counts}"
    if rc != 0 or seen.counts["passed"] == 0 or seen.counts["skipped"]:
        raise AssertionError(line)
    yield line


ONE_CARD = [yardsticks, star2d1r, box2d3r, star2d3r, one_d, three_d,
            custom, ghost, run_diff, kernel_vs_plain, gpu_tests]


# -- four-card phases ---------------------------------------------------------
def sharded_case(name, interior, mesh_shape, **kw):
    import jax
    import jax.numpy as jnp
    from lorastencil.engine import StencilEngine
    from lorastencil.parallel import domain

    sh = domain.sharded_engine(name, interior, mesh_shape, **kw)
    one = StencilEngine.for_shape(name, interior,
                                  fused_steps=kw.get("fused_steps"))
    x64 = random_grid(sh.spec, interior)
    x = x64.astype(jnp.float32)
    # every block on its own card: the embedded state spans the mesh
    state = jax.jit(sh.to_sharded)(x)
    devs = {s.device for s in state.addressable_shards}
    if len(devs) != int(np.prod(mesh_shape)):
        raise AssertionError(f"blocks sit on {len(devs)} devices, mesh "
                             f"{mesh_shape} needs one each")
    # the steps alone, on state already embedded (run() also embeds the
    # grid held by card 0 into the mesh and gathers the result back)
    steps_ms, _ = median_ms(jax.jit(lambda s: sh._run(s, STEPS)), state)
    del state
    state1 = jax.jit(one.to_internal)(x)
    steps_ms1, _ = median_ms(jax.jit(
        lambda s: one._run_internal(s, STEPS)), state1)
    del state1
    want = yardstick(x64, sh.spec, STEPS)
    ms, got = median_ms(sh.run, x, STEPS)
    err = rel_err(got, want)
    got1 = one.run(x, STEPS)
    err1 = float(jnp.max(jnp.abs(jnp.asarray(got) - got1))
                 / jnp.max(jnp.abs(got1)))
    ms1, _ = median_ms(one.run, x, STEPS)
    line = (f"{name} {'x'.join(map(str, interior))} mesh {mesh_shape} "
            f"{kw}: backend={sh.backend}, err vs fp64 {err:.2e}, vs one "
            f"card {err1:.2e} (tol 1e-5); run() median {ms:.3f} ms for "
            f"{STEPS} steps on {len(devs)} cards vs {ms1:.3f} ms on one; "
            f"steps alone {steps_ms:.3f} ms vs {steps_ms1:.3f} ms")
    if not (err <= 1e-5 and err1 <= 1e-5):
        raise AssertionError(line)
    return line


def sharded_2d():
    yield sharded_case("star2d1r", (16384, 16384), (2, 2), fused_steps=2,
                       overlap=True)
    # the kernel's deeper fusion needs more than 48 KB of shared memory
    # per block, which must be granted on every card of the mesh
    yield sharded_case("star2d1r", (16384, 16384), (2, 2), fused_steps=4,
                       overlap=True)


def sharded_3d():
    yield sharded_case("box3d1r", (512, 512, 512), (4, 1, 1))


FOUR_CARD = [sharded_2d, sharded_3d]


if __name__ == "__main__":
    sys.exit(main())
