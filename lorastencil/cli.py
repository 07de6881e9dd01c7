"""Command-line driver, mirroring the reference binaries' contract:

    lorastencil_1d shape n times                (src/1d/main.cu:26-31)
    lorastencil_2d shape m n times              (src/2d/main.cu:29-35)
    lorastencil_3d shape h m n times            (src/3d/main.cu:25-31)

Here unified as:

    python -m lorastencil.cli <shape> <sizes...> <steps> [options]

with the reference's fill modes (random / index / ones -- compile-time
 #defines there, flags here: ``src/2d/main.cu:232-254``) and its
correctness check (``--check``: fp64 ground-truth comparison at 1e-7-style
tolerance, the runtime equivalent of the reference's CHECK_ERROR build,
``src/2d/main.cu:282-328``) -- except we check k steps, not just one.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from . import engine
from .models.shapes import ALL_SHAPES, get_shape
from .utils import metrics, reference


def make_input(spec, interior, fill: str, seed: int = 0) -> np.ndarray:
    shape = spec.padded_shape(interior)
    if fill == "random":
        return reference.random_padded(spec, interior, seed=seed)
    grid = np.zeros(shape, dtype=np.float64)
    it = reference.interior_slices(spec, shape)
    if fill == "index":
        grid[it] = np.arange(int(np.prod(interior))).reshape(interior)
    else:  # ones
        grid[it] = 1.0
    return grid


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="lorastencil",
        description="low-rank stencil computation on a GPU (or the CPU)",
    )
    p.add_argument("shape", choices=sorted(ALL_SHAPES))
    p.add_argument("sizes", type=int, nargs="+",
                   help="interior sizes (1, 2 or 3 of them) then steps")
    p.add_argument("--fill", choices=["random", "index", "ones"],
                   default="random")
    p.add_argument("--check", action="store_true",
                   help="verify against the fp64 ground truth")
    p.add_argument("--backend", choices=["auto", "xla", "kernel"],
                   default="auto",
                   help="step path: auto = the 2-D kernel on a GPU where "
                        "it applies, XLA elsewhere (lorastencil/backend.py)")
    p.add_argument("--fused-steps", type=int, default=None,
                   help="timesteps per pass (one device-memory round "
                        "trip on the 2-D kernel); default: the "
                        "engine's choice")
    p.add_argument("--dtype",
                   choices=["float32", "bfloat16", "float64", "df64"],
                   default="float32",
                   help="state dtype; bfloat16 = stored bf16, computed "
                        "fp32 (~4e-3/step storage rounding); float64 "
                        "enables x64 (the reference's fp64 regime); "
                        "df64 = fp64-grade double-float fp32 pairs "
                        "(ops/df64.py)")
    p.add_argument("--boundary",
                   choices=["dirichlet0", "periodic", "reflect"],
                   default="dirichlet0",
                   help="dirichlet0 = reference halo-decay semantics; "
                        "periodic = the grid wraps; reflect = "
                        "symmetric (zero-flux) mirror padding "
                        "(beyond-reference capabilities; --check "
                        "compares against the matching NumPy truth)")
    p.add_argument("--tile", type=int, nargs=2, default=None)
    p.add_argument("--mesh", type=int, nargs="+", default=None,
                   metavar="D",
                   help="shard the grid over a device mesh (domain "
                        "decomposition with ppermute halo exchange): "
                        "1 integer for 1-D shapes, 2 (rows cols) for "
                        "2-D/3-D; the framework's multi-chip path, "
                        "beyond the single-GPU reference")
    p.add_argument("--no-overlap", action="store_true",
                   help="with --mesh: disable the overlapped "
                        "(compute-hidden) halo exchange")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", action="store_true", help="emit JSON metrics")
    args = p.parse_args(argv)

    from .backend import setup_compile_cache

    setup_compile_cache()
    if args.dtype == "float64":
        import jax

        jax.config.update("jax_enable_x64", True)

    spec = get_shape(args.shape)
    if len(args.sizes) != spec.ndim + 1:
        p.error(
            f"{args.shape} needs {spec.ndim} size(s) + steps, got "
            f"{len(args.sizes)} numbers"
        )
    interior = tuple(args.sizes[: spec.ndim])
    steps = args.sizes[spec.ndim]

    print(
        f"INFO: shape = {spec.name}, sizes = {interior}, steps = {steps}",
        flush=True,
    )
    grid0 = make_input(spec, interior, args.fill, args.seed)
    tile = tuple(args.tile) if args.tile else None
    if args.mesh is not None:
        return _run_sharded(p, args, spec, interior, steps, grid0, tile)
    eng = engine.StencilEngine.for_shape(
        args.shape, interior, backend=args.backend, dtype=args.dtype,
        fused_steps=args.fused_steps, tile=tile, boundary=args.boundary)

    timing, _ = metrics.time_run(
        lambda: eng.run_checksum(grid0, steps), repeats=args.repeats
    )
    res = metrics.bench_result(
        spec, interior, steps, timing.median_s, eng.backend, args.dtype,
        args.repeats,
    )
    print(res.human(), flush=True)
    if args.json:
        print(res.json(), flush=True)

    if args.check:
        return _check(args, spec, grid0, steps, eng.run)
    return 0


def _run_sharded(p, args, spec, interior, steps, grid0, tile) -> int:
    """--mesh path: domain decomposition over a device mesh (the
    framework's multi-chip capability; the reference driver is
    single-GPU, src/2d/main.cu:97-135)."""
    from .parallel import domain

    mesh_shape = tuple(args.mesh)
    # 1-D shapes: (dx); 2-D: (dx, dy); 3-D: (dx, dy) row/col meshes or
    # (dz, dx, dy) with the z axis sharded too (parallel/domain.py)
    want_axes = {1: (1,), 2: (2,), 3: (2, 3)}[spec.ndim]
    if len(mesh_shape) == 1 and spec.ndim > 1:
        mesh_shape = (mesh_shape[0], 1)
    if len(mesh_shape) not in want_axes:
        p.error(f"--mesh for {args.shape} needs "
                f"{' or '.join(map(str, want_axes))} integer(s), "
                f"got {len(args.mesh)}")
    if args.dtype == "float64":
        p.error("--mesh supports float32/bfloat16/df64 state")
    import jax

    n_need = int(np.prod(mesh_shape))
    n_have = len(jax.devices())
    if n_have < n_need:
        p.error(f"--mesh {mesh_shape} needs {n_need} devices, have "
                f"{n_have} (on CPU set "
                f"XLA_FLAGS=--xla_force_host_platform_device_count=N)")
    sh_kw = dict(tile=tile, dtype=args.dtype, backend=args.backend,
                 boundary=args.boundary, overlap=not args.no_overlap)
    if args.fused_steps is not None:
        sh_kw["fused_steps"] = args.fused_steps
    eng = domain.sharded_engine(
        args.shape, interior if spec.ndim > 1 else interior[0],
        mesh_shape, **sh_kw)
    print(f"INFO: mesh = {mesh_shape}, local interior = "
          f"{eng.local_interior}, overlapped exchange = "
          f"{eng._can_overlap()}", flush=True)

    timing, _ = metrics.time_run(
        lambda: eng.run_checksum(grid0, steps), repeats=args.repeats
    )
    res = metrics.bench_result(
        spec, interior, steps, timing.median_s,
        f"{eng.backend}-mesh{mesh_shape}", args.dtype, args.repeats,
    )
    print(res.human(), flush=True)
    if args.json:
        print(res.json(), flush=True)
    if args.check:
        return _check(args, spec, grid0, steps, eng.run)
    return 0


def _check(args, spec, grid0, steps, run_fn) -> int:
    """Runtime equivalent of the reference's CHECK_ERROR build
    (src/2d/main.cu:282-328), over k steps and with an honest FAIL."""
    print("\nChecking correctness ...", flush=True)
    if args.boundary == "periodic":
        want = reference.run_periodic(grid0, spec, steps)
    elif args.boundary == "reflect":
        want = reference.run_reflect(grid0, spec, steps)
    else:
        want = reference.run(grid0, spec, steps)
    got = np.asarray(run_fn(grid0, steps), dtype=np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    if not np.isfinite(scale):
        print(
            "FAILED: ground truth overflows fp64 -- use fewer steps "
            "for --check (values grow by sum|coeffs| each step)"
        )
        return 1
    # df64's hi word is fp32 but its Veltkamp splitter scales
    # intermediates by 4097 (ops/df64.py), so its usable range ends at
    # fp32_max / 4097 (~8.3e34)
    limit = (np.finfo(np.float32).max / 4097.0 if args.dtype == "df64"
             else np.finfo(np.float32).max)
    if args.dtype in ("float32", "df64") and scale > limit:
        print(
            f"FAILED: ground truth reaches {scale:.2e}, beyond the "
            f"{args.dtype} range ({limit:.2e}) -- use fewer --check "
            f"steps (values grow by sum|coeffs| per step; the "
            f"reference checks 1 step) or --dtype float64"
        )
        return 1
    diff = np.abs(got - want)
    rel = float(diff.max()) / scale
    # fp32 compute vs the reference's fp64/1e-7; fp64 runs hold the
    # reference's own regime with headroom; bf16 storage rounds
    # ~4e-3 per step
    tol = {"float64": 1e-12, "df64": 1e-11, "float32": 1e-5,
           "bfloat16": 2e-2}[args.dtype]
    bad = np.argwhere(~(diff <= tol * scale))  # NaN counts as mismatch
    for idx in bad[:10]:
        print(
            f"mismatch at {tuple(int(i) for i in idx)}: "
            f"got {got[tuple(idx)]}, want {want[tuple(idx)]}"
        )
    if len(bad):
        print(f"FAILED: {len(bad)} mismatches (max rel err {rel:.2e})")
        return 1
    print(f"Correct! (max rel err {rel:.2e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
