"""The 2-D Hopper kernel: ``fused_steps`` timesteps per launch, called
through JAX's foreign function interface.

Same contract as the plain step (ops/plain.py): ``step(cur, donor, spec,
layout, fused_steps, bounds, region) -> next`` on a 2-D internal layout,
with the donor aliased to the output so only the interior extent is
written.  The kernel (ops/cuda/stencil2d.cuh) stages a halo'd tile in
shared memory and applies the substeps on chip; see its header comment.

The stencil's coefficients are compiled into the kernel.  For each
(stencil, dtype, fused_steps) this module writes a small header with
the tap arithmetic (only nonzero taps) and builds it with ``nvcc``
at first use into ``.build/cuda/`` in the checkout (listed in
.gitignore); later runs reuse the library.  To build ahead of a run:

    python -m lorastencil.ops.hopper2d star2d1r box2d3r

The build needs ``nvcc`` (``/usr/local/cuda/bin`` or ``$CUDA_HOME``);
the kernel runs only on a GPU and has no interpret mode.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import jax
import jax.numpy as jnp

from ..models.shapes import StencilSpec
from .layout import Layout2D
from .plain import region_cells

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda",
                   "stencil2d.cuh")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".build", "cuda")

V = 4          # output rows per thread (register micro-tile V x 4)
THREADS = 256
TILE = (64, 64)  # (TM, TN) output tile of one block
MAX_RADIUS = 4  # a micro-tile's 12-float row segment reaches 4 columns


def applies(spec: StencilSpec, dtype) -> bool:
    """Whether the kernel covers this stencil and state dtype."""
    return (spec.ndim == 2 and 1 <= spec.radius <= MAX_RADIUS
            and jnp.dtype(dtype) in (jnp.dtype(jnp.float32),
                                     jnp.dtype(jnp.bfloat16)))


def smem_bytes(spec: StencilSpec, fused_steps: int) -> int:
    """Dynamic shared memory of one block (mirrors the kernel's
    NBUF * SR * SP * 4): the staged window plus, when substeps are
    fused, its ping-pong twin."""
    tm, tn = TILE
    h = fused_steps * spec.radius
    padl = 4 + (4 - h % 4) % 4
    pitch = -(-(tn + 2 * h + padl + 8) // 4) * 4
    rows = tm + 2 * h + V
    nbuf = 2 if fused_steps > 1 else 1
    return nbuf * rows * pitch * 4


def launch_grid(layout: Layout2D, region=None):
    """(blocks along columns, blocks along rows) of one launch."""
    (lo0, hi0), (lo1, hi1) = region_cells(layout, region)
    tm, tn = TILE
    return (-(-(hi1 - lo1) // tn), -(-(hi0 - lo0) // tm))


def _f(w) -> str:
    """fp32 literal of a tap (the same rounding as the plain step)."""
    return repr(float(np.float32(w))) + "f"


def tap_rows(spec: StencilSpec) -> str:
    """``tap_row(a, seg, o)``: for stencil row ``a`` (row offset a - r),
    o[c] += S[a][b] * seg[4 + c + b - r] over the nonzero taps, c < 4."""
    r = spec.radius
    lines = ["__device__ __forceinline__ void tap_row(int a, "
             "const float* seg, float* o) {", "  switch (a) {"]
    for a, row in enumerate(spec.dense_coeffs()):
        body = [f"o[{c}] = fmaf({_f(w)}, seg[{4 + c + b - r}], o[{c}]);"
                for c in range(4) for b, w in enumerate(row) if w != 0.0]
        if body:
            lines.append(f"    case {a}: " + " ".join(body) + " break;")
    lines += ["    default: break;", "  }", "}"]
    return "\n".join(lines)


def header(spec: StencilSpec, dtype, fused_steps: int) -> str:
    """The generated source of one kernel variant: constants, the tap
    function of ``spec``, then the kernel template."""
    if not applies(spec, dtype):
        raise ValueError(f"the 2-D kernel does not cover {spec.name!r} "
                         f"with {jnp.dtype(dtype)} state")
    tm, tn = TILE
    state = ("__nv_bfloat16" if jnp.dtype(dtype) == jnp.bfloat16
             else "float")
    out = [
        "// generated by lorastencil/ops/hopper2d.py -- do not edit",
        f"// stencil {spec.name}: {jnp.dtype(dtype)} state, fused_steps "
        f"{fused_steps}",
        "#include <cuda_bf16.h>",
        f"#define LS_R {spec.radius}", f"#define LS_K {fused_steps}",
        f"#define LS_TM {tm}", f"#define LS_TN {tn}", f"#define LS_V {V}",
        f"#define LS_THREADS {THREADS}",
        f"typedef {state} State;",
        tap_rows(spec),
        '#include "stencil2d.cuh"',
    ]
    return "\n".join(out) + "\n"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the 2-D kernel is built with "
                           "the CUDA toolkit (set CUDA_HOME)")
    return found


def build(spec: StencilSpec, dtype, fused_steps: int) -> str:
    """Build (or find) the shared library of one kernel variant; returns
    its path.  The file name hashes the generated source and the kernel
    template, so an edit to either rebuilds."""
    src = header(spec, dtype, fused_steps)
    with open(SRC, "rb") as f:
        key = hashlib.sha256(src.encode() + f.read()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"ls2d_{key}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cu = os.path.join(tmp, "kernel.cu")
        with open(cu, "w") as f:
            f.write(src)
        out = os.path.join(tmp, "lib.so")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-I", jax.ffi.include_dir(), "-I", os.path.dirname(SRC),
               "-o", out, cu]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {spec.name} "
                               f"(k={fused_steps}):\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(out, lib)  # atomic: a reader never sees half a file
    return lib


_TARGETS = {}


def _target(spec: StencilSpec, dtype, fused_steps: int) -> str:
    """Build, load and register one variant; returns its FFI name."""
    lib = build(spec, dtype, fused_steps)
    name = "lorastencil_" + os.path.basename(lib)[:-3]
    if name not in _TARGETS:
        handle = ctypes.cdll.LoadLibrary(lib)
        jax.ffi.register_ffi_target(
            name, jax.ffi.pycapsule(handle.LsStencil2d), platform="CUDA")
        _TARGETS[name] = handle
    return name


def step(cur: jax.Array, donor: jax.Array, spec: StencilSpec,
         layout: Layout2D, fused_steps: int = 1,
         bounds=None, region=None) -> jax.Array:
    """``fused_steps`` timesteps in one launch (ops/plain.py contract)."""
    k, r = max(1, fused_steps), spec.radius
    if min(layout.origin) < k * r:
        raise ValueError(f"fused_steps={k} reads {k * r} cells into the "
                         f"guard; the layout's guard is {layout.origin}")
    (lo0, hi0), (lo1, hi1) = region_cells(layout, region)
    if bounds is None:
        m, n = layout.interior
        bounds = np.array([0, m, 0, n], np.int32)
    r0, c0 = layout.origin
    call = jax.ffi.ffi_call(
        _target(spec, cur.dtype, k),
        jax.ShapeDtypeStruct(cur.shape, cur.dtype),
        input_output_aliases={1: 0})
    return call(cur, donor, jnp.asarray(bounds, jnp.int32),
                r0=np.int64(r0), c0=np.int64(c0), lo0=np.int64(lo0),
                hi0=np.int64(hi0), lo1=np.int64(lo1), hi1=np.int64(hi1))


def prebuild(names) -> list:
    """Build the kernels of the named 2-D shapes (fp32 and bf16, fused
    steps 1..4), one nvcc per core at a time; returns the libraries."""
    from concurrent.futures import ThreadPoolExecutor

    from ..models.shapes import get_shape

    variants = [(get_shape(name), dtype, k) for name in names
                for dtype in (jnp.float32, jnp.bfloat16)
                for k in range(1, 5)]
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        return list(pool.map(lambda v: build(*v), variants))


def main(argv=None) -> int:
    """Build the kernels of the named 2-D shapes ahead of a run."""
    names = (argv if argv is not None else sys.argv[1:]) or ["star2d1r"]
    for lib in prebuild(names):
        print(lib)
    return 0


if __name__ == "__main__":
    sys.exit(main())
