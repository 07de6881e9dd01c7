"""NumPy float64 ground truth for all stencil shapes.

Reproduces the semantics of the reference's ``test_cpu`` verifiers
(``reference/src/1d/main.cu:34-40``, ``src/2d/main.cu:38-93``,
``src/3d/main.cu:33-68``) and its multi-step behavior:

* State is the *padded* array (interior + halo of width ``spec.halo``).
* One step writes the dense stencil into the interior only; every halo
  cell of the output is zero (the reference's device output buffers are
  zero-initialized and kernels write interior tiles only, so halo values
  decay to zero after the first step -- SURVEY.md section 4).
* The first step therefore sees the *user-provided* halo values; later
  steps see zeros.
"""

from __future__ import annotations

import numpy as np

from ..models.shapes import StencilSpec


def interior_slices(spec: StencilSpec, padded_shape):
    """Slices selecting the interior of a padded array."""
    return tuple(
        slice(h, s - h) for h, s in zip(spec.halo, padded_shape)
    )


def dense_step(grid: np.ndarray, spec: StencilSpec,
               prefer_native: bool = True) -> np.ndarray:
    """One stencil step on a padded grid; returns the new padded grid
    (interior = stencil, halo = 0).  float64 throughout.

    Dispatches to the threaded C++ twin (``native.dense_step``) when the
    shared library is built -- the same fp64 semantics, parity-asserted
    in tests/test_native.py, but fast enough to ``--check`` full-size
    grids.  ``prefer_native=False`` forces the NumPy path (ground truth
    for the parity tests themselves)."""
    grid = np.asarray(grid, dtype=np.float64)
    assert grid.ndim == spec.ndim
    if prefer_native:
        from .. import native

        if native.available():
            return native.dense_step(grid, spec.dense_coeffs(), spec.halo)
    S = spec.dense_coeffs()
    r = spec.radius
    out = np.zeros_like(grid)
    it = interior_slices(spec, grid.shape)
    acc = np.zeros(out[it].shape, dtype=np.float64)
    for idx in np.argwhere(np.abs(S) > 0):
        w = S[tuple(idx)]
        off = [int(i) - r for i in idx]
        src = tuple(
            slice(sl.start + o, sl.stop + o) for sl, o in zip(it, off)
        )
        acc += w * grid[src]
    out[it] = acc
    return out


def run(grid0: np.ndarray, spec: StencilSpec, steps: int) -> np.ndarray:
    """``steps`` stencil steps from the user-provided padded grid."""
    g = np.asarray(grid0, dtype=np.float64)
    for _ in range(steps):
        g = dense_step(g, spec)
    return g


def run_periodic(grid0: np.ndarray, spec: StencilSpec,
                 steps: int) -> np.ndarray:
    """Periodic-wrap ground truth over the padded layout: the interior
    evolves as out[p] = sum_o S[o] * in[(p+o) mod n] (np.roll); the halo
    cells of the result are zero (the engine's output guard ring is the
    zero donor ring -- only the interior is written).  The input halo is
    ignored (the wrap defines the neighbors)."""
    shape = grid0.shape
    it = interior_slices(spec, shape)
    g = np.asarray(grid0, np.float64)[it]
    S = spec.dense_coeffs()
    r = spec.radius
    for _ in range(steps):
        acc = np.zeros_like(g)
        for idx in np.argwhere(np.abs(S) > 0):
            off = tuple(int(i) - r for i in idx)
            acc += float(S[tuple(idx)]) * np.roll(
                g, tuple(-o for o in off), axis=tuple(range(g.ndim)))
        g = acc
    out = np.zeros(shape, np.float64)
    out[it] = g
    return out


def run_reflect(grid0: np.ndarray, spec: StencilSpec,
                steps: int) -> np.ndarray:
    """Reflect (symmetric / zero-flux) ground truth: each step pads the
    interior with np.pad(mode='symmetric') by the radius, correlates,
    and crops.  Result halo cells are zero (like run_periodic)."""
    shape = grid0.shape
    it = interior_slices(spec, shape)
    g = np.asarray(grid0, np.float64)[it]
    S = spec.dense_coeffs()
    r = spec.radius
    for _ in range(steps):
        gp = np.pad(g, r, mode="symmetric")
        acc = np.zeros_like(g)
        for idx in np.argwhere(np.abs(S) > 0):
            sl = tuple(slice(int(i), int(i) + s)
                       for i, s in zip(idx, g.shape))
            acc += float(S[tuple(idx)]) * gp[sl]
        g = acc
    out = np.zeros(shape, np.float64)
    out[it] = g
    return out


def conv_full(grid: np.ndarray, spec: StencilSpec) -> np.ndarray:
    """Unmasked correlation over the FULL padded extent in float64:
    out[p] = sum_o S[o] * grid[p+o] for every p, reads beyond the array
    treated as zero.  Host twin of ops/xla_ref.conv_full -- the final
    factor of the adjoint chain (engine.run_vjp), writing halo positions
    too (step one of the forward pass reads the input halo)."""
    grid = np.asarray(grid, np.float64)
    S = spec.dense_coeffs()
    r = spec.radius
    gp = np.pad(grid, r)
    acc = np.zeros_like(grid)
    for idx in np.argwhere(np.abs(S) > 0):
        src = tuple(slice(int(i), int(i) + s)
                    for i, s in zip(idx, grid.shape))
        acc += S[tuple(idx)] * gp[src]
    return acc


def fold_adjoint_step(y: np.ndarray, spec_flipped: StencilSpec
                      ) -> np.ndarray:
    """One float64 adjoint step of the reflect operator
    R = crop-conv o pad_sym: R^T = pad_sym^T o conv^T.  conv^T is the
    flipped correlation scattered onto the padded extent; pad_sym^T
    FOLDS each ghost strip back onto the interior cells it mirrored.
    ``y`` is an interior-extent array.  Host twin of
    engine._fold_adjoint_step (the df64 tier's reflect adjoint runs in
    exact host fp64 -- engine.run_vjp)."""
    r = spec_flipped.radius
    z = conv_full(np.pad(np.asarray(y, np.float64), r), spec_flipped)

    def at(sl, a, nd):
        t = [slice(None)] * nd
        t[a] = sl
        return tuple(t)

    for a in range(z.ndim):
        nd = z.ndim
        core = z[at(slice(r, z.shape[a] - r), a, nd)].copy()
        left = np.flip(z[at(slice(0, r), a, nd)], axis=a)
        right = np.flip(z[at(slice(z.shape[a] - r, None), a, nd)], axis=a)
        na = core.shape[a]
        core[at(slice(0, r), a, nd)] += left
        core[at(slice(na - r, None), a, nd)] += right
        z = core
    return z


def random_padded(spec: StencilSpec, interior, seed: int = 0,
                  lo: int = 0, hi: int = 100) -> np.ndarray:
    """Random integer-valued padded grid, mirroring the reference's
    FILL_RANDOM over the whole padded buffer, halo included.  The 2-D/3-D
    drivers use rand() % 100 (``src/2d/main.cu:232-235``); the 1-D driver
    uses rand() % 10000 (``src/1d/main.cu:105-108``) -- a scaling
    difference only, so one %100 generator serves all shapes here."""
    rng = np.random.default_rng(seed)
    shape = spec.padded_shape(interior)
    return rng.integers(lo, hi, size=shape).astype(np.float64)
