"""Plain-XLA stencil arithmetic.

Two forms of one correlation, each as a "valid" convolution (the output
is the input shrunk by the stencil radius on every side):

* `dense_valid`     -- one shifted slice-add per nonzero coefficient;
* `separable_valid` -- per rank-1 term, a 1-D tap convolution per axis,
                       plus the sparse residue (the low-rank form).

`dense_step` / `separable_step` wrap them over the reference-compatible
padded layout: they write the stencil into the interior and zero the
halo, matching the reference's multi-step semantics (utils/reference.py).
The engines' plain step (ops/plain.py) applies the same valid forms to
their internal layouts.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..models.shapes import StencilSpec


def dense_valid(x: jax.Array, spec: StencilSpec) -> jax.Array:
    """Valid correlation, one shifted slice per nonzero tap: the output
    is ``x`` shrunk by ``spec.radius`` on every axis."""
    S = spec.dense_coeffs()
    r = spec.radius
    out_shape = tuple(s - 2 * r for s in x.shape)
    acc = None
    for idx in np.argwhere(np.abs(S) > 0):
        w = float(S[tuple(idx)])
        src = tuple(slice(int(i), int(i) + s)
                    for i, s in zip(idx, out_shape))
        contrib = w * x[src]
        acc = contrib if acc is None else acc + contrib
    return acc if acc is not None else jnp.zeros(out_shape, x.dtype)


def separable_valid(x: jax.Array, spec: StencilSpec) -> jax.Array:
    """Valid correlation in low-rank form: per rank-1 term one 1-D tap
    convolution per axis (identity axes are slices), plus the sparse
    residue as shifted slices.  Same output as :func:`dense_valid`."""
    r = spec.radius
    out_shape = tuple(s - 2 * r for s in x.shape)
    acc = None
    for term in spec.terms:
        cur = x
        for a, taps in enumerate(term.taps):
            rt = 0 if taps is None else (len(taps) - 1) // 2
            ext = tuple(slice(0, s) for s in cur.shape)
            cur = _axis_conv(
                cur, taps if taps is not None else (1.0,), a,
                ext[:a] + (slice(r, r + out_shape[a]),) + ext[a + 1:],
                rt)
        acc = cur if acc is None else acc + cur
    for off, w in spec.residue:
        src = tuple(slice(r + o, r + o + s)
                    for o, s in zip(off, out_shape))
        contrib = w * x[src]
        acc = contrib if acc is None else acc + contrib
    return acc if acc is not None else jnp.zeros(out_shape, x.dtype)


def _padded_step(grid: jax.Array, spec: StencilSpec, valid) -> jax.Array:
    if grid.ndim != spec.ndim:
        raise ValueError(
            f"grid is {grid.ndim}-D but stencil {spec.name!r} is "
            f"{spec.ndim}-D")
    r = spec.radius
    it = tuple(slice(h, s - h) for h, s in zip(spec.halo, grid.shape))
    win = grid[tuple(slice(h - r, s - h + r)
                     for h, s in zip(spec.halo, grid.shape))]
    return jnp.zeros_like(grid).at[it].set(
        valid(win, spec).astype(grid.dtype))


def dense_step(grid: jax.Array, spec: StencilSpec) -> jax.Array:
    """Naive stencil on a padded grid: one shifted slice per nonzero
    tap into the interior, halo zeroed."""
    return _padded_step(grid, spec, dense_valid)


def separable_step(grid: jax.Array, spec: StencilSpec) -> jax.Array:
    """Low-rank stencil on a padded grid (per-term chained 1-D convs
    plus residue) into the interior, halo zeroed."""
    return _padded_step(grid, spec, separable_valid)


def conv_full(grid: jax.Array, spec: StencilSpec) -> jax.Array:
    """Unmasked correlation over the FULL padded extent (zero boundary):
    out[p] = sum_o S[o] * grid[p+o] for every p, reads beyond the array
    treated as zero.  This is the final factor of the adjoint chain
    (engine.run_diff): unlike dense_step it writes halo positions too
    (the gradient with respect to the input halo is nonzero -- step one
    of the forward pass reads it)."""
    S = spec.dense_coeffs()
    r = spec.radius
    gp = jnp.pad(grid, r)
    acc = None
    for idx in np.argwhere(np.abs(S) > 0):
        w = float(S[tuple(idx)])
        src = tuple(slice(int(i), int(i) + s)
                    for i, s in zip(idx, grid.shape))
        contrib = w * gp[src]
        acc = contrib if acc is None else acc + contrib
    if acc is None:
        acc = jnp.zeros_like(grid)
    return acc.astype(grid.dtype)


def _axis_conv(x, taps, axis, out_extent_slices, r):
    """1-D correlation of radius ``r`` along ``axis``: the output has the
    extent of ``out_extent_slices`` (a per-axis slice tuple into x)."""
    acc = None
    for k, w in enumerate(taps):
        if w == 0.0:
            continue
        src = list(out_extent_slices)
        sl = src[axis]
        src[axis] = slice(sl.start + k - r, sl.stop + k - r)
        contrib = x[tuple(src)] if w == 1.0 else w * x[tuple(src)]
        acc = contrib if acc is None else acc + contrib
    if acc is None:
        acc = jnp.zeros(
            tuple(sl.stop - sl.start for sl in out_extent_slices),
            dtype=x.dtype,
        )
    return acc
