"""The plain step: ``fused_steps`` timesteps on an internal layout in
plain ``jax.numpy``, compiled by XLA on every platform.

Contract (shared with the 2-D Hopper kernel, ops/hopper2d.py):

    step(cur, donor, spec, layout, fused_steps, bounds, region) -> next

* ``cur``: the internal buffer (ops/layout.py).  Its guard ring holds the
  cells a pass reads beyond the interior -- the user halo on step one,
  exchanged neighbour data in a sharded run, ghost cells under
  periodic/reflect boundaries.
* ``donor``: the buffer the result is written into.  Only the interior
  extent (tile round-up included) is overwritten; its guard ring is kept,
  which is how halo cells decay to zero after step one.
* ``fused_steps = k``: the pass reads a window ``k * radius`` cells deep
  into the guard and applies k steps, each shrinking the extent by the
  radius.
* ``bounds``: after every substep, cells outside the box
  ``[lo, hi)`` per axis (interior coordinates) are zeroed -- the
  reference's halo decay and the tile round-up guard.  None means the
  true interior.  Sharded runs and ghost boundaries pass a box that
  reaches into the ring so exchanged or ghost cells survive the
  intermediate substeps.  3-D accepts 4 entries (in-plane only; z spans
  the interior) or 6.
* ``region``: tile-index window the call writes (the sharded engine's
  boundary frame / interior split); None means the whole grid.
* ``pair``: the state is a stacked ``(2, *layout.shape)`` df64 pair
  (ops/df64.py) and every substep runs the error-free pair chain.

bf16 state is stored bf16 and computed in fp32; float32 and float64 are
computed in their own precision.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models.shapes import StencilSpec
from . import df64 as _df64
from . import xla_ref
from .layout import COL_ALIGN, Layout1D, Layout2D, Layout3D


def geometry(layout):
    """Per-axis ``(origin, extent, interior, tile)`` of a layout, with
    1-D layouts seen as their flat view.  ``tile`` is None on axes that
    are not tiled (the 3-D z axis)."""
    if isinstance(layout, Layout2D):
        (gi, gj), (tm, tn) = layout.grid, layout.tile
        return (layout.origin, (gi * tm, gj * tn), layout.interior,
                (tm, tn))
    if isinstance(layout, Layout3D):
        (gi, gj), (tm, tn) = layout.grid, layout.tile
        h = layout.interior[0]
        return (layout.origin, (h, gi * tm, gj * tn), layout.interior,
                (None, tm, tn))
    if isinstance(layout, Layout1D):
        t = layout.tile_rows * COL_ALIGN
        return ((layout.origin,), (layout.grid[0] * t,),
                (layout.interior,), (t,))
    raise TypeError(f"unknown layout {type(layout).__name__}")


def region_cells(layout, region):
    """Per-axis ``(lo, hi)`` cell ranges (interior coordinates) of a
    tile-index ``region``; the full extent when ``region`` is None."""
    _, extent, _, tile = geometry(layout)
    if region is None:
        return tuple((0, e) for e in extent)
    if isinstance(layout, Layout1D):
        region = (region,)
    tiled = [a for a, t in enumerate(tile) if t is not None]
    out = [(0, e) for e in extent]
    for a, (t0, t1) in zip(tiled, region):
        out[a] = (t0 * tile[a], min(t1 * tile[a], extent[a]))
    return tuple(out)


def _bounds_pairs(bounds, interior):
    """Normalize ``bounds`` to one ``(lo, hi)`` pair per axis (None ->
    the true interior; 3-D plane-only bounds get the full z span)."""
    nd = len(interior)
    if bounds is None:
        return tuple((0, s) for s in interior), True
    b = jnp.asarray(bounds, jnp.int32)
    if nd == 3 and b.shape[0] == 4:
        pairs = [(0, interior[0])]
        pairs += [(b[2 * i], b[2 * i + 1]) for i in range(2)]
        return tuple(pairs), False
    return tuple((b[2 * i], b[2 * i + 1]) for i in range(nd)), False


def _mask(val, starts, pairs, skip):
    """Zero the cells of ``val`` (whose cell 0 sits at ``starts`` in
    interior coordinates) outside the per-axis ``pairs`` boxes; axes in
    ``skip`` cannot hold such cells and are left alone."""
    keep = None
    nd = len(starts)
    lead = val.ndim - nd
    for a, (s0, (lo, hi)) in enumerate(zip(starts, pairs)):
        if a in skip:
            continue
        c = jnp.arange(val.shape[lead + a], dtype=jnp.int32) + s0
        ok = (c >= lo) & (c < hi)
        ok = ok.reshape((-1,) + (1,) * (nd - 1 - a))
        keep = ok if keep is None else keep & ok
    if keep is None:
        return val
    return jnp.where(keep, val, jnp.zeros((), val.dtype))


def compute_dtype(dtype):
    """Arithmetic dtype of a state dtype: bf16 computes in fp32."""
    dtype = jnp.dtype(dtype)
    return jnp.dtype(jnp.float32) if dtype == jnp.bfloat16 else dtype


def step(cur: jax.Array, donor: jax.Array, spec: StencilSpec, layout,
         fused_steps: int = 1, bounds=None, region=None,
         pair: bool = False) -> jax.Array:
    """``fused_steps`` timesteps of ``spec`` (see the module docstring)."""
    origin, extent, interior, _ = geometry(layout)
    k, r = max(1, fused_steps), spec.radius
    d = k * r
    if any(o < d for o in origin):
        raise ValueError(
            f"fused_steps={k} reads {d} cells into the guard; the "
            f"layout's guard is {origin}")
    cells = region_cells(layout, region)
    lead = (2,) if pair else ()
    flat = isinstance(layout, Layout1D)
    x = cur.reshape(lead + (-1,)) if flat else cur
    win = x[(Ellipsis,) + tuple(slice(o + lo - d, o + hi + d)
                                for o, (lo, hi) in zip(origin, cells))]
    pairs, static = _bounds_pairs(bounds, interior)
    if not pair:
        win = win.astype(compute_dtype(cur.dtype))
    val = win
    for s in range(k):
        if pair:
            val = jnp.stack(_df64.pair_valid(val[0], val[1], spec))
        else:
            # one shifted slice per nonzero tap: XLA fuses a step into one
            # pass, where the separable form materializes each term's
            # first 1-D pass (PERF.md, Findings)
            val = xla_ref.dense_valid(val, spec)
        e = (k - 1 - s) * r
        final = s == k - 1
        # static bounds on the last substep: an axis whose written
        # extent lies inside the interior has nothing to zero
        skip = {a for a, ((lo, hi), n) in enumerate(zip(cells, interior))
                if final and static and hi <= n}
        val = _mask(val, tuple(lo - e for lo, _ in cells), pairs, skip)
    out = donor.reshape(lead + (-1,)) if flat else donor
    out = out.at[(Ellipsis,) + tuple(slice(o + lo, o + hi) for o, (lo, hi)
                                     in zip(origin, cells))].set(
        val.astype(donor.dtype))
    return out.reshape(donor.shape)
