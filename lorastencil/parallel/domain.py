"""Multi-chip domain decomposition: shard_map + ppermute halo exchange.

The reference is strictly single-GPU (SURVEY.md section 2, parallelism
checklist); large-grid scaling is new capability.  The grid's interior is
decomposed over a 1-, 2- or 3-D device mesh; each device owns a local
internal-layout buffer (ops/layout.py) whose guard ring doubles as the
halo-receive buffer.  Per step:

  1. neighbor exchange with ``jax.lax.ppermute`` (NCCL on GPUs) -- a
     two-phase (rows, then halo-extended columns) exchange so corner
     halos ride along; devices on the global boundary receive ppermute's
     fill value (zero), which IS the reference's decaying Dirichlet-0
     halo semantics;
  2. the single-device step (ops/plain.py contract: the 2-D Hopper
     kernel or the plain XLA step, as backend.py decides) runs on the
     local buffer.

Every device of the mesh holds one block: ``make_mesh`` lays
``jax.devices()`` out in order, one block per device.

The whole multi-step loop is one jitted shard_map program.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import backend as _backend
from ..models.shapes import StencilSpec, get_shape
from ..ops import hopper2d, plain
from ..ops.layout import Layout2D, default_tile_2d


def _shift(x, axis_name: str, fwd: bool, npairs: int,
           wrap: bool = False):
    """Neighbor ppermute along a mesh axis.  Non-wrapping by default
    (devices with no source receive zeros -- the reference's Dirichlet
    edge); ``wrap=True`` closes the ring (periodic boundaries)."""
    if npairs == 1:
        return x if wrap else jnp.zeros_like(x)
    if wrap:
        perm = ([(i, (i + 1) % npairs) for i in range(npairs)] if fwd
                else [((i + 1) % npairs, i) for i in range(npairs)])
    else:
        perm = ([(i, i + 1) for i in range(npairs - 1)] if fwd
                else [(i + 1, i) for i in range(npairs - 1)])
    return jax.lax.ppermute(x, axis_name, perm)


def _check_reflect_fused(spec: StencilSpec, config) -> None:
    if config.boundary != "reflect" or max(1, config.fused_steps) <= 1:
        return
    if not spec.axis_symmetric():
        raise ValueError(
            "sharded reflect boundaries with fused_steps > 1 need "
            "per-axis symmetric coefficients (mirror symmetry must "
            "commute with the stencil); use fused_steps=1")


def _take(buf, start, size: int, axis: int):
    """``size`` cells along ``axis`` from ``start`` -- which is a plain
    int on the static path (divisible blocks; XLA folds it) or a traced
    per-device scalar on the tailed ghost path."""
    return jax.lax.dynamic_slice_in_dim(buf, start, size, axis=axis)


def _put(buf, vals, start, axis: int):
    return jax.lax.dynamic_update_slice_in_dim(buf, vals, start,
                                               axis=axis)


def _check_tails(boundary: str, tails, depth: int, mesh_shape) -> None:
    """Ghost modes wrap/mirror at the TRUE global edge, which for the
    last device along an axis sits ``tail`` cells into its (padded)
    block; the ghost machinery needs ``depth`` real cells on its inside
    (and the far-side wrap source reads the same strip)."""
    if boundary == "dirichlet0":
        return
    for t in tails:
        if t < depth:
            raise ValueError(
                f"boundary={boundary!r}: the last device's true block "
                f"tail ({t} cells) is smaller than the exchange depth "
                f"{depth} on mesh {tuple(mesh_shape)}; use fewer "
                f"devices or lower fused_steps")


def _pad_local_block(lm: int, ln: int, tile, explicit_tile: bool):
    """dirichlet0 local-block padding, shared by the 2-D and 3-D
    engines: round the block up to a tile multiple (no tile round-up
    region, so the exchanged guard ring never aliases interior tiles;
    padded fake cells are bounds-masked to Dirichlet zero).  When
    padding to the default tile would waste > ~8% of the block (small
    local blocks), a zero-waste divisor tile wins instead.
    Returns (lm, ln, tile)."""
    from ..ops.layout import COL_ALIGN, ROW_ALIGN, divisor_tile_2d

    bm = ROW_ALIGN * (-(-lm // ROW_ALIGN))
    bn = COL_ALIGN * (-(-ln // COL_ALIGN))
    if not explicit_tile and (bm % tile[0] or bn % tile[1]):
        pad = (tile[0] * (-(-bm // tile[0]))
               * tile[1] * (-(-bn // tile[1])))
        if pad > 1.08 * bm * bn:
            tile = divisor_tile_2d(bm, bn)
    return (tile[0] * (-(-bm // tile[0])),
            tile[1] * (-(-bn // tile[1])), tile)


def _block_backend(spec: StencilSpec, config, pair: bool = False) -> str:
    """The per-block step path of a sharded engine (backend.resolve):
    the 2-D kernel only for fp32/bf16 2-D state."""
    applies = (not pair and config.dtype != "df64"
               and hopper2d.applies(spec, jnp.dtype(config.dtype)))
    return _backend.resolve(config.backend, kernel_applies=applies,
                            fused_steps=config.fused_steps)


def make_mesh(shape: Tuple[int, ...], axis_names=("x", "y"),
              devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = int(np.prod(shape))
    assert len(devices) >= n, f"need {n} devices, have {len(devices)}"
    arr = np.array(devices[:n]).reshape(shape)
    return Mesh(arr, axis_names[: len(shape)])


@dataclasses.dataclass(frozen=True)
class ShardedConfig:
    # devices per grid axis: (rows, cols) for 2-D/3-D plane meshes, (n,)
    # for 1-D, or (z, rows, cols) for 3-D meshes that also decompose the
    # z axis (SURVEY section 5 long-context row; the z-sweep pipeline
    # is the reference's 3-D scaling axis,
    # reference/src/3d/gpu_box.cu:126-139)
    mesh_shape: Tuple[int, ...]
    tile: Optional[Tuple[int, int]] = None
    # state dtype in device memory: "float32", "bfloat16" (half the
    # bytes AND half the exchanged halo bytes; computed in fp32,
    # ~4e-3/step storage rounding) or "df64" (fp32 pair state)
    dtype: str = "float32"
    # per-block step: "auto" / "xla" / "kernel" (backend.resolve)
    backend: str = "auto"
    # timesteps fused per halo exchange: one ppermute round per k
    # steps with k*radius-deep halos -- k fewer collectives per step.
    fused_steps: int = 1
    # overlap the halo exchange with interior compute (2-D): boundary
    # tiles compute first, their edge strips ppermute to the neighbors
    # WHILE the interior tiles compute (no data dependency between the
    # collective and the interior kernel, so XLA's async collectives ride
    # under it), and the received ring lands in the output buffer for the
    # NEXT pass.  Falls back to the sequential exchange when the local
    # tile grid is too small to split (< 3 tiles per axis).
    overlap: bool = True
    # boundary condition: "dirichlet0" (reference halo-decay
    # semantics), "periodic" (the GLOBAL grid wraps: the ring ppermute
    # closes into a torus) or "reflect" (global-edge devices mirror
    # their own edge strip; interior exchange is unchanged)
    boundary: str = "dirichlet0"

    def __post_init__(self):
        if self.dtype not in ("float32", "bfloat16", "df64"):
            raise ValueError(
                f"sharded dtype must be 'float32', 'bfloat16' or "
                f"'df64', got {self.dtype!r}")
        if self.boundary not in ("dirichlet0", "periodic", "reflect"):
            raise ValueError(
                f"sharded boundary must be 'dirichlet0', 'periodic' or "
                f"'reflect', got {self.boundary!r}")
        if self.backend not in _backend.BACKENDS:
            raise ValueError(
                f"backend must be one of {_backend.BACKENDS}, got "
                f"{self.backend!r}")


class ShardedStencil2D:
    """Domain-decomposed 2-D stencil over a device mesh."""

    PAIR = False  # df64 pair state (the DF64 subclasses)

    def __init__(self, spec: StencilSpec, interior: Tuple[int, int],
                 config: ShardedConfig, mesh: Optional[Mesh] = None):
        assert spec.ndim == 2
        if config.dtype == "df64" and type(self) is ShardedStencil2D:
            raise ValueError(
                "dtype='df64' pair state needs ShardedStencilDF64 "
                "(sharded_engine routes there)")
        self.spec = spec
        self.config = config
        _check_reflect_fused(spec, config)
        gm, gn = interior
        dx, dy = config.mesh_shape
        self.interior = (gm, gn)
        self.mesh = mesh if mesh is not None else make_mesh((dx, dy))
        from ..ops.layout import COL_ALIGN, ROW_ALIGN

        self.backend = _block_backend(spec, config, self.PAIR)
        k = max(1, config.fused_steps)
        self.fused_steps = k
        lm, ln = -(-gm // dx), -(-gn // dy)
        tile = config.tile or default_tile_2d(lm, ln)
        # arbitrary global sizes shard via block padding (see
        # _pad_local_block).  Ghost modes
        # place the wrap/mirror ghost at the last device's TRUE tail
        # (tails below): fake cells beyond it are bounds-masked, so block
        # padding is safe for every boundary.
        lm, ln, tile = _pad_local_block(lm, ln, tile,
                                        config.tile is not None)
        self.local_interior = (lm, ln)
        # exchange depth per pass: k*radius cells feed the fused substeps
        self.depth = max(max(spec.halo), k * spec.radius)
        # true global-edge offsets within the LAST device's block along
        # each axis (== the block size when divisible -> the exchange
        # offsets stay static ints).  dirichlet0 keeps the static path:
        # its global edge needs no ghost source.
        if config.boundary == "dirichlet0":
            self.tails = (lm, ln)
        else:
            self.tails = (gm - (dx - 1) * lm, gn - (dy - 1) * ln)
        _check_tails(config.boundary, self.tails, self.depth, (dx, dy))
        guard_r = ROW_ALIGN * (-(-self.depth // ROW_ALIGN))
        assert self.depth <= COL_ALIGN
        assert self.depth <= min(lm, ln), (
            f"exchange depth {self.depth} exceeds the local block "
            f"{(lm, ln)}; use fewer devices or lower fused_steps")
        self.layout = Layout2D(interior=self.local_interior, halo=spec.halo,
                               tile=tile, guard=(guard_r, COL_ALIGN))
        self._run_jit = jax.jit(self._run, static_argnames=("steps",))

    # -- halo exchange ----------------------------------------------------
    def _hi_starts(self):
        """(row, col) local starts of the high-side ghost ring: the true
        global tail for the LAST device along each axis, the block edge
        otherwise.  Plain ints when the blocks divide (the exchange
        slices stay static); traced per-device scalars on the tailed
        ghost path (lax.dynamic_slice handles both)."""
        m, n = self.layout.interior
        tm, tn = self.tails
        dx, dy = self.config.mesh_shape
        rs = m if tm == m else jnp.where(
            jax.lax.axis_index("x") == dx - 1, tm, m)
        cs = n if tn == n else jnp.where(
            jax.lax.axis_index("y") == dy - 1, tn, n)
        return rs, cs

    def _exchange(self, buf):
        """Fill the local guard ring from neighbors (zero at the global
        boundary) to ``self.depth`` cells -- deep enough for a whole
        fused pass.  buf: local internal buffer.

        The high-side ring sits at the device's true-tail offset
        (_hi_starts): for the last device under a ghost boundary that is
        the true global edge INSIDE its padded block, so wrap/mirror
        sources and targets never touch fake padded cells."""
        hm = hn = self.depth
        r0, c0 = self.layout.origin
        dx, dy = self.config.mesh_shape

        wrap = self.config.boundary == "periodic"

        # Dirichlet: devices on the global boundary keep their existing
        # ring (the user-provided halo on step 1; zero afterwards),
        # matching the single-device reference semantics exactly.
        # Periodic: the ppermute ring closes into a torus and every
        # device takes the received strip.
        ix = jax.lax.axis_index("x")
        iy = jax.lax.axis_index("y")
        rs, cs = self._hi_starts()

        # phase 1: rows (axis 'x').  Send my top interior strip to the
        # north neighbor (it becomes their bottom ring) and vice versa.
        top = buf[r0: r0 + hm, :]
        bot = _take(buf, r0 + rs - hm, hm, 0)
        from_north = _shift(bot, "x", True, dx, wrap)
        from_south = _shift(top, "x", False, dx, wrap)
        refl = self.config.boundary == "reflect"
        edge_n = (jnp.flip(top, axis=0) if refl
                  else buf[r0 - hm: r0, :])
        edge_s = (jnp.flip(bot, axis=0) if refl
                  else _take(buf, r0 + rs, hm, 0))
        buf = buf.at[r0 - hm: r0, :].set(
            from_north if wrap else
            jnp.where(ix > 0, from_north, edge_n))
        buf = _put(buf,
                   from_south if wrap else
                   jnp.where(ix < dx - 1, from_south, edge_s),
                   r0 + rs, 0)

        # phase 2: cols (axis 'y'), strips include the just-filled ring
        # rows so corners propagate.
        left = buf[:, c0: c0 + hn]
        right = _take(buf, c0 + cs - hn, hn, 1)
        from_west = _shift(right, "y", True, dy, wrap)
        from_east = _shift(left, "y", False, dy, wrap)
        edge_w = (jnp.flip(left, axis=1) if refl
                  else buf[:, c0 - hn: c0])
        edge_e = (jnp.flip(right, axis=1) if refl
                  else _take(buf, c0 + cs, hn, 1))
        buf = buf.at[:, c0 - hn: c0].set(
            from_west if wrap else
            jnp.where(iy > 0, from_west, edge_w))
        buf = _put(buf,
                   from_east if wrap else
                   jnp.where(iy < dy - 1, from_east, edge_e),
                   c0 + cs, 1)
        return buf

    def _exchange_strips(self, buf):
        """Two-phase neighbor ppermute WITHOUT writing into ``buf``:
        returns the received ring strips (zeros at the global boundary --
        the reference's Dirichlet-0 decay).  Column strips span the full
        buffer height with the phase-1 row strips patched in, so corners
        propagate exactly as in the sequential exchange."""
        hm = hn = self.depth
        r0, c0 = self.layout.origin
        dx, dy = self.config.mesh_shape
        wrap = self.config.boundary == "periodic"
        ix = jax.lax.axis_index("x")
        rs, cs = self._hi_starts()

        top = buf[r0: r0 + hm, :]
        bot = _take(buf, r0 + rs - hm, hm, 0)
        from_north = _shift(bot, "x", True, dx, wrap)
        from_south = _shift(top, "x", False, dx, wrap)

        refl = self.config.boundary == "reflect"

        def col_strip(c_lo):
            s = _take(buf, c_lo, hn, 1)
            fn = _take(from_north, c_lo, hn, 1)
            fs = _take(from_south, c_lo, hn, 1)
            en = (jnp.flip(_take(top, c_lo, hn, 1), axis=0) if refl
                  else jnp.zeros_like(fn))
            es = (jnp.flip(_take(bot, c_lo, hn, 1), axis=0) if refl
                  else jnp.zeros_like(fs))
            s = s.at[r0 - hm: r0, :].set(
                fn if wrap else jnp.where(ix > 0, fn, en))
            s = _put(s, fs if wrap else jnp.where(ix < dx - 1, fs, es),
                     r0 + rs, 0)
            return s

        from_west = _shift(col_strip(c0 + cs - hn), "y", True, dy, wrap)
        from_east = _shift(col_strip(c0), "y", False, dy, wrap)
        return from_north, from_south, from_west, from_east

    def _write_ring(self, buf, parts):
        """Write received strips into the guard ring (unconditional: the
        ppermute already yields zeros at the global boundary)."""
        hm = hn = self.depth
        r0, c0 = self.layout.origin
        dx, dy = self.config.mesh_shape
        wrap = self.config.boundary == "periodic"
        refl = self.config.boundary == "reflect"
        ix = jax.lax.axis_index("x")
        iy = jax.lax.axis_index("y")
        rs, cs = self._hi_starts()
        from_north, from_south, from_west, from_east = parts
        en = (jnp.flip(buf[r0: r0 + hm, :], axis=0) if refl
              else jnp.zeros_like(from_north))
        es = (jnp.flip(_take(buf, r0 + rs - hm, hm, 0), axis=0) if refl
              else jnp.zeros_like(from_south))
        buf = buf.at[r0 - hm: r0, :].set(
            from_north if wrap else jnp.where(ix > 0, from_north, en))
        buf = _put(buf,
                   from_south if wrap else
                   jnp.where(ix < dx - 1, from_south, es),
                   r0 + rs, 0)
        # col mirrors read the buffer AFTER the row-ring writes so the
        # corners compose row-mirror x col-mirror (np.pad symmetric)
        ew = (jnp.flip(buf[:, c0: c0 + hn], axis=1) if refl
              else jnp.zeros_like(from_west))
        ee = (jnp.flip(_take(buf, c0 + cs - hn, hn, 1), axis=1) if refl
              else jnp.zeros_like(from_east))
        buf = buf.at[:, c0 - hn: c0].set(
            from_west if wrap else jnp.where(iy > 0, from_west, ew))
        buf = _put(buf,
                   from_east if wrap else
                   jnp.where(iy < dy - 1, from_east, ee),
                   c0 + cs, 1)
        return buf

    def _bounds(self):
        lm, ln = self.local_interior
        gm, gn = self.interior
        ix = jax.lax.axis_index("x")
        iy = jax.lax.axis_index("y")
        # global-interior bounds in local coordinates: interior devices
        # must not mask ring intermediates holding exchanged data; under
        # periodic the global-edge rings hold wrapped data too, so the
        # box widens by the exchange depth
        d = self.depth if self.config.boundary != "dirichlet0" else 0
        return jnp.stack([
            -ix * lm - d, gm - ix * lm + d,
            -iy * ln - d, gn - iy * ln + d,
        ]).astype(jnp.int32)

    def _kernel(self, cur, donor, fused_k, region=None):
        """One pass of the block step on the local buffer, masked to the
        global interior (the ops/plain.py contract)."""
        if self.backend == "kernel":
            return hopper2d.step(cur, donor, self.spec, self.layout,
                                 fused_steps=fused_k, bounds=self._bounds(),
                                 region=region)
        return plain.step(cur, donor, self.spec, self.layout,
                          fused_steps=fused_k, bounds=self._bounds(),
                          region=region, pair=self.PAIR)

    def _overlap_reason(self):
        """None when the overlapped exchange can run, else why not."""
        gi, gj = self.layout.grid
        TM, TN = self.layout.tile
        HR, HC = self.layout.guard
        tm, tn = self.tails
        lm, ln = self.local_interior
        if gi < 3 or gj < 3:
            return f"local tile grid {gi}x{gj} < 3x3"
        # interior tiles must not touch the ring, and the exchanged
        # strips must come out of the boundary tiles alone
        if HR > TM or HC > TN or self.depth > min(TM, TN):
            return "exchange depth exceeds the boundary tile"
        # tailed ghost modes read the TRUE-edge strip (at the tail
        # offset), which must also live in the last tile row/col
        if ((tm != lm and tm - self.depth < (gi - 1) * TM)
                or (tn != ln and tn - self.depth < (gj - 1) * TN)):
            return "true-tail edge strip lies outside the boundary tiles"
        return None

    def _can_overlap(self) -> bool:
        return self.config.overlap and self._overlap_reason() is None

    # -- per-device step ----------------------------------------------------
    def _local_step(self, cur, donor, fused_k):
        cur = self._exchange(cur)
        return self._kernel(cur, donor, fused_k)

    def _local_step_ringout(self, cur, donor, fused_k):
        """Small-grid step with the overlapped engine's DATAFLOW but a
        single full-grid kernel call: compute the whole block from
        ``cur`` (whose ring already holds this pass's neighbor data),
        then exchange the output's edge strips and write the received
        ring into the freshly produced output -- uniquely owned, so XLA
        updates it in place.  This replaces the exchange-into-input
        sequential step, whose ring writes materialize four full-buffer
        copies, whenever the tile grid is too small for a boundary
        frame.  The collective is not hidden under compute -- on a
        sub-3x3 tile grid there is no interior region to hide it under
        anyway."""
        out = self._kernel(cur, donor, fused_k)
        parts = self._exchange_strips(out)
        return self._write_ring(out, parts)

    def _local_step_overlap(self, cur, donor, fused_k):
        """One pass with the halo exchange OVERLAPPED with interior
        compute (SURVEY section 7 hard-part).

        ``cur``'s ring already holds the neighbor data for THIS pass
        (written at the end of the previous pass; the user halo initially).
        Boundary tiles compute first; the ppermute of their freshly
        written edge strips has no data dependency on the interior
        kernel, so XLA schedules the collective under it (async
        collective-permute on real meshes).  The received ring lands in
        the OUTPUT buffer, ready for the next pass."""
        gi, gj = self.layout.grid

        def step(inp, out_buf, region):
            return self._kernel(inp, out_buf, fused_k, region)

        # boundary frame first: it produces the edge strips to exchange
        out = step(cur, donor, ((0, 1), (0, gj)))
        out = step(cur, out, ((gi - 1, gi), (0, gj)))
        out = step(cur, out, ((1, gi - 1), (0, 1)))
        out = step(cur, out, ((1, gi - 1), (gj - 1, gj)))
        # start the exchange of out's edges; the interior kernel below
        # does not depend on it, so the collective rides under compute
        parts = self._exchange_strips(out)
        out = step(cur, out, ((1, gi - 1), (1, gj - 1)))
        return self._write_ring(out, parts)

    def _run(self, state, steps: int):
        """state: sharded stack of local buffers, shape
        (dx * Mp_loc, dy * Np_loc), sharded P('x', 'y')."""
        from jax import shard_map

        from ..engine import ping_pong_loop

        k = self.fused_steps
        if self._can_overlap() and int(np.prod(self.config.mesh_shape)) > 1:
            # >1 device: hide the collective under the interior tiles
            step_fn = self._local_step_overlap
        elif self.config.overlap:
            # overlap requested but the grid can't split into a
            # boundary frame: same ring-in-output dataflow, one call
            step_fn = self._local_step_ringout
        else:
            step_fn = self._local_step  # explicit overlap=False

        def body_fn(local):
            return ping_pong_loop(step_fn, local, steps, k)

        fn = shard_map(
            body_fn, mesh=self.mesh,
            in_specs=P("x", "y"), out_specs=P("x", "y"),
            check_vma=False,
        )
        return fn(state)

    # -- user API -----------------------------------------------------------
    def to_sharded(self, padded):
        """User global padded array -> sharded stack of local internal
        buffers (traceable; call inside jit for real runs).

        Each local buffer gets its interior plus a DEPTH-wide ring taken
        from the global array (neighbor interiors inside the grid, the
        user halo at the boundary, zeros beyond): pass 1 then needs no
        leading exchange -- the overlapped engine exchanges at the END of
        each pass for the next one."""
        spec, lay = self.spec, self.layout
        hm, hn = spec.halo
        gm, gn = self.interior
        lm, ln = self.local_interior
        dx, dy = self.config.mesh_shape
        Mp, Np = lay.shape
        r0, c0 = lay.origin
        d = self.depth
        padded = jnp.asarray(padded, jnp.float32)
        # the block-padded global extent (== (gm, gn) when divisible);
        # fake cells beyond the true interior stay zero = Dirichlet-0
        Gm, Gn = dx * lm, dy * ln
        gpad = jnp.zeros((Gm + 2 * d, Gn + 2 * d), jnp.float32)
        gpad = gpad.at[d - hm: d + gm + hm, d - hn: d + gn + hn].set(padded)
        if self.config.boundary == "periodic":
            # global wrap ring (pass 1 of the overlapped engine reads
            # it); the high-side ghost sits at the TRUE edge gm/gn --
            # block-padded cells beyond gm + d stay zero
            gpad = gpad.at[:d, d: d + gn].set(gpad[gm: gm + d, d: d + gn])
            gpad = gpad.at[d + gm: 2 * d + gm, d: d + gn].set(
                gpad[d: 2 * d, d: d + gn])
            gpad = gpad.at[:, :d].set(gpad[:, gn: gn + d])
            gpad = gpad.at[:, d + gn: 2 * d + gn].set(gpad[:, d: 2 * d])
        elif self.config.boundary == "reflect":
            gpad = gpad.at[:d, d: d + gn].set(
                jnp.flip(gpad[d: 2 * d, d: d + gn], axis=0))
            gpad = gpad.at[d + gm: 2 * d + gm, d: d + gn].set(
                jnp.flip(gpad[gm: gm + d, d: d + gn], axis=0))
            gpad = gpad.at[:, :d].set(jnp.flip(gpad[:, d: 2 * d], axis=1))
            gpad = gpad.at[:, d + gn: 2 * d + gn].set(
                jnp.flip(gpad[:, gn: gn + d], axis=1))
        out = jnp.zeros((dx * Mp, dy * Np), jnp.float32)
        for i in range(dx):
            for j in range(dy):
                src = gpad[i * lm: i * lm + lm + 2 * d,
                           j * ln: j * ln + ln + 2 * d]
                out = out.at[
                    i * Mp + r0 - d: i * Mp + r0 + lm + d,
                    j * Np + c0 - d: j * Np + c0 + ln + d,
                ].set(src)
        return jax.lax.with_sharding_constraint(
            out.astype(jnp.dtype(self.config.dtype)),
            NamedSharding(self.mesh, P("x", "y")))

    def from_sharded(self, state):
        """Sharded local buffers -> user global padded array."""
        spec, lay = self.spec, self.layout
        hm, hn = spec.halo
        lm, ln = self.local_interior
        dx, dy = self.config.mesh_shape
        Mp, Np = lay.shape
        r0, c0 = lay.origin
        gm, gn = self.interior
        out = jnp.zeros((gm + 2 * hm, gn + 2 * hn), state.dtype)
        for i in range(dx):
            tm = min(lm, gm - i * lm)  # clamp the block-padded tail
            if tm <= 0:
                continue
            for j in range(dy):
                tn = min(ln, gn - j * ln)
                if tn <= 0:
                    continue
                block = state[i * Mp + r0: i * Mp + r0 + tm,
                              j * Np + c0: j * Np + c0 + tn]
                out = out.at[hm + i * lm: hm + i * lm + tm,
                             hn + j * ln: hn + j * ln + tn].set(block)
        return out

    def run(self, padded, steps: int):
        """One jitted program end-to-end (embed -> exchange+steps ->
        extract)."""
        if not hasattr(self, "_full_jit"):
            self._full_jit = jax.jit(
                lambda g, steps: self.from_sharded(
                    self._run(self.to_sharded(g), steps)),
                static_argnames=("steps",),
            )
        return self._full_jit(padded, steps=steps)

    def run_checksum(self, padded, steps: int):
        """Like run() but returns only a replicated scalar checksum --
        the timing entry point (syncs execution without the full
        device-to-host copy)."""
        if not hasattr(self, "_checksum_jit"):
            self._checksum_jit = jax.jit(
                lambda g, steps: jnp.sum(
                    self._run(self.to_sharded(g), steps)
                    .astype(jnp.float32)),
                static_argnames=("steps",),
            )
        return self._checksum_jit(padded, steps=steps)


class ShardedStencilDF64(ShardedStencil2D):
    """Domain-decomposed fp64-grade 2-D stencil: double-float fp32 pair
    state over a device mesh.

    The reference's native-fp64 regime
    (reference/src/1d/1d_utils.h:44, src/2d/gpu.cu:31-273) is
    strictly single-GPU.  State is a stacked (2, dx*Mp, dy*Np) fp32
    array sharded P(None, 'x', 'y'): the hi/lo planes ride the SAME
    two-phase ppermute halo exchange as the fp32 tier (vmapped over the
    pair axis, so each phase stays one collective with a doubled
    payload), and each device runs the plain pair step (ops/plain.py,
    ``pair=True``) on its local block with the dynamic global-interior
    bounds.

    Boundary conditions: dirichlet0, periodic and reflect (ring
    copies/flips are exact on (hi, lo) pairs).  Overlap uses the
    ring-in-output dataflow (_local_step_ringout): the pair step is not
    split into boundary/interior regions.
    """

    PAIR = True

    def __init__(self, spec: StencilSpec, interior: Tuple[int, int],
                 config: ShardedConfig, mesh: Optional[Mesh] = None):
        if config.dtype != "df64":
            raise ValueError("ShardedStencilDF64 needs dtype='df64'")
        super().__init__(spec, interior,
                         dataclasses.replace(config, dtype="float32"), mesh)

    # -- per-device step (pair state) -------------------------------------
    def _local_step(self, cur2, donor2, fused_k):
        cur2 = jax.vmap(self._exchange)(cur2)
        return self._kernel(cur2, donor2, fused_k)

    def _local_step_ringout(self, cur2, donor2, fused_k):
        """Ring-in-output pass: cur2's ring already holds this pass's
        neighbor data; the fresh output's edge strips exchange after the
        step and the received ring lands in the (uniquely owned)
        output, ready for the next pass."""
        out2 = self._kernel(cur2, donor2, fused_k)
        parts = jax.vmap(self._exchange_strips)(out2)
        return jax.vmap(self._write_ring)(out2, parts)

    def _run(self, state2, steps: int):
        """state2: (2, dx*Mp, dy*Np) fp32 pair stack, P(None, 'x', 'y')."""
        from jax import shard_map

        from ..engine import ping_pong_loop

        step_fn = (self._local_step_ringout if self.config.overlap
                   else self._local_step)

        def body_fn(local2):
            return ping_pong_loop(step_fn, local2, steps, self.fused_steps)

        fn = shard_map(
            body_fn, mesh=self.mesh,
            in_specs=P(None, "x", "y"), out_specs=P(None, "x", "y"),
            check_vma=False,
        )
        return fn(state2)

    # -- user API ---------------------------------------------------------
    def to_sharded(self, pair):
        """(2, gm+2h, gn+2h) fp32 hi/lo planes (ops/df64.split_host) ->
        sharded (2, dx*Mp, dy*Np) pair stack."""
        embed = ShardedStencil2D.to_sharded
        out = jnp.stack([embed(self, pair[0]), embed(self, pair[1])])
        return jax.lax.with_sharding_constraint(
            out, NamedSharding(self.mesh, P(None, "x", "y")))

    def from_sharded(self, state2):
        extract = ShardedStencil2D.from_sharded
        return jnp.stack([extract(self, state2[0]),
                          extract(self, state2[1])])

    def run(self, padded, steps: int):
        """User global fp64 padded array in, fp64 NumPy out (pair
        split/merge on the host; one jitted program in between)."""
        from ..ops import df64 as _df64

        pair = _df64.split_host(np.asarray(padded))
        if not hasattr(self, "_full_jit"):
            self._full_jit = jax.jit(
                lambda p, steps: self.from_sharded(
                    self._run(self.to_sharded(p), steps)),
                static_argnames=("steps",),
            )
        return _df64.merge_host(np.asarray(self._full_jit(pair,
                                                          steps=steps)))

    def run_checksum(self, padded, steps: int):
        from ..ops import df64 as _df64

        pair = _df64.split_host(np.asarray(padded))
        if not hasattr(self, "_checksum_jit"):
            self._checksum_jit = jax.jit(
                lambda p, steps: jnp.sum(
                    self._run(self.to_sharded(p), steps)),
                static_argnames=("steps",),
            )
        return self._checksum_jit(pair, steps=steps)


class ShardedStencil3D:
    """Domain-decomposed 3-D stencil.  ``mesh_shape=(dx, dy)`` shards the
    (row, col) plane axes over a 2-D mesh (every device keeps its whole
    z extent); ``mesh_shape=(dz, dx, dy)`` also decomposes the z axis over
    a 3-D mesh: a z-plane ppermute phase runs before the (rows, cols)
    phases, the z guard planes double as the z halo-receive buffer, and
    later phases' strips carry the earlier phases' received data so the
    8 corner octants propagate exactly (the 3-axis generalization of the
    two-phase corner ride-along)."""

    PAIR = False  # df64 pair state (ShardedStencilDF64_3D)

    def __init__(self, spec: StencilSpec, interior, config: ShardedConfig,
                 mesh: Optional[Mesh] = None):
        assert spec.ndim == 3
        from ..ops.layout import (COL_ALIGN, ROW_ALIGN, Layout3D,
                                  default_tile_3d)

        if config.dtype == "df64" and type(self) is ShardedStencil3D:
            raise ValueError(
                "dtype='df64' pair state needs ShardedStencilDF64_3D "
                "(sharded_engine dispatches there)")
        self.spec = spec
        self.config = config
        _check_reflect_fused(spec, config)
        h, gm, gn = interior
        ms = tuple(config.mesh_shape)
        if len(ms) == 3:
            dz, dx, dy = ms
        else:
            dz, (dx, dy) = 1, ms
        self.dz, self.dxy = dz, (dx, dy)
        self.interior = tuple(interior)
        if mesh is not None:
            self.mesh = mesh
        elif dz > 1:
            self.mesh = make_mesh((dz, dx, dy), ("z", "x", "y"))
        else:
            self.mesh = make_mesh((dx, dy))
        k = max(1, config.fused_steps)
        self.fused_steps = k
        lm, ln = -(-gm // dx), -(-gn // dy)
        tile = config.tile or default_tile_3d(lm, ln)
        # arbitrary global sizes shard via block padding for EVERY
        # boundary (see _pad_local_block and the 2-D twin: ghost modes
        # anchor the wrap/mirror at the last device's true tail)
        lm, ln, tile = _pad_local_block(lm, ln, tile,
                                        config.tile is not None)
        # z blocks need no alignment (planes are the leading
        # axis); non-divisible H pads the last block, masked via bounds
        lz = -(-h // dz)
        self.local_interior = (lz, lm, ln)
        # exchange depth per pass: k*radius cells feed the fused substeps
        # (the in-plane window guard is ROW_ALIGN rows / COL_ALIGN cols)
        self.depth = max(max(spec.halo[1:]), k * spec.radius)
        zd = max(spec.halo[0], k * spec.radius)
        self.zdepth = zd
        if config.boundary == "dirichlet0":
            self.tails = (lm, ln)
            self.ztail = lz
        else:
            self.tails = (gm - (dx - 1) * lm, gn - (dy - 1) * ln)
            self.ztail = h - (dz - 1) * lz
        _check_tails(config.boundary, self.tails, self.depth, (dx, dy))
        if dz > 1:
            _check_tails(config.boundary, (self.ztail,), zd, (dz,))
            assert zd <= lz, (
                f"z exchange depth {zd} exceeds the local z block {lz}; "
                f"use fewer z devices or lower fused_steps")
        assert self.depth <= ROW_ALIGN, (
            f"3-D fused exchange depth {self.depth} exceeds the {ROW_ALIGN}-"
            f"row window guard; lower fused_steps")
        assert self.depth <= min(lm, ln), (
            f"exchange depth {self.depth} exceeds the local block "
            f"{(lm, ln)}; use fewer devices or lower fused_steps")
        self.layout = Layout3D(interior=self.local_interior, halo=spec.halo,
                               tile=tile, zguard=zd)
        self.backend = _block_backend(spec, config, self.PAIR)
        self._run_jit = jax.jit(self._run, static_argnames=("steps",))

    def _hi_starts(self):
        """See the 2-D twin: true-tail ghost starts along (rows, cols)."""
        _, m, n = self.layout.interior
        tm, tn = self.tails
        dx, dy = self.dxy
        rs = m if tm == m else jnp.where(
            jax.lax.axis_index("x") == dx - 1, tm, m)
        cs = n if tn == n else jnp.where(
            jax.lax.axis_index("y") == dy - 1, tn, n)
        return rs, cs

    def _z_start(self):
        """Flat start of the high-side z ghost: the true tail on the
        last z device under a ghost boundary (see _hi_starts)."""
        lz = self.local_interior[0]
        if self.ztail == lz:
            return lz
        return jnp.where(jax.lax.axis_index("z") == self.dz - 1,
                         self.ztail, lz)

    def _z_parts(self, buf):
        """z-phase ppermute of the zdepth-deep boundary plane slabs
        (full (row, col) extent, guard rings included, so the row/col
        phases that follow carry the z ghosts into the corners).
        Returns (topz, botz, from_up, from_down, zs)."""
        zd = self.zdepth
        z0 = self.layout.origin[0]
        wrap = self.config.boundary == "periodic"
        zs = self._z_start()
        topz = buf[z0: z0 + zd]
        botz = _take(buf, z0 + zs - zd, zd, 0)
        from_up = _shift(botz, "z", True, self.dz, wrap)
        from_down = _shift(topz, "z", False, self.dz, wrap)
        return topz, botz, from_up, from_down, zs

    def _z_exchange(self, buf):
        """Fill the z guard planes from the z-mesh neighbors (the 3-D
        analog of the row phase; dirichlet0 global-edge devices keep
        their existing planes -- the user z halo on step 1)."""
        zd = self.zdepth
        z0 = self.layout.origin[0]
        wrap = self.config.boundary == "periodic"
        refl = self.config.boundary == "reflect"
        iz = jax.lax.axis_index("z")
        topz, botz, from_up, from_down, zs = self._z_parts(buf)
        e_lo = (jnp.flip(topz, axis=0) if refl else buf[z0 - zd: z0])
        e_hi = (jnp.flip(botz, axis=0) if refl
                else _take(buf, z0 + zs, zd, 0))
        buf = buf.at[z0 - zd: z0].set(
            from_up if wrap else jnp.where(iz > 0, from_up, e_lo))
        return _put(buf,
                    from_down if wrap else
                    jnp.where(iz < self.dz - 1, from_down, e_hi),
                    z0 + zs, 0)

    def _exchange(self, buf):
        hm = hn = self.depth
        _, r0, c0 = self.layout.origin
        dx, dy = self.dxy

        wrap = self.config.boundary == "periodic"
        refl = self.config.boundary == "reflect"
        ix = jax.lax.axis_index("x")
        iy = jax.lax.axis_index("y")
        rs, cs = self._hi_starts()

        if self.dz > 1:
            buf = self._z_exchange(buf)
        elif wrap or refl:
            buf = self._z_ghost(buf)
        top = buf[:, r0: r0 + hm, :]
        bot = _take(buf, r0 + rs - hm, hm, 1)
        from_north = _shift(bot, "x", True, dx, wrap)
        from_south = _shift(top, "x", False, dx, wrap)
        en = (jnp.flip(top, axis=1) if refl else buf[:, r0 - hm: r0, :])
        es = (jnp.flip(bot, axis=1) if refl
              else _take(buf, r0 + rs, hm, 1))
        buf = buf.at[:, r0 - hm: r0, :].set(
            from_north if wrap else jnp.where(ix > 0, from_north, en))
        buf = _put(buf,
                   from_south if wrap else
                   jnp.where(ix < dx - 1, from_south, es),
                   r0 + rs, 1)

        left = buf[:, :, c0: c0 + hn]
        right = _take(buf, c0 + cs - hn, hn, 2)
        from_west = _shift(right, "y", True, dy, wrap)
        from_east = _shift(left, "y", False, dy, wrap)
        ew = (jnp.flip(left, axis=2) if refl else buf[:, :, c0 - hn: c0])
        ee = (jnp.flip(right, axis=2) if refl
              else _take(buf, c0 + cs, hn, 2))
        buf = buf.at[:, :, c0 - hn: c0].set(
            from_west if wrap else jnp.where(iy > 0, from_west, ew))
        buf = _put(buf,
                   from_east if wrap else
                   jnp.where(iy < dy - 1, from_east, ee),
                   c0 + cs, 2)
        return buf

    def _z_ghost(self, buf):
        """Local ghost refresh of the z guard planes (unsharded-z
        meshes): wrap for periodic, mirror for reflect, spanning the
        full (row, col) extent so the subsequent row/col exchanges
        carry the z ghost rings too.  z-sharded meshes use the
        _z_exchange ppermute phase instead."""
        h = self.local_interior[0]
        z0 = self.layout.origin[0]
        dz = self.layout.zguard
        if self.config.boundary == "reflect":
            lo = jnp.flip(buf[z0: z0 + dz], axis=0)
            hi = jnp.flip(buf[z0 + h - dz: z0 + h], axis=0)
        else:
            lo = buf[z0 + h - dz: z0 + h]
            hi = buf[z0: z0 + dz]
        buf = buf.at[z0 - dz: z0].set(lo)
        return buf.at[z0 + h: z0 + h + dz].set(hi)

    def _exchange_strips(self, buf):
        """Plane-wise multi-phase ppermute WITHOUT writing into ``buf``
        (the 3-D analog of ShardedStencil2D._exchange_strips).  On a
        3-D mesh a z-plane phase runs first; its received planes are
        patched into the row strips (and, transitively, the col strips)
        so all corner octants ride along."""
        hm = hn = self.depth
        z0, r0, c0 = self.layout.origin
        dx, dy = self.dxy
        wrap = self.config.boundary == "periodic"
        refl = self.config.boundary == "reflect"
        ix = jax.lax.axis_index("x")
        rs, cs = self._hi_starts()

        zparts = None
        if self.dz > 1:
            zd = self.zdepth
            iz = jax.lax.axis_index("z")
            topz, botz, from_up, from_down, zs = self._z_parts(buf)
            zparts = (from_up, from_down)

        def patch_z(s, take_axis, lo):
            """Patch the received z-ghost planes into a row/col strip
            (output-ring semantics: dirichlet global z edges get
            zeros, reflect mirrors the strip's own edge planes)."""
            if self.dz <= 1:
                return s
            fu = _take(from_up, lo, s.shape[take_axis], take_axis)
            fd = _take(from_down, lo, s.shape[take_axis], take_axis)
            eu = (jnp.flip(_take(topz, lo, s.shape[take_axis], take_axis),
                           axis=0) if refl else jnp.zeros_like(fu))
            ed = (jnp.flip(_take(botz, lo, s.shape[take_axis], take_axis),
                           axis=0) if refl else jnp.zeros_like(fd))
            s = s.at[z0 - zd: z0].set(
                fu if wrap else jnp.where(iz > 0, fu, eu))
            return _put(s, fd if wrap else
                        jnp.where(iz < self.dz - 1, fd, ed), z0 + zs, 0)

        def row_strip(r_lo):
            return patch_z(_take(buf, r_lo, hm, 1), 1, r_lo)

        top = row_strip(r0)
        bot = row_strip(r0 + rs - hm)
        from_north = _shift(bot, "x", True, dx, wrap)
        from_south = _shift(top, "x", False, dx, wrap)

        def col_strip(c_lo):
            s = patch_z(_take(buf, c_lo, hn, 2), 2, c_lo)
            fn = _take(from_north, c_lo, hn, 2)
            fs = _take(from_south, c_lo, hn, 2)
            en = (jnp.flip(_take(top, c_lo, hn, 2), axis=1) if refl
                  else jnp.zeros_like(fn))
            es = (jnp.flip(_take(bot, c_lo, hn, 2), axis=1) if refl
                  else jnp.zeros_like(fs))
            s = s.at[:, r0 - hm: r0, :].set(
                fn if wrap else jnp.where(ix > 0, fn, en))
            s = _put(s, fs if wrap else jnp.where(ix < dx - 1, fs, es),
                     r0 + rs, 1)
            return s

        from_west = _shift(col_strip(c0 + cs - hn), "y", True, dy, wrap)
        from_east = _shift(col_strip(c0), "y", False, dy, wrap)
        return zparts, from_north, from_south, from_west, from_east

    def _write_ring(self, buf, parts):
        hm = hn = self.depth
        z0, r0, c0 = self.layout.origin
        dx, dy = self.dxy
        ix = jax.lax.axis_index("x")
        iy = jax.lax.axis_index("y")
        wrap = self.config.boundary == "periodic"
        refl = self.config.boundary == "reflect"
        rs, cs = self._hi_starts()
        zparts, from_north, from_south, from_west, from_east = parts
        if zparts is not None:
            # z planes first; the row/col writes below overwrite their
            # (stale-at-the-sender) ring cells with fresh patched strips
            zd = self.zdepth
            iz = jax.lax.axis_index("z")
            zs = self._z_start()
            from_up, from_down = zparts
            e_lo = (jnp.flip(buf[z0: z0 + zd], axis=0) if refl
                    else jnp.zeros_like(from_up))
            e_hi = (jnp.flip(_take(buf, z0 + zs - zd, zd, 0), axis=0)
                    if refl else jnp.zeros_like(from_down))
            buf = buf.at[z0 - zd: z0].set(
                from_up if wrap else jnp.where(iz > 0, from_up, e_lo))
            buf = _put(buf,
                       from_down if wrap else
                       jnp.where(iz < self.dz - 1, from_down, e_hi),
                       z0 + zs, 0)
        en = (jnp.flip(buf[:, r0: r0 + hm, :], axis=1) if refl
              else jnp.zeros_like(from_north))
        es = (jnp.flip(_take(buf, r0 + rs - hm, hm, 1), axis=1) if refl
              else jnp.zeros_like(from_south))
        buf = buf.at[:, r0 - hm: r0, :].set(
            from_north if wrap else jnp.where(ix > 0, from_north, en))
        buf = _put(buf,
                   from_south if wrap else
                   jnp.where(ix < dx - 1, from_south, es),
                   r0 + rs, 1)
        # col mirrors read the buffer AFTER the row-ring writes so the
        # corners compose row-mirror x col-mirror (np.pad symmetric)
        ew = (jnp.flip(buf[:, :, c0: c0 + hn], axis=2) if refl
              else jnp.zeros_like(from_west))
        ee = (jnp.flip(_take(buf, c0 + cs - hn, hn, 2), axis=2) if refl
              else jnp.zeros_like(from_east))
        buf = buf.at[:, :, c0 - hn: c0].set(
            from_west if wrap else jnp.where(iy > 0, from_west, ew))
        buf = _put(buf,
                   from_east if wrap else
                   jnp.where(iy < dy - 1, from_east, ee),
                   c0 + cs, 2)
        return buf

    def _bounds(self):
        lz, lm, ln = self.local_interior
        H, gm, gn = self.interior
        ix = jax.lax.axis_index("x")
        iy = jax.lax.axis_index("y")
        ghost = self.config.boundary != "dirichlet0"
        if self.dz > 1:
            # z sharded: the global-interior z range in local plane
            # coordinates (ghost modes widen by the exchange depth so
            # received ghost planes survive intermediate-level masks)
            iz = jax.lax.axis_index("z")
            d = self.depth if ghost else 0
            zd = self.zdepth if ghost else 0
            return jnp.stack([
                -iz * lz - zd, H - iz * lz + zd,
                -ix * lm - d, gm - ix * lm + d,
                -iy * ln - d, gn - iy * ln + d,
            ]).astype(jnp.int32)
        if ghost:
            # 6-length box with a z range: the ghost z guard planes
            # and global-edge rings must survive the kernel's
            # intermediate-level masks
            d = self.depth
            dzg = self.layout.zguard
            return jnp.stack([
                jnp.int32(-dzg), jnp.int32(H + dzg),
                -ix * lm - d, gm - ix * lm + d,
                -iy * ln - d, gn - iy * ln + d,
            ]).astype(jnp.int32)
        return jnp.stack([
            -ix * lm, gm - ix * lm, -iy * ln, gn - iy * ln,
        ]).astype(jnp.int32)

    def _kernel(self, cur, donor, fused_k, region=None):
        """One pass of the block step on the local buffer (the
        ops/plain.py contract)."""
        return plain.step(cur, donor, self.spec, self.layout,
                          fused_steps=fused_k, bounds=self._bounds(),
                          region=region, pair=self.PAIR)

    def _overlap_reason(self):
        gi, gj = self.layout.grid
        from ..ops.layout import COL_ALIGN as _L, ROW_ALIGN as _S

        TM, TN = self.layout.tile
        _, lm, ln = self.local_interior
        tm, tn = self.tails
        if self.dz > 1:
            # the z strips (first/last interior planes over the FULL
            # plane extent) are produced by every tile, so there is no
            # boundary frame to exchange early -- ring-in-output instead
            return "z-sharded meshes exchange after the full-grid kernel"
        if gi < 3 or gj < 3:
            return f"local tile grid {gi}x{gj} < 3x3"
        if _S > TM or _L > TN or self.depth > min(TM, TN):
            return "exchange depth exceeds the boundary tile"
        if ((tm != lm and tm - self.depth < (gi - 1) * TM)
                or (tn != ln and tn - self.depth < (gj - 1) * TN)):
            return "true-tail edge strip lies outside the boundary tiles"
        return None

    def _can_overlap(self) -> bool:
        return self.config.overlap and self._overlap_reason() is None

    def _local_step(self, cur, donor, fused_k):
        cur = self._exchange(cur)
        return self._kernel(cur, donor, fused_k)

    def _local_step_ringout(self, cur, donor, fused_k):
        """Small-grid ring-in-output step (see the 2-D twin): one
        full-grid kernel call, then the exchange writes into the fresh
        output -- no exchange-into-input full-buffer copies.  On a
        z-sharded mesh this is the standard step: ``cur``'s full ring
        (z planes included) was written at the end of the previous
        pass (the embedding's ring on pass 1)."""
        if self._needs_local_zghost():
            cur = self._z_ghost(cur)
        out = self._kernel(cur, donor, fused_k)
        parts = self._exchange_strips(out)
        return self._write_ring(out, parts)

    def _needs_local_zghost(self) -> bool:
        """A z-sharded mesh refreshes z ghosts via the z ppermute phase;
        only unsharded-z ghost boundaries use the local wrap/mirror."""
        return self.dz == 1 and self.config.boundary != "dirichlet0"

    def _local_step_overlap(self, cur, donor, fused_k):
        """Boundary-first pass: the ppermute of the freshly written edge
        strips rides under the interior-tile kernel (see the 2-D
        twin)."""
        gi, gj = self.layout.grid

        def step(inp, out_buf, region):
            return self._kernel(inp, out_buf, fused_k, region)

        if self._needs_local_zghost():
            cur = self._z_ghost(cur)  # local; rows/cols ride the overlap
        out = step(cur, donor, ((0, 1), (0, gj)))
        out = step(cur, out, ((gi - 1, gi), (0, gj)))
        out = step(cur, out, ((1, gi - 1), (0, 1)))
        out = step(cur, out, ((1, gi - 1), (gj - 1, gj)))
        parts = self._exchange_strips(out)
        out = step(cur, out, ((1, gi - 1), (1, gj - 1)))
        return self._write_ring(out, parts)

    def _run(self, state, steps: int):
        from jax import shard_map

        from ..engine import ping_pong_loop

        if self._can_overlap() and int(np.prod(self.config.mesh_shape)) > 1:
            # >1 device: hide the collective under the interior tiles
            step_fn = self._local_step_overlap
        elif self.config.overlap:
            step_fn = self._local_step_ringout
        else:
            step_fn = self._local_step  # explicit overlap=False

        def body_fn(local):
            return ping_pong_loop(step_fn, local, steps,
                                  self.fused_steps)

        zspec = "z" if self.dz > 1 else None
        fn = shard_map(body_fn, mesh=self.mesh,
                       in_specs=P(zspec, "x", "y"),
                       out_specs=P(zspec, "x", "y"), check_vma=False)
        return fn(state)

    def to_sharded(self, padded):
        """Embed with a DEPTH-wide (row, col) ring -- and, on a z-sharded
        mesh, a zdepth-wide z ring -- from the global array (see the 2-D
        twin)."""
        spec, lay = self.spec, self.layout
        hz, hm, hn = spec.halo
        lz, lm, ln = self.local_interior
        dz, (dx, dy) = self.dz, self.dxy
        Hp, Mp, Np = lay.shape
        z0, r0, c0 = lay.origin
        d = self.depth
        # z embedding ring: pass-1 neighbor planes when z is sharded,
        # just the user halo otherwise (the per-pass _z_ghost refresh
        # covers unsharded ghost boundaries)
        zd = self.zdepth if dz > 1 else hz
        H, gm, gn = self.interior
        # block-padded extent (== true interior when divisible)
        Gm, Gn = dx * lm, dy * ln
        padded = jnp.asarray(padded, jnp.float32)
        gpad = jnp.zeros((dz * lz + 2 * zd, Gm + 2 * d, Gn + 2 * d),
                         jnp.float32)
        gpad = gpad.at[zd - hz: zd + H + hz,
                       d - hm: d + gm + hm, d - hn: d + gn + hn].set(padded)
        if self.config.boundary == "periodic":
            if dz > 1:
                # global z wrap ring first (TRUE edge H; block-padded
                # planes beyond stay zero); the row/col fills below span
                # the full z extent so corners ride along
                gpad = gpad.at[:zd, d: d + gm, d: d + gn].set(
                    gpad[H: H + zd, d: d + gm, d: d + gn])
                gpad = gpad.at[zd + H: 2 * zd + H, d: d + gm,
                               d: d + gn].set(
                    gpad[zd: 2 * zd, d: d + gm, d: d + gn])
            # global row/col wrap ring; high-side ghosts sit at the TRUE
            # edges gm/gn, block-padded cells beyond stay zero
            gpad = gpad.at[:, :d, d: d + gn].set(
                gpad[:, gm: gm + d, d: d + gn])
            gpad = gpad.at[:, d + gm: 2 * d + gm, d: d + gn].set(
                gpad[:, d: 2 * d, d: d + gn])
            gpad = gpad.at[:, :, :d].set(gpad[:, :, gn: gn + d])
            gpad = gpad.at[:, :, d + gn: 2 * d + gn].set(
                gpad[:, :, d: 2 * d])
        elif self.config.boundary == "reflect":
            if dz > 1:
                gpad = gpad.at[:zd, d: d + gm, d: d + gn].set(
                    jnp.flip(gpad[zd: 2 * zd, d: d + gm, d: d + gn],
                             axis=0))
                gpad = gpad.at[zd + H: 2 * zd + H, d: d + gm,
                               d: d + gn].set(
                    jnp.flip(gpad[H: H + zd, d: d + gm, d: d + gn],
                             axis=0))
            gpad = gpad.at[:, :d, d: d + gn].set(
                jnp.flip(gpad[:, d: 2 * d, d: d + gn], axis=1))
            gpad = gpad.at[:, d + gm: 2 * d + gm, d: d + gn].set(
                jnp.flip(gpad[:, gm: gm + d, d: d + gn], axis=1))
            gpad = gpad.at[:, :, :d].set(
                jnp.flip(gpad[:, :, d: 2 * d], axis=2))
            gpad = gpad.at[:, :, d + gn: 2 * d + gn].set(
                jnp.flip(gpad[:, :, gn: gn + d], axis=2))
        out = jnp.zeros((dz * Hp, dx * Mp, dy * Np), jnp.float32)
        for zi in range(dz):
            for i in range(dx):
                for j in range(dy):
                    src = gpad[zi * lz: zi * lz + lz + 2 * zd,
                               i * lm: i * lm + lm + 2 * d,
                               j * ln: j * ln + ln + 2 * d]
                    out = out.at[
                        zi * Hp + z0 - zd: zi * Hp + z0 + lz + zd,
                        i * Mp + r0 - d: i * Mp + r0 + lm + d,
                        j * Np + c0 - d: j * Np + c0 + ln + d,
                    ].set(src)
        zspec = "z" if dz > 1 else None
        return jax.lax.with_sharding_constraint(
            out.astype(jnp.dtype(self.config.dtype)),
            NamedSharding(self.mesh, P(zspec, "x", "y")))

    def from_sharded(self, state):
        spec, lay = self.spec, self.layout
        hz, hm, hn = spec.halo
        lz, lm, ln = self.local_interior
        dz, (dx, dy) = self.dz, self.dxy
        Hp, Mp, Np = lay.shape
        z0, r0, c0 = lay.origin
        H, gm, gn = self.interior
        out = jnp.zeros((H + 2 * hz, gm + 2 * hm, gn + 2 * hn), state.dtype)
        for zi in range(dz):
            tz = min(lz, H - zi * lz)  # clamp the block-padded z tail
            if tz <= 0:
                continue
            # z-sharded: interior planes only (the output z halo is zero
            # after a step -- reference halo-decay semantics; the local
            # guard holds exchanged neighbor data, not output).  The
            # dz == 1 extraction keeps the guard planes: they are zero
            # after any step and the user halo at steps == 0.
            zsl = (slice(z0, z0 + tz) if dz > 1
                   else slice(z0 - hz, z0 + lz + hz))
            osl = (slice(hz + zi * lz, hz + zi * lz + tz) if dz > 1
                   else slice(0, H + 2 * hz))
            for i in range(dx):
                tm = min(lm, gm - i * lm)  # clamp the block-padded tail
                if tm <= 0:
                    continue
                for j in range(dy):
                    tn = min(ln, gn - j * ln)
                    if tn <= 0:
                        continue
                    block = state[
                        zi * Hp + zsl.start: zi * Hp + zsl.stop,
                        i * Mp + r0: i * Mp + r0 + tm,
                        j * Np + c0: j * Np + c0 + tn]
                    out = out.at[osl,
                                 hm + i * lm: hm + i * lm + tm,
                                 hn + j * ln: hn + j * ln + tn].set(block)
        return out

    def run(self, padded, steps: int):
        """One jitted program end-to-end (embed -> exchange+steps ->
        extract)."""
        if not hasattr(self, "_full_jit"):
            self._full_jit = jax.jit(
                lambda g, steps: self.from_sharded(
                    self._run(self.to_sharded(g), steps)),
                static_argnames=("steps",),
            )
        return self._full_jit(padded, steps=steps)

    def run_checksum(self, padded, steps: int):
        """Like run() but returns only a replicated scalar checksum --
        the timing entry point (syncs execution without the full
        device-to-host copy)."""
        if not hasattr(self, "_checksum_jit"):
            self._checksum_jit = jax.jit(
                lambda g, steps: jnp.sum(
                    self._run(self.to_sharded(g), steps)
                    .astype(jnp.float32)),
                static_argnames=("steps",),
            )
        return self._checksum_jit(padded, steps=steps)


class ShardedStencilDF64_3D(ShardedStencil3D):
    """Domain-decomposed fp64-grade 3-D stencil: double-float fp32 pair
    state over a 2-D (rows, cols) or 3-D (z, rows, cols) device mesh.

    The 3-D twin of ShardedStencilDF64: state is a stacked
    (2, dz*Hp, dx*Mp, dy*Np) fp32 array sharded P(None, ['z',] 'x',
    'y'); the hi/lo planes ride the SAME multi-phase ppermute exchange
    as the fp32 tier (vmapped over the pair axis) and each device runs
    the plain pair step on its local block with the dynamic
    global-interior bounds.  Boundary conditions: dirichlet0, periodic,
    reflect (ring copies/flips are exact on (hi, lo) pairs).  Overlap
    uses the ring-in-output dataflow, exactly like the 2-D twin."""

    PAIR = True

    def __init__(self, spec: StencilSpec, interior, config: ShardedConfig,
                 mesh: Optional[Mesh] = None):
        if config.dtype != "df64":
            raise ValueError("ShardedStencilDF64_3D needs dtype='df64'")
        super().__init__(spec, interior,
                         dataclasses.replace(config, dtype="float32"), mesh)

    # -- per-device step (pair state) -------------------------------------
    def _local_step(self, cur2, donor2, fused_k):
        cur2 = jax.vmap(self._exchange)(cur2)
        return self._kernel(cur2, donor2, fused_k)

    def _local_step_ringout(self, cur2, donor2, fused_k):
        if self._needs_local_zghost():
            cur2 = jax.vmap(self._z_ghost)(cur2)
        out2 = self._kernel(cur2, donor2, fused_k)
        parts = jax.vmap(self._exchange_strips)(out2)
        return jax.vmap(self._write_ring)(out2, parts)

    def _run(self, state2, steps: int):
        """state2: (2, dz*Hp, dx*Mp, dy*Np) fp32 pair stack."""
        from jax import shard_map

        from ..engine import ping_pong_loop

        step_fn = (self._local_step_ringout if self.config.overlap
                   else self._local_step)

        def body_fn(local2):
            return ping_pong_loop(step_fn, local2, steps, self.fused_steps)

        zspec = "z" if self.dz > 1 else None
        fn = shard_map(
            body_fn, mesh=self.mesh,
            in_specs=P(None, zspec, "x", "y"),
            out_specs=P(None, zspec, "x", "y"),
            check_vma=False,
        )
        return fn(state2)

    # -- user API ---------------------------------------------------------
    def to_sharded(self, pair):
        embed = ShardedStencil3D.to_sharded
        out = jnp.stack([embed(self, pair[0]), embed(self, pair[1])])
        zspec = "z" if self.dz > 1 else None
        return jax.lax.with_sharding_constraint(
            out, NamedSharding(self.mesh, P(None, zspec, "x", "y")))

    def from_sharded(self, state2):
        extract = ShardedStencil3D.from_sharded
        return jnp.stack([extract(self, state2[0]),
                          extract(self, state2[1])])

    def run(self, padded, steps: int):
        """User global fp64 padded array in, fp64 NumPy out (pair
        split/merge on the host; one jitted program in between)."""
        from ..ops import df64 as _df64

        pair = _df64.split_host(np.asarray(padded))
        if not hasattr(self, "_full_jit"):
            self._full_jit = jax.jit(
                lambda p, steps: self.from_sharded(
                    self._run(self.to_sharded(p), steps)),
                static_argnames=("steps",),
            )
        return _df64.merge_host(np.asarray(self._full_jit(pair,
                                                          steps=steps)))

    def run_checksum(self, padded, steps: int):
        from ..ops import df64 as _df64

        pair = _df64.split_host(np.asarray(padded))
        if not hasattr(self, "_checksum_jit"):
            self._checksum_jit = jax.jit(
                lambda p, steps: jnp.sum(
                    self._run(self.to_sharded(p), steps)),
                static_argnames=("steps",),
            )
        return self._checksum_jit(pair, steps=steps)


class ShardedStencil1D:
    """Domain-decomposed 1-D stencil over a 1-D mesh: each device owns a
    contiguous flat block; per step the depth-deep edge strips ppermute
    to the neighbors' guard cells (the user halo positions), then the
    block step runs locally."""

    PAIR = False  # df64 pair state (ShardedStencilDF64_1D)

    def __init__(self, spec: StencilSpec, interior: int,
                 config: ShardedConfig, mesh: Optional[Mesh] = None):
        assert spec.ndim == 1
        from ..ops.layout import COL_ALIGN, ROW_ALIGN, Layout1D

        if config.dtype == "df64" and type(self) is ShardedStencil1D:
            raise ValueError(
                "dtype='df64' pair state needs ShardedStencilDF64_1D "
                "(sharded_engine dispatches there)")
        self.spec = spec
        self.config = config
        _check_reflect_fused(spec, config)
        (dx,) = config.mesh_shape[:1]
        self.interior = interior
        # pad the local block to a row multiple: arbitrary global sizes
        # shard for EVERY boundary (see the 2-D twin); dirichlet0 masks
        # fake tail cells to zero, ghost modes anchor the wrap/mirror at
        # the last device's true tail
        nl = -(-interior // dx)
        self.local_interior = COL_ALIGN * (-(-nl // COL_ALIGN))
        self.tail = (self.local_interior
                     if config.boundary == "dirichlet0"
                     else interior - (dx - 1) * self.local_interior)
        self.dx = dx
        self.fused_steps = max(1, config.fused_steps)
        # exchange depth per pass: k*radius cells feed the fused substeps
        self.depth = max(spec.halo[0], self.fused_steps * spec.radius)
        per = ROW_ALIGN * COL_ALIGN
        guard_rows = ROW_ALIGN * (-(-self.depth // per))
        self.mesh = mesh if mesh is not None else make_mesh((dx,), ("x",))
        rows = max(ROW_ALIGN, min(512, ROW_ALIGN * (
            -(-self.local_interior // per))))
        self.layout = Layout1D(interior=self.local_interior,
                               halo=spec.halo[0], tile_rows=rows,
                               guard_rows=guard_rows)
        _check_tails(config.boundary, (self.tail,), self.depth, (dx,))
        self.backend = _block_backend(spec, config, self.PAIR)
        self._run_jit = jax.jit(self._run, static_argnames=("steps",))

    def _hi_start(self):
        """Flat start of the high-side ghost: the true tail on the last
        device under a ghost boundary (see the 2-D twin)."""
        n = self.local_interior
        if self.tail == n:
            return n
        return jnp.where(jax.lax.axis_index("x") == self.dx - 1,
                         self.tail, n)

    def _read_edges(self, buf):
        """(head, tail): the depth-deep edge strips in flat order."""
        h = self.depth
        o = self.layout.origin
        flat = buf.reshape(-1)
        return flat[o: o + h], _take(flat, o + self._hi_start() - h, h, 0)

    def _set_ring(self, buf, left_vals, right_vals):
        """Write the ring cells (flat [-depth, 0) and [ts, ts+depth)
        with ts the true-tail ghost start -- == n when divisible)."""
        h = self.depth
        o = self.layout.origin
        flat = buf.reshape(-1)
        flat = flat.at[o - h: o].set(left_vals)
        flat = _put(flat, right_vals, o + self._hi_start(), 0)
        return flat.reshape(buf.shape)

    def _read_ring(self, buf):
        h = self.depth
        o = self.layout.origin
        flat = buf.reshape(-1)
        return flat[o - h: o], _take(flat, o + self._hi_start(), h, 0)

    def _exchange(self, buf):
        dx = self.dx
        wrap = self.config.boundary == "periodic"
        refl = self.config.boundary == "reflect"
        ix = jax.lax.axis_index("x")
        head, tail = self._read_edges(buf)
        from_left = _shift(tail, "x", True, dx, wrap)
        from_right = _shift(head, "x", False, dx, wrap)
        if wrap:
            return self._set_ring(buf, from_left, from_right)
        if refl:
            el, er = head[::-1], tail[::-1]
        else:
            el, er = self._read_ring(buf)
        return self._set_ring(
            buf,
            jnp.where(ix > 0, from_left, el),
            jnp.where(ix < dx - 1, from_right, er))

    def _bounds(self):
        nl = self.local_interior
        ix = jax.lax.axis_index("x")
        d = self.depth if self.config.boundary != "dirichlet0" else 0
        return jnp.stack([-ix * nl - d,
                          self.interior - ix * nl + d]).astype(jnp.int32)

    def _exchange_strips(self, buf):
        """Neighbor ppermute of the depth-deep edge strips WITHOUT
        writing into ``buf`` (overlap mode)."""
        wrap = self.config.boundary == "periodic"
        head, tail = self._read_edges(buf)
        from_left = _shift(tail, "x", True, self.dx, wrap)
        from_right = _shift(head, "x", False, self.dx, wrap)
        return from_left, from_right

    def _write_ring(self, buf, parts):
        ix = jax.lax.axis_index("x")
        from_left, from_right = parts
        if self.config.boundary == "periodic":
            return self._set_ring(buf, from_left, from_right)
        if self.config.boundary == "reflect":
            head, tail = self._read_edges(buf)
            el, er = head[::-1], tail[::-1]
        else:
            el = jnp.zeros_like(from_left)
            er = jnp.zeros_like(from_right)
        return self._set_ring(
            buf,
            jnp.where(ix > 0, from_left, el),
            jnp.where(ix < self.dx - 1, from_right, er))

    def _overlap_reason(self):
        from ..ops.layout import COL_ALIGN

        (g,) = self.layout.grid
        TR = self.layout.tile_rows
        if g < 3:
            return f"local tile grid {g} < 3"
        if self.layout.guard_rows > TR or self.depth > TR * COL_ALIGN:
            return "exchange depth exceeds the boundary tile"
        if (self.tail != self.local_interior
                and self.tail - self.depth < (g - 1) * TR * COL_ALIGN):
            return "true-tail edge strip lies outside the boundary tiles"
        return None

    def _can_overlap(self) -> bool:
        return self.config.overlap and self._overlap_reason() is None

    def _kernel_step(self, cur, donor, fused_k, bounds, region=None):
        return plain.step(cur, donor, self.spec, self.layout,
                          fused_steps=fused_k, bounds=bounds, region=region,
                          pair=self.PAIR)

    def _local_step(self, cur, donor, fused_k):
        cur = self._exchange(cur)
        return self._kernel_step(cur, donor, fused_k, self._bounds())

    def _local_step_ringout(self, cur, donor, fused_k):
        """Small-grid ring-in-output step (see the 2-D twin): one
        full-grid kernel call, then the exchange writes into the fresh
        output -- no exchange-into-input full-buffer copies."""
        out = self._kernel_step(cur, donor, fused_k, self._bounds())
        parts = self._exchange_strips(out)
        return self._write_ring(out, parts)

    def _local_step_overlap(self, cur, donor, fused_k):
        """Boundary-first pass: the edge-strip ppermute rides under the
        interior-tile kernel (see the 2-D twin)."""
        (g,) = self.layout.grid
        bounds = self._bounds()

        out = self._kernel_step(cur, donor, fused_k, bounds, (0, 1))
        out = self._kernel_step(cur, out, fused_k, bounds, (g - 1, g))
        parts = self._exchange_strips(out)
        out = self._kernel_step(cur, out, fused_k, bounds, (1, g - 1))
        return self._write_ring(out, parts)

    def _run(self, state, steps: int):
        from jax import shard_map

        from ..engine import ping_pong_loop

        if self._can_overlap() and int(np.prod(self.config.mesh_shape)) > 1:
            # >1 device: hide the collective under the interior tiles
            step_fn = self._local_step_overlap
        elif self.config.overlap:
            step_fn = self._local_step_ringout
        else:
            step_fn = self._local_step  # explicit overlap=False

        def body_fn(local):
            return ping_pong_loop(step_fn, local, steps,
                                  self.fused_steps)

        fn = shard_map(body_fn, mesh=self.mesh,
                       in_specs=P("x", None), out_specs=P("x", None),
                       check_vma=False)
        return fn(state)

    def to_sharded(self, padded):
        """Embed with a DEPTH-wide ring from the global array (see the
        2-D twin)."""
        h = self.spec.halo[0]
        d = self.depth
        n = self.local_interior
        R, L = self.layout.shape
        N = self.interior
        padded = jnp.asarray(padded, jnp.float32)
        # block-padded extent (== N when lane-aligned divisible)
        gpad = jnp.zeros((self.dx * n + 2 * d,), jnp.float32)
        gpad = gpad.at[d - h: d + N + h].set(padded)
        if self.config.boundary == "periodic":
            gpad = gpad.at[:d].set(gpad[N: N + d])
            gpad = gpad.at[d + N: 2 * d + N].set(gpad[d: 2 * d])
        elif self.config.boundary == "reflect":
            gpad = gpad.at[:d].set(gpad[d: 2 * d][::-1])
            gpad = gpad.at[d + N: 2 * d + N].set(gpad[N: N + d][::-1])
        o = self.layout.origin
        out = jnp.zeros((self.dx * R * L,), jnp.float32)
        for i in range(self.dx):
            src = gpad[i * n: i * n + n + 2 * d]
            out = out.at[i * R * L + o - d:
                         i * R * L + o + n + d].set(src)
        out2 = out.reshape(self.dx * R, L)
        return jax.lax.with_sharding_constraint(
            out2.astype(jnp.dtype(self.config.dtype)),
            NamedSharding(self.mesh, P("x", None)))

    def from_sharded(self, state):
        h = self.spec.halo[0]
        n = self.local_interior
        R, L = self.layout.shape
        o = self.layout.origin
        flat = state.reshape(-1)
        out = jnp.zeros((self.interior + 2 * h,), state.dtype)
        for i in range(self.dx):
            take = min(n, self.interior - i * n)  # block-padded tail
            if take <= 0:
                continue
            loc = flat[i * R * L + o: i * R * L + o + take]
            out = out.at[h + i * n: h + i * n + take].set(loc)
        return out

    def run(self, padded, steps: int):
        """One jitted program end-to-end (embed -> exchange+steps ->
        extract)."""
        if not hasattr(self, "_full_jit"):
            self._full_jit = jax.jit(
                lambda g, steps: self.from_sharded(
                    self._run(self.to_sharded(g), steps)),
                static_argnames=("steps",),
            )
        return self._full_jit(padded, steps=steps)

    def run_checksum(self, padded, steps: int):
        """Like run() but returns only a replicated scalar checksum --
        the timing entry point (syncs execution without the full
        device-to-host copy)."""
        if not hasattr(self, "_checksum_jit"):
            self._checksum_jit = jax.jit(
                lambda g, steps: jnp.sum(
                    self._run(self.to_sharded(g), steps)
                    .astype(jnp.float32)),
                static_argnames=("steps",),
            )
        return self._checksum_jit(padded, steps=steps)


class ShardedStencilDF64_1D(ShardedStencil1D):
    """Domain-decomposed fp64-grade 1-D stencil: double-float fp32 pair
    state over a 1-D device mesh.

    The 1-D twin of ShardedStencilDF64: the hi/lo planes ride the SAME
    edge-strip ppermute exchange as the fp32 tier (vmapped over the
    pair axis) and each device runs the plain pair step on its local
    block with the dynamic flat bounds.  Boundary conditions:
    dirichlet0, periodic, reflect (ring copies/flips are exact on
    (hi, lo) pairs).  overlap=True uses the ring-in-output dataflow,
    like the 2-D/3-D twins."""

    PAIR = True

    def __init__(self, spec: StencilSpec, interior: int,
                 config: ShardedConfig, mesh: Optional[Mesh] = None):
        if config.dtype != "df64":
            raise ValueError("ShardedStencilDF64_1D needs dtype='df64'")
        super().__init__(spec, interior,
                         dataclasses.replace(config, dtype="float32"), mesh)

    # -- per-device step (pair state) -------------------------------------
    def _local_step(self, cur2, donor2, fused_k):
        cur2 = jax.vmap(self._exchange)(cur2)
        return self._kernel_step(cur2, donor2, fused_k, self._bounds())

    def _local_step_ringout(self, cur2, donor2, fused_k):
        """Ring-in-output pass (see the 2-D twin): cur2's ring already
        holds this pass's neighbor data; the fresh output's edge strips
        exchange after the step."""
        out2 = self._kernel_step(cur2, donor2, fused_k, self._bounds())
        parts = jax.vmap(self._exchange_strips)(out2)
        return jax.vmap(self._write_ring)(out2, parts)

    def _run(self, state2, steps: int):
        """state2: (2, dx*R, 128) fp32 pair stack, P(None, 'x', None)."""
        from jax import shard_map

        from ..engine import ping_pong_loop

        step_fn = (self._local_step_ringout if self.config.overlap
                   else self._local_step)

        def body_fn(local2):
            return ping_pong_loop(step_fn, local2, steps, self.fused_steps)

        fn = shard_map(
            body_fn, mesh=self.mesh,
            in_specs=P(None, "x", None), out_specs=P(None, "x", None),
            check_vma=False,
        )
        return fn(state2)

    # -- user API ---------------------------------------------------------
    def to_sharded(self, pair):
        """(2, n+2h) fp32 hi/lo strips (ops/df64.split_host) -> sharded
        (2, dx*R, 128) pair stack."""
        embed = ShardedStencil1D.to_sharded
        out = jnp.stack([embed(self, pair[0]), embed(self, pair[1])])
        return jax.lax.with_sharding_constraint(
            out, NamedSharding(self.mesh, P(None, "x", None)))

    def from_sharded(self, state2):
        extract = ShardedStencil1D.from_sharded
        return jnp.stack([extract(self, state2[0]),
                          extract(self, state2[1])])

    def run(self, padded, steps: int):
        """User global fp64 padded array in, fp64 NumPy out (pair
        split/merge on the host; one jitted program in between)."""
        from ..ops import df64 as _df64

        pair = _df64.split_host(np.asarray(padded))
        if not hasattr(self, "_full_jit"):
            self._full_jit = jax.jit(
                lambda p, steps: self.from_sharded(
                    self._run(self.to_sharded(p), steps)),
                static_argnames=("steps",),
            )
        return _df64.merge_host(np.asarray(self._full_jit(pair,
                                                          steps=steps)))

    def run_checksum(self, padded, steps: int):
        from ..ops import df64 as _df64

        pair = _df64.split_host(np.asarray(padded))
        if not hasattr(self, "_checksum_jit"):
            self._checksum_jit = jax.jit(
                lambda p, steps: jnp.sum(
                    self._run(self.to_sharded(p), steps)),
                static_argnames=("steps",),
            )
        return self._checksum_jit(pair, steps=steps)


def sharded_engine(shape, interior, mesh_shape, **kw):
    """Domain-decomposed engine for a registry shape name OR a custom
    ``StencilSpec`` (e.g. from ``StencilEngine.for_coeffs(...).spec``)."""
    spec = shape if isinstance(shape, StencilSpec) else get_shape(shape)
    cfg = ShardedConfig(mesh_shape=tuple(mesh_shape), **kw)
    if cfg.dtype == "df64":
        # sharded df64 runs the plain pair step per block
        if spec.ndim == 3:
            return ShardedStencilDF64_3D(spec, tuple(interior), cfg)
        if spec.ndim == 1:
            return ShardedStencilDF64_1D(
                spec, int(np.atleast_1d(interior)[0]), cfg)
        return ShardedStencilDF64(spec, tuple(interior), cfg)
    if spec.ndim == 3:
        return ShardedStencil3D(spec, tuple(interior), cfg)
    if spec.ndim == 1:
        return ShardedStencil1D(spec, int(np.atleast_1d(interior)[0]), cfg)
    return ShardedStencil2D(spec, tuple(interior), cfg)


def sharded_engine_for_coeffs(coeffs, interior, mesh_shape, name="custom",
                              halo=None, max_rank: int = 4, **kw):
    """Sharded engine for arbitrary dense coefficients (1-D taps or a
    2-D matrix): factorization as in StencilEngine.for_coeffs, then
    domain decomposition over the mesh."""
    from ..engine import StencilEngine

    spec = StencilEngine.for_coeffs(
        np.asarray(coeffs, np.float64), interior, name=name, halo=halo,
        max_rank=max_rank).spec
    return sharded_engine(spec, interior, mesh_shape, **kw)
