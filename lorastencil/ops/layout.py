"""Internal grid layouts.

The user-facing state is the reference-compatible padded array
(interior + halo, e.g. ``(m+8, n+8)`` for 2-D -- ``src/2d/main.cu:217-218``).
Internally it is re-embedded into a buffer with a guard ring wide enough
for a whole fused pass, and an interior rounded up to whole tiles:

    rows:  [ guard | interior rows (padded to tile multiple) | guard ]
    cols:  [ guard 128 | interior cols (padded to tile multiple) | guard 128 ]

The 128-column guard keeps every row of the interior 512-byte aligned in
fp32, so a step's loads and stores start on whole memory transactions.

The user halo lives in the innermost cells of the guard bands (width =
spec.halo); everything else in the guard is zero and *stays* zero: a step
writes only the interior extent, and the engines reuse a zero-ringed donor
buffer for the output, so halo cells decay to zero after the first step
exactly like the reference's zero-initialized ping-pong device buffers
(``src/2d/gpu.cu:396-400``; SURVEY.md section 4).

Interior cells beyond the true interior (tile round-up) are masked to zero
by every step so they never leak into real cells on later steps.  The
tile is also the unit in which the sharded engine splits its boundary
frame from its interior (parallel/domain.py).

1-D uses a flattened 2-D view: the padded 1-D array is stored row-major in
a ``(rows, 128)`` buffer where flat index = row*128 + col, with a guard of
whole rows on both sides; the user halo occupies the last cells of the
leading guard.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp

COL_ALIGN = 128
ROW_ALIGN = 8


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Layout2D:
    interior: Tuple[int, int]  # (m, n)
    halo: Tuple[int, int]
    tile: Tuple[int, int]  # (TM, TN): TM % 8 == 0, TN % 128 == 0
    # guard band: rows may exceed ROW_ALIGN when several timesteps are
    # fused per pass (halo k*radius)
    guard: Tuple[int, int] = (ROW_ALIGN, COL_ALIGN)

    @property
    def grid(self) -> Tuple[int, int]:
        m, n = self.interior
        return (_cdiv(m, self.tile[0]), _cdiv(n, self.tile[1]))

    @property
    def origin(self) -> Tuple[int, int]:
        """Internal coordinates of interior cell (0, 0)."""
        return self.guard

    @property
    def shape(self) -> Tuple[int, int]:
        gi, gj = self.grid
        gr, gc = self.guard
        return (gr + gi * self.tile[0] + gr, gc + gj * self.tile[1] + gc)

    def validate(self):
        hm, hn = self.halo
        gr, gc = self.guard
        assert self.tile[0] % ROW_ALIGN == 0
        assert self.tile[1] % COL_ALIGN == 0
        assert gr % ROW_ALIGN == 0 and gc % COL_ALIGN == 0
        assert hm <= gr and hn <= gc, "halo must fit in the guard"

    def to_internal(self, padded, dtype=jnp.float32):
        """Embed a user padded array (m+2*hm, n+2*hn) into the internal
        buffer (user halo goes into the guard ring)."""
        m, n = self.interior
        hm, hn = self.halo
        buf = jnp.zeros(self.shape, dtype=dtype)
        r0, c0 = self.origin
        return buf.at[r0 - hm: r0 + m + hm, c0 - hn: c0 + n + hn].set(
            jnp.asarray(padded, dtype=dtype)
        )

    def from_internal(self, buf):
        """Extract the user padded array from the internal buffer."""
        m, n = self.interior
        hm, hn = self.halo
        r0, c0 = self.origin
        return buf[r0 - hm: r0 + m + hm, c0 - hn: c0 + n + hn]


@dataclasses.dataclass(frozen=True)
class Layout1D:
    interior: int  # n
    halo: int
    tile_rows: int  # rows of 128 cells per tile
    # guard rows on each side of the interior (multiple of ROW_ALIGN):
    # a fused pass reads k*radius cells into it
    guard_rows: int = ROW_ALIGN

    @property
    def grid(self) -> Tuple[int]:
        return (_cdiv(self.interior, self.tile_rows * COL_ALIGN),)

    @property
    def origin(self) -> int:
        """Flat internal index of interior element 0."""
        return self.guard_rows * COL_ALIGN

    @property
    def shape(self) -> Tuple[int, int]:
        (g,) = self.grid
        return (self.guard_rows + g * self.tile_rows + self.guard_rows,
                COL_ALIGN)

    def validate(self):
        assert self.halo <= self.guard_rows * COL_ALIGN
        assert self.tile_rows % ROW_ALIGN == 0
        assert (self.guard_rows % ROW_ALIGN == 0
                and self.guard_rows >= ROW_ALIGN)

    def to_internal(self, padded, dtype=jnp.float32):
        n, h = self.interior, self.halo
        buf = jnp.zeros(self.shape[0] * COL_ALIGN, dtype=dtype)
        buf = buf.at[self.origin - h: self.origin + n + h].set(
            jnp.asarray(padded, dtype=dtype)
        )
        return buf.reshape(self.shape)

    def from_internal(self, buf):
        n, h = self.interior, self.halo
        flat = buf.reshape(-1)
        return flat[self.origin - h: self.origin + n + h]


@dataclasses.dataclass(frozen=True)
class Layout3D:
    interior: Tuple[int, int, int]  # (h, m, n)
    halo: Tuple[int, int, int]      # (1, 2, 4) for the reference shapes
    tile: Tuple[int, int]           # (TM, TN) in-plane tile
    # z guard planes (>= halo[0]; widened to fused_steps*radius when
    # timesteps are fused)
    zguard: int = 1

    @property
    def grid(self) -> Tuple[int, int]:
        _, m, n = self.interior
        return (_cdiv(m, self.tile[0]), _cdiv(n, self.tile[1]))

    @property
    def origin(self) -> Tuple[int, int, int]:
        return (self.zguard, ROW_ALIGN, COL_ALIGN)

    @property
    def shape(self) -> Tuple[int, int, int]:
        h = self.interior[0]
        gi, gj = self.grid
        return (h + 2 * self.zguard,
                ROW_ALIGN + gi * self.tile[0] + ROW_ALIGN,
                COL_ALIGN + gj * self.tile[1] + COL_ALIGN)

    def validate(self):
        assert self.tile[0] % ROW_ALIGN == 0
        assert self.tile[1] % COL_ALIGN == 0
        assert self.halo[1] <= ROW_ALIGN and self.halo[2] <= COL_ALIGN
        assert self.zguard >= self.halo[0]

    def to_internal(self, padded, dtype=jnp.float32):
        h, m, n = self.interior
        hz, hm, hn = self.halo
        buf = jnp.zeros(self.shape, dtype=dtype)
        z0, r0, c0 = self.origin
        return buf.at[z0 - hz: z0 + h + hz,
                      r0 - hm: r0 + m + hm,
                      c0 - hn: c0 + n + hn].set(
            jnp.asarray(padded, dtype=dtype)
        )

    def from_internal(self, buf):
        h, m, n = self.interior
        hz, hm, hn = self.halo
        z0, r0, c0 = self.origin
        return buf[z0 - hz: z0 + h + hz,
                   r0 - hm: r0 + m + hm,
                   c0 - hn: c0 + n + hn]


def default_tile_2d(m: int, n: int) -> Tuple[int, int]:
    """Round-up tile of the 2-D layout: at most (256, 512), shrunk to
    the interior on small grids so the round-up stays small."""
    return (min(256, ROW_ALIGN * _cdiv(m, ROW_ALIGN)),
            min(512, COL_ALIGN * _cdiv(n, COL_ALIGN)))


def divisor_tile_2d(m: int, n: int) -> Tuple[int, int]:
    """Largest (8-multiple, 128-multiple) tile <= (256, 512) that
    DIVIDES (m, n): a sharded local block padded to the default tile
    would waste the difference."""
    tm = ROW_ALIGN
    for c in range(256, ROW_ALIGN - 1, -ROW_ALIGN):
        if m % c == 0:
            tm = c
            break
    tn = COL_ALIGN
    for c in range(512, COL_ALIGN - 1, -COL_ALIGN):
        if n % c == 0:
            tn = c
            break
    return (tm, tn)


def default_tile_3d(m: int, n: int) -> Tuple[int, int]:
    """In-plane round-up tile of the 3-D layout: at most (64, 512)."""
    return (min(64, ROW_ALIGN * _cdiv(m, ROW_ALIGN)),
            min(512, COL_ALIGN * _cdiv(n, COL_ALIGN)))
