"""Stencil shape definitions (the framework's "model zoo").

A stencil update is ``out[p] = sum_o S[o] * in[p + o]`` over a dense
coefficient array ``S`` of shape ``(2r+1,)*ndim``.  LoRAStencil's core idea
(reference: ``reference/src/2d/gpu.cu:280-350``) is that ``S`` is (close
to) low rank, so the update decomposes into a sum of *separable* rank-1 terms
-- one 1-D convolution per axis -- plus a small sparse residue (the
reference runs each 1-D convolution as a banded-matrix product on tensor
cores).

This module defines the declarative spec (`StencilSpec`) and registers the
eight shapes the reference artifact supports, with the exact coefficient
values from the reference drivers:

  * 1d1r / 1d2r          taps from ``src/1d/main.cu:77-78``
  * star2d1r             pyramid, ``src/2d/main.cu:187-195``
  * star2d3r             cross,   ``src/2d/main.cu:177-184``
  * box2d3r (box2d1r)    rank-3 symmetric box, ``src/2d/main.cu:151-167``
  * star3d1r             7-point, ``src/3d/main.cu:121-125``
  * box3d1r              27-point separable, ``src/3d/main.cu:112-119``

Halo widths and interior regions follow the reference exactly:
1-D halo 4 (``src/1d/main.cu:96``), 2-D halo 4 on both axes
(``src/2d/main.cu:217-218``), 3-D halos (1, 2, 4) for (z, row, col)
(``src/3d/main.cu:21-23``).  The per-shape ``fuse_factor`` is the
temporal-fusion equivalence factor used in the GStencil/s metric
(``src/1d/gpu_1r.cu:132`` etc.).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

Taps = Tuple[float, ...]


@dataclasses.dataclass(frozen=True)
class SeparableTerm:
    """One separable (rank-1 across axes) term of a stencil.

    ``taps[a]`` is the 1-D convolution kernel along axis ``a`` (odd length,
    centered), or ``None`` meaning the identity along that axis (a delta at
    the center -- no convolution is performed).  The dense contribution of
    the term is the outer product of its per-axis taps (with ``None``
    treated as a centered delta).
    """

    taps: Tuple[Optional[Taps], ...]

    def dense(self, radius: int) -> np.ndarray:
        """Dense (2*radius+1,)*ndim coefficient array of this term."""
        ndim = len(self.taps)
        out = np.ones((1,) * ndim, dtype=np.float64)
        full = 2 * radius + 1
        axes = []
        for t in self.taps:
            if t is None:
                v = np.zeros(full)
                v[radius] = 1.0
            else:
                v = np.asarray(t, dtype=np.float64)
                assert v.size % 2 == 1, "taps must have odd length"
                pad = (full - v.size) // 2
                assert pad >= 0, f"taps longer than stencil width {full}"
                v = np.pad(v, (pad, pad))
            axes.append(v)
        out = axes[0]
        for v in axes[1:]:
            out = np.multiply.outer(out, v)
        return out


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    """A complete stencil shape: separable terms + sparse residue.

    dense_coeffs = sum(term.dense() for term in terms)
                   + sum(w * delta(offset) for offset, w in residue)
    """

    name: str
    ndim: int
    radius: int
    halo: Tuple[int, ...]  # per-axis halo width of the padded layout
    terms: Tuple[SeparableTerm, ...]
    # ((offset per axis, relative to center), weight)
    residue: Tuple[Tuple[Tuple[int, ...], float], ...]
    fuse_factor: int  # temporal-fusion equivalence factor for GStencil/s

    def dense_coeffs(self) -> np.ndarray:
        """Dense coefficient array, shape (2*radius+1,)*ndim, float64."""
        full = 2 * self.radius + 1
        S = np.zeros((full,) * self.ndim, dtype=np.float64)
        for t in self.terms:
            S = S + t.dense(self.radius)
        for off, w in self.residue:
            idx = tuple(self.radius + o for o in off)
            S[idx] += w
        return S

    @property
    def interior_offset(self) -> Tuple[int, ...]:
        return self.halo

    def padded_shape(self, interior: Sequence[int]) -> Tuple[int, ...]:
        return tuple(s + 2 * h for s, h in zip(interior, self.halo))

    def axis_symmetric(self) -> bool:
        """True when the dense coefficients are mirror-symmetric along
        every axis (all eight reference shapes are).  Mirror symmetry
        commutes with the stencil, which is what makes reflect
        boundaries exact under temporal fusion."""
        S = self.dense_coeffs()
        return all(bool(np.allclose(S, np.flip(S, axis=a)))
                   for a in range(self.ndim))

    def flipped(self) -> "StencilSpec":
        """The point-reflected stencil S'[o] = S[-o]: per-axis taps
        reversed, residue offsets negated.  The adjoint (transpose) of
        the linear stencil operator is the flipped stencil -- the basis
        of the exact custom VJP (engine.run_diff).  All eight reference
        shapes are symmetric, so their flip is themselves; custom
        coefficients need the real flip."""
        terms = tuple(
            SeparableTerm(taps=tuple(
                None if t is None else tuple(reversed(t))
                for t in term.taps))
            for term in self.terms)
        residue = tuple(
            (tuple(-o for o in off), w) for off, w in self.residue)
        return dataclasses.replace(
            self, name=self.name + "_adj", terms=terms, residue=residue)


def _pyramid_star2d1r() -> np.ndarray:
    """The 7x7 star2d1r coefficients (src/2d/main.cu:187-195)."""
    return np.array(
        [
            [0, 0, 0, 1, 0, 0, 0],
            [0, 0, 2, 4, 2, 0, 0],
            [0, 2, 4, 8, 4, 2, 0],
            [1, 4, 8, 16, 8, 4, 1],
            [0, 2, 4, 8, 4, 2, 0],
            [0, 0, 2, 4, 2, 0, 0],
            [0, 0, 0, 1, 0, 0, 0],
        ],
        dtype=np.float64,
    )


def _box2d_coeffs() -> np.ndarray:
    """The 7x7 box coefficients (src/2d/main.cu:151-167): an exactly
    rank-3 symmetric matrix (center forced to 8)."""
    S = np.zeros((7, 7), dtype=np.float64)
    num = 1
    for i in range(-3, 1):
        for j in range(-3, 1):
            if i <= j:
                for a, b in {(i, j), (-i, j), (i, -j), (-i, -j),
                             (j, i), (-j, i), (j, -i), (-j, -i)}:
                    S[a + 3, b + 3] = num
                num += 1
    S[3, 3] = 8.0
    return S


def _star2d3r_coeffs() -> np.ndarray:
    """The 7x7 star2d3r cross (src/2d/main.cu:177-184)."""
    S = np.zeros((7, 7), dtype=np.float64)
    num = 1
    for i in range(-3, 1):
        S[i + 3, 3] = num
        S[-i + 3, 3] = num
        S[3, i + 3] = num
        S[3, -i + 3] = num
        num += 1
    return S


def _residue_from(S: np.ndarray, terms: Sequence[SeparableTerm], radius: int):
    """Sparse residue = S - sum(terms), as ((offsets), weight) tuples."""
    R = S.astype(np.float64).copy()
    for t in terms:
        R = R - t.dense(radius)
    out = []
    for idx in np.argwhere(np.abs(R) > 1e-12):
        off = tuple(int(i) - radius for i in idx)
        out.append((off, float(R[tuple(idx)])))
    return tuple(out)


def _build_registry():
    reg = {}

    # ---- 1-D ----------------------------------------------------------
    # taps {0,1,2,3,4,3,2,1,0} = [1,1,1,1] (*) [1,1,1,1]: 3 fused unit steps
    taps_1d1r = (0.0, 1.0, 2.0, 3.0, 4.0, 3.0, 2.0, 1.0, 0.0)
    reg["1d1r"] = StencilSpec(
        name="1d1r", ndim=1, radius=4, halo=(4,),
        terms=(SeparableTerm(taps=(taps_1d1r,)),),
        residue=(), fuse_factor=3,
    )
    taps_1d2r = (1.0, 2.0, 3.0, 4.0, 5.0, 4.0, 3.0, 2.0, 1.0)
    reg["1d2r"] = StencilSpec(
        name="1d2r", ndim=1, radius=4, halo=(4,),
        terms=(SeparableTerm(taps=(taps_1d2r,)),),
        residue=(), fuse_factor=2,
    )

    # ---- 2-D ----------------------------------------------------------
    # star2d1r: S = u u^T + 9-point residue (u from src/2d/gpu.cu:486-487)
    u = (0.0, 1.0, 2.0, 4.0, 2.0, 1.0, 0.0)
    star1_terms = (SeparableTerm(taps=(u, u)),)
    S = _pyramid_star2d1r()
    reg["star2d1r"] = StencilSpec(
        name="star2d1r", ndim=2, radius=3, halo=(4, 4),
        terms=star1_terms,
        residue=_residue_from(S, star1_terms, 3),
        fuse_factor=3,
    )

    # star2d3r: cross = column-axis conv + row-axis conv (center once).
    # One-sided terms: axis-0 conv with full taps, axis-1 conv with
    # center-zeroed taps (src/2d/gpu.cu:433-444).
    Sx = _star2d3r_coeffs()
    col_taps = tuple(Sx[:, 3])              # (1,2,3,4,3,2,1) along rows
    row_taps = list(Sx[3, :])
    row_taps[3] = 0.0                # center counted once (column term only)
    star3_terms = (
        SeparableTerm(taps=(col_taps, None)),
        SeparableTerm(taps=(None, tuple(row_taps))),
    )
    reg["star2d3r"] = StencilSpec(
        name="star2d3r", ndim=2, radius=3, halo=(4, 4),
        terms=star3_terms,
        residue=_residue_from(Sx, star3_terms, 3),  # empty by construction
        fuse_factor=1,
    )

    # box2d3r: exactly rank-3; factor via the pivot peel (factorize.py).
    from . import factorize  # local import to avoid cycle at module load

    Sb = _box2d_coeffs()
    uv = factorize.pivot_peel(Sb, pivots=((0, 0), (1, 1), (2, 2)))
    box_terms = tuple(
        SeparableTerm(taps=(tuple(a), tuple(b))) for a, b in uv.terms
    )
    reg["box2d3r"] = StencilSpec(
        name="box2d3r", ndim=2, radius=3, halo=(4, 4),
        terms=box_terms,
        residue=_residue_from(Sb, box_terms, 3),  # exactly empty (rank 3)
        fuse_factor=3,
    )
    # box2d1r aliases the box2d3r path (src/2d/main.cu:276-278)
    reg["box2d1r"] = dataclasses.replace(reg["box2d3r"], name="box2d1r")

    # ---- 3-D ----------------------------------------------------------
    # star3d1r 7-point: z +/- 1 identity planes + in-plane cross
    # (src/3d/main.cu:121-125; kernel structure src/3d/gpu_star.cu:110-131)
    reg["star3d1r"] = StencilSpec(
        name="star3d1r", ndim=3, radius=1, halo=(1, 2, 4),
        terms=(
            SeparableTerm(taps=((1.0, 0.0, 1.0), None, None)),
            SeparableTerm(taps=(None, (1.0, 1.0, 1.0), None)),
            SeparableTerm(taps=(None, None, (1.0, 1.0, 1.0))),
        ),
        residue=(), fuse_factor=1,
    )
    # box3d1r: fully separable [1,1,1] x [1,1,1] x [1,2,1]
    # (src/3d/main.cu:112-119: param[i] = [1,2,1][i % 3])
    reg["box3d1r"] = StencilSpec(
        name="box3d1r", ndim=3, radius=1, halo=(1, 2, 4),
        terms=(
            SeparableTerm(taps=((1.0, 1.0, 1.0), (1.0, 1.0, 1.0),
                                (1.0, 2.0, 1.0))),
        ),
        residue=(), fuse_factor=1,
    )
    return reg


_REGISTRY = None


def registry():
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = _build_registry()
    return _REGISTRY


def get_shape(name: str) -> StencilSpec:
    reg = registry()
    if name not in reg:
        raise KeyError(f"unknown stencil shape {name!r}; have {sorted(reg)}")
    return reg[name]


ALL_SHAPES = (
    "1d1r", "1d2r",
    "star2d1r", "box2d1r", "star2d3r", "box2d3r",
    "star3d1r", "box3d1r",
)
