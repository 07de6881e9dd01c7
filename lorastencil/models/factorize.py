"""Coefficient factorization: turn a dense stencil coefficient matrix into
separable rank-1 terms + a sparse residue.

This generalizes the reference's host-side Gaussian "rank peel"
(``reference/src/2d/gpu.cu:280-350``), which peels rank-1 cross terms
off a doubly-symmetric 7x7 matrix using diagonal pivots (0,0), (1,1), (2,2)
and keeps whatever is left as a residual.  Here the peel works for any
square matrix and any pivot sequence, and an SVD fallback handles matrices
the peel cannot reduce.  Temporal fusion (pre-fusing k radius-r steps into
one radius-k*r step by self-convolving the taps -- the trick behind the
reference's fuse factors, see SURVEY.md section 0.6) is `fuse_taps` /
`fuse_coeffs`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class PeelResult:
    terms: Tuple[Tuple[np.ndarray, np.ndarray], ...]  # (u, v): u v^T terms
    residual: np.ndarray  # S - sum(u v^T)


def pivot_peel(
    S: np.ndarray,
    pivots: Optional[Sequence[Tuple[int, int]]] = None,
    tol: float = 1e-12,
) -> PeelResult:
    """Peel rank-1 terms off ``S`` by Gaussian elimination at given pivots.

    Each step subtracts ``R[:, pj] R[pi, :] / R[pi, pj]`` (the rank-1 cross
    through the pivot), which zeroes the pivot's entire row and column.  For
    the reference's box coefficients with pivots on the diagonal this
    reproduces its factorization exactly (outer ring -> inner), leaving a
    zero residual.  Pivots with |value| <= tol are skipped.

    Returns terms (u, v) with ``contribution = outer(u, v)`` where ``u``
    indexes axis 0 (rows) and ``v`` axis 1 (cols).
    """
    R = np.asarray(S, dtype=np.float64).copy()
    n = R.shape[0]
    if pivots is None:
        pivots = [(i, i) for i in range(n // 2 + 1)]
    terms = []
    for (pi, pj) in pivots:
        p = R[pi, pj]
        if abs(p) <= tol:
            continue
        u = R[:, pj].copy() / p
        v = R[pi, :].copy()
        R = R - np.outer(u, v)
        terms.append((u, v))
    return PeelResult(terms=tuple(terms), residual=R)


def greedy_peel(S: np.ndarray, max_rank: int = 6,
                tol: float = 1e-12) -> PeelResult:
    """Rank-1 peel at the largest-magnitude pivot, repeatedly.

    For sparse integer-valued residue matrices (e.g. star2d1r's 8-point
    residue) this yields a small set of separable terms with simple
    rational taps."""
    R = np.asarray(S, dtype=np.float64).copy()
    terms = []
    for _ in range(max_rank):
        idx = np.unravel_index(np.argmax(np.abs(R)), R.shape)
        p = R[idx]
        if abs(p) <= tol:
            break
        u = R[:, idx[1]].copy() / p
        v = R[idx[0], :].copy()
        R = R - np.outer(u, v)
        terms.append((u, v))
    return PeelResult(terms=tuple(terms), residual=R)


def svd_decompose(S: np.ndarray, max_rank: int,
                  tol: float = 1e-10) -> PeelResult:
    """Rank-truncated SVD of ``S``: terms (u_t, v_t) with residual."""
    S = np.asarray(S, dtype=np.float64)
    U, s, Vt = np.linalg.svd(S)
    terms = []
    approx = np.zeros_like(S)
    for t in range(min(max_rank, s.size)):
        if s[t] <= tol * s[0]:
            break
        u = U[:, t] * s[t]
        v = Vt[t, :]
        terms.append((u, v))
        approx += np.outer(u, v)
    return PeelResult(terms=tuple(terms), residual=S - approx)


def sparse_residue(R: np.ndarray, tol: float = 1e-12):
    """Nonzero entries of a residual as ((offsets), weight), centered."""
    R = np.asarray(R, dtype=np.float64)
    radius = tuple((s - 1) // 2 for s in R.shape)
    out = []
    for idx in np.argwhere(np.abs(R) > tol):
        off = tuple(int(i) - r for i, r in zip(idx, radius))
        out.append((off, float(R[tuple(idx)])))
    return tuple(out)


def decompose_2d(
    S: np.ndarray,
    max_rank: int = 4,
    residue_budget: int = 16,
    tol: float = 1e-10,
):
    """Best-effort decomposition of a 2-D coefficient matrix into
    (terms, residue).  Strategy, in order:

    1. diagonal pivot peel (exact for the reference's symmetric boxes);
    2. if the peel's residual is dense, rank-1 SVD + sparse residue
       (handles star2d1r-like "low rank + spikes" matrices);
    3. plain truncated SVD, keeping the leftover as residue if sparse
       enough, otherwise raising.

    Returns (terms, residue) where terms is a tuple of (u, v) pairs.
    """
    S = np.asarray(S, dtype=np.float64)

    def nnz(R):
        return int(np.sum(np.abs(R) > tol))

    best = None
    peel = pivot_peel(S, tol=tol)
    if len(peel.terms) <= max_rank and nnz(peel.residual) <= residue_budget:
        best = peel
    if best is None:
        for r in range(1, max_rank + 1):
            cand = svd_decompose(S, max_rank=r, tol=tol)
            if nnz(cand.residual) <= residue_budget:
                best = cand
                break
    if best is None:
        raise ValueError(
            f"cannot decompose {S.shape} stencil into <= {max_rank} separable "
            f"terms with <= {residue_budget} residue points"
        )
    return best.terms, sparse_residue(best.residual, tol=tol)


def decompose_3d(
    S: np.ndarray,
    max_rank: int = 4,
    residue_budget: int = 24,
    max_terms: Optional[int] = None,
    tol: float = 1e-10,
):
    """Best-effort decomposition of a 3-D coefficient array into
    separable (tz, u, v) terms + a sparse residue.  Strategy:

    1. **fully separable z**: if the z-unfolding (nz, nr*nc) is rank 1,
       ``S = a (x) P`` -- one 2-D decomposition of the plane ``P`` with
       the z taps ``a`` shared by every term (the box3d1r structure,
       ``reference/src/3d/main.cu:112-119``); ``a`` is normalized
       so its largest tap is exactly 1.0 (the kernels' w == +-1
       shortcut);
    2. otherwise **per-z-plane**: each nonzero plane decomposes in 2-D
       with a delta z tap (near-single-point planes go straight to the
       residue).

    ``max_rank`` bounds each 2-D decomposition; ``max_terms`` (default
    ``3 * nz``) bounds the total term count.  Returns (terms, residue)
    with terms a tuple of (tz, u, v) tap tuples and residue
    ((dz, dr, dc), w) points."""
    S = np.asarray(S, dtype=np.float64)
    assert S.ndim == 3 and all(s % 2 for s in S.shape), S.shape
    nz = S.shape[0]
    rz = (nz - 1) // 2
    r2 = tuple((s - 1) // 2 for s in S.shape[1:])
    if max_terms is None:
        max_terms = 3 * nz
    flat = S.reshape(nz, -1)
    _, s, _ = np.linalg.svd(flat, full_matrices=False)
    terms3, residue3 = [], []
    if s.size == 0 or s[0] <= tol:
        return (), ()
    use_rank1 = s.size == 1 or (s[1:] <= tol * s[0]).all()
    rank1_resid = ()
    if use_rank1:
        iz = int(np.argmax(np.max(np.abs(flat), axis=1)))
        k = int(np.argmax(np.abs(flat[iz])))
        a = flat[:, k] / flat[iz, k]  # largest-|.| z tap == 1.0 exactly
        # exact reconstruction check AT MACHINE PRECISION: the SVD gap
        # test above accepts deviations up to ~tol (1e-10) relative,
        # which silently dropped would break the df64 tier's
        # ~1e-14/step accuracy contract (advisor finding, round 4).
        # Push the rank-1 reconstruction residual S - a (x) S[iz] into
        # the sparse residue when it is sparse; fall back to the
        # per-plane path when it is dense.
        R = S - a[:, None, None] * S[iz][None]
        eps = 1e-15 * np.abs(S).max()
        rank1_resid = tuple(map(tuple, np.argwhere(np.abs(R) > eps)))
        if len(rank1_resid) > residue_budget:
            use_rank1 = False
    if use_rank1:
        # rank-1 z-unfolding: S = a (x) S[iz] + sparse machine-eps
        # residual (rank1_resid, usually empty)
        terms2, residue2 = decompose_2d(S[iz], max_rank=max_rank,
                                        residue_budget=residue_budget,
                                        tol=tol)
        for u, v in terms2:
            terms3.append((tuple(a), tuple(u), tuple(v)))
        for (dr, dc), w in residue2:
            for z in range(nz):
                if abs(a[z]) > tol:
                    residue3.append(((z - rz, dr, dc), float(a[z] * w)))
        for idx in rank1_resid:
            residue3.append(((int(idx[0]) - rz, int(idx[1]) - r2[0],
                              int(idx[2]) - r2[1]), float(R[idx])))
    else:
        for z in range(nz):
            plane = S[z]
            nn = np.argwhere(np.abs(plane) > tol)
            if len(nn) == 0:
                continue
            if len(nn) <= 2:
                for idx in nn:
                    residue3.append((
                        (z - rz, int(idx[0]) - r2[0], int(idx[1]) - r2[1]),
                        float(plane[tuple(idx)])))
                continue
            dz = tuple(1.0 if i == z else 0.0 for i in range(nz))
            terms2, residue2 = decompose_2d(
                plane, max_rank=max_rank, residue_budget=residue_budget,
                tol=tol)
            for u, v in terms2:
                terms3.append((dz, tuple(u), tuple(v)))
            for (dr, dc), w in residue2:
                residue3.append(((z - rz, dr, dc), w))
    if len(terms3) > max_terms or len(residue3) > residue_budget:
        raise ValueError(
            f"cannot decompose {S.shape} stencil within {max_terms} "
            f"separable terms / {residue_budget} residue points "
            f"(got {len(terms3)} terms, {len(residue3)} points)")
    return tuple(terms3), tuple(residue3)


def fuse_taps(taps: Sequence[float], k: int) -> np.ndarray:
    """Temporal fusion of 1-D taps: k-fold self-convolution.

    Applying the fused taps once equals applying ``taps`` k times, so the
    GStencil/s metric may be multiplied by k (the reference's fuse factor;
    e.g. 1d1r's {0,1,2,3,4,3,2,1,0} = [1,1,1,1] self-convolved, counted x3:
    ``src/1d/gpu_1r.cu:132``).
    """
    t = np.asarray(taps, dtype=np.float64)
    out = np.array([1.0])
    for _ in range(k):
        out = np.convolve(out, t)
    return out


def fuse_coeffs(S: np.ndarray, k: int) -> np.ndarray:
    """k-fold self-convolution of a dense N-D coefficient array."""
    S = np.asarray(S, dtype=np.float64)
    out = np.zeros((1,) * S.ndim)
    out[(0,) * S.ndim] = 1.0
    for _ in range(k):
        out = _convolve_full_nd(out, S)
    return out


def _convolve_full_nd(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out_shape = tuple(x + y - 1 for x, y in zip(a.shape, b.shape))
    out = np.zeros(out_shape, dtype=np.float64)
    for idx in np.ndindex(a.shape):
        if a[idx] != 0.0:
            sl = tuple(slice(i, i + s) for i, s in zip(idx, b.shape))
            out[sl] += a[idx] * b
    return out


def banded_matrix(
    taps: Sequence[float], n_out: int, dtype=np.float32
) -> np.ndarray:
    """Banded (Toeplitz) matrix B of shape (n_out + 2r, n_out) such that for
    a window ``x`` of length ``n_out + 2r`` (the output extended by radius r
    on both sides), ``x @ B`` equals the valid 1-D correlation of ``x`` with
    ``taps``:  out[c] = sum_k taps[k] * x[c + k].

    This is the reference's 16x8 banded parameter matrix
    (``src/1d/gpu_1r.cu:94-99``, ``src/2d/gpu.cu:429-444``) at any size:
    B[c + k, c] = taps[k].
    """
    t = np.asarray(taps, dtype=np.float64)
    w = t.size
    B = np.zeros((n_out + w - 1, n_out), dtype=np.float64)
    for k in range(w):
        idx = np.arange(n_out)
        B[idx + k, idx] = t[k]
    return B.astype(dtype)
