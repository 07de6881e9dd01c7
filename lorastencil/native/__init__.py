"""ctypes bindings for the native host core (liblorastencil_core.so).

The reference's host layer is C++ (factorization + banded-matrix
construction + chrono metrics, reference/src/2d/gpu.cu:280-387);
this package is the framework's equivalent.  If the shared library has
not been built (``python -m lorastencil.native.build``), every entry
point transparently falls back to the NumPy implementations in
models/factorize.py -- tests assert the two agree exactly.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence, Tuple

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "liblorastencil_core.so")
_lib = None


_load_failed = False


def load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed or not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.ls_abi_version.restype = ctypes.c_int
    if lib.ls_abi_version() != 2:
        # stale binary from an older source tree: fall back to NumPy
        # rather than binding symbols it may not export
        _load_failed = True
        return None
    dp = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    ip = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.ls_pivot_peel.restype = ctypes.c_int
    lib.ls_pivot_peel.argtypes = [dp, ctypes.c_int, ip, ctypes.c_int,
                                  ctypes.c_double, dp]
    lib.ls_banded_matrix.restype = None
    lib.ls_banded_matrix.argtypes = [dp, ctypes.c_int, ctypes.c_int, dp]
    lib.ls_fuse_taps.restype = None
    lib.ls_fuse_taps.argtypes = [dp, ctypes.c_int, ctypes.c_int, dp]
    lib.ls_fuse_coeffs_2d.restype = None
    lib.ls_fuse_coeffs_2d.argtypes = [dp, ctypes.c_int, ctypes.c_int, dp]
    lib.ls_dense_step_2d.restype = None
    lib.ls_dense_step_2d.argtypes = [dp, dp, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, dp,
                                     ctypes.c_int]
    lib.ls_dense_step_1d.restype = None
    lib.ls_dense_step_1d.argtypes = [dp, dp, ctypes.c_int, ctypes.c_int,
                                     dp, ctypes.c_int]
    lib.ls_dense_step_3d.restype = None
    lib.ls_dense_step_3d.argtypes = [dp, dp, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, dp,
                                     ctypes.c_int]
    lib.ls_monotonic_ns.restype = ctypes.c_int64
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def pivot_peel(S: np.ndarray, pivots: Sequence[Tuple[int, int]],
               tol: float = 1e-12):
    """Native pivot peel; same contract as factorize.pivot_peel."""
    lib = load()
    if lib is None:
        from ..models import factorize
        return factorize.pivot_peel(S, pivots=pivots, tol=tol)
    S = np.ascontiguousarray(S, dtype=np.float64)
    n = S.shape[0]
    R = S.copy()
    piv = np.asarray(pivots, dtype=np.int32).reshape(-1)
    terms_buf = np.zeros((len(pivots), 2 * n), dtype=np.float64)
    nt = lib.ls_pivot_peel(R, n, piv, len(pivots), tol, terms_buf)
    from ..models.factorize import PeelResult
    terms = tuple(
        (terms_buf[t, :n].copy(), terms_buf[t, n:].copy()) for t in range(nt)
    )
    return PeelResult(terms=terms, residual=R)


def banded_matrix(taps, n_out: int, dtype=np.float32) -> np.ndarray:
    lib = load()
    if lib is None:
        from ..models import factorize
        return factorize.banded_matrix(taps, n_out, dtype=dtype)
    t = np.ascontiguousarray(taps, dtype=np.float64)
    B = np.zeros((n_out + t.size - 1, n_out), dtype=np.float64)
    lib.ls_banded_matrix(t, t.size, n_out, B)
    return B.astype(dtype)


def fuse_taps(taps, k: int) -> np.ndarray:
    lib = load()
    if lib is None:
        from ..models import factorize
        return factorize.fuse_taps(taps, k)
    t = np.ascontiguousarray(taps, dtype=np.float64)
    out = np.zeros(k * (t.size - 1) + 1, dtype=np.float64)
    lib.ls_fuse_taps(t, t.size, k, out)
    return out


def fuse_coeffs_2d(S: np.ndarray, k: int) -> np.ndarray:
    lib = load()
    if lib is None:
        from ..models import factorize
        return factorize.fuse_coeffs(S, k)
    S = np.ascontiguousarray(S, dtype=np.float64)
    w = S.shape[0]
    ow = k * (w - 1) + 1
    out = np.zeros((ow, ow), dtype=np.float64)
    lib.ls_fuse_coeffs_2d(S, w, k, out)
    return out


def dense_step_2d(grid: np.ndarray, S: np.ndarray, halo) -> np.ndarray:
    """Native fp64 dense reference step (2-D), C++ twin of
    utils/reference.dense_step."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library not built")
    grid = np.ascontiguousarray(grid, dtype=np.float64)
    S = np.ascontiguousarray(S, dtype=np.float64)
    r = (S.shape[0] - 1) // 2
    out = np.zeros_like(grid)
    lib.ls_dense_step_2d(grid, out, grid.shape[0], grid.shape[1],
                         halo[0], halo[1], S, r)
    return out


def dense_step_1d(grid: np.ndarray, taps: np.ndarray, halo) -> np.ndarray:
    lib = load()
    if lib is None:
        raise RuntimeError("native library not built")
    grid = np.ascontiguousarray(grid, dtype=np.float64)
    taps = np.ascontiguousarray(taps, dtype=np.float64)
    out = np.zeros_like(grid)
    lib.ls_dense_step_1d(grid, out, grid.shape[0], halo[0], taps,
                         (taps.size - 1) // 2)
    return out


def dense_step_3d(grid: np.ndarray, S: np.ndarray, halo) -> np.ndarray:
    lib = load()
    if lib is None:
        raise RuntimeError("native library not built")
    grid = np.ascontiguousarray(grid, dtype=np.float64)
    S = np.ascontiguousarray(S, dtype=np.float64)
    r = (S.shape[0] - 1) // 2
    out = np.zeros_like(grid)
    lib.ls_dense_step_3d(grid, out, grid.shape[0], grid.shape[1],
                         grid.shape[2], halo[0], halo[1], halo[2], S, r)
    return out


def dense_step(grid: np.ndarray, S: np.ndarray, halo) -> np.ndarray:
    """Dimension dispatch for the native fp64 reference step."""
    if grid.ndim == 1:
        return dense_step_1d(grid, S, halo)
    if grid.ndim == 2:
        return dense_step_2d(grid, S, halo)
    return dense_step_3d(grid, S, halo)


def monotonic_ns() -> int:
    lib = load()
    if lib is None:
        import time
        return time.monotonic_ns()
    return int(lib.ls_monotonic_ns())
