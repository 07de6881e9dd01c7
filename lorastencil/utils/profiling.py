"""Profiling helpers: device traces and roofline shares.

The reference's observability is wall-clock chrono + ptxas occupancy
flags (``reference/src/2d/gpu.cu:408-418``, CMakeLists.txt:23).
Here: ``jax.profiler`` traces, and a roofline share of a measured time
against published peak rates of the device.

The peak table is keyed by ``jax.devices()[0].device_kind``.  A device
that is not in the table gets no share (None) -- never an assumed peak.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np

from ..models.shapes import StencilSpec


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device trace: view with tensorboard --logdir=<dir>."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass(frozen=True)
class Peak:
    hbm_gbps: float        # device-memory bandwidth, GB/s
    fp32_tflops: float     # fp32 outside the tensor cores
    fp64_tflops: float     # fp64 outside the tensor cores
    source: str


# NVIDIA H100 SXM data sheet (dense rates, 700 W part): 3.35 TB/s HBM3,
# 67 TFLOP/s fp32 and 67 TFLOP/s fp64 (the fp64 tensor-core rate is
# also 67).  A card set below 700 W cannot hold these clocks.
PEAKS = {
    "NVIDIA H100 80GB HBM3": Peak(3350.0, 67.0, 67.0,
                                  "NVIDIA H100 SXM data sheet"),
}


def peak(device_kind: str) -> Optional[Peak]:
    """The published peaks of ``device_kind``, or None if unknown."""
    return PEAKS.get(device_kind)


def min_bytes_per_cell_step(dtype_bytes: int,
                            fused_steps: int = 1) -> float:
    """Least device-memory traffic of one cell-step: the state is read
    once and written once per pass of ``fused_steps`` steps."""
    return 2.0 * dtype_bytes / max(1, fused_steps)


def flops_per_cell_step(spec: StencilSpec, form: str = "dense") -> float:
    """Arithmetic of one cell-step: a multiply-add (2 FLOP) per nonzero
    dense tap, or per separable tap plus residue tap."""
    if form == "dense":
        return 2.0 * float(np.count_nonzero(spec.dense_coeffs()))
    n = sum(sum(1 for w in t if w != 0.0)
            for term in spec.terms for t in term.taps if t is not None)
    return 2.0 * float(n + len(spec.residue))


@dataclasses.dataclass
class Roofline:
    bytes_per_cell_step: float
    flops_per_cell_step: float
    bw_bound_gcells: float
    compute_bound_gcells: float

    @property
    def bound(self) -> str:
        return ("memory" if self.bw_bound_gcells <= self.compute_bound_gcells
                else "compute")

    @property
    def governing_gcells(self) -> float:
        return min(self.bw_bound_gcells, self.compute_bound_gcells)

    def share(self, gcells_per_s: float) -> float:
        """Measured rate over the governing bound."""
        return gcells_per_s / self.governing_gcells


def stencil_roofline(spec: StencilSpec, device_kind: str,
                     dtype: str = "float32", fused_steps: int = 1,
                     form: str = "dense") -> Optional[Roofline]:
    """Roofline of ``spec`` on ``device_kind`` (None if the device is not
    in PEAKS): the least bytes per cell-step over the HBM peak, and the
    FLOPs per cell-step over the fp32 (fp64 for float64) peak.  The df64
    pair chain has no single-rate model and gets None too."""
    pk = peak(device_kind)
    if pk is None or dtype == "df64":
        return None
    nbytes = {"bfloat16": 2, "float64": 8}.get(dtype, 4)
    bpc = min_bytes_per_cell_step(nbytes, fused_steps)
    fpc = flops_per_cell_step(spec, form)
    tflops = pk.fp64_tflops if dtype == "float64" else pk.fp32_tflops
    return Roofline(
        bytes_per_cell_step=bpc,
        flops_per_cell_step=fpc,
        bw_bound_gcells=pk.hbm_gbps / bpc,
        compute_bound_gcells=(tflops * 1e3 / fpc if fpc else float("inf")),
    )
