"""Where a step runs, decided in one place.

The platform of ``jax.devices()[0]`` picks the path:

* ``gpu`` -- the compiled path: the 2-D Hopper kernel (ops/hopper2d.py)
  where it applies, XLA's compilation of the plain step
  (ops/plain.py) everywhere else;
* ``cpu`` -- the plain step, compiled by XLA for the CPU;
* any other platform raises.

Nothing is emulated: the CUDA kernel has no interpret mode, and no path
falls back to another device.  This module also places JAX's persistent
compilation cache (:func:`setup_compile_cache`).
"""

from __future__ import annotations

import os
import subprocess

import jax

BACKENDS = ("auto", "xla", "kernel")

# fixed cache directory in the checkout (listed in .gitignore); the path
# is part of the cache key, so it must not move between runs
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")


def platform() -> str:
    """The platform JAX runs on (``jax.devices()[0].platform``)."""
    return jax.devices()[0].platform


def resolve(requested: str, kernel_applies: bool,
            plat: "str | None" = None, fused_steps=None) -> str:
    """The step path, ``"kernel"`` or ``"xla"``, for a requested backend.

    ``"auto"`` takes the kernel on a GPU when ``kernel_applies`` and the
    caller did not fix ``fused_steps`` at 1 -- the kernel loses to XLA at
    one step per pass and wins from two (PERF.md, Findings) -- else XLA;
    ``"xla"`` always takes XLA; ``"kernel"`` insists on the kernel and
    raises where it cannot run.  Platforms other than gpu and cpu
    raise."""
    plat = platform() if plat is None else plat
    if plat not in ("gpu", "cpu"):
        raise RuntimeError(
            f"no step path for platform {plat!r}: lorastencil runs on an "
            f"NVIDIA GPU or on the CPU")
    if requested not in BACKENDS:
        raise ValueError(
            f"backend must be one of {BACKENDS}, got {requested!r}")
    if requested == "kernel":
        if plat != "gpu":
            raise ValueError(
                "backend='kernel' needs a GPU: the CUDA kernel has no "
                "interpret mode")
        if not kernel_applies:
            raise ValueError(
                "backend='kernel': no kernel covers this stencil "
                "(2-D, radius <= 4, float32 or bfloat16 state)")
        return "kernel"
    if (requested == "auto" and plat == "gpu" and kernel_applies
            and fused_steps != 1):
        return "kernel"
    return "xla"


def require_gpu() -> str:
    """Exit with an error unless JAX runs on a GPU; returns the device
    kind.  For entry points whose numbers mean something only on the
    card (bench.py, chip_smoke.py)."""
    try:
        dev = jax.devices()[0]
    except RuntimeError as e:  # no backend at all
        raise SystemExit(f"no JAX device: {e}")
    if dev.platform != "gpu":
        raise SystemExit(
            f"this entry point measures the GPU; JAX found "
            f"{dev.platform!r} ({dev.device_kind})")
    return dev.device_kind


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and
    nothing is set here; otherwise the cache goes to ``.jax_cache/`` in
    the checkout.  Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def card_info() -> str:
    """The GPU's name and power limit as ``nvidia-smi`` reports them
    (``name, power.limit``, one line per card); a card set below its
    maximum power runs slower under load, so every timing is reported
    beside this line."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip() or out.stderr.strip()
