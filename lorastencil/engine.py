"""High-level stencil engine: the user-facing API of the framework.

Mirrors the reference's host API layer (one ``gpu_<shape>()`` wrapper per
shape, ``reference/src/*/*.cu`` -- coefficient factorization, device
upload, ping-pong timestep loop) as a single declarative engine:

    eng = StencilEngine.for_shape("star2d1r", interior=(4096, 4096))
    out_padded = eng.run(in_padded, steps=64)   # one jit, donated buffers

Design notes:
  * The whole multi-step loop is one jitted program (``lax.fori_loop``
    with donated ping-pong buffers) -- a single device program per call,
    never one dispatch per step like the reference's per-step kernel
    launches (``src/2d/gpu.cu:410-412``).
  * State lives in the internal layout (ops/layout.py); the
    reference-compatible padded array only appears at the boundary.
  * Each pass is one step function with one contract (ops/plain.py):
    the 2-D Hopper kernel (ops/hopper2d.py) on a GPU where it applies,
    the plain ``jax.numpy`` step compiled by XLA everywhere else
    (backend.py decides).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import backend as _backend
from .models.shapes import StencilSpec, get_shape
from .ops import hopper2d, plain, xla_ref
from .ops.layout import (COL_ALIGN, ROW_ALIGN, Layout1D, Layout2D, Layout3D,
                         default_tile_2d, default_tile_3d)

# timesteps per pass on the 2-D kernel when ``fused_steps`` is None
# (measured on the card: PERF.md, Findings); the plain step takes one
KERNEL_FUSED_STEPS = 4
MAX_KERNEL_FUSED_STEPS = 4


def _ring_refresh_nd(state, mode: str, origin, dims, d: int):
    """Axis-by-axis ghost-ring fill (depth ``d``) around the box at
    ``origin``/``dims``: 'periodic' copies the opposite interior edge,
    'reflect' mirrors the same edge, 'zero' clears the ring.  Later axes
    copy the already-written rings, so corners (and 3-D edges) compose
    exactly like np.pad / the sharded two-phase exchange."""
    ext = [slice(o, o + sdim) for o, sdim in zip(origin, dims)]
    s = state
    for a in range(len(ext)):
        o, nd = origin[a], dims[a]

        def at(sl_a, ext=tuple(ext), a=a):
            t = list(ext)
            t[a] = sl_a
            return tuple(t)

        head = s[at(slice(o, o + d))]
        tail = s[at(slice(o + nd - d, o + nd))]
        if mode == "reflect":
            lsrc = jnp.flip(head, axis=a)
            rsrc = jnp.flip(tail, axis=a)
        elif mode == "periodic":
            lsrc, rsrc = tail, head
        else:
            lsrc = rsrc = jnp.zeros_like(head)
        s = s.at[at(slice(o - d, o))].set(lsrc)
        s = s.at[at(slice(o + nd, o + nd + d))].set(rsrc)
        ext[a] = slice(o - d, o + nd + d)
    return s


def ping_pong_loop(step_fn, state, steps: int, k: int = 1):
    """Run ``steps`` timesteps via ``step_fn(cur, donor, fused_k)`` passes.

    Ping-pong with STABLE carry positions: the loop body runs two passes
    (a->b, b->a) so loop-carried buffers never swap slots -- XLA
    otherwise inserts a full-buffer copy per iteration to reconcile the
    swapped aliasing.  The first two passes run outside the loop with
    fresh zero donors: the initial state's guard ring holds the user
    halo and must never be reused as an output buffer.  A final
    remainder pass covers ``steps % k``.
    """
    if steps == 0:
        return state
    passes, rem = divmod(steps, k)

    latest, other = state, None
    done = 0
    if passes >= 1:
        latest, other = step_fn(state, jnp.zeros_like(state), k), \
            jnp.zeros_like(state)
        done = 1
    if passes >= 2:
        latest, other = step_fn(latest, other, k), latest
        done = 2
    pairs, odd = divmod(passes - done, 2)
    if pairs:
        def body(_, carry):
            x, y = carry
            y = step_fn(x, y, k)
            x = step_fn(y, x, k)
            return (x, y)

        latest, other = jax.lax.fori_loop(0, pairs, body, (latest, other))
    if odd:
        latest, other = step_fn(latest, other, k), latest
    if rem:
        latest = step_fn(latest, other if other is not None
                         else jnp.zeros_like(latest), rem)
    return latest


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    # state dtype in device memory: "float32" (default), "bfloat16"
    # (stored bf16, computed fp32: half the bytes, ~4e-3/step storage
    # rounding), "float64" (needs jax_enable_x64; the reference's fp64
    # regime), or "df64" (fp64-grade double-float fp32 pairs with
    # error-free transformations, ops/df64.py)
    dtype: str = "float32"
    # "auto" (the 2-D kernel on a GPU where it applies, unless
    # fused_steps is 1; else XLA), "xla" (the plain step) or "kernel"
    # (insist on the kernel)
    backend: str = "auto"
    # round-up tile of the internal layout (None: layout default)
    tile: Optional[Tuple[int, ...]] = None
    # timesteps per pass.  None = KERNEL_FUSED_STEPS on the 2-D kernel,
    # 1 on the plain step.  Clamped so the fused halo fits the guard:
    # k*radius <= 128 (2-D columns), <= 8 (3-D in-plane rows); the
    # kernel takes at most MAX_KERNEL_FUSED_STEPS.
    fused_steps: Optional[int] = None
    # boundary condition: "dirichlet0" (reference semantics: the halo
    # decays to zero -- SURVEY.md section 4), "periodic" (the grid
    # wraps) or "reflect" (symmetric / zero-flux mirror padding).  For
    # the ghost modes the guard ring is refreshed before every pass and
    # the step's bounds extend over the ring -- the same machinery that
    # keeps exchanged neighbor data alive on interior devices of a
    # sharded run.  Ghost modes ignore the supplied halo cells; reflect
    # with fused_steps > 1 additionally needs per-axis symmetric
    # coefficients (mirror symmetry must commute with the stencil).
    boundary: str = "dirichlet0"


class StencilEngine:
    def __init__(self, spec: StencilSpec, interior,
                 config: EngineConfig = EngineConfig()):
        self.spec = spec
        self.interior = tuple(int(s) for s in np.atleast_1d(interior))
        assert len(self.interior) == spec.ndim
        self.config = config
        # dtype "df64": fp64-grade double-float pairs (the reference's
        # native-fp64 regime, src/1d/1d_utils.h:44, emulated with
        # error-free fp32 transformations -- ops/df64.py).  Device state
        # is stacked (2, *layout) fp32; split/merge on the host.
        self.df64 = config.dtype == "df64"
        self.dtype = jnp.dtype("float32" if self.df64 else config.dtype)
        if self.dtype == jnp.float64 and not jax.config.read(
                "jax_enable_x64"):
            raise ValueError(
                "dtype float64 needs jax_enable_x64 (JAX truncates to "
                "float32 silently otherwise)")
        if config.boundary not in ("dirichlet0", "periodic", "reflect"):
            raise ValueError(
                f"boundary must be 'dirichlet0', 'periodic' or "
                f"'reflect', got {config.boundary!r}")
        self.backend = _backend.resolve(
            config.backend,
            kernel_applies=(not self.df64
                            and hopper2d.applies(spec, self.dtype)),
            fused_steps=config.fused_steps)
        self.layout = self._build_layout()
        self.ghost = config.boundary != "dirichlet0"
        if self.ghost and min(self.interior) < self._ring_depth():
            raise ValueError(
                f"{config.boundary} boundaries need every interior dim "
                f">= the ring depth {self._ring_depth()} "
                f"(= fused_steps * radius); got {self.interior}")
        if (config.boundary == "reflect" and self._fused_k() > 1
                and not self.spec.axis_symmetric()):
            raise ValueError(
                "reflect boundaries with fused_steps > 1 need per-axis "
                "symmetric coefficients (mirror symmetry must commute "
                "with the stencil for the once-per-pass ring refresh to "
                "be exact); use fused_steps=1 for this spec")
        self._run_jit = jax.jit(
            self._run_internal, static_argnames=("steps",), donate_argnums=(0,)
        )
        if self.df64:
            # per-plane sums for the checksum (merged in fp64 on the host
            # -- no fp64 dtype may reach the device)
            self._run_df64_sums_jit = jax.jit(
                lambda s2, steps: jnp.sum(
                    self._run_internal(s2, steps).reshape(2, -1), axis=1),
                static_argnames=("steps",))
            self._df64_embed_jit = jax.jit(lambda s: jnp.stack(
                [self.layout.to_internal(s[0]),
                 self.layout.to_internal(s[1])]))
        # the whole user-facing pipeline (embed -> steps -> extract) as
        # ONE compiled program
        self._run_user_jit = jax.jit(
            lambda padded, steps: self.from_internal(
                self._run_internal(self.to_internal(padded), steps)
            ),
            static_argnames=("steps",),
        )
        # scalar-output variant for timing
        self._run_checksum_jit = jax.jit(
            lambda padded, steps: jnp.sum(
                self._run_internal(self.to_internal(padded), steps)
            ),
            static_argnames=("steps",),
        )

    @classmethod
    def for_shape(cls, name: str, interior, **kw) -> "StencilEngine":
        cfg_kw = {k: v for k, v in kw.items()
                  if k in EngineConfig.__dataclass_fields__}
        return cls(get_shape(name), interior, EngineConfig(**cfg_kw))

    @classmethod
    def for_coeffs(cls, coeffs, interior, name: str = "custom",
                   halo=None, fuse_factor: int = 1, max_rank: int = 4,
                   **kw) -> "StencilEngine":
        """Engine for an arbitrary dense coefficient array.

        2-D: the low-rank decomposition (pivot peel -> SVD fallback +
        sparse residue, models/factorize.py) runs automatically -- the
        generalization of the reference's hand-picked factorizations to
        user stencils.  3-D: a fully-separable z profile when the
        z-unfolding is rank 1 (the box3d1r structure), per-z-plane 2-D
        decompositions otherwise (factorize.decompose_3d).  1-D: a
        vector of taps (always dense; a 1-D stencil needs no
        factorization)."""
        from .models import factorize
        from .models.shapes import SeparableTerm, StencilSpec

        S = np.asarray(coeffs, dtype=np.float64)
        if S.ndim == 1:
            assert S.size % 2 == 1, "1-D taps must have odd length"
            radius = (S.size - 1) // 2
            spec = StencilSpec(
                name=name, ndim=1, radius=radius,
                halo=tuple(halo) if halo is not None else (radius,),
                terms=(SeparableTerm(taps=(tuple(S),)),),
                residue=(), fuse_factor=fuse_factor,
            )
        elif S.ndim == 3:
            assert all(s % 2 for s in S.shape), \
                "3-D coefficient extents must be odd"
            radius = max((s - 1) // 2 for s in S.shape)
            terms, residue = factorize.decompose_3d(S, max_rank=max_rank)
            spec = StencilSpec(
                name=name, ndim=3, radius=radius,
                halo=(tuple(halo) if halo is not None
                      else (radius, radius, radius)),
                terms=tuple(
                    SeparableTerm(taps=(tuple(tz), tuple(u), tuple(v)))
                    for tz, u, v in terms),
                residue=residue, fuse_factor=fuse_factor,
            )
        else:
            assert (S.ndim == 2 and S.shape[0] == S.shape[1]
                    and S.shape[0] % 2)
            radius = (S.shape[0] - 1) // 2
            terms, residue = factorize.decompose_2d(S, max_rank=max_rank)
            spec = StencilSpec(
                name=name, ndim=2, radius=radius,
                halo=tuple(halo) if halo is not None else (radius, radius),
                terms=tuple(SeparableTerm(taps=(tuple(u), tuple(v)))
                            for u, v in terms),
                residue=residue, fuse_factor=fuse_factor,
            )
        cfg_kw = {k: v for k, v in kw.items()
                  if k in EngineConfig.__dataclass_fields__}
        return cls(spec, interior, EngineConfig(**cfg_kw))

    # -- layout ----------------------------------------------------------
    def _fused_k(self) -> int:
        k = self.config.fused_steps
        if k is None:
            k = KERNEL_FUSED_STEPS if self.backend == "kernel" else 1
        k = max(1, k)
        r = max(1, self.spec.radius)
        if self.backend == "kernel":
            k = min(k, MAX_KERNEL_FUSED_STEPS)
        if self.spec.ndim == 2:
            k = min(k, COL_ALIGN // r)
        elif self.spec.ndim == 3:
            k = min(k, ROW_ALIGN // r)
        return k

    def _build_layout(self):
        spec, interior = self.spec, self.interior
        need = max(max(spec.halo), self._fused_k() * spec.radius)
        if spec.ndim == 1:
            n1 = interior[0]
            rows = max(ROW_ALIGN, min(512, ROW_ALIGN * (
                -(-n1 // (ROW_ALIGN * COL_ALIGN)))))
            per = ROW_ALIGN * COL_ALIGN
            return Layout1D(interior=n1, halo=spec.halo[0], tile_rows=rows,
                            guard_rows=ROW_ALIGN * (-(-need // per)))
        if spec.ndim == 2:
            tile = self.config.tile or default_tile_2d(*interior)
            need = max(spec.halo[0], self._fused_k() * spec.radius)
            guard_r = ROW_ALIGN * (-(-need // ROW_ALIGN))
            return Layout2D(interior=interior, halo=spec.halo, tile=tile,
                            guard=(guard_r, COL_ALIGN))
        tile = self.config.tile or default_tile_3d(*interior[1:])
        zg = max(spec.halo[0], self._fused_k() * spec.radius)
        return Layout3D(interior=interior, halo=spec.halo, tile=tile,
                        zguard=zg)

    # -- single pass (fused_k timesteps) on the internal layout -----------
    def _ring_depth(self) -> int:
        return max(1, self._fused_k() * self.spec.radius)

    def _ring_refresh(self, state, mode: str):
        """Fill the guard ring (depth = fused_steps * radius) so one
        pass sees the boundary condition's ghost cells -- the
        single-chip analog of the sharded ring exchange:

          * ``periodic``: the opposite interior edge (wrap);
          * ``reflect``: the SAME interior edge mirrored (symmetric /
            zero-flux padding);
          * ``zero``: clears the ring (final-output halo contract).

        df64 pair states refresh each plane (pure copies/flips, so the
        (hi, lo) invariant is exact)."""
        if self.df64 and state.ndim == len(self.layout.shape) + 1:
            return jnp.stack([self._ring_refresh(state[0], mode),
                              self._ring_refresh(state[1], mode)])
        d = self._ring_depth()
        lay = self.layout
        if self.spec.ndim == 1:
            flat = _ring_refresh_nd(state.reshape(-1), mode, (lay.origin,),
                                    (lay.interior,), d)
            return flat.reshape(state.shape)
        return _ring_refresh_nd(state, mode, lay.origin, lay.interior, d)

    def _ghost_bounds(self):
        """Validity bounds that keep the ghost ring alive through every
        fused substep's mask (and still zero tile round-up garbage)."""
        d = self._ring_depth()
        lo_hi = []
        for s in self.interior:
            lo_hi += [-d, s + d]
        return jnp.asarray(lo_hi, jnp.int32)

    def _step_internal(self, cur, donor, fused_k: int = 1):
        bounds = None
        if self.ghost:
            cur = self._ring_refresh(cur, self.config.boundary)
            bounds = self._ghost_bounds()
        if self.backend == "kernel":
            return hopper2d.step(cur, donor, self.spec, self.layout,
                                 fused_steps=fused_k, bounds=bounds)
        return plain.step(cur, donor, self.spec, self.layout,
                          fused_steps=fused_k, bounds=bounds,
                          pair=self.df64)

    def _run_internal(self, state, steps: int):
        out = ping_pong_loop(self._step_internal, state, steps,
                             self._fused_k())
        if self.ghost and steps > 0:
            # ring cells inside the tile round-up region were written by
            # the masked steps; the output halo contract is zeros
            out = self._ring_refresh(out, "zero")
        return out

    # -- public API -------------------------------------------------------
    def to_internal(self, padded):
        if self.df64:
            from .ops import df64 as _df64
            # host split: fp64 never reaches the device
            return self._df64_embed_jit(_df64.split_host(np.asarray(padded)))
        return self.layout.to_internal(padded, dtype=self.dtype)

    def from_internal(self, state):
        if self.df64:
            from .ops import df64 as _df64
            state = np.asarray(state)
            return _df64.merge_host(np.stack([
                np.asarray(self.layout.from_internal(state[0])),
                np.asarray(self.layout.from_internal(state[1]))]))
        return self.layout.from_internal(state)

    def run_internal(self, state, steps: int):
        """Jitted multi-step run on internal state (state is donated)."""
        return self._run_jit(state, steps=steps)

    def run(self, padded, steps: int):
        """Reference-semantics multi-step run on a user padded array.

        One compiled program end to end; ``padded`` may be a NumPy array
        (transferred once).  The df64 tier returns a float64 NumPy array
        (pairs split/merged on the host)."""
        if self.df64:
            return self.from_internal(
                self._run_jit(self.to_internal(padded), steps=steps))
        return self._run_user_jit(padded, steps=steps)

    def run_checksum(self, padded, steps: int):
        """Like run() but returns only a scalar checksum (for timing)."""
        if self.df64:
            s = np.asarray(
                self._run_df64_sums_jit(self.to_internal(padded),
                                        steps=steps), np.float64)
            return s[0] + s[1]
        return self._run_checksum_jit(padded, steps=steps)

    # -- differentiation ---------------------------------------------------
    def adjoint(self) -> "StencilEngine":
        """Engine of the point-reflected (transposed) stencil.

        A stencil step is linear: out = M C x with C the correlation by
        the coefficients and M the interior mask (reference halo-decay
        semantics).  Its transpose is (M C)^T = C' M with C' the FLIPPED
        stencil's correlation (models/shapes.StencilSpec.flipped) -- so
        the adjoint of k steps is C'^T-chained through the SAME engine
        machinery.  Cached per engine."""
        if not hasattr(self, "_adjoint"):
            self._adjoint = StencilEngine(
                self.spec.flipped(), self.interior, self.config)
        return self._adjoint

    def run_diff(self, padded, steps: int):
        """Differentiable run(): identical forward values, with an EXACT
        custom VJP through the adjoint stencil ((MC)^T)^k = C'(MC')^{k-1}M
        -- k-1 passes of the flipped-spec engine on the interior-masked
        cotangent, then one unmasked correlation (which recovers the
        gradient with respect to the input halo cells that step one
        reads).  Enables gradient-based PDE-constrained optimization
        through the production step (kernel or XLA) without differentiating
        kernel internals (the operator is linear; no residuals stored)."""
        if self.df64:
            raise ValueError(
                "run_diff is not wired for the df64 pair state (JAX "
                "autodiff would silently downcast the fp64 cotangent); "
                "use engine.run_vjp for an fp64-grade adjoint product, "
                "or differentiate via dtype float32 (exact VJP)")
        return _run_linear(self, padded, steps)

    def run_vjp(self, cotangent, steps: int):
        """Host-level exact adjoint product: the gradient of
        ``sum(run(x, steps) * cotangent)`` with respect to ``x`` (the
        operator is linear, so no primal point is needed).

        For the df64 tier the chain stays fp64-grade end to end (JAX
        autodiff would downcast the fp64 cotangent): the interior-masked
        cotangent runs ``steps-1`` passes of the FLIPPED df64 engine on
        device (~1e-14/step, the forward tier's own
        accuracy), and the final unmasked correlation -- plus the whole
        reflect fold-back chain, whose per-step fold is not an engine
        step -- runs in exact host float64 (utils/reference.py; the
        backward of inversion workloads runs once per solve, not in the
        hot loop).  fp64 in, fp64 out.

        For every other tier this returns exactly what
        ``jax.grad`` through :meth:`run_diff` computes (same code path:
        the custom-VJP backward), as a convenience for host-driven
        adjoint loops.  Reference has no autodiff at all; this extends
        the artifact's linear-operator semantics
        (``reference/src/2d/main.cu:38-93``) to its transpose."""
        if not self.df64:
            return _run_linear_bwd(self, steps, None,
                                   jnp.asarray(cotangent, self.dtype))[0]
        g = np.asarray(cotangent, np.float64)
        if steps <= 0:
            return g
        it = tuple(slice(h, s - h) for h, s in zip(self.spec.halo,
                                                   g.shape))
        if self.config.boundary == "reflect":
            # per-step fold-back on the interior extent in exact fp64;
            # the input halo is ignored under reflect -> zero gradient
            from .utils import reference as _ref

            flipped = self.spec.flipped()
            y = g[it]
            for _ in range(steps):
                y = _ref.fold_adjoint_step(y, flipped)
            out = np.zeros_like(g)
            out[it] = y
            return out
        mg = np.zeros_like(g)
        mg[it] = g[it]
        adj = self.adjoint()
        if self.config.boundary == "periodic":
            # circulant transpose = flipped-spec periodic operator, all
            # k steps through the df64 adjoint engine; the input halo is
            # ignored under periodic -> zero gradient (the ghost-ring
            # output contract already zeroes the halo)
            return adj.run(mg, steps)
        lam = adj.run(mg, steps - 1) if steps > 1 else mg
        from .utils import reference as _ref

        return _ref.conv_full(lam, adj.spec)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 2))
def _run_linear(eng: StencilEngine, padded, steps: int):
    return eng.run(padded, steps)


def _run_linear_fwd(eng, padded, steps):
    return _run_linear(eng, padded, steps), None


def _fold_adjoint_step(y, spec_flipped):
    """One adjoint step of the reflect operator R = crop-conv o pad_sym:
    R^T = pad_sym^T o conv^T.  conv^T = flipped correlation scattered
    onto the padded extent; pad_sym^T FOLDS each ghost strip back onto
    the interior cells it mirrored.  ``y`` is an interior-extent array.
    XLA shift-adds (this backward runs once per step -- inversion
    workloads, not the hot loop)."""
    r = spec_flipped.radius
    ndim = y.ndim
    z = xla_ref.conv_full(jnp.pad(y, r), spec_flipped)
    for a in range(ndim):

        def at(sl):
            t = [slice(None)] * z.ndim
            t[a] = sl
            return tuple(t)

        core = z[at(slice(r, z.shape[a] - r))]
        left = jnp.flip(z[at(slice(0, r))], axis=a)
        right = jnp.flip(z[at(slice(z.shape[a] - r, None))], axis=a)
        na = core.shape[a]
        core = core.at[at(slice(0, r))].add(left)
        z = core.at[at(slice(na - r, None))].add(right)
    return z


def _run_linear_bwd(eng, steps, _res, g):
    if steps == 0:
        return (g,)
    it = tuple(slice(h, s - h) for h, s in zip(eng.spec.halo, g.shape))
    if eng.config.boundary == "reflect":
        # per-step fold-back adjoint on the interior extent; the input
        # halo is ignored under reflect, so its gradient is zero
        flipped = eng.spec.flipped()
        y = g[it]
        for _ in range(steps):
            y = _fold_adjoint_step(y, flipped)
        return (jnp.zeros_like(g).at[it].set(y),)
    mg = jnp.zeros_like(g).at[it].set(g[it])
    adj = eng.adjoint()
    if eng.config.boundary == "periodic":
        # the periodic operator is circulant: its transpose is the
        # flipped-spec PERIODIC operator, applied all k steps; the input
        # halo is ignored under periodic, so its gradient is zero
        # (adj.run's output halo is zero by the ghost-ring contract)
        return (adj.run(mg, steps),)
    lam = adj.run(mg, steps - 1) if steps > 1 else mg
    return (xla_ref.conv_full(lam, adj.spec),)


_run_linear.defvjp(_run_linear_fwd, _run_linear_bwd)


def run(padded, spec: StencilSpec, steps: int, **kw):
    """One-shot convenience API (see .claude/skills/verify/SKILL.md).

    Uses the passed spec directly (works for custom specs, not just
    registry names)."""
    interior = tuple(
        s - 2 * h for s, h in zip(np.shape(padded), spec.halo)
    )
    cfg_kw = {k: v for k, v in kw.items()
              if k in EngineConfig.__dataclass_fields__}
    eng = StencilEngine(spec, interior, EngineConfig(**cfg_kw))
    return eng.run(padded, steps)
