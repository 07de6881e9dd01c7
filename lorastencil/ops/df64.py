"""Double-float (df64) stencil tier: fp64-grade accuracy from fp32 words.

The reference computes in native fp64 (``DATA_TYPE double``,
``reference/src/1d/1d_utils.h:44``; DMMA fp64 tensor-core GEMMs,
``src/2d/gpu.cu:224-247``).  The engines also run native ``float64``
under x64; this tier is the fp32-word alternative, kept so the two can be
compared: every value is an UNEVALUATED PAIR of fp32 words
``(hi, lo)`` with ``hi = fl(x)`` and ``lo = fl(x - hi)``, carrying
~2x24 = 48 mantissa bits (~1e-14 relative), and every stencil tap is
applied with error-free transformations:

* ``two_sum``   -- Knuth's branch-free exact addition (6 flops);
* ``two_prod``  -- Dekker/Veltkamp split multiplication (exact without
  an FMA; every partial product of the 12-bit splits is exactly
  representable in fp32, so XLA's instruction selection cannot change
  the result);
* df64 x constant-tap products and df64 accumulation per nonzero
  coefficient of the dense stencil (the ``test_cpu`` semantics,
  ``reference/src/2d/main.cu:38-93``).

Everything device-side is plain fp32 arithmetic inside one jit -- no
fp64 dtype ever reaches the device (JAX would silently truncate it with
x64 disabled), so splitting/merging happens on the host in NumPy.  This
is a correctness tier, not a throughput tier: ~20-40 flops per tap per
cell.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..models.shapes import StencilSpec

# Veltkamp splitter for fp32 (24-bit mantissa): 2^12 + 1.  Splits a
# float into 12-bit halves whose pairwise products are exact in fp32.
_SPLITTER = np.float32(4097.0)


# -- host split / merge ----------------------------------------------------
def split_host(x) -> np.ndarray:
    """fp64 array -> stacked (2, *shape) fp32 (hi, lo) pairs (NumPy).

    ``hi`` is the fp32 rounding of x; ``lo`` the fp32 rounding of the
    remainder (exact when x came from fp64: the remainder has <= 29
    significant bits... clipped to fp32's 24 -- the tier's ~1e-14 floor).
    """
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return np.stack([hi, lo])


def merge_host(state2: np.ndarray) -> np.ndarray:
    """Stacked (2, *shape) fp32 -> fp64 array (NumPy)."""
    state2 = np.asarray(state2, dtype=np.float32)
    return state2[0].astype(np.float64) + state2[1].astype(np.float64)


# -- error-free transformations (device fp32) -------------------------------
def two_sum(a, b):
    """Knuth TwoSum: s + e == a + b EXACTLY (s = fl(a+b))."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Dekker FastTwoSum (requires |a| >= |b|): s + e == a + b exactly."""
    s = a + b
    e = b - (s - a)
    return s, e


def veltkamp_split(a):
    """a == hi + lo with both halves on <= 12 mantissa bits.

    |a| must stay below fp32_max / 4097 (~8.3e34) -- the scaled
    intermediate overflows beyond that (the CLI's --check range guard
    uses this limit for the df64 tier).
    """
    t = _SPLITTER * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """Dekker TwoProd: p + e == a * b EXACTLY (no FMA needed).

    Caution: ``p`` is a rounded product -- feeding it into a Fast/
    TwoSum in the SAME jit lets XLA:CPU contract that sum into an FMA
    and break the transformation (see dense_step's docstring).  Inside
    kernels, prefer dense_step's exact-partial-products pattern.
    """
    p = a * b
    ah, al = veltkamp_split(a)
    bh, bl = veltkamp_split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(ah, al, bh, bl):
    """(ah, al) + (bh, bl) -> normalized df64 pair (~2^-47 rel err)."""
    s, e = two_sum(ah, bh)
    e = e + (al + bl)
    return quick_two_sum(s, e)


# -- dense stencil step ------------------------------------------------------
def pair_valid(hi: jax.Array, lo: jax.Array, spec: StencilSpec):
    """Valid df64 correlation of the pair planes ``(hi, lo)``: returns
    the ``(hi, lo)`` pair of the output, each plane shrunk by
    ``spec.radius`` on every axis (the df64 twin of
    xla_ref.dense_valid).

    The tap loop is a ``fori_loop`` over dynamic slices whose body
    unrolls a BOUNDED group of G=8 taps (plus one <G unrolled
    remainder epilogue): fully unrolling the ~30-op df64 chain makes
    XLA:CPU's fused-loop codegen superlinear in tap count (measured
    2 s at 7 taps -> 70 s at 34), while one tap per iteration pays the
    accumulator pair's read+write per tap -- the bounded group
    amortizes it 8x with a body that still compiles in ~2 s.  The
    state's Veltkamp halves are hoisted out of the loop (shared by
    every tap's partial products).

    FMA-contraction hazard (measured, XLA:CPU): fused mul+add chains
    are contracted into FMAs -- ``p + e`` with ``p = x*w`` becomes
    ``fma(x, w, e)``, which silently breaks Fast/TwoSum's "s = fl(a+b)"
    precondition; neither ``optimization_barrier`` nor bitcast round
    trips stop it.  The tap body is therefore built so contraction
    CANNOT change any value: every runtime product is EXACT (12-bit
    Veltkamp halves x 12-bit tap halves -- an fma of an exact product
    equals the unfused sum), sums of exact products flow through
    TwoSum, and the only rounded products (the ~2^-24-relative
    ``lo*w`` correction terms) enter plain adds where an fma only
    perturbs below the tier's ~2^-47 target.
    """
    S = spec.dense_coeffs()
    r = spec.radius
    idxs = np.argwhere(np.abs(S) > 0)
    ishape = tuple(s - 2 * r for s in hi.shape)
    zero = jnp.zeros(ishape, jnp.float32)
    if not len(idxs):
        return zero, zero
    G = min(8, len(idxs))
    w64 = np.array([S[tuple(i)] for i in idxs], np.float64)
    wh = w64.astype(np.float32)
    wl = (w64 - wh.astype(np.float64)).astype(np.float32)
    # host-split tap halves: bh + bl == wh exactly, each <= 12 bits
    bh, bl = veltkamp_split(wh)  # NumPy in, NumPy out (dtype-generic)
    starts = jnp.asarray(idxs, jnp.int32)
    whj, wlj = jnp.asarray(wh), jnp.asarray(wl)
    bhj, blj = jnp.asarray(bh), jnp.asarray(bl)
    his, hil = veltkamp_split(hi)  # hoisted: exact halves of hi

    def one_tap(t, ah, al):
        st = [starts[t, d] for d in range(len(ishape))]
        xs = jax.lax.dynamic_slice(his, st, ishape)
        xl2 = jax.lax.dynamic_slice(hil, st, ishape)
        xlo = jax.lax.dynamic_slice(lo, st, ishape)
        x = xs + xl2  # == the hi slice, exactly
        w_h, w_l = whj[t], wlj[t]
        b_h, b_l = bhj[t], blj[t]
        # four EXACT partial products of x * w_h
        q1 = xs * b_h
        q2 = xs * b_l
        q3 = xl2 * b_h
        q4 = xl2 * b_l
        # rounded correction terms (~2^-24 relative; fma-safe)
        c = xlo * w_h + x * w_l
        t1, u1 = two_sum(q2, q3)
        ph, pe = two_sum(q1, t1)
        pl = pe + ((u1 + q4) + c)
        # accumulate the product pair (ph is add-rooted: fma-safe)
        return df_add(ah, al, ph, pl)

    def group(g, acc):
        ah, al = acc
        for j in range(G):
            ah, al = one_tap(g * G + j, ah, al)
        return ah, al

    acc_h, acc_l = jax.lax.fori_loop(0, len(idxs) // G, group,
                                     (zero, zero))
    for t in range(len(idxs) - len(idxs) % G, len(idxs)):  # epilogue
        acc_h, acc_l = one_tap(t, acc_h, acc_l)
    return acc_h, acc_l
