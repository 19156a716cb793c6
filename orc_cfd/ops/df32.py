"""Double-float (2xf32) arithmetic for the f64-accuracy hot ops.

On a backend without native f64, XLA emulates every f64 op in
software. This module implements the narrower primitives the solver
hot loop actually needs — SpMV and dot products on values that
carry f64-like precision as (hi, lo) f32 pairs — so the traffic stays
two f32 planes (same 8 B/value as f64) while the arithmetic uses plain
f32 vector ops instead of full IEEE-double emulation.

Precision contract (cheaper than IEEE double-double, sufficient for
Krylov iterations):
- products are exact two-products of the HI parts plus first-order
  cross terms (hi*lo), i.e. relative error ~2^-45 per term vs f64's
  2^-53;
- accumulation uses error-free two-sums, so long row/dot reductions
  do not lose the low bits.

Note: JAX exposes no scalar FMA, so exact two-products use Dekker
splitting (2^12+1), which is exact in round-to-nearest f32.

BACKEND caveat: XLA:CPU's LLVM pipeline rewrites these error-free
transformations away under jit (a chain of 39 two_prod/two_sum steps
ends at f32 epsilon; none of the xla_cpu_enable_fast_math /
excess-precision flags restore it; eager per-op dispatch is
unaffected). Whether XLA:GPU keeps them is unmeasured; the refinement
residual (solver/refine.py) uses native f64 on every backend.

Reference counterpart: none — the reference is CPU f64 throughout
(lib.rs:213). Whether "f64 accuracy at f32 speed" pays on a card with
native f64 is ROADMAP design item 3.
"""

from __future__ import annotations

import jax.numpy as jnp

_SPLIT = 4097.0  # 2^12 + 1 (Dekker split constant for f32)


def two_sum(a, b):
    """Error-free sum: a + b = s + e exactly (Knuth, 6 flops)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Error-free sum assuming |a| >= |b| (Dekker, 3 flops)."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Dekker split: a = hi + lo with hi carrying the top 12 bits."""
    c = a * _SPLIT
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product: a * b = p + e exactly (Dekker, 17 flops)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_from_f64(x):
    """(hi, lo) f32 pair from an f64 array (lossless to ~2^-48)."""
    hi = x.astype(jnp.float32)
    lo = (x - hi.astype(x.dtype)).astype(jnp.float32)
    return hi, lo


def df_to_f64(hi, lo):
    return hi.astype(jnp.float64) + lo.astype(jnp.float64)


def df_add(xh, xl, yh, yl):
    """Double-float addition (Joldes et al. AccurateDWPlusDW-style,
    branch-free)."""
    sh, se = two_sum(xh, yh)
    tl, te = two_sum(xl, yl)
    c = se + tl
    vh, vl = fast_two_sum(sh, c)
    return fast_two_sum(vh, vl + te)


def df_mul(xh, xl, yh, yl):
    """Double-float multiply: exact hi*hi two-product + first-order
    cross terms."""
    ph, pe = two_prod(xh, yh)
    pe = pe + (xh * yl + xl * yh)
    return fast_two_sum(ph, pe)


def df_spmv(diag_h, diag_l, off_h, off_l, offsets, xh, xl):
    """Shift-path ELL SpMV in double-float: y = D x + sum_k off_k *
    roll(x, -d_k). Returns (yh, yl). Mirrors ops.spmv.ell_spmv's
    structured branch; all traffic is f32 planes."""
    yh, yl = df_mul(diag_h, diag_l, xh, xl)
    for k, d in enumerate(offsets):
        xkh = jnp.roll(xh, -d, axis=-1) if d != 0 else xh
        xkl = jnp.roll(xl, -d, axis=-1) if d != 0 else xl
        ph, pl_ = df_mul(off_h[..., k], off_l[..., k], xkh, xkl)
        yh, yl = df_add(yh, yl, ph, pl_)
    return yh, yl


def df_sum(p, e=None):
    """Error-tracked binary-tree sum of an f32 array: returns (hi, lo)
    with the hi-plane reduction's rounding errors collected exactly at
    every tree level (two_sum per pair, fully vectorized — log2(N)
    elementwise passes) and the error plane reduced in plain f32
    (second-order, ~2^-48 relative). `e` optionally seeds the error
    plane (the product low parts in df_dot)."""
    err = jnp.zeros((), jnp.float32) if e is None else jnp.sum(e)
    n = p.shape[-1]
    while n > 1:
        half = n // 2
        a, b = p[..., :half], p[..., half : 2 * half]
        s, t = two_sum(a, b)
        err = err + jnp.sum(t)
        if n % 2:
            s = jnp.concatenate([s, p[..., -1:]], axis=-1)
            half += 1
        p = s
        n = half
    return fast_two_sum(p[..., 0], err)


def df_dot(xh, xl, yh, yl):
    """Double-float dot product: error-free per-element products plus
    an error-tracked tree reduction. Returns (hi, lo)."""
    ph, pe = two_prod(xh, yh)
    pe = pe + (xh * yl + xl * yh)
    return df_sum(ph, pe)
