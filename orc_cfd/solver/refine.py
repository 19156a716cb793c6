"""Mixed-precision iterative refinement: f64-accuracy linear solves
from f32 inner solves.

    split once:  A = Ah + Al,  b = bh + bl   (f32 hi/lo pairs)
    repeat k times:
        r  = b - A x          (native f64 residual)
        d  = solve(Ah, r_hi)  (PLAIN f32 — the full Krylov machinery
                               on the hi-plane matrix)
        x += d                (df32 add)

Each refinement contracts the error by the inner solve's relative
accuracy; the f64 residual sets the attainable limit. The
high-precision work is ONE residual per refinement, not per Krylov
iteration, so the cost approaches the plain f32 solve.

Opt-in: MatrixSolverSettings.precision = SolverPrecision.DF32_IR on an
f64 system (utils/settings.py); routed by krylov.iterative_solve.
Single-device only (the sharded runtime runs f32 + compensated
reductions instead).
"""

from __future__ import annotations

import jax.numpy as jnp

from orc_cfd.ops.df32 import (
    df_add,
    df_from_f64,
    df_to_f64,
)
from orc_cfd.ops.spmv import EllMatrix


class _DfMatrix:
    """f64 EllMatrix with an f64 matvec for residuals (returned as a
    df32 pair) and the hi-plane f32 matrix for the inner solves."""

    def __init__(self, A: EllMatrix):
        self._A64 = A
        if A.plan is not None and not A.slice_layout:
            A = A.prepare()  # f64 XLA selects — once per solve
        diag_h, _ = df_from_f64(A.diag)
        off_h, _ = df_from_f64(A.off)
        self.A32 = EllMatrix(
            diag=diag_h,
            off=off_h,
            neighbors=A.neighbors,
            offsets=A.offsets,
            plan=A.plan,
            slice_layout=A.slice_layout,
        )

    def df_matvec(self, xh, xl):
        """(A x) in f64, split into a df32 (hi, lo) pair."""
        return df_from_f64(self._A64.matvec(df_to_f64(xh, xl)))


def df32_ir_solve(
    A: EllMatrix,
    b,
    x0,
    settings,
    axis_sum,
    project,
    refine_steps: int = 3,
):
    """f64-accuracy solve of the f64 system (A, b) via df32 iterative
    refinement with plain-f32 inner solves. Returns (x_f64, SolveInfo)
    like every krylov solver; SolveInfo.residual is the df32-accurate
    final residual norm (f32 scalar widened to the b dtype)."""
    from orc_cfd.solver.krylov import SolveInfo, iterative_solve
    from orc_cfd.utils.settings import SolverPrecision

    inner_settings = settings.replace_precision(SolverPrecision.NATIVE)
    M = _DfMatrix(A)
    bh, bl = df_from_f64(b)
    xh, xl = df_from_f64(x0)

    it_total = jnp.zeros((), jnp.int32)
    diverged = jnp.zeros((), bool)
    for _ in range(refine_steps):
        axh, axl = M.df_matvec(xh, xl)
        rh, rl = df_add(bh, bl, -axh, -axl)
        rh, rl = project(rh), project(rl)
        d, info = iterative_solve(
            M.A32,
            rh,
            jnp.zeros_like(rh),
            inner_settings,
            axis_sum=axis_sum,
            project=project,
        )
        xh, xl = df_add(xh, xl, d, jnp.zeros_like(d))
        it_total = it_total + info.iterations
        diverged = diverged | info.diverged

    axh, axl = M.df_matvec(xh, xl)
    rh, _ = df_add(bh, bl, -axh, -axl)
    rh = project(rh)
    rn = jnp.sqrt(axis_sum(jnp.sum(rh * rh, axis=-1))).astype(b.dtype)
    x = df_to_f64(xh, xl)
    return x, SolveInfo(
        iterations=it_total,
        residual=rn,
        diverged=diverged | jnp.isnan(rn),
    )
