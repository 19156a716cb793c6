"""Iterative sparse solvers over ELL matrices.

Vectorized counterpart of the reference's `iterative_solve`
(linear_algebra.rs:143-299): the same solver menu (Jacobi relaxation
with relative-residual early exit, fixed-count BiCGSTAB with
r_hat0 = ones, optional row-scaling Jacobi preconditioner, multigrid)
expressed in `lax` control flow so whole solves stay on device, plus a
*working* multi-color Gauss-Seidel (the reference's is disabled,
linear_algebra.rs:245).

Divergence is reported through `SolveInfo` flags instead of panics; the
host decides what to do (reference panics at
linear_algebra.rs:192-196,214-216).

All solvers support leading batch dimensions via `jax.vmap` (used to
solve the u/v/w momentum systems, which share sparsity, as one batched
solve). Bodies self-gate on their convergence flag so vmap'ed early
exit matches the sequential semantics exactly.

Dot products route through a `psum` hook so the same code runs inside
`shard_map` with cells partitioned across devices (set by
orc_cfd.parallel).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from orc_cfd.ops.spmv import EllMatrix
from orc_cfd.utils.settings import (
    MatrixSolverSettings,
    PreconditionMethod,
    SolutionMethod,
)


class SolveInfo(NamedTuple):
    iterations: jnp.ndarray  # actual iterations run
    residual: jnp.ndarray  # final (preconditioned) residual norm
    diverged: jnp.ndarray  # bool: NaN or >1e10 blowup detected


def _identity_sum(x):
    return x


def _norm(v, axis_sum):
    return jnp.sqrt(axis_sum(jnp.sum(v * v, axis=-1)))


def _dot(a, b, axis_sum):
    return axis_sum(jnp.sum(a * b, axis=-1))


def _wide(v):
    """Double-width view of f32 data for compensated reductions (f32
    products are exact in f64; the f64 sum is then correctly rounded
    to far below f32 epsilon)."""
    return v.astype(jnp.float64) if v.dtype == jnp.float32 else v


def _norm_comp(v, axis_sum):
    w = _wide(v)
    return jnp.sqrt(axis_sum(jnp.sum(w * w, axis=-1))).astype(v.dtype)


def _dot_comp(a, b, axis_sum):
    return axis_sum(jnp.sum(_wide(a) * _wide(b), axis=-1)).astype(a.dtype)


def _reducers(compensated: bool):
    """(dot, norm) pair: plain f-width or compensated (f64-accumulated
    for f32 systems; identical for f64 systems)."""
    if compensated:
        if not jax.config.jax_enable_x64:
            raise ValueError(
                "compensated_f32 needs double-width accumulation, but "
                "JAX x64 is disabled (ORC_X64=0): astype(float64) "
                "would silently stay float32 and the flag would be a "
                "no-op. Re-enable x64 or drop compensated_f32."
            )
        return _dot_comp, _norm_comp
    return _dot, _norm


def _no_refresh(x):
    return x


def _no_project(x):
    return x


def constant_deflation(null_scale, active=None, axis_sum=_identity_sum):
    """Projection removing the constant (gauge) mode from a vector:
    x -> x - null_scale * mean_active(x).

    For an UNANCHORED pressure-correction system (no pressure BC — the
    all-wall cavity, the body-force periodic channel) the matrix is
    exactly singular with nullspace = constants. Krylov solvers on such
    systems are fine in exact arithmetic (every Krylov vector stays in
    the zero-mean subspace), but the Jacobi-preconditioned operator
    D^-1 A loses the orthogonality range(A) ⊥ 1, so roundoff seeds a
    constant component that near-singular alpha/omega steps amplify —
    measured: transient |x| > 1e10 spikes (false divergence flags) and
    genuine breakdown NaNs on the 16^2 cavity MULTIGRID. Deflating the
    matvec outputs keeps the whole Krylov space in the stable subspace,
    where the operator is nonsingular.

    `null_scale` is a traced scalar: 1.0 for singular systems, 0.0 for
    anchored ones (the projection is then the identity, but the same
    trace serves traced zone tables). `active` masks padded/halo rows
    (None = all rows); `axis_sum` completes sums under shard_map.
    Operates on the trailing axis only for 1-D vectors — do not use on
    batched systems."""
    def project(x):
        if active is None:
            n = axis_sum(jnp.asarray(x.shape[-1], x.dtype))
            mean = axis_sum(jnp.sum(x, axis=-1)) / n
            return x - null_scale * mean
        one = jnp.asarray(1.0, x.dtype)
        n = axis_sum(jnp.sum(jnp.where(active, one, 0.0)))
        mean = axis_sum(jnp.sum(jnp.where(active, x, 0.0))) / n
        return x - null_scale * jnp.where(active, mean, 0.0)

    return project


def _mv(A: EllMatrix, x, refresh):
    """A @ x with a halo-refresh hook: neighbor gathers read the
    refreshed vector (remote values at halo slots) while the diagonal
    term uses the local vector, so halo rows (diag 1, off 0) keep
    Krylov vectors identically zero outside owned cells."""
    if refresh is _no_refresh:
        return A.matvec(x)
    xr = refresh(x)
    if A.offsets is not None:
        y = A.diag * x
        split = isinstance(A.off, tuple)
        for k, d in enumerate(A.offsets):
            xk = jnp.roll(xr, -d, axis=-1) if d != 0 else xr
            y = y + (A.off[k] if split else A.off[..., k]) * xk
        return y
    return A.diag * x + jnp.sum(A.off * xr[..., A.neighbors], axis=-1)


def jacobi_solve(
    A: EllMatrix,
    b,
    x0,
    iterations: int,
    relaxation,
    convergence_threshold,
    axis_sum=_identity_sum,
    refresh=_no_refresh,
    compensated: bool = False,
    project=_no_project,
):
    """Relaxed Jacobi with the reference's convergence semantics
    (linear_algebra.rs:172-218): the baseline residual is recorded after
    the second sweep (its off-by-one kept for behavioral parity) and the
    loop exits when ||r|| / ||r_baseline|| < threshold."""
    _, _norm = _reducers(compensated)
    inv_diag = 1.0 / A.diag
    b_prime = b * inv_diag

    def body(state):
        x, it, base_r, done, diverged = state
        ax = _mv(A, x, refresh)
        ax_off = ax - A.diag * x
        x_new = relaxation * (b_prime - ax_off * inv_diag) + (1.0 - relaxation) * x
        r = _norm(b - _mv(A, x_new, refresh), axis_sum)
        base_r = jnp.where(it == 1, r, base_r)
        conv = (it >= 2) & (r / base_r < convergence_threshold)
        max_abs = jnp.max(jnp.abs(x_new))
        bad = jnp.isnan(r) | (max_abs > 1e10)
        x = jnp.where(done, x, x_new)
        return (
            x,
            it + jnp.where(done, 0, 1),
            base_r,
            done | conv | bad,
            diverged | bad,
        )

    def cond(state):
        _, it, _, done, _ = state
        return (~done) & (it < iterations)

    x, it, _, _, diverged = lax.while_loop(
        cond,
        body,
        (
            x0,
            jnp.zeros((), jnp.int32),
            jnp.ones((), x0.dtype),
            jnp.zeros((), bool),
            jnp.zeros((), bool),
        ),
    )
    # Stationary sweeps are NEUTRAL in the constant null mode (no
    # amplification), so deflating once at exit suffices.
    x = project(x)
    r = _norm(project(b - _mv(A, x, refresh)), axis_sum)
    return x, SolveInfo(iterations=it, residual=r, diverged=diverged)


def jacobi_smooth_solve(
    A: EllMatrix,
    b,
    x0,
    iterations: int,
    relaxation,
    axis_sum=_identity_sum,
    refresh=_no_refresh,
    compensated: bool = False,
    project=_no_project,
):
    """Fixed-count damped Jacobi: the deterministic smoother used for
    warm-started transport solves (momentum, RANS k/eps — see
    MatrixSolverSettings.momentum_iterations). Unlike jacobi_solve
    there is no residual norm, no adaptive exit, and no per-sweep
    global reduction — the iterates are a pure stationary map of the
    inputs, so sharded and single-device runs agree to halo roundoff
    regardless of psum summation order. One SpMV per sweep; the final
    residual norm is computed once for SolveInfo/divergence flags."""
    _, _norm = _reducers(compensated)
    inv_diag = 1.0 / A.diag
    b_prime = b * inv_diag

    def sweep(_, x):
        ax_off = _mv(A, x, refresh) - A.diag * x
        return relaxation * (b_prime - ax_off * inv_diag) + (
            1.0 - relaxation
        ) * x

    x = project(lax.fori_loop(0, iterations, sweep, x0))
    rn = _norm(project(b - _mv(A, x, refresh)), axis_sum)
    diverged = jnp.isnan(rn) | (jnp.max(jnp.abs(x)) > 1e10)
    return x, SolveInfo(
        iterations=jnp.asarray(iterations, jnp.int32),
        residual=rn,
        diverged=diverged,
    )


def bicgstab_solve(
    A: EllMatrix,
    b,
    x0,
    iterations: int,
    axis_sum=_identity_sum,
    convergence_threshold: float = 1e-14,
    refresh=_no_refresh,
    compensated: bool = False,
    project=_no_project,
):
    """Textbook BiCGSTAB (reference: linear_algebra.rs:247-269). Unlike
    the reference (fixed count, no exit), this adds a relative-residual
    exit (||r|| <= threshold * ||r0||, i.e. relative to the INITIAL
    residual — see the criterion note below) and breakdown guards: once the residual (or a Krylov denominator)
    underflows, continuing produces 0/0 -> NaN and poisons the solution,
    so the iteration freezes instead.

    `compensated`: accumulate f32 dot products / norms in f64 (see
    MatrixSolverSettings.compensated_f32).

    `project`: nullspace deflation hook (see constant_deflation) —
    applied to the initial residual and every matvec output, so on a
    singular-but-consistent system all Krylov vectors stay in the
    deflated subspace where the operator is nonsingular."""
    _dot, _norm = _reducers(compensated)
    r0 = project(b - _mv(A, x0, refresh))
    # Shadow residual r_hat = r0 (the standard choice). The reference
    # uses a ones vector (linear_algebra.rs:252), which is
    # near-orthogonal to noise-like residuals and makes rho a pure
    # cancellation — observed to destabilize warm-started solves.
    r_hat = r0
    rho0 = _dot(r0, r_hat, axis_sum)
    bnorm = _norm(b, axis_sum)
    r0norm = _norm(r0, axis_sum)
    tiny = jnp.asarray(jnp.finfo(b.dtype).tiny, b.dtype)
    eps = jnp.asarray(jnp.finfo(b.dtype).eps, b.dtype)
    # Convergence is relative to the INITIAL residual (each call
    # reduces ||r|| by `convergence_threshold`), NOT relative to ||b||:
    # warm-started solves (SIMPLE momentum, x0 = previous velocity)
    # enter with r0 far below ||b|| — under implicit relaxation b
    # carries the (1-alpha)/alpha * diag * u term, so thresh*||b|| is an
    # O(1)-physics absolute bar that freezes the solve (0 iterations)
    # while the momentum equation still carries a discretization-scale
    # defect ~ thresh*|u|*(mu/h^2 + u/h). Measured: that floor GREW
    # under refinement and capped the Re=1000 cavity at ~0.1 landmark
    # error for every scheme (the round-2 "systematic core-vortex
    # deficit"); an MMS convergence study went from order -1.8
    # (diverging!) to clean order with the rel-to-r0 exit.
    # The roundoff floor below keeps the one thing the old criterion
    # did right: a warm start AT the solution (r0 at SpMV-accumulation
    # noise scale) exits immediately instead of random-walking on noise
    # (observed after SIMPLE convergence).
    floor = jnp.maximum(64.0 * eps * bnorm, tiny)
    done0 = r0norm <= floor
    # Residual growth far beyond the initial scale is divergence-in-
    # progress — freeze rather than amplify.
    r_cap = 1e6 * (bnorm + r0norm) + tiny

    def _safe_div(num, den):
        return num / jnp.where(den == 0, 1.0, den)

    def body(state):
        x, r, p, rho, it, done = state
        nu = project(_mv(A, p, refresh))
        d_rn = _dot(r_hat, nu, axis_sum)
        alpha = _safe_div(rho, d_rn)
        h = x + alpha * p
        s = r - alpha * nu
        t = project(_mv(A, s, refresh))
        d_tt = _dot(t, t, axis_sum)
        omega = _safe_div(_dot(t, s, axis_sum), d_tt)
        x_new = h + omega * s
        r_new = s - omega * t
        rho_new = _dot(r_hat, r_new, axis_sum)
        beta = _safe_div(rho_new, rho) * _safe_div(alpha, omega)
        p_new = r_new + beta * (p - omega * nu)
        rn_new = _norm(r_new, axis_sum)
        breakdown = (
            (jnp.abs(d_rn) <= tiny)
            | (d_tt <= tiny)
            | (jnp.abs(omega) <= tiny)
            | (jnp.abs(rho) <= tiny)
            | (rn_new > r_cap)
            | jnp.isnan(rn_new)
        )
        conv = (rn_new <= convergence_threshold * r0norm) | (rn_new <= floor)
        # A breakdown step's update is garbage — freeze the pre-step state.
        frozen = done | breakdown
        x = jnp.where(frozen, x, x_new)
        r = jnp.where(frozen, r, r_new)
        p = jnp.where(frozen, p, p_new)
        rho = jnp.where(frozen, rho, rho_new)
        return x, r, p, rho, it + jnp.where(done, 0, 1), done | conv | breakdown

    def cond(state):
        *_, it, done = state
        return (~done) & (it < iterations)

    x, r, _, _, it, _ = lax.while_loop(
        cond, body, (x0, r0, r0, rho0, jnp.zeros((), jnp.int32), done0)
    )
    rn = _norm(project(b - _mv(A, x, refresh)), axis_sum)
    diverged = jnp.isnan(rn) | (jnp.max(jnp.abs(x)) > 1e10)
    return x, SolveInfo(iterations=it, residual=rn, diverged=diverged)


def gauss_seidel_solve(
    A: EllMatrix,
    b,
    x0,
    iterations: int,
    relaxation,
    colors,  # [C] i32 color of each row (host-precomputed greedy coloring)
    n_colors: int,
    axis_sum=_identity_sum,
    refresh=_no_refresh,
    project=_no_project,
):
    """Multi-color Gauss-Seidel: rows of one color update simultaneously
    using the latest values of all other colors — the parallelizable
    reformulation of the reference's (disabled) sequential sweep
    (linear_algebra.rs:219-246)."""

    def sweep(x):
        for c in range(n_colors):
            ax_off = _mv(A, x, refresh) - A.diag * x
            x_gs = (1.0 - relaxation) * x + relaxation * (b - ax_off) / A.diag
            x = jnp.where(colors == c, x_gs, x)
        return x

    x = project(lax.fori_loop(0, iterations, lambda i, x: sweep(x), x0))
    rn = _norm(project(b - _mv(A, x, refresh)), axis_sum)
    diverged = jnp.isnan(rn) | (jnp.max(jnp.abs(x)) > 1e10)
    return x, SolveInfo(
        iterations=jnp.asarray(iterations, jnp.int32), residual=rn, diverged=diverged
    )


def iterative_solve(
    A: EllMatrix,
    b,
    x0,
    settings: MatrixSolverSettings,
    colors=None,
    n_colors: int = 0,
    axis_sum=_identity_sum,
    mg_hierarchy=None,
    mg_owned=None,  # (owned_mask [L], owned_global [L]) for sharded MG
    refresh=_no_refresh,
    project=_no_project,
    null_scale=None,  # traced scalar for coarse-level deflation (MG)
):
    """Solver dispatch mirroring the reference's `iterative_solve`
    (linear_algebra.rs:143-299). Handles a single system; vmap for
    batched systems (see `solve_momentum`).

    `project`/`null_scale`: constant-nullspace deflation for singular
    (unanchored pressure-correction) systems — see constant_deflation.
    `project` handles the fine level (it knows the active/owned mask);
    `null_scale` lets the multigrid cycles build plain-mean projections
    for their replicated all-active coarse levels."""
    method = settings.solver_type
    from orc_cfd.utils.settings import SolverPrecision

    if (
        settings.precision == SolverPrecision.DF32_IR
        and A.diag.dtype == jnp.float64
        and refresh is _no_refresh
        and method
        in (SolutionMethod.BICGSTAB, SolutionMethod.JACOBI,
            SolutionMethod.JACOBI_SMOOTH)
    ):
        # f64-accuracy via iterative refinement: plain f32 inner
        # solves + one native f64 residual per refinement
        # (solver/refine.py).
        from orc_cfd.solver.refine import df32_ir_solve

        return df32_ir_solve(
            A, b, x0, settings, axis_sum, project,
            refine_steps=settings.refine_steps,
        )
    if (
        refresh is _no_refresh
        and A.plan is not None
        and method != SolutionMethod.MULTIGRID
    ):
        # Irregular-mesh path: one-time conversion to the
        # slice-column layout (mesh/reorder.py) so every SpMV in the
        # solve reads contiguous slices. On the H100 this is slower
        # than the plain ELL gather (PERF.md; ROADMAP design item 4).
        A = A.prepare()
    if A.offsets is not None and method != SolutionMethod.MULTIGRID:
        # Structured fast path: pre-slice the K off-diagonal columns
        # OUTSIDE the solver loop — re-slicing [C,K] per sweep inside
        # lax.while_loop re-layouts the minor-K assembly output every
        # iteration (see EllMatrix.split_columns).
        A = A.split_columns()
    if settings.preconditioner == PreconditionMethod.JACOBI:
        A, inv_d = A.jacobi_preconditioned()
        b = b * inv_d
    if method == SolutionMethod.JACOBI:
        return jacobi_solve(
            A,
            b,
            x0,
            settings.iterations,
            settings.relaxation,
            settings.relative_convergence_threshold,
            axis_sum,
            refresh,
            compensated=settings.compensated_f32,
            project=project,
        )
    if method == SolutionMethod.JACOBI_SMOOTH:
        return jacobi_smooth_solve(
            A,
            b,
            x0,
            settings.iterations,
            settings.relaxation,
            axis_sum,
            refresh,
            compensated=settings.compensated_f32,
            project=project,
        )
    if method == SolutionMethod.BICGSTAB:
        # The reference's BiCGSTAB has no convergence exit
        # (linear_algebra.rs:255-268); here the settings threshold
        # applies as ||r|| <= thresh * ||r0|| (set it to 0 to force the
        # reference's fixed-count behavior). Relative-to-r0, not
        # relative-to-b: see the criterion note in bicgstab_solve.
        return bicgstab_solve(
            A,
            b,
            x0,
            settings.iterations,
            axis_sum,
            convergence_threshold=settings.relative_convergence_threshold,
            refresh=refresh,
            compensated=settings.compensated_f32,
            project=project,
        )
    if method == SolutionMethod.GAUSS_SEIDEL:
        if colors is None:
            raise ValueError(
                "Gauss-Seidel needs a host-precomputed coloring; pass "
                "colors/n_colors (see orc_cfd.solver.coloring)"
            )
        return gauss_seidel_solve(
            A,
            b,
            x0,
            settings.iterations,
            settings.relaxation,
            colors,
            n_colors,
            axis_sum,
            refresh,
            project=project,
        )
    if method == SolutionMethod.MULTIGRID:
        if mg_hierarchy is None:
            raise ValueError(
                "Multigrid needs a host-built hierarchy; pass mg_hierarchy "
                "(see orc_cfd.solver.gmg.build_gmg_hierarchy for "
                "structured meshes, orc_cfd.solver.amg.build_hierarchy "
                "otherwise)"
            )
        from orc_cfd.solver.gmg import GmgLevel, gmg_solve, gmg_solve_sharded

        if len(mg_hierarchy) and isinstance(mg_hierarchy[0], GmgLevel):
            if mg_owned is not None:  # sharded run (shard_map context)
                return gmg_solve_sharded(
                    A, b, x0, settings, mg_hierarchy, axis_sum, refresh,
                    mg_owned[0], mg_owned[1],
                    project=project, null_scale=null_scale,
                )
            return gmg_solve(
                A, b, x0, settings, mg_hierarchy, axis_sum,
                project=project, null_scale=null_scale,
            )
        from orc_cfd.solver.amg import (
            multigrid_solve,
            multigrid_solve_sharded,
        )

        if mg_owned is not None:  # sharded run (shard_map context)
            return multigrid_solve_sharded(
                A, b, x0, settings, mg_hierarchy, axis_sum, refresh,
                mg_owned[0], mg_owned[1],
                project=project, null_scale=null_scale,
            )
        return multigrid_solve(
            A, b, x0, settings, mg_hierarchy, axis_sum,
            project=project, null_scale=null_scale,
        )
    raise NotImplementedError(f"solution method {method}")
