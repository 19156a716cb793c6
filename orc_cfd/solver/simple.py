"""SIMPLE pressure-velocity coupling — the outer nonlinear loop.

Vectorized re-design of the reference's `solve_steady`
(solver.rs:26-244): one *entire* SIMPLE iteration (gradient
reconstruction -> face fluxes -> momentum assembly -> three batched
momentum solves -> pressure-correction assembly + solve -> field
updates -> metrics) is a single traced function, and `lax.scan` drives
`reporting_interval` iterations per device dispatch. Assembly, solves
and updates never leave the device; the host only reads back the small
metrics pytree between chunks for reporting/divergence handling.

Improvements over the reference, by design (SURVEY.md 7):
- cell gradients computed once per iteration (not per face per cell);
- u/v/w solved as one batched [3, C] solve over shared sparsity;
- divergence reported as data, not a panic (host raises
  `SolverDivergedError` with the iteration number).
"""

from __future__ import annotations

import dataclasses
import os
import time
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from orc_cfd.mesh.compile import CompiledMesh
from orc_cfd.mesh.zones import BoundaryTable
from orc_cfd.ops.assembly import (
    DiffusionSystem,
    apply_pressure_correction,
    diffusion_system,
    momentum_system,
    pressure_correction_system,
)
from orc_cfd.ops.fields import device_bc, face_bc
from orc_cfd.ops.gradients import pressure_gradient, velocity_gradient
from orc_cfd.ops.interpolation import face_flux, face_pressure
from orc_cfd.ops.spmv import EllMatrix
from orc_cfd.solver.krylov import _no_refresh, iterative_solve
from orc_cfd.utils.settings import (
    GradientReconstruction,
    MomentumScheme,
    NumericalSettings,
    PressureInterpolation,
    RelaxationMode,
    SolutionMethod,
    VelocityInterpolation,
)


class NullComm:
    """Single-device communication context: no halo, local reductions.

    The sharded runtime (orc_cfd.parallel) substitutes an object with a
    `ppermute`-based `refresh` and `psum`/`pmin`/`pmax` reductions; the
    step code is identical in both cases (SPMD by construction).
    """

    # The krylov-module no-op sentinel, NOT a plain method: dispatch
    # sites test `refresh is _no_refresh` to decide the single-device
    # fast paths (EllMatrix.prepare() slice-plan conversion, direct
    # matvec); a bound method would defeat those checks and silently
    # route irregular meshes onto the element-gather SpMV.
    refresh = staticmethod(_no_refresh)

    def axis_sum(self, v):
        return v

    def axis_min(self, v):
        return v

    def axis_max(self, v):
        return v


class SolverDivergedError(RuntimeError):
    def __init__(self, iteration: int):
        super().__init__(f"solution diverged at iteration {iteration}")
        self.iteration = iteration


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FlowState:
    vel: jax.Array  # [C,3]
    p: jax.Array  # [C]
    # Momentum-matrix diagonals from the previous iteration; used by
    # Rhie-Chow fluxes and the pressure-correction coefficients before
    # this iteration's matrices exist (the reference reads them from its
    # in-place-updated CSR matrices, initialized to 1.0 —
    # discretization.rs:450-472).
    #
    # COMPONENT-MAJOR [3,C] (not [C,3]): a minor-dim-3 scan carry is
    # padded many times over on a backend that tiles the minor dims
    # (see ops/layout.py) and needs a broadcast to (re)produce it
    # every iteration. [3,C] matches the batched [3,C]
    # momentum-solve layout (the producer: A3.diag), so the shared-
    # matrix case is a contiguous 3-row broadcast and per-component
    # reads are zero-copy row slices. Cell-major consumers (Rhie-Chow
    # geometry products) take a one-off _md_cell() transpose.
    mom_diag: jax.Array  # [3,C]
    # Stored conservative face fluxes [F] (owner-outward normal
    # velocity) — only under PressureVelocityCoupling.SIMPLE_FC
    # (solver/fc.py); None on the stateless parity loop.
    flux: "jax.Array | None" = None


class StepMetrics(NamedTuple):
    vel_avg: jax.Array  # [3]
    peclet_avg: jax.Array
    peclet_min: jax.Array
    peclet_max: jax.Array
    p_corr_norm: jax.Array
    vel_corr_norm: jax.Array
    mom_residual: jax.Array  # [3] final momentum solve residuals
    pc_residual: jax.Array  # pressure-correction solve residual
    diverged: jax.Array  # bool
    mom_iters: jax.Array  # [3] inner iterations taken per momentum solve
    pc_iters: jax.Array  # inner iterations taken by the p' solve


def stack_history(history):
    """Concatenate per-chunk StepMetrics into one StepMetrics of
    [n_iterations]-leading arrays (for plotting / residual-history
    comparison against other solvers)."""
    import numpy as np

    return StepMetrics(
        *[
            np.concatenate([np.asarray(getattr(h, f)) for h in history])
            for f in StepMetrics._fields
        ]
    )


def save_history(path, history):
    """Write the stacked iteration history as an npz archive."""
    import numpy as np

    hs = stack_history(history)
    np.savez_compressed(path, **{f: getattr(hs, f) for f in hs._fields})


def initial_state(mesh: CompiledMesh, vel=None, p=None) -> FlowState:
    C = mesh.n_cells
    dt = mesh.dtype
    return FlowState(
        vel=jnp.zeros((C, 3), dt) if vel is None else jnp.asarray(vel, dt),
        p=jnp.zeros((C,), dt) if p is None else jnp.asarray(p, dt),
        mom_diag=jnp.ones((3, C), dt),
    )


def _md_cell(mom_diag):
    """Cell-major [C,3] view of the component-major [3,C] stored
    momentum diagonals (see FlowState.mom_diag) for the geometry-
    product consumers (Rhie-Chow fluxes, correction coefficients)."""
    return jnp.moveaxis(mom_diag, 0, -1)


def _refresh_rows(comm, md):
    """comm.refresh for a component-major [B,C] array: refresh fills
    halo slots along the leading cell axis, so map it over B."""
    if comm.refresh is _no_refresh:
        return md
    return jax.vmap(comm.refresh)(md)


def _needs_grad_p(settings: NumericalSettings) -> bool:
    return (
        settings.velocity_interpolation == VelocityInterpolation.RHIE_CHOW
        or settings.pressure_interpolation == PressureInterpolation.SECOND_ORDER
    )


def table_maybe_singular(table) -> bool:
    """True when NO zone can anchor the p' system — every zone is
    INTERIOR or a (compile-merged) periodic pair, i.e. the domain is
    fully periodic and the pressure-correction matrix is exactly
    singular. Host-side and static: zone TYPES are fixed per problem
    (only BC VALUES are traced), so anchored problems skip the
    deflation machinery entirely (bitwise-identical solve, no extra
    reductions) while fully-periodic ones get it."""
    from orc_cfd.mesh.zones import FaceCondition

    exempt = (
        FaceCondition.INTERIOR,
        FaceCondition.PERIODIC,
        FaceCondition.PERIODIC_SHADOW,
    )
    return all(fz.zone_type in exempt for fz in table.zones.values())


def table_has_pressure_bc(table) -> bool:
    """True when any zone is a pressure inlet/outlet — the ONLY zones
    that anchor the SIMPLE_FC pressure equation (solver/fc.py), whose
    matrix takes nothing from prescribed-flux boundaries."""
    from orc_cfd.mesh.zones import FaceCondition

    return any(
        fz.zone_type
        in (FaceCondition.PRESSURE_INLET, FaceCondition.PRESSURE_OUTLET)
        for fz in table.zones.values()
    )


def initial_flux(mesh, zone_codes, zone_scalar, zone_vector, settings, state):
    """Seed FlowState.flux for a SIMPLE_FC run: the plain interpolated
    flux of the initial fields (solver/fc.py corrects it conservatively
    from the first iteration on)."""
    fbc = face_bc(mesh, zone_codes, zone_scalar, zone_vector)
    grad_p = (
        pressure_gradient(
            mesh, fbc, state.p, settings.gradient_reconstruction
        )
        if _needs_grad_p(settings)
        else None
    )
    return face_flux(
        mesh,
        fbc,
        state.vel,
        settings.velocity_interpolation,
        p=state.p,
        grad_p=grad_p,
        mom_diag=_md_cell(state.mom_diag),
    )


def _solve_p_prime(
    Pmat, b_p, p, settings, active, comm, solver_extras,
    maybe_singular: bool,
    x0=None,
):
    """Solve the pressure-correction system, with the constant null
    mode DEFLATED when the system is singular.

    The reference-parity p' matrix gives every boundary face a
    rho A^2/a/2 diagonal term (assembly.pressure_correction_system), so
    any domain with at least one non-periodic boundary zone is
    anchored. A FULLY periodic domain (e.g. a Taylor-Green box before
    its symmetry reduction, homogeneous-turbulence slabs) has an
    exactly SINGULAR system: constant nullspace, consistent RHS.
    Krylov solvers on such systems are stable only in exact arithmetic
    — the Jacobi-preconditioned operator loses range(A) ⊥ 1, and
    roundoff-seeded constant components get amplified by near-singular
    alpha/omega steps into |x| > 1e10 spikes and breakdown NaNs
    (measured: 16^2 cavity MULTIGRID with an unanchored experimental
    matrix). `maybe_singular` comes statically from the zone table
    (table_maybe_singular); the projection is psum-correct under
    shard_map (the mean is a global scalar)."""
    from orc_cfd.solver.krylov import _no_project, constant_deflation

    if maybe_singular:
        null_scale = jnp.asarray(1.0, p.dtype)
        project = constant_deflation(
            null_scale, active=active, axis_sum=comm.axis_sum
        )
        extra = dict(project=project, null_scale=null_scale)
    else:
        # Anchored problem (static fact from the zone table): the
        # projections would be exact identities — skip them so the
        # solve is bitwise-identical to the pre-deflation code and
        # pays zero extra reductions.
        project = _no_project
        extra = {}
    # Warm starts must be zero at halo/padded slots: the distributed
    # Krylov contract keeps iterates identically zero outside owned
    # cells (halo rows are identity with b = 0), and a nonzero x0
    # there would bleed into every psum'ed dot product.
    x0 = (
        jnp.zeros_like(p)
        if x0 is None
        else jnp.where(active, x0, 0.0)
    )
    p_prime, p_info = iterative_solve(
        Pmat,
        b_p,
        x0,
        settings.matrix_solver,
        axis_sum=comm.axis_sum,
        refresh=comm.refresh,
        **extra,
        **solver_extras,
    )
    p_prime = project(p_prime)  # zero-mean gauge representative
    return comm.refresh(p_prime), p_info


def simple_step(
    mesh: CompiledMesh,
    zone_codes,
    zone_scalar,
    zone_vector,
    settings: NumericalSettings,
    rho,
    mu,
    diff: DiffusionSystem,
    state: FlowState,
    solver_extras: Optional[dict] = None,
    comm: Optional[NullComm] = None,
    inertia=None,
    maybe_singular: bool = True,
):
    """One SIMPLE iteration. Traceable; all arguments but `settings`
    and `maybe_singular` (static), `solver_extras` (aux pytrees) and
    `comm` are device data.
    Runs unchanged on one device (comm=NullComm) or inside `shard_map`
    with cells partitioned across a device mesh."""
    solver_extras = solver_extras or {}
    comm = comm or NullComm()
    fbc = face_bc(mesh, zone_codes, zone_scalar, zone_vector)
    active = mesh.cell_face_mask.any(axis=1)  # owned, non-padded cells

    vel = comm.refresh(state.vel)
    p = comm.refresh(state.p)
    mom_diag = _md_cell(_refresh_rows(comm, state.mom_diag))

    grad_p = (
        comm.refresh(
            pressure_gradient(mesh, fbc, p, settings.gradient_reconstruction)
        )
        if _needs_grad_p(settings)
        else None
    )
    grad_v = (
        comm.refresh(
            velocity_gradient(mesh, fbc, vel, settings.gradient_reconstruction)
        )
        if settings.momentum
        in (MomentumScheme.TVD, MomentumScheme.TVD_DC, MomentumScheme.CD2)
        else None
    )

    flux = face_flux(
        mesh,
        fbc,
        vel,
        settings.velocity_interpolation,
        p=p,
        grad_p=grad_p,
        mom_diag=mom_diag,
    )
    p_f = face_pressure(
        mesh, fbc, p, settings.pressure_interpolation, grad_p=grad_p
    )

    A3, b3, pe = momentum_system(
        mesh, fbc, settings, rho, vel, flux, p_f, diff, grad_vel=grad_v,
        inertia=inertia,
    )

    # Batched momentum solve over the shared sparsity.
    def solve_one(diag, off, b, x0):
        Ai = EllMatrix(
            diag=diag, off=off, neighbors=A3.neighbors, offsets=A3.offsets,
            plan=A3.plan,
        )
        return iterative_solve(
            Ai,
            b,
            x0,
            settings.momentum_matrix_solver(),
            axis_sum=comm.axis_sum,
            refresh=comm.refresh,
            **solver_extras,
        )

    x0 = jnp.where(active[None, :], jnp.moveaxis(vel, -1, 0), 0.0)  # [3,C]
    if A3.diag.ndim == 1:
        # Shared matrix (UD/CD1/TVD_DC): broadcast it into the batched
        # solve — the coefficients are read once for all three systems.
        sol, info = jax.vmap(solve_one, in_axes=(None, None, 0, 0))(
            A3.diag, A3.off, b3, x0
        )
        md = comm.refresh(A3.diag)
        new_mom_diag = jnp.broadcast_to(md[None, :], (3, md.shape[-1]))
    else:
        sol, info = jax.vmap(solve_one)(A3.diag, A3.off, b3, x0)
        new_mom_diag = _refresh_rows(comm, A3.diag)
    new_vel = comm.refresh(jnp.moveaxis(sol, 0, -1))
    new_md_c = _md_cell(new_mom_diag)

    # Pressure-correction system with post-solve velocities and the new
    # momentum diagonals (reference: solver.rs:137-148).
    flux2 = face_flux(
        mesh,
        fbc,
        new_vel,
        settings.velocity_interpolation,
        p=p,
        grad_p=grad_p,
        mom_diag=new_md_c,
    )
    Pmat, b_p = pressure_correction_system(mesh, fbc, rho, flux2, new_md_c)
    p_prime, p_info = _solve_p_prime(
        Pmat, b_p, p, settings, active, comm, solver_extras, maybe_singular
    )

    vel3, p_new, (p_corr_sq, vel_corr_sq) = apply_pressure_correction(
        mesh, fbc, settings, p_prime, new_md_c, new_vel, p
    )

    n_active = comm.axis_sum(jnp.sum(active))
    vel_avg = (
        comm.axis_sum(jnp.sum(jnp.where(active[:, None], vel3, 0.0), axis=0))
        / n_active
    )
    pe_avg = comm.axis_sum(jnp.sum(pe)) / (3.0 * n_active)
    inf = jnp.asarray(jnp.inf, pe.dtype)
    pe_min = comm.axis_min(jnp.min(jnp.where(active[:, None], pe, inf)))
    pe_max = comm.axis_max(jnp.max(jnp.where(active[:, None], pe, -inf)))
    p_corr_norm = jnp.sqrt(comm.axis_sum(p_corr_sq))
    vel_corr_norm = jnp.sqrt(comm.axis_sum(vel_corr_sq))
    diverged = (
        jnp.any(jnp.isnan(vel_avg))
        | jnp.any(info.diverged)
        | p_info.diverged
    )
    diverged = comm.axis_max(diverged)
    metrics = StepMetrics(
        vel_avg=vel_avg,
        peclet_avg=pe_avg,
        peclet_min=pe_min,
        peclet_max=pe_max,
        p_corr_norm=p_corr_norm,
        vel_corr_norm=vel_corr_norm,
        mom_residual=info.residual,
        pc_residual=p_info.residual,
        diverged=diverged,
        mom_iters=info.iterations,
        pc_iters=p_info.iterations,
    )
    new_state = FlowState(vel=vel3, p=p_new, mom_diag=new_mom_diag)
    return new_state, metrics


def ck_simple_step(
    mesh: CompiledMesh,
    ck,
    zone_codes,
    zone_scalar,
    zone_vector,
    settings: NumericalSettings,
    rho,
    mu,
    ck_diff,
    state: FlowState,
    solver_extras: Optional[dict] = None,
    inertia=None,
    comm: Optional[NullComm] = None,
    pallas_asm=None,  # static (cols, dims) -> fused assembly kernels
    maybe_singular: bool = True,
):
    """One SIMPLE iteration in the gather-free (c,k)-direct formulation
    (see orc_cfd.ops.ck_ops) — the fast path for structured meshes.
    Semantically identical to `simple_step` (equivalence pinned by
    tests/test_ck.py). Like `simple_step` it runs unchanged under
    `shard_map`: `comm.refresh` fills ghost-layer slots before every
    neighbor shift, so the slab-partitioned distributed run keeps the
    gather-free roll formulation end-to-end."""
    from orc_cfd.ops.ck_ops import (
        ck_apply_correction,
        ck_bc,
        ck_face_pressure,
        ck_flux,
        ck_momentum,
        ck_pressure_correction,
        ck_pressure_gradient,
        ck_velocity_gradient,
        nbr_values,
    )

    solver_extras = solver_extras or {}
    comm = comm or NullComm()
    bc = ck_bc(ck, zone_codes, zone_scalar, zone_vector)
    diff_diag, diff_off, diff_b = ck_diff
    vel = comm.refresh(state.vel)
    p = comm.refresh(state.p)
    mom_diag = _refresh_rows(comm, state.mom_diag)  # [3,C]
    # Cell-major view for the geometry-product consumers; never built
    # on the fused-kernel path (the kernels take the shared [C] row).
    md_c = None if pallas_asm is not None else _md_cell(mom_diag)
    active = ck.mask.any(axis=1)

    need_gp = _needs_grad_p(settings)
    from orc_cfd.ops.ck_ops import (
        ck_lsq_pressure_gradient,
        ck_lsq_velocity_gradient,
    )
    from orc_cfd.utils.settings import GradientReconstruction

    lsq = (
        settings.gradient_reconstruction
        == GradientReconstruction.LEAST_SQUARES
    )
    # The fused-kernel branch loads neighbor values inside the kernel —
    # never materialize the [C,K(,3)] neighbor tables there.
    vel_nbr = (
        None if pallas_asm is not None
        else nbr_values(mesh, vel, ck.interior)
    )
    grad_p = grad_p_nbr = None
    asm_gg = pallas_asm is not None and pallas_asm[1].gg
    if need_gp and not asm_gg:
        # asm_gg: the fused kernels compute the Green-Gauss pressure
        # gradient IN-KERNEL from the p halo — no separate XLA
        # gradient pass, no grad-p arrays streamed through memory.
        gp_fn = ck_lsq_pressure_gradient if lsq else ck_pressure_gradient
        grad_p = comm.refresh(gp_fn(mesh, ck, bc, p))
        if pallas_asm is None:
            grad_p_nbr = nbr_values(mesh, grad_p, ck.interior)
    gv_fn = ck_lsq_velocity_gradient if lsq else ck_velocity_gradient
    grad_v = (
        comm.refresh(gv_fn(mesh, ck, bc, vel, vel_nbr=vel_nbr))
        if settings.momentum
        in (MomentumScheme.TVD, MomentumScheme.TVD_DC, MomentumScheme.CD2)
        else None
    )
    mom_diag_nbr = (
        None if pallas_asm is not None
        else nbr_values(mesh, md_c, ck.interior)
    )

    if pallas_asm is not None:
        # Fused assembly kernels (ops/pallas_assembly.py): one pass over
        # the cell fields produces the shared momentum matrix + RHS; no
        # [C,K] intermediates touch device memory.
        from orc_cfd.ops.pallas_assembly import (
            bc_value_table,
            momentum_assembly,
            pack_flags,
        )

        cols, aspec, interp = pallas_asm
        flags = pack_flags(ck.interior, ck.mask)
        bcv = bc_value_table(zone_scalar, zone_vector)
        mdiag, moff, b3 = momentum_assembly(
            vel, p, bcv, flags, cols, rho, mu,
            settings.momentum_relaxation,
            grad_p=grad_p, mom_diag=mom_diag[0], grad_vel=grad_v,
            inertia=inertia, spec=aspec, interpret=interp,
        )
        if settings.momentum_source is not None:
            from orc_cfd.ops.fields import momentum_source_term

            src = momentum_source_term(
                settings.momentum_source,
                mesh.cell_centroid,
                mesh.cell_volume,
            )
            b3 = b3 + jnp.where(
                active[None, :], jnp.moveaxis(src, -1, 0), 0.0
            )
        A3 = EllMatrix(
            diag=mdiag, off=moff, neighbors=None,
            offsets=mesh.neighbor_offsets,
        )
        rvdt = inertia[0] if inertia is not None else 0.0
        safe_dd = jnp.where(active, diff_diag, 1.0)
        pe = jnp.where(
            active[:, None],
            ((settings.momentum_relaxation * mdiag - diff_diag - rvdt)
             / safe_dd)[:, None]
            * jnp.ones((1, 3), mdiag.dtype),
            0.0,
        )
    else:
        flux = ck_flux(
            mesh, ck, bc, vel, settings.velocity_interpolation,
            p=p, grad_p=grad_p, grad_p_nbr=grad_p_nbr,
            mom_diag=md_c, mom_diag_nbr=mom_diag_nbr, vel_nbr=vel_nbr,
        )
        F = flux * ck.area * rho
        p_f = ck_face_pressure(
            mesh, ck, bc, p, settings.pressure_interpolation,
            grad_p=grad_p, grad_p_nbr=grad_p_nbr,
        )
        A3, b3, pe = ck_momentum(
            mesh, ck, bc, settings, rho, vel, F, p_f,
            diff_diag, diff_off, diff_b, grad_vel=grad_v, vel_nbr=vel_nbr,
            inertia=inertia,
        )

    def solve_one(diag, off, b, x0):
        Ai = EllMatrix(
            diag=diag, off=off, neighbors=A3.neighbors, offsets=A3.offsets,
            plan=A3.plan,
        )
        return iterative_solve(
            Ai,
            b,
            x0,
            settings.momentum_matrix_solver(),
            axis_sum=comm.axis_sum,
            refresh=comm.refresh,
            **solver_extras,
        )

    x0 = jnp.where(active[None, :], jnp.moveaxis(vel, -1, 0), 0.0)
    if A3.diag.ndim == 1:
        # Shared matrix (UD/CD1/TVD_DC): broadcast it into the batched
        # solve — the coefficients are read once for all three systems.
        sol, info = jax.vmap(solve_one, in_axes=(None, None, 0, 0))(
            A3.diag, A3.off, b3, x0
        )
        md = comm.refresh(A3.diag)
        new_mom_diag = jnp.broadcast_to(md[None, :], (3, md.shape[-1]))
    else:
        sol, info = jax.vmap(solve_one)(A3.diag, A3.off, b3, x0)
        new_mom_diag = _refresh_rows(comm, A3.diag)
    new_vel = comm.refresh(jnp.moveaxis(sol, 0, -1))
    if pallas_asm is not None:
        from orc_cfd.ops.pallas_assembly import pc_assembly

        pdiag, poff, b_p = pc_assembly(
            new_vel, new_mom_diag[0], bcv, flags, cols, rho,
            p=p, grad_p=grad_p, spec=aspec, interpret=interp,
        )
        Pmat = EllMatrix(
            diag=pdiag, off=poff, neighbors=None,
            offsets=mesh.neighbor_offsets,
        )
    else:
        new_md_c = _md_cell(new_mom_diag)
        new_md_nbr = nbr_values(mesh, new_md_c, ck.interior)
        new_vel_nbr = nbr_values(mesh, new_vel, ck.interior)

        flux2 = ck_flux(
            mesh, ck, bc, new_vel, settings.velocity_interpolation,
            p=p, grad_p=grad_p, grad_p_nbr=grad_p_nbr,
            mom_diag=new_md_c, mom_diag_nbr=new_md_nbr,
            vel_nbr=new_vel_nbr,
        )
        F2 = flux2 * ck.area * rho
        Pmat, b_p = ck_pressure_correction(
            mesh, ck, bc, rho, F2, new_md_c, mom_diag_nbr=new_md_nbr
        )
    p_prime, p_info = _solve_p_prime(
        Pmat, b_p, p, settings, active, comm, solver_extras, maybe_singular
    )
    vel3, p_new, (p_corr_sq, vel_corr_sq) = ck_apply_correction(
        mesh, ck, bc, settings, p_prime, _md_cell(new_mom_diag), new_vel, p
    )

    n_active = comm.axis_sum(jnp.sum(active))
    vel_avg = (
        comm.axis_sum(jnp.sum(jnp.where(active[:, None], vel3, 0.0), axis=0))
        / n_active
    )
    inf = jnp.asarray(jnp.inf, pe.dtype)
    metrics = StepMetrics(
        vel_avg=vel_avg,
        peclet_avg=comm.axis_sum(jnp.sum(pe)) / (3.0 * n_active),
        peclet_min=comm.axis_min(
            jnp.min(jnp.where(active[:, None], pe, inf))
        ),
        peclet_max=comm.axis_max(
            jnp.max(jnp.where(active[:, None], pe, -inf))
        ),
        p_corr_norm=jnp.sqrt(comm.axis_sum(p_corr_sq)),
        vel_corr_norm=jnp.sqrt(comm.axis_sum(vel_corr_sq)),
        mom_residual=info.residual,
        pc_residual=p_info.residual,
        diverged=comm.axis_max(
            jnp.any(jnp.isnan(vel_avg))
            | jnp.any(info.diverged)
            | p_info.diverged
        ),
        mom_iters=info.iterations,
        pc_iters=p_info.iterations,
    )
    return FlowState(vel=vel3, p=p_new, mom_diag=new_mom_diag), metrics


#: Cell-count ceiling for the [C,K]-expanded fast path (the expanded
#: static geometry costs ~350 B/cell at K=6 f32); the ceiling guards
#: the geometry expansion itself, not the step.
CK_AUTO_MAX_CELLS = int(os.environ.get("ORC_CK_MAX_CELLS", "10000000"))


@partial(
    jax.jit,
    static_argnames=(
        "settings", "n_steps", "n_colors", "use_ck", "pallas_asm",
        "maybe_singular", "use_fc",
    ),
)
def _run_scan(
    mesh, diff, ck, ck_diff, state, zc, zs, zv, rho, mu, colors,
    mg_hierarchy, *, settings, n_steps, n_colors, use_ck,
    pallas_asm=None, maybe_singular=True, use_fc=False,
):
    """Module-level jitted scan so repeated solve_steady calls on the
    same mesh/settings reuse the compiled executable (a per-call jit
    closure would recompile — and bake the mesh in as constants)."""
    extras = {}
    if colors is not None:
        extras = dict(colors=colors, n_colors=n_colors)
    elif mg_hierarchy is not None:
        extras = dict(mg_hierarchy=mg_hierarchy)

    def step(s):
        if use_fc:
            if use_ck:
                from orc_cfd.solver.fc import ck_simple_step_fc

                return ck_simple_step_fc(
                    mesh, ck, zc, zs, zv, settings, rho, mu, ck_diff, s,
                    extras, pallas_asm=pallas_asm,
                    maybe_singular=maybe_singular,
                )
            from orc_cfd.solver.fc import simple_step_fc

            return simple_step_fc(
                mesh, zc, zs, zv, settings, rho, mu, diff, s, extras,
                maybe_singular=maybe_singular,
            )
        if use_ck:
            return ck_simple_step(
                mesh, ck, zc, zs, zv, settings, rho, mu, ck_diff, s, extras,
                pallas_asm=pallas_asm, maybe_singular=maybe_singular,
            )
        return simple_step(
            mesh, zc, zs, zv, settings, rho, mu, diff, s, extras,
            maybe_singular=maybe_singular,
        )

    # Kahan-compensated state accumulation for f32 runs (see
    # NumericalSettings.compensated_state): without it, per-iteration
    # increments below f32 epsilon of the fields round away and the
    # run freezes short of steady state.
    use_comp = (
        settings.compensated_state and state.vel.dtype == jnp.float32
    )
    if not use_comp:
        return lax.scan(
            lambda s, _: step(s), state, None, length=n_steps
        )

    def body(carry, _):
        s, cv, cp = carry
        s2, metrics = step(s)
        dv = (s2.vel - s.vel) + cv
        vel = s.vel + dv
        cv = dv - (vel - s.vel)
        dp = (s2.p - s.p) + cp
        p = s.p + dp
        cp = dp - (p - s.p)
        s2 = dataclasses.replace(s2, vel=vel, p=p)
        return (s2, cv, cp), metrics

    comp0 = (jnp.zeros_like(state.vel), jnp.zeros_like(state.p))
    (state, _, _), metrics = lax.scan(
        body, (state, *comp0), None, length=n_steps
    )
    return state, metrics


def _make_chunk_runner(
    mesh, settings, diff, n_steps, solver_extras, ck=None, ck_diff=None,
    pallas_asm=None, maybe_singular=True, use_fc=False,
):
    """`lax.scan` runner over n_steps SIMPLE iterations.

    On the ck path the face-major mesh tables are never read, so the
    runner passes a trimmed mesh (mesh.compile.trim_for_ck): the big
    face/[C,K]-index arrays stay out of the executable's arguments
    (less per-dispatch layout normalization, and they can be freed for
    large runs)."""
    colors = solver_extras.get("colors")
    n_colors = solver_extras.get("n_colors", 0)
    mg = solver_extras.get("mg_hierarchy")
    if ck is not None and mesh.neighbor_offsets is not None:
        # Structured meshes only: the irregular-mesh ck fallback still
        # gathers through mesh.cell_neighbors (ck_ops.nbr_values) and
        # builds EllMatrices from it, so those must stay intact there.
        from orc_cfd.mesh.compile import trim_for_ck

        mesh = trim_for_ck(mesh)
        diff = None  # unused by the ck body; don't ship its arrays

    if pallas_asm is not None and ck_diff is not None:
        # The fused kernels compute diffusion from mu internally; only
        # the diffusion DIAGONAL is still read (Peclet metrics). Dummy
        # out the [C,K] off-diagonals + [C,3] sources (~0.6 GB at 16.8M
        # cells f32) so they are not executable arguments. 2-row
        # dummies fail loudly on any accidental use (cf. trim_for_ck).
        dd, doff, _db = ck_diff
        ck_diff = (
            dd,
            jnp.zeros((2, doff.shape[1]), doff.dtype),
            jnp.zeros((2, 3), dd.dtype),
        )

    def run(state, zone_codes, zone_scalar, zone_vector, rho, mu):
        return _run_scan(
            mesh,
            diff,
            ck,
            ck_diff,
            state,
            zone_codes,
            zone_scalar,
            zone_vector,
            rho,
            mu,
            colors,
            mg,
            settings=settings,
            n_steps=n_steps,
            n_colors=n_colors,
            use_ck=ck is not None,
            pallas_asm=pallas_asm,
            maybe_singular=maybe_singular,
            use_fc=use_fc,
        )

    return run


def _pallas_asm_spec(
    mesh, table, settings, ck, fc=False, sharded=False
):
    """Static (cols, AsmSpec, interpret) for the fused assembly kernels
    when the configuration is eligible (ops/pallas_assembly.py), else
    None. The kernels run compiled on a GPU backend
    (backend.kernel_mode); ORC_PALLAS_ASM=0 keeps the XLA ck path there,
    and ORC_PALLAS_ASM=force runs them in interpret mode elsewhere
    (tests / the virtual-mesh dryrun). Covers the shared-matrix
    momentum schemes (UD / CD1 / TVD_DC), Linear[Weighted] AND
    Rhie-Chow face velocities, Linear[Weighted] AND SecondOrder face
    pressures, the transient inertia term, and momentum sources (added
    in XLA after the kernel).

    `sharded`: the slab partition's 1-deep ghost layer cannot feed the
    in-kernel neighbor gradient (needs p + flags 2 layers deep), so
    sharded runs keep AsmSpec.gg off and read ppermute-refreshed grad p
    instead."""
    from orc_cfd.backend import kernel_mode

    mode = os.environ.get("ORC_PALLAS_ASM", "1")
    if (
        mode == "0"
        or ck is None
        or mesh.ck_constants is None
        or mesh.dtype != jnp.float32
        or settings.relaxation_mode != RelaxationMode.IMPLICIT
    ):
        return None
    run = kernel_mode(interpret=mode == "force")
    if run is None:
        return None
    scheme = {
        MomentumScheme.UD: "ud",
        MomentumScheme.CD1: "cd1",
        MomentumScheme.TVD_DC: "tvd_dc",
    }.get(settings.momentum)
    if scheme is None:
        return None
    if scheme == "tvd_dc" and settings.tvd_psi is None:
        return None
    vi = settings.velocity_interpolation
    if vi == VelocityInterpolation.RHIE_CHOW:
        rc = True
    elif vi in (
        VelocityInterpolation.LINEAR,
        VelocityInterpolation.LINEAR_WEIGHTED,
    ):
        rc = False
    else:
        return None
    pi = settings.pressure_interpolation
    if pi == PressureInterpolation.SECOND_ORDER:
        p_so = True
    elif pi in (
        PressureInterpolation.LINEAR,
        PressureInterpolation.LINEAR_WEIGHTED,
    ):
        p_so = False
    else:
        return None
    from orc_cfd.ops.pallas_assembly import AsmSpec, column_specs

    cols = column_specs(mesh, table)
    if cols is None:
        return None
    # In-kernel Green-Gauss pressure gradient: eliminates the separate
    # XLA gradient pass. Only for GG_CELL gradients (LSQ gradients keep
    # the grad-p input), non-FC, single-device (see docstring).
    gg = (
        (rc or p_so)
        and not fc
        and not sharded
        and settings.gradient_reconstruction
        == GradientReconstruction.GREEN_GAUSS_CELL
    )
    spec = AsmSpec(
        scheme=scheme,
        rc=rc,
        p_so=p_so,
        psi=settings.tvd_psi if scheme == "tvd_dc" else None,
        vol=float(mesh.cell_volume[0]),
        gg=gg,
    )
    return (cols, spec, run == "interpret")


def solve_steady(
    mesh: CompiledMesh,
    table: BoundaryTable,
    settings: NumericalSettings,
    rho: float,
    mu: float,
    state: Optional[FlowState] = None,
    iterations: int = 10,
    reporting_interval: int = 1,
    verbose: bool = True,
    check_divergence: bool = True,
    use_ck: str | bool = "auto",
):
    """Host driver for the steady SIMPLE loop
    (reference: solver.rs:26-244 + report line solver.rs:206-216).

    `use_ck`: "auto" selects the gather-free (c,k)-direct step for
    meshes under CK_AUTO_MAX_CELLS; True forces it; False forces the
    face-major path.

    Returns (FlowState, list[StepMetrics-pytree per chunk]).
    """
    table.validate_supported()
    reporting_interval = max(1, min(reporting_interval, iterations))
    zc, zs, zv = device_bc(table, dtype=mesh.dtype)
    if state is None:
        state = initial_state(mesh)

    from orc_cfd.utils.settings import PressureVelocityCoupling

    use_fc = (
        settings.resolved_coupling()
        == PressureVelocityCoupling.SIMPLE_FC
    )
    ck = ck_diff = None
    # The (c,k)-direct step computes Green-Gauss cell gradients only;
    # LSQ / node-based runs must take the face-major path.
    from orc_cfd.utils.settings import GradientReconstruction

    ck_grad_ok = settings.gradient_reconstruction in (
        GradientReconstruction.GREEN_GAUSS_CELL,
        GradientReconstruction.LEAST_SQUARES,
    )
    if use_ck is True and not ck_grad_ok:
        raise ValueError(
            "use_ck=True requires green_gauss_cell or least_squares "
            f"gradients (the ck-direct step does not implement "
            f"{settings.gradient_reconstruction})"
        )
    if use_ck is True or (
        use_ck == "auto"
        and ck_grad_ok
        and mesh.n_cells <= CK_AUTO_MAX_CELLS
    ):
        from orc_cfd.ops.ck_ops import build_ck_geometry, ck_bc, ck_diffusion

        ck = build_ck_geometry(mesh, len(table.zone_ids))
        bc0 = ck_bc(ck, zc, zs, zv)
        ck_diff = ck_diffusion(mesh, ck, bc0, jnp.asarray(mu, mesh.dtype))

    # The face-major diffusion system is only needed when the
    # face-major step will actually run, or for the AMG hierarchy's
    # coupling values — skip the whole build otherwise so large ck runs
    # never materialize those arrays.
    need_diff = (
        ck is None
        or settings.matrix_solver.solver_type == SolutionMethod.MULTIGRID
    )
    diff = None
    if need_diff:
        fbc = face_bc(mesh, zc, zs, zv)
        diff = diffusion_system(mesh, fbc, jnp.asarray(mu, mesh.dtype))

    solver_extras = {}
    if settings.matrix_solver.solver_type == SolutionMethod.GAUSS_SEIDEL:
        from orc_cfd.solver.coloring import greedy_coloring

        colors, n_colors = greedy_coloring(mesh)
        solver_extras = dict(colors=colors, n_colors=n_colors)
    elif settings.matrix_solver.solver_type == SolutionMethod.MULTIGRID:
        from orc_cfd.solver.gmg import build_mg_hierarchy

        solver_extras = dict(
            mg_hierarchy=build_mg_hierarchy(mesh, diff, settings)
        )

    if use_fc and state.flux is None:
        # The stored flux must exist before the scan starts (fixed
        # carry structure): [C,K] on the ck path, [F] face-major.
        if ck is not None:
            from orc_cfd.ops.ck_ops import ck_bc as _ckbc
            from orc_cfd.solver.fc import ck_initial_flux

            state = dataclasses.replace(
                state,
                flux=ck_initial_flux(
                    mesh, ck, _ckbc(ck, zc, zs, zv), settings, state
                ),
            )
        else:
            state = dataclasses.replace(
                state,
                flux=initial_flux(mesh, zc, zs, zv, settings, state),
            )

    pallas_asm = _pallas_asm_spec(mesh, table, settings, ck, fc=use_fc)
    maybe_singular = (
        not table_has_pressure_bc(table)
        if use_fc
        else table_maybe_singular(table)
    )

    if ck is not None and mesh.neighbor_offsets is not None:
        # Drop this frame's references to the big tables too so the
        # trimmed runner's freeing actually frees (see trim_for_ck).
        from orc_cfd.mesh.compile import trim_for_ck

        mesh = trim_for_ck(mesh)
        diff = None

    run = _make_chunk_runner(
        mesh, settings, diff, reporting_interval, solver_extras,
        ck=ck, ck_diff=ck_diff, pallas_asm=pallas_asm,
        maybe_singular=maybe_singular, use_fc=use_fc,
    )
    history = []
    done = 0
    t0 = time.perf_counter()
    while done < iterations:
        n = min(reporting_interval, iterations - done)
        if n != reporting_interval:
            run = _make_chunk_runner(
                mesh, settings, diff, n, solver_extras, ck=ck,
                ck_diff=ck_diff, pallas_asm=pallas_asm,
                maybe_singular=maybe_singular, use_fc=use_fc,
            )
        state, metrics = run(state, zc, zs, zv, rho, mu)
        jax.block_until_ready(state)
        done += n
        history.append(metrics)
        if verbose:
            dt_ms = (time.perf_counter() - t0) * 1e3 / n
            t0 = time.perf_counter()
            va = jax.device_get(metrics.vel_avg[-1])
            print(
                f"Iteration {done}: avg velocity = "
                f"({va[0]:.2e}, {va[1]:.2e}, {va[2]:.2e})\t"
                f"avg peclet = {float(metrics.peclet_avg[-1]):.1e}\t"
                f"vel corr = {float(metrics.vel_corr_norm[-1]):.2e}\t"
                f"p corr = {float(metrics.p_corr_norm[-1]):.2e}\t"
                f"ms/iter = {dt_ms:.3g}"
            )
        if check_divergence and bool(jax.device_get(jnp.any(metrics.diverged))):
            raise SolverDivergedError(done)
    return state, history
