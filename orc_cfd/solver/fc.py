"""Flux-corrected SIMPLE (`PressureVelocityCoupling.SIMPLE_FC`).

The parity SIMPLE loop (solver/simple.py) is STATELESS in the fluxes:
every outer iteration re-interpolates face fluxes from the cell fields,
so the mass-loop gain per mode is whatever the interpolation gives, and
stability leans on the reference's spurious boundary p'-diagonal (the
"screened Poisson" — see assembly.pressure_correction_system) plus tiny
pressure relaxation. This module implements the standard
production-code structure instead (the round-3 design item in
NOTES.md):

- face fluxes are STATE (`FlowState.flux`, owner-outward normal
  velocity [F]); momentum advects with last iteration's corrected —
  conservative — flux;
- the pressure equation solves for the FULL p field (not an increment),
  assembled from the flux predictor `flux_h` (the Rhie-Chow flux
  WITHOUT its compact pressure-difference term — that term is what the
  equation replaces);
- the stored flux is corrected with the UNRELAXED new p through
  exactly the matrix coefficients, so div(flux) equals the linear-solve
  residual every iteration — mass errors cannot accumulate, for any
  pressure relaxation;
- p is relaxed only where the next momentum solve reads it
  (p <- p + alpha_p (p_new - p)), and the cell velocities get the
  consistent face-value correction from the relaxed increment.

Because the pressure-equation coefficient is chosen EQUAL to the
Rhie-Chow damping coefficient d_f = 0.5 rho A (V_i/a_i + V_j/a_j)/dist,
the corrected interior flux at a converged state (p_new == p) is
IDENTICAL to the classic Rhie-Chow flux — SIMPLE_FC converges to the
same discrete solution as the parity loop on enclosed domains (pinned
by tests/test_fc.py). At pressure boundaries the flux model gains a
one-sided d_b (p_c - p_BC)/dist_fo term the stateless loop lacks (a
proper boundary Rhie-Chow); with LINEAR/LINEAR_WEIGHTED interpolation
the compact pressure coupling of the corrected flux supplies the
checkerboard control Rhie-Chow normally provides.

Stability consequences (measured, tests/test_fc.py): alpha_p 0.3 is
stable where the parity loop needs 0.01-0.1, and the thin-z cavity
that diverges under the parity loop (z-plane boundary terms swamping
the p' diagonal ~1e2-1e3x) converges — the prescribed-flux boundary
terms are OMITTED from this pressure equation (walls pass no mass;
conservation is enforced through the stored flux, which needs no
stabilizing fake diagonal).

Scope: face-major (reference implementation), the gather-free
(c,k)-direct fast path (ck_simple_step_fc; equivalence pinned to 1e-12
by tests/test_fc.py), and shard_map (both local steps take the comm
hooks; sharded == single-device pinned at 1e-8). Transient / RANS /
fused-Pallas ports are tracked in NOTES.md and guarded with clear
errors.
"""

from __future__ import annotations

import jax.numpy as jnp

from orc_cfd.mesh.compile import CompiledMesh
from orc_cfd.ops.assembly import (
    _gathered,
    _normal_momentum_coeff,
    apply_pressure_correction,
    momentum_system,
)
from orc_cfd.ops.fields import (
    INTERIOR,
    PRESSURE_INLET,
    PRESSURE_OUTLET,
    VELOCITY_INLET,
    WALL,
)
from orc_cfd.ops.gradients import pressure_gradient, velocity_gradient
from orc_cfd.ops.interpolation import face_flux, face_pressure
from orc_cfd.ops.layout import take
from orc_cfd.ops.spmv import EllMatrix
from orc_cfd.utils.settings import (
    MomentumScheme,
    PressureCorrectionForm,
    VelocityInterpolation,
)


def face_flux_h(mesh, fbc, vel, scheme, p=None, grad_p=None, mom_diag=None):
    """Flux predictor for the p-form pressure equation: the face-normal
    velocity WITHOUT the compact pressure-difference damping term.

    For LINEAR / LINEAR_WEIGHTED this IS face_flux (they carry no
    pressure term). For RHIE_CHOW it is 0.5*(term1 + term3) of the
    interpolation.face_flux formula — term2, the compact
    (p_i - p_j)/dist damping, is exactly what the pressure equation's
    flux correction re-adds with the new p, so including it here would
    double-count it. Boundary faces keep face_flux's rules (0 at
    wall/symmetry, BC value at velocity inlets, v_own.n at pressure
    faces)."""
    if scheme in (
        VelocityInterpolation.LINEAR,
        VelocityInterpolation.LINEAR_WEIGHTED,
    ):
        return face_flux(mesh, fbc, vel, scheme)
    if scheme != VelocityInterpolation.RHIE_CHOW:
        raise NotImplementedError(f"SIMPLE_FC with {scheme}")
    if p is None or grad_p is None or mom_diag is None:
        raise ValueError("Rhie-Chow flux_h requires p, grad_p, mom_diag")
    n = mesh.face_normal
    own_i = mesh.face_owner
    nbr_i = mesh.face_neighbor
    v_own = take(vel, own_i)
    v_nbr = take(vel, nbr_i)
    a_i = jnp.linalg.norm(take(mom_diag, own_i) * n, axis=1)
    a_j = jnp.linalg.norm(take(mom_diag, nbr_i) * n, axis=1)
    voa_i = mesh.cell_volume[own_i] / a_i
    voa_j = mesh.cell_volume[nbr_i] / a_j
    r_ij = mesh.face_r_on
    dist = mesh.face_dist_on
    term1 = jnp.einsum("fi,fi->f", v_own + v_nbr, n, precision="highest")
    gsum = (
        voa_i[:, None] * take(grad_p, own_i)
        + voa_j[:, None] * take(grad_p, nbr_i)
    )
    term3 = jnp.einsum("fi,fi->f", gsum, r_ij, precision="highest") / dist
    interior = 0.5 * (term1 + term3)
    boundary_vn = jnp.where(
        fbc.is_(VELOCITY_INLET),
        jnp.einsum("fi,fi->f", fbc.vector, n, precision="highest"),
        jnp.einsum("fi,fi->f", v_own, n, precision="highest"),  # pressure inlet/outlet
    )
    from orc_cfd.ops.fields import SYMMETRY

    return jnp.where(
        fbc.is_(WALL, SYMMETRY),
        0.0,
        jnp.where(fbc.is_(INTERIOR), interior, boundary_vn),
    )


def _face_d_coeffs(mesh, fbc, rho, mom_diag):
    """Per-FACE pressure-coupling coefficients of the flux model
    (units: mass flow per pressure):

    - interior: d_f = 0.5 rho A (V_i/a_i + V_j/a_j)/dist — the
      Rhie-Chow damping coefficient, so the corrected flux reduces to
      the classic Rhie-Chow flux when p_new == p;
    - pressure boundaries: d_b = rho A (V_c/a_c)/dist_fo — the
      one-sided half-cell closure (dist_fo IS the half-cell distance);
    - prescribed-flux boundaries: 0 (their flux cannot respond to p).
    """
    n = mesh.face_normal
    own_i = mesh.face_owner
    nbr_i = mesh.face_neighbor
    a_i = _normal_momentum_coeff(take(mom_diag, own_i), n)
    a_j = _normal_momentum_coeff(take(mom_diag, nbr_i), n)
    voa_i = mesh.cell_volume[own_i] / a_i
    voa_j = mesh.cell_volume[nbr_i] / a_j
    A = mesh.face_area
    d_int = 0.5 * rho * A * (voa_i + voa_j) / mesh.face_dist_on
    d_bnd = rho * A * voa_i / mesh.face_dist_fo
    is_p = fbc.is_(PRESSURE_INLET, PRESSURE_OUTLET)
    return jnp.where(
        fbc.is_(INTERIOR), d_int, jnp.where(is_p, d_bnd, 0.0)
    )


def fc_pressure_system(mesh, fbc, rho, flux_h, d_face):
    """Assemble the full-p continuity system A p = b from the flux
    predictor: row c is

        sum_int d_f (p_c - p_nb) + sum_pf d_b (p_c - p_BC)
            = - sum_f sgn flux_h A rho

    i.e. the corrected-flux divergence set to zero. Prescribed-flux
    faces contribute NOTHING to the matrix (their flux is fixed); a
    domain with no pressure BC is exactly singular and is solved
    deflated (krylov.constant_deflation)."""
    cf, m, (code, scalar, _), area, interior = _gathered(mesh, fbc)
    sgn = mesh.cell_face_sign
    d_ck = take(d_face, cf)
    is_p = ((code == PRESSURE_INLET) | (code == PRESSURE_OUTLET)) & m
    b = jnp.sum(
        jnp.where(m, -sgn * take(flux_h, cf) * area * rho, 0.0), axis=1
    )
    b = b + jnp.sum(jnp.where(is_p, d_ck * scalar, 0.0), axis=1)
    diag = jnp.sum(
        jnp.where(interior | is_p, d_ck, 0.0), axis=1
    )
    active = m.any(axis=1)
    diag = jnp.where(active, diag, 1.0)
    b = jnp.where(active, b, 0.0)
    off = jnp.where(interior, -d_ck, 0.0)
    return (
        EllMatrix(
            diag=diag,
            off=off,
            neighbors=mesh.cell_neighbors,
            offsets=mesh.neighbor_offsets,
            plan=mesh.slice_plan,
        ),
        b,
    )


def correct_flux(mesh, fbc, flux_h, d_face, rho, p_new):
    """Conservative flux update with the UNRELAXED new p:
    div(corrected flux) == b - A p_new == the linear-solve residual."""
    own_i = mesh.face_owner
    nbr_i = mesh.face_neighbor
    p_own = take(p_new, own_i)
    dv = d_face / (rho * jnp.maximum(mesh.face_area, 1e-300))
    delta = jnp.where(
        fbc.is_(INTERIOR),
        p_own - take(p_new, nbr_i),
        p_own - fbc.scalar,  # d_face is 0 except at pressure faces
    )
    return flux_h + dv * delta


def simple_step_fc(
    mesh: CompiledMesh,
    zone_codes,
    zone_scalar,
    zone_vector,
    settings,
    rho,
    mu,
    diff,
    state,
    solver_extras=None,
    comm=None,
    inertia=None,
    maybe_singular: bool = True,
):
    """One flux-corrected SIMPLE iteration (see the module docstring).

    `state.flux` must be initialized (solver/simple.initial_flux);
    `maybe_singular` is the STATIC host fact "no pressure zones"
    (simple.table_has_pressure_bc) — unlike the parity loop, walls
    anchor nothing here."""
    from orc_cfd.ops.fields import face_bc
    from orc_cfd.solver.krylov import iterative_solve
    from orc_cfd.solver.simple import (
        FlowState,
        NullComm,
        StepMetrics,
        _md_cell,
        _needs_grad_p,
        _refresh_rows,
        _solve_p_prime,
    )

    solver_extras = solver_extras or {}
    comm = comm or NullComm()
    fbc = face_bc(mesh, zone_codes, zone_scalar, zone_vector)
    active = mesh.cell_face_mask.any(axis=1)

    vel = comm.refresh(state.vel)
    p = comm.refresh(state.p)
    mom_diag = _refresh_rows(comm, state.mom_diag)  # [3,C]
    flux = state.flux  # [F] conservative from the previous correction

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
    p_f = face_pressure(
        mesh, fbc, p, settings.pressure_interpolation, grad_p=grad_p
    )

    A3, b3, pe = momentum_system(
        mesh, fbc, settings, rho, vel, flux, p_f, diff, grad_vel=grad_v,
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

    import jax

    x0 = jnp.where(active[None, :], jnp.moveaxis(vel, -1, 0), 0.0)
    if A3.diag.ndim == 1:
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

    # Pressure equation from the flux predictor (full p, not p').
    flux_h = face_flux_h(
        mesh,
        fbc,
        new_vel,
        settings.velocity_interpolation,
        p=p,
        grad_p=grad_p,
        mom_diag=new_md_c,
    )
    d_face = _face_d_coeffs(mesh, fbc, rho, new_md_c)
    Pmat, b_p = fc_pressure_system(mesh, fbc, rho, flux_h, d_face)
    # Warm-started full-p solve (x0 = current p: near convergence the
    # initial residual is already small and the rel-to-r0 exit fires
    # fast); unanchored domains solve deflated and return the
    # zero-mean gauge representative.
    p_new, p_info = _solve_p_prime(
        Pmat, b_p, p, settings, active, comm, solver_extras,
        maybe_singular, x0=p,
    )

    # Conservative stored flux from the UNRELAXED p_new; under
    # explicit relaxation it is blended with the previous stored flux
    # by the same alpha the velocity correction receives (both
    # operands are divergence-free, so the blend stays conservative —
    # settings.resolved_fc_flux_relaxation).
    new_flux = correct_flux(mesh, fbc, flux_h, d_face, rho, p_new)
    beta_f = settings.resolved_fc_flux_relaxation()
    if beta_f != 1.0:
        new_flux = flux + beta_f * (new_flux - flux)

    # Relaxed pressure + consistent face-value velocity correction from
    # the relaxed increment (what the next momentum solve sees).
    dp = (p_new - p) * settings.pressure_relaxation
    s_corr = settings.replace(
        pressure_relaxation=1.0,
        pressure_correction_form=PressureCorrectionForm.FACE_VALUE,
    )
    vel3, p_out, (p_corr_sq, vel_corr_sq) = apply_pressure_correction(
        mesh, fbc, s_corr, comm.refresh(dp), new_md_c, new_vel, p
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
    new_state = FlowState(
        vel=vel3, p=p_out, mom_diag=new_mom_diag, flux=new_flux
    )
    return new_state, metrics


# --- (c,k)-direct port (the gather-free fast path; see ops/ck_ops) ---


def ck_flux_h(
    mesh, ck, bc, vel, scheme,
    p=None, grad_p=None, grad_p_nbr=None, mom_diag=None, mom_diag_nbr=None,
    vel_nbr=None,
):
    """[C,K] flux predictor — ck_ops.ck_flux WITHOUT the Rhie-Chow
    compact term2 (see face_flux_h). Antisymmetric per face by
    construction: both sides evaluate commutative-symmetric expressions
    against opposite stored normals, so the two (c,k) images of an
    interior face are exact FP negations of each other."""
    from orc_cfd.ops.ck_ops import nbr_values

    v_c = vel[:, None, :]
    v_n = (
        vel_nbr if vel_nbr is not None
        else nbr_values(mesh, vel, ck.interior)
    )
    if scheme in (
        VelocityInterpolation.LINEAR,
        VelocityInterpolation.LINEAR_WEIGHTED,
    ):
        from orc_cfd.ops.ck_ops import ck_flux

        return ck_flux(mesh, ck, bc, vel, scheme, vel_nbr=vel_nbr)
    if scheme != VelocityInterpolation.RHIE_CHOW:
        raise NotImplementedError(f"SIMPLE_FC with {scheme}")
    md_n = (
        mom_diag_nbr if mom_diag_nbr is not None
        else nbr_values(mesh, mom_diag, ck.interior)
    )
    a_c = jnp.sqrt(jnp.sum((mom_diag[:, None, :] * ck.n_out) ** 2, axis=-1))
    a_n = jnp.sqrt(jnp.sum((md_n * ck.n_out) ** 2, axis=-1))
    vol = mesh.cell_volume
    voa_c = vol[:, None] / a_c
    voa_n = nbr_values(mesh, vol, ck.interior) / a_n
    gp_n = (
        grad_p_nbr if grad_p_nbr is not None
        else nbr_values(mesh, grad_p, ck.interior)
    )
    term1 = jnp.sum((v_c + v_n) * ck.n_out, axis=-1)
    gsum = voa_c[..., None] * grad_p[:, None, :] + voa_n[..., None] * gp_n
    term3 = jnp.sum(gsum * ck.r_on, axis=-1) / ck.dist_on
    interior = 0.5 * (term1 + term3)
    bnd = jnp.where(
        bc.is_vel_inlet,
        jnp.sum(bc.vector * ck.n_out, axis=-1),
        jnp.sum(v_c * ck.n_out, axis=-1),  # pressure BCs
    )
    return jnp.where(
        bc.is_wall_like,
        0.0,
        jnp.where(ck.interior, interior, jnp.where(ck.mask, bnd, 0.0)),
    )


def ck_d_coeffs(mesh, ck, bc, rho, mom_diag, mom_diag_nbr=None):
    """[C,K] flux pressure-coupling coefficients (see _face_d_coeffs).
    Symmetric across each interior face (voa_c + voa_n commutes), so
    the corrected [C,K] flux stays exactly antisymmetric."""
    from orc_cfd.ops.ck_ops import nbr_values

    md_n = (
        mom_diag_nbr if mom_diag_nbr is not None
        else nbr_values(mesh, mom_diag, ck.interior)
    )
    a_c = jnp.sqrt(jnp.sum((mom_diag[:, None, :] * ck.n_out) ** 2, axis=-1))
    a_n = jnp.sqrt(jnp.sum((md_n * ck.n_out) ** 2, axis=-1))
    vol = mesh.cell_volume
    voa_c = vol[:, None] / jnp.where(ck.mask, a_c, 1.0)
    voa_n = nbr_values(mesh, vol, ck.interior) / jnp.where(ck.mask, a_n, 1.0)
    d_int = 0.5 * rho * ck.area * (voa_c + voa_n) / ck.dist_on
    d_bnd = rho * ck.area * voa_c / ck.dist_fo
    return jnp.where(
        ck.interior, d_int, jnp.where(bc.is_pressure, d_bnd, 0.0)
    )


def ck_fc_pressure_system(mesh, ck, bc, rho, flux_h, d_ck):
    """[C,K] assembly of the full-p continuity system (see
    fc_pressure_system)."""
    b = jnp.sum(
        jnp.where(ck.mask, -flux_h * ck.area * rho, 0.0), axis=1
    )
    b = b + jnp.sum(jnp.where(bc.is_pressure, d_ck * bc.scalar, 0.0), axis=1)
    diag = jnp.sum(
        jnp.where(ck.interior | bc.is_pressure, d_ck, 0.0), axis=1
    )
    active = ck.mask.any(axis=1)
    diag = jnp.where(active, diag, 1.0)
    b = jnp.where(active, b, 0.0)
    off = jnp.where(ck.interior, -d_ck, 0.0)
    return (
        EllMatrix(
            diag=diag,
            off=off,
            neighbors=mesh.cell_neighbors,
            offsets=mesh.neighbor_offsets,
            plan=mesh.slice_plan,
        ),
        b,
    )


def ck_correct_flux(mesh, ck, bc, flux_h, d_ck, rho, p_new, p_new_nbr):
    """Conservative [C,K] flux update with the unrelaxed new p."""
    delta = jnp.where(
        ck.interior,
        p_new[:, None] - p_new_nbr,
        p_new[:, None] - bc.scalar,  # d_ck is 0 except at pressure faces
    )
    dv = d_ck / (rho * jnp.where(ck.mask, ck.area, 1.0))
    return flux_h + jnp.where(ck.mask, dv * delta, 0.0)


def ck_initial_flux(mesh, ck, bc, settings, state):
    """Seed FlowState.flux ([C,K]) for a ck-path SIMPLE_FC run."""
    from orc_cfd.ops.ck_ops import (
        ck_flux,
        ck_lsq_pressure_gradient,
        ck_pressure_gradient,
    )
    from orc_cfd.solver.simple import _md_cell, _needs_grad_p
    from orc_cfd.utils.settings import GradientReconstruction

    grad_p = None
    if _needs_grad_p(settings):
        lsq = (
            settings.gradient_reconstruction
            == GradientReconstruction.LEAST_SQUARES
        )
        gp_fn = ck_lsq_pressure_gradient if lsq else ck_pressure_gradient
        grad_p = gp_fn(mesh, ck, bc, state.p)
    return ck_flux(
        mesh, ck, bc, state.vel, settings.velocity_interpolation,
        p=state.p, grad_p=grad_p, mom_diag=_md_cell(state.mom_diag),
    )


def ck_simple_step_fc(
    mesh,
    ck,
    zone_codes,
    zone_scalar,
    zone_vector,
    settings,
    rho,
    mu,
    ck_diff,
    state,
    solver_extras=None,
    inertia=None,
    comm=None,
    pallas_asm=None,  # static (cols, interpret) -> fused assembly
    maybe_singular: bool = True,
):
    """Flux-corrected SIMPLE on the gather-free (c,k)-direct path
    (face-major twin: simple_step_fc). `state.flux` is the [C,K]
    outward normal velocity (exactly antisymmetric per interior face,
    see ck_flux_h/ck_d_coeffs)."""
    import jax

    from orc_cfd.ops.ck_ops import (
        ck_apply_correction,
        ck_bc,
        ck_face_pressure,
        ck_lsq_pressure_gradient,
        ck_lsq_velocity_gradient,
        ck_momentum,
        ck_pressure_gradient,
        ck_velocity_gradient,
        nbr_values,
    )
    from orc_cfd.solver.krylov import iterative_solve
    from orc_cfd.solver.simple import (
        FlowState,
        NullComm,
        StepMetrics,
        _md_cell,
        _needs_grad_p,
        _refresh_rows,
        _solve_p_prime,
    )
    from orc_cfd.utils.settings import GradientReconstruction

    solver_extras = solver_extras or {}
    comm = comm or NullComm()
    bc = ck_bc(ck, zone_codes, zone_scalar, zone_vector)
    diff_diag, diff_off, diff_b = ck_diff
    vel = comm.refresh(state.vel)
    p = comm.refresh(state.p)
    mom_diag = _refresh_rows(comm, state.mom_diag)  # [3,C]
    flux = state.flux  # [C,K] conservative from the previous correction
    active = ck.mask.any(axis=1)

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
    if _needs_grad_p(settings):
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

    if pallas_asm is not None:
        # Fused SIMPLE_FC momentum assembly (ops/pallas_assembly.py):
        # the stored conservative flux rides into the kernel as a
        # [C,K] input; no other [C,K] intermediate touches device
        # memory.
        from orc_cfd.ops.pallas_assembly import (
            bc_value_table,
            fc_momentum_assembly,
            pack_flags,
        )

        cols, aspec, interp = pallas_asm
        flags = pack_flags(ck.interior, ck.mask)
        bcv = bc_value_table(zone_scalar, zone_vector)
        mdiag, moff, b3 = fc_momentum_assembly(
            vel, p, flux, bcv, flags, cols, rho, mu,
            settings.momentum_relaxation,
            grad_p=grad_p, grad_vel=grad_v, inertia=inertia,
            spec=aspec, interpret=interp,
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

    new_md_nbr = nbr_values(mesh, new_md_c, ck.interior)
    if pallas_asm is not None:
        from orc_cfd.ops.pallas_assembly import fc_pc_assembly

        pdiag, poff, b_p, flux_h = fc_pc_assembly(
            new_vel, new_mom_diag[0], bcv, flags, cols, rho,
            grad_p=grad_p, spec=aspec, interpret=interp,
        )
        Pmat = EllMatrix(
            diag=pdiag, off=poff, neighbors=None,
            offsets=mesh.neighbor_offsets,
        )
        # d for the conservative correction: recomputed in XLA from the
        # shared momentum diagonal (fuses into the correction's
        # elementwise pass; a 1-ulp mismatch vs the kernel's matrix
        # coefficients only perturbs div(flux) at rounding scale,
        # re-zeroed by the next p-solve).
        d_ck = ck_d_coeffs(mesh, ck, bc, rho, new_md_c, new_md_nbr)
    else:
        new_vel_nbr = nbr_values(mesh, new_vel, ck.interior)
        flux_h = ck_flux_h(
            mesh, ck, bc, new_vel, settings.velocity_interpolation,
            p=p, grad_p=grad_p, grad_p_nbr=grad_p_nbr,
            mom_diag=new_md_c, mom_diag_nbr=new_md_nbr,
            vel_nbr=new_vel_nbr,
        )
        d_ck = ck_d_coeffs(mesh, ck, bc, rho, new_md_c, new_md_nbr)
        Pmat, b_p = ck_fc_pressure_system(mesh, ck, bc, rho, flux_h, d_ck)
    p_new, p_info = _solve_p_prime(
        Pmat, b_p, p, settings, active, comm, solver_extras,
        maybe_singular, x0=p,
    )
    p_new_nbr = nbr_values(mesh, p_new, ck.interior)
    new_flux = ck_correct_flux(
        mesh, ck, bc, flux_h, d_ck, rho, p_new, p_new_nbr
    )
    # Stored-flux under-relaxation (see the face-major step / the
    # settings.fc_flux_relaxation docstring): conservative blend,
    # alpha-consistent with the explicit velocity correction.
    beta_f = settings.resolved_fc_flux_relaxation()
    if beta_f != 1.0:
        new_flux = flux + beta_f * (new_flux - flux)

    dp = (p_new - p) * settings.pressure_relaxation
    s_corr = settings.replace(
        pressure_relaxation=1.0,
        pressure_correction_form=PressureCorrectionForm.FACE_VALUE,
    )
    vel3, p_out, (p_corr_sq, vel_corr_sq) = ck_apply_correction(
        mesh, ck, bc, s_corr, comm.refresh(dp), new_md_c, new_vel, p
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
    new_state = FlowState(
        vel=vel3, p=p_out, mom_diag=new_mom_diag, flux=new_flux
    )
    return new_state, metrics
