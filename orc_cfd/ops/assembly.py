"""Finite-volume system assembly as vectorized [C,K] ops.

Vectorized re-design of the reference's cell-loop assembly
(discretization.rs): per-face quantities (flux, face pressure) are
computed once face-major, then every (cell, face-slot) pair of the
padded [C,K] adjacency is processed elementwise — gathers + `where`
selects + masked reductions, no scatter, no in-place CSR mutation.

Sign bookkeeping: `flux[f]` is owner-outward; the mass flow out of cell
c through slot k is ``F = sign[c,k] * flux[cf[c,k]] * area * rho``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from orc_cfd.mesh.compile import CompiledMesh
from orc_cfd.ops.fields import (
    PRESSURE_INLET,
    PRESSURE_OUTLET,
    SYMMETRY,
    VELOCITY_INLET,
    WALL,
    FaceBC,
)
from orc_cfd.ops.layout import take
from orc_cfd.ops.spmv import EllMatrix
from orc_cfd.utils.settings import MomentumScheme, NumericalSettings


class DiffusionSystem(NamedTuple):
    """Velocity-independent diffusion contributions, built once
    (reference: discretization.rs:39-131)."""

    diag: jnp.ndarray  # [C]
    off: jnp.ndarray  # [C,K]
    b: jnp.ndarray  # [C,3] Dirichlet-velocity source


def _gathered(mesh: CompiledMesh, fbc: FaceBC):
    """Common per-(c,k) gathers. BC data comes from the zone tables via
    FaceBC.ck (never through the per-face arrays — see FaceBC), built
    ONCE here and threaded to the callers (each fbc.ck call re-traces
    the Z-way [C,K(,3)] where-chain; XLA CSEs the duplicates but the
    traced graph bloats at multi-million cells)."""
    cf = mesh.cell_faces
    m = mesh.cell_face_mask
    code, scalar, vector = fbc.ck(mesh)
    area = take(mesh.face_area, cf)
    interior = take(mesh.face_interior, cf) & m
    return cf, m, (code, scalar, vector), area, interior


def diffusion_system(mesh: CompiledMesh, fbc: FaceBC, mu) -> DiffusionSystem:
    cf, m, (code, _, bc_vec), area, interior = _gathered(mesh, fbc)
    # Dirichlet-velocity boundaries contribute d = mu A / |x_f - x_c|
    # plus a source d * v_bc; zero-gradient boundaries (pressure BCs,
    # symmetry) contribute nothing (discretization.rs:69-118).
    d_bnd = mu * area / take(mesh.face_dist_fo, cf)
    d_int = mu * area / take(mesh.face_dist_on, cf)
    dirichlet = ((code == WALL) | (code == VELOCITY_INLET)) & m
    d = jnp.where(interior, d_int, jnp.where(dirichlet, d_bnd, 0.0))
    diag = jnp.sum(d, axis=1)
    off = jnp.where(interior, -d, 0.0)
    b = jnp.sum(
        jnp.where(dirichlet[..., None], d[..., None] * bc_vec, 0.0),
        axis=1,
    )
    return DiffusionSystem(diag=diag, off=off, b=b)


def momentum_system(
    mesh: CompiledMesh,
    fbc: FaceBC,
    settings: NumericalSettings,
    rho,
    vel,  # [C,3]
    flux,  # [F] owner-outward normal velocity
    p_face,  # [F]
    diff: DiffusionSystem,
    grad_vel=None,  # [C,3,3], required for TVD
    inertia=None,  # (rho V / dt [C], vel_n [C,3]) for transient runs
):
    """Assemble the three momentum systems (shared sparsity) in one pass
    (reference: discretization.rs:133-356). With `inertia`, the
    first-order implicit unsteady term rho V/dt (phi - phi_n) is added
    (the reference's unimplemented "transient iteration" roadmap item,
    README.md:42).

    Returns (EllMatrix with batch dim 3 ordered [u,v,w], b [3,C],
    per-cell Peclet array).
    """
    cf, m, (code, _, bc_vec), area, interior = _gathered(mesh, fbc)
    sgn = mesh.cell_face_sign
    F = sgn * take(flux, cf) * area * rho  # mass flow out of c through slot k
    Fv = F[..., None]  # broadcast over components

    scheme = settings.momentum
    s_dc = 0.0  # deferred-correction source (CD2/TVD_DC)
    # UD/CD1(/TVD_DC)'s advection coefficients are component-independent:
    # the three momentum systems then share ONE matrix ([C]/[C,K]
    # instead of [3,C]/[3,C,K]) and the batched solve broadcasts it —
    # 3x less coefficient memory AND 3x less SpMV traffic.
    if scheme == MomentumScheme.UD:
        a_nb = jnp.minimum(F, 0.0)  # [C,K], shared
    elif scheme == MomentumScheme.CD1:
        a_nb = F / 2.0  # [C,K], shared
    elif scheme == MomentumScheme.CD2:
        # Gradient-corrected CD: implicit CD1 stencil plus an explicit
        # deferred correction 0.5*(grad_C . r_Cf + grad_D . r_Df), which
        # restores second order on non-uniform grids. (The reference
        # enumerates CD2 but panics on it, lib.rs:101-102 /
        # discretization.rs:287; this is the real implementation.)
        if grad_vel is None:
            raise ValueError("CD2 momentum requires grad_vel")
        a_nb = Fv / 2.0 * jnp.ones((1, 1, 3), F.dtype)
        nbr = mesh.cell_neighbors
        # Per-(c,k) cell->face and neighbor->face vectors. Neighbor-side
        # rows (sgn<0) and periodic wraps need the face/neighbor seen in
        # the LOCAL frame, which the stored owner->neighbor vector
        # face_r_on encodes (incl. the periodic translation):
        #   owner row:    r_cf = x_f - x_own,  r_df = r_cf - r_on
        #   neighbor row: r_cf = (x_f - x_own_of_face) - r_on [local
        #   face], r_df = r_cf + r_on.
        r_on_ck = sgn[..., None] * take(mesh.face_r_on, cf)  # c -> other
        r_f_own = take(
            mesh.face_centroid - take(mesh.cell_centroid, mesh.face_owner),
            cf,
        )
        r_cf = jnp.where(
            (sgn > 0)[..., None],
            r_f_own,
            r_f_own - take(mesh.face_r_on, cf),
        )
        r_df = r_cf - r_on_ck
        g_c = jnp.einsum("cij,ckj->cki", grad_vel, r_cf, precision="highest")
        g_d = jnp.einsum("ckij,ckj->cki", take(grad_vel, nbr), r_df, precision="highest")
        delta = 0.5 * (g_c + g_d)  # [C,K,3]
        s_dc = -jnp.sum(
            jnp.where(interior[..., None], Fv * delta, 0.0), axis=1
        )
    elif scheme == MomentumScheme.TVD:
        if settings.tvd_psi is None or grad_vel is None:
            raise ValueError("TVD momentum requires tvd_psi and grad_vel")
        psi = settings.tvd_psi
        nbr = mesh.cell_neighbors
        downstream = jnp.where(F > 0, nbr, jnp.arange(mesh.n_cells)[:, None])
        v_d = take(vel, downstream)  # [C,K,3]
        v_c = vel[:, None, :]
        diffv = v_d - v_c
        same = jnp.linalg.norm(diffv, axis=-1) == 0.0  # all-components equal
        # Cell->neighbor vector from the stored face geometry (periodic
        # wraps see the neighbor's translated image, not the far side of
        # the domain).
        r_pa = sgn[..., None] * take(mesh.face_r_on, cf)
        gdotr = jnp.einsum("cij,ckj->cki", grad_vel, r_pa, precision="highest")  # [C,K,3]
        # Safe division: components with zero velocity difference fall
        # back to r=1 (psi(1)=1 for consistent limiters -> CD), avoiding
        # the reference's unguarded per-component division
        # (discretization.rs:276-278).
        safe = jnp.where(diffv == 0.0, 1.0, diffv)
        r = jnp.where(diffv == 0.0, 1.0, 2.0 * gdotr / safe - 1.0)
        a_tvd = Fv * psi(r) / 2.0
        a_cd = Fv / 2.0 * jnp.ones_like(a_tvd)
        a_ud = jnp.minimum(Fv, 0.0) * jnp.ones_like(a_tvd)
        a_nb = jnp.where(
            interior[..., None],
            jnp.where(same[..., None], a_cd, a_tvd),
            a_ud,  # boundary faces use UD (discretization.rs:235-239)
        )
    elif scheme == MomentumScheme.TVD_DC:
        # Deferred-correction TVD (see MomentumScheme.TVD_DC): implicit
        # UD matrix + explicit limited increment, computed from the
        # UPWIND side of each face so both rows sharing a face subtract
        # the same face value (exact conservation, unlike the
        # reference's in-matrix TVD).
        if settings.tvd_psi is None or grad_vel is None:
            raise ValueError("TVD_DC momentum requires tvd_psi and grad_vel")
        psi = settings.tvd_psi
        nbr = mesh.cell_neighbors
        a_nb = jnp.minimum(F, 0.0)  # [C,K]: the UD matrix, shared
        r_cd = sgn[..., None] * take(mesh.face_r_on, cf)  # c -> neighbor
        d_cd = take(vel, nbr) - vel[:, None, :]  # [C,K,3]
        up_is_c = (F > 0)[..., None]
        delta = jnp.where(up_is_c, d_cd, -d_cd)  # phi_D - phi_U
        g_c = jnp.einsum("cij,ckj->cki", grad_vel, r_cd, precision="highest")
        g_n = jnp.einsum("ckij,ckj->cki", take(grad_vel, nbr), -r_cd, precision="highest")
        gdotr = jnp.where(up_is_c, g_c, g_n)  # grad_U . r_UD
        safe = jnp.where(delta == 0.0, 1.0, delta)
        r = 2.0 * gdotr / safe - 1.0
        corr = jnp.where(delta == 0.0, 0.0, psi(r) / 2.0 * delta)
        s_dc = -jnp.sum(
            jnp.where(interior[..., None], Fv * corr, 0.0), axis=1
        )
    else:
        raise NotImplementedError(f"momentum scheme {scheme}")
    shared = a_nb.ndim == 2  # component-independent matrix (UD/CD1/TVD_DC)
    if shared:
        a_nb = jnp.where(m, a_nb, 0.0)
        a_p = jnp.sum(jnp.where(m, -a_nb + F, 0.0), axis=1)  # [C]
        a_nb_src = a_nb[..., None]  # for the Dirichlet vector source
    else:
        a_nb = jnp.where(m[..., None], a_nb, 0.0)
        a_p = jnp.sum(jnp.where(m[..., None], -a_nb + Fv, 0.0), axis=1)  # [C,3]
        a_nb_src = a_nb

    # a_p accumulates -a_nb + F over real faces; pressure force source
    # s_u -= n_out * p_f * A  (discretization.rs:290-291).
    n_out = sgn[..., None] * take(mesh.face_normal, cf)
    s_u = -jnp.sum(
        jnp.where(m[..., None], n_out * (take(p_face, cf) * area)[..., None], 0.0),
        axis=1,
    )
    # Dirichlet-velocity boundary advection source (a_nb - F) * v_bc
    # (discretization.rs:294-307).
    dirichlet = ((code == WALL) | (code == VELOCITY_INLET)) & m & ~interior
    s_u = s_u + jnp.sum(
        jnp.where(
            dirichlet[..., None], (a_nb_src - Fv) * bc_vec, 0.0
        ),
        axis=1,
    )
    # Deferred-correction (CD2/TVD_DC) and user momentum source
    # (reference: get_momentum_source_term, solver.rs:698-701 /
    # discretization.rs:171-173 where s_u_dc is a zero TODO).
    s_u = s_u + s_dc
    if settings.momentum_source is not None:
        from orc_cfd.ops.fields import momentum_source_term

        s_u = s_u + momentum_source_term(
            settings.momentum_source, mesh.cell_centroid, mesh.cell_volume
        )

    # Assemble the ELL matrices: off-diag = a_nb + diffusion off-diag at
    # interior slots; diag = a_p + diffusion diag. Shared form: one
    # [C]/[C,K] matrix for all three components (b stays [3,C]);
    # per-component form: [3,C]/[3,C,K].
    # Inactive rows (padded / halo cells in sharded runs) get identity
    # rows so the systems stay nonsingular and Krylov vectors stay zero
    # off the owned set.
    active = m.any(axis=1)
    a_t = 0.0
    s_t = 0.0
    if inertia is not None:
        rv_dt, vel_n = inertia
        a_t = rv_dt if shared else rv_dt[:, None]
        s_t = rv_dt[:, None] * vel_n
    from orc_cfd.utils.settings import RelaxationMode

    if shared:
        off = jnp.where(interior, a_nb + diff.off, 0.0)  # [C,K]
        diag = a_p + diff.diag + a_t  # [C]
        b = s_u + diff.b + s_t  # [C,3]
        if settings.relaxation_mode == RelaxationMode.IMPLICIT:
            alpha = settings.momentum_relaxation
            b = b + (1.0 - alpha) / alpha * diag[:, None] * vel
            diag = diag / alpha
        diag = jnp.where(active, diag, 1.0)
        b = jnp.where(active[:, None], b, 0.0)
        pe = jnp.where(
            active[:, None],
            (a_p / jnp.where(active, diff.diag, 1.0))[:, None]
            * jnp.ones((1, 3), a_p.dtype),
            0.0,
        )
        A = EllMatrix(
            diag=diag,  # [C], shared by u/v/w
            off=off,  # [C,K]
            neighbors=mesh.cell_neighbors,
            offsets=mesh.neighbor_offsets,
            plan=mesh.slice_plan,
        )
        return A, jnp.moveaxis(b, -1, 0), pe

    off = jnp.where(
        interior[..., None], a_nb + diff.off[..., None], 0.0
    )  # [C,K,3]
    diag = a_p + diff.diag[:, None] + a_t  # [C,3]
    b = s_u + diff.b + s_t  # [C,3]
    if settings.relaxation_mode == RelaxationMode.IMPLICIT:
        alpha = settings.momentum_relaxation
        b = b + (1.0 - alpha) / alpha * diag * vel
        diag = diag / alpha
    diag = jnp.where(active[:, None], diag, 1.0)
    b = jnp.where(active[:, None], b, 0.0)

    # "Peclet" per cell/component = a_p / diffusion diagonal
    # (discretization.rs:331-338); inactive rows excluded via NaN-free
    # neutral values (stats are reduced by the caller).
    pe = jnp.where(
        active[:, None],
        a_p / jnp.where(active, diff.diag, 1.0)[:, None],
        0.0,
    )

    A = EllMatrix(
        diag=jnp.moveaxis(diag, -1, 0),  # [3,C]
        off=jnp.moveaxis(off, -1, 0),  # [3,C,K]
        neighbors=mesh.cell_neighbors,
        offsets=mesh.neighbor_offsets,
        plan=mesh.slice_plan,
    )
    return A, jnp.moveaxis(b, -1, 0), pe


def _normal_momentum_coeff(mom_diag_c, n):
    """|(a_u n_x, a_v n_y, a_w n_z)| (discretization.rs:14-23)."""
    return jnp.linalg.norm(mom_diag_c * n, axis=-1)


def pressure_correction_system(
    mesh: CompiledMesh,
    fbc: FaceBC,
    rho,
    flux,  # [F] recomputed with post-momentum velocities
    mom_diag,  # [C,3] current momentum diagonals
):
    """SIMPLE continuity system (reference: discretization.rs:358-448).

    b = net mass inflow; interior a_nb = rho A^2 / a_face with the
    two-cell averaged normal momentum coefficient; boundary faces add
    rho A^2 / a_cell / 2 to the diagonal (the reference's admitted
    guess, discretization.rs:434-435 — kept for behavioral parity).
    """
    cf, m, (code, _, _), area, interior = _gathered(mesh, fbc)
    sgn = mesh.cell_face_sign
    b = jnp.sum(jnp.where(m, -sgn * take(flux, cf) * area * rho, 0.0), axis=1)

    n = take(mesh.face_normal, cf)
    a_c = _normal_momentum_coeff(mom_diag[:, None, :], n)  # [C,K]
    a_face = 0.5 * jnp.linalg.norm(
        (mom_diag[:, None, :] + take(mom_diag, mesh.cell_neighbors)) * n, axis=-1
    )
    a_nb = rho * area**2 / a_face
    a_bnd = rho * area**2 / a_c / 2.0
    # Boundary faces all contribute rho A^2/a/2 to the diagonal,
    # following the reference (discretization.rs:434-436) INCLUDING its
    # known inconsistency (its own TODO at :426 says walls should add
    # zero). This is deliberate: with stateless fluxes (re-interpolated
    # from cell fields each iteration, never corrected in place) these
    # spurious prescribed-flux terms are what keep the outer loop
    # stable — on single-layer 2D meshes every cell carries the
    # z-plane term, making the p' system a SCREENED Poisson whose
    # damping the whole relaxation regime is tuned around. Removing
    # them (round-3 experiment) sends the graded channel_flow.msh
    # divergent under every scheme/anchor-scaling tried, because the
    # stateless loop's per-mode gain is only bounded by this screen.
    # The physically-correct treatment (zero wall contribution) needs
    # stored-and-corrected face fluxes so the mass-loop gain is exactly
    # 1 by construction — see NOTES.md 'flux-correction' design item.
    active = m.any(axis=1)
    diag = jnp.sum(
        jnp.where(interior, a_nb, jnp.where(m, a_bnd, 0.0)), axis=1
    )
    diag = jnp.where(active, diag, 1.0)
    b = jnp.where(active, b, 0.0)
    off = jnp.where(interior, -a_nb, 0.0)
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


def apply_pressure_correction(
    mesh: CompiledMesh,
    fbc: FaceBC,
    settings: NumericalSettings,
    p_prime,  # [C]
    mom_diag,  # [C,3]
    vel,  # [C,3]
    p,  # [C]
):
    """SIMPLE update: p += alpha_p p'; u += alpha_u/a_diag *
    sum_f (p'_c - p'_f) A n_out, with the interior p'_f selected by
    settings.pressure_correction_form (see that enum for the full
    stability/accuracy trade):

    - CELL_DIFFERENCE (reference parity, solver.rs:1214-1223, the
      default): p'_f = p'_nb — 2x the consistent magnitude, compact
      checkerboard damping;
    - FACE_VALUE (consistent): p'_f linear, so the sum is exactly
      -(V/a) grad p'.

    Both use p'_f = 0 at pressure BCs (the Dirichlet pull) and
    p'_f = p'_c (zero-gradient) at prescribed-flux BCs."""
    from orc_cfd.utils.settings import PressureCorrectionForm

    cf, m, (code, _, _), area, interior = _gathered(mesh, fbc)
    sgn = mesh.cell_face_sign
    p_pr_nb = take(p_prime, mesh.cell_neighbors)
    if settings.pressure_correction_form == PressureCorrectionForm.FACE_VALUE:
        p_pr_int = 0.5 * (p_prime[:, None] + p_pr_nb)
    else:
        p_pr_int = p_pr_nb
    p_pr_f = jnp.where(
        interior,
        p_pr_int,
        jnp.where(
            ((code == PRESSURE_INLET) | (code == PRESSURE_OUTLET)),
            0.0,
            p_prime[:, None],  # wall / symmetry / velocity inlet
        ),
    )
    n_out = sgn[..., None] * take(mesh.face_normal, cf)
    scaled_n = n_out / mom_diag[:, None, :]
    dpp = (p_prime[:, None] - p_pr_f) * area
    corr = jnp.sum(
        jnp.where(m[..., None], scaled_n * dpp[..., None], 0.0), axis=1
    )  # [C,3]

    from orc_cfd.utils.settings import RelaxationMode

    corr_factor = (
        1.0
        if settings.relaxation_mode == RelaxationMode.IMPLICIT
        else settings.momentum_relaxation
    )
    new_vel = vel + corr_factor * corr
    new_p = p + settings.pressure_relaxation * p_prime
    # Correction norms over owned/active cells only (halo slots of a
    # sharded run carry remote copies that must not be double-counted).
    active = m.any(axis=1)
    p_sq = jnp.sum(jnp.where(active, p_prime * p_prime, 0.0))
    v_sq = jnp.sum(jnp.where(active[:, None], corr * corr, 0.0))
    return new_vel, new_p, (p_sq, v_sq)
