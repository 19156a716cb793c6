"""Face interpolation ops: velocity, pressure, and mass flux at faces.

Vectorized re-design of the reference's per-face closures
(reference: solver.rs:952-1150): each op is a single vectorized map over
all F faces — two cell-value gathers, elementwise math, and BC selection
by `jnp.where` over the face BC-code array. Fluxes and face pressures
are computed ONCE per face per outer iteration and reused by every
assembly that needs them (the reference recomputes gradients per face
per cell, an O(F * K) blowup noted in SURVEY.md 3.3).

Sign convention: `face_flux` returns the normal velocity with respect to
the owner cell's outward normal. The flux out of the *neighbor* cell
through the same face is its negation (the [C,K] assembly applies
`cell_face_sign`).
"""

from __future__ import annotations

import jax.numpy as jnp

from orc_cfd.mesh.compile import CompiledMesh
from orc_cfd.ops.fields import (
    INTERIOR,
    PRESSURE_INLET,
    PRESSURE_OUTLET,
    SYMMETRY,
    VELOCITY_INLET,
    WALL,
    FaceBC,
)
from orc_cfd.ops.layout import take
from orc_cfd.utils.settings import PressureInterpolation, VelocityInterpolation


def _interior_scalar(mesh: CompiledMesh, own, nbr, weighted: bool):
    if weighted:
        w = mesh.face_lw
        if own.ndim > 1:
            w = w[:, None]
        return own + (nbr - own) * w
    return 0.5 * (own + nbr)


def face_velocity(
    mesh: CompiledMesh,
    fbc: FaceBC,
    vel,  # [C,3]
    scheme: VelocityInterpolation = VelocityInterpolation.LINEAR,
):
    """Velocity at each face [F,3] (reference: solver.rs:952-1003)."""
    own = take(vel, mesh.face_owner)
    nbr = take(vel, mesh.face_neighbor)
    if scheme == VelocityInterpolation.LINEAR_WEIGHTED:
        interior = _interior_scalar(mesh, own, nbr, True)
    else:
        interior = _interior_scalar(mesh, own, nbr, False)

    out = jnp.where(
        fbc.is_(WALL, VELOCITY_INLET)[:, None],
        fbc.vector,
        jnp.where(
            fbc.is_(PRESSURE_INLET, PRESSURE_OUTLET, SYMMETRY)[:, None],
            own,
            interior,
        ),
    )
    return out


def face_pressure(
    mesh: CompiledMesh,
    fbc: FaceBC,
    p,  # [C]
    scheme: PressureInterpolation,
    grad_p=None,  # [C,3], required for SECOND_ORDER
):
    """Pressure at each face [F] (reference: solver.rs:1104-1150)."""
    own = p[mesh.face_owner]
    nbr = p[mesh.face_neighbor]
    if scheme == PressureInterpolation.LINEAR:
        interior = 0.5 * (own + nbr)
    elif scheme == PressureInterpolation.LINEAR_WEIGHTED:
        interior = _interior_scalar(mesh, own, nbr, True)
    elif scheme == PressureInterpolation.SECOND_ORDER:
        if grad_p is None:
            raise ValueError("SECOND_ORDER face pressure requires grad_p")
        r0 = mesh.face_centroid - take(mesh.cell_centroid, mesh.face_owner)
        # x_f - x_nbr via the stored owner->neighbor vector (carries the
        # periodic-image translation; raw centroid differences would
        # span the whole domain across a periodic wrap).
        r1 = r0 - mesh.face_r_on
        g0 = jnp.einsum("fi,fi->f", take(grad_p, mesh.face_owner), r0, precision="highest")
        g1 = jnp.einsum("fi,fi->f", take(grad_p, mesh.face_neighbor), r1, precision="highest")
        interior = 0.5 * ((own + nbr) + (g0 + g1))
    else:
        raise NotImplementedError(f"pressure interpolation {scheme}")

    return jnp.where(
        fbc.is_(WALL, SYMMETRY, VELOCITY_INLET),
        own,
        jnp.where(fbc.is_(PRESSURE_INLET, PRESSURE_OUTLET), fbc.scalar, interior),
    )


def face_flux(
    mesh: CompiledMesh,
    fbc: FaceBC,
    vel,  # [C,3]
    scheme: VelocityInterpolation,
    p=None,  # [C]      (Rhie-Chow)
    grad_p=None,  # [C,3]    (Rhie-Chow)
    mom_diag=None,  # [C,3] momentum-matrix diagonals (Rhie-Chow)
):
    """Normal velocity (owner-outward) at each face [F]
    (reference: solver.rs:1007-1102).

    Rhie-Chow (solver.rs:1051-1095):
        0.5 * [ (v_i + v_j) . n
                + (V_i/a_i + V_j/a_j) (p_i - p_j)/|r_ij|
                + (V_i/a_i grad_p_i + V_j/a_j grad_p_j) . r_ij_hat ]
    with a_c = |(a_u_c n_x, a_v_c n_y, a_w_c n_z)| the normal momentum
    coefficient (discretization.rs:14-23). Gradients and diagonals are
    the once-per-iteration cell arrays, not recomputed per face.

    DELIBERATE DEVIATION from the reference: solver.rs:1095 SUBTRACTS
    term_3. With (p_i - p_j) in term_2, the damping must ADD the
    gradient part so the correction vanishes on a linear pressure field
    (0.5*(term2+term3) = -d_f[(dp/dn)_f - grad_p_f.n], the standard
    Rhie-Chow dissipation). The reference's sign leaves a spurious
    -d_f*grad_p.n flux ~ O(h*grad_p) on SMOOTH fields — measured here
    as a scheme-insensitive ~60% increase in the Re=1000 cavity
    Ghia-landmark error (0.063 -> 0.102 at 64^2, TVD_DC).
    """
    n = mesh.face_normal
    own_i = mesh.face_owner
    nbr_i = mesh.face_neighbor
    v_own = take(vel, own_i)
    v_nbr = take(vel, nbr_i)

    if scheme in (
        VelocityInterpolation.LINEAR,
        VelocityInterpolation.LINEAR_WEIGHTED,
    ):
        vf = _interior_scalar(
            mesh, v_own, v_nbr, scheme == VelocityInterpolation.LINEAR_WEIGHTED
        )
        interior = jnp.einsum("fi,fi->f", vf, n, precision="highest")
    elif scheme == VelocityInterpolation.RHIE_CHOW:
        if p is None or grad_p is None or mom_diag is None:
            raise ValueError("Rhie-Chow flux requires p, grad_p, mom_diag")
        a_i = jnp.linalg.norm(take(mom_diag, own_i) * n, axis=1)
        a_j = jnp.linalg.norm(take(mom_diag, nbr_i) * n, axis=1)
        voa_i = mesh.cell_volume[own_i] / a_i
        voa_j = mesh.cell_volume[nbr_i] / a_j
        r_ij = mesh.face_r_on  # owner -> neighbor centroid vector
        dist = mesh.face_dist_on
        term1 = jnp.einsum("fi,fi->f", v_own + v_nbr, n, precision="highest")
        term2 = (voa_i + voa_j) * (p[own_i] - p[nbr_i]) / dist
        gsum = voa_i[:, None] * take(grad_p, own_i) + voa_j[:, None] * take(grad_p, nbr_i)
        term3 = jnp.einsum("fi,fi->f", gsum, r_ij, precision="highest") / dist
        interior = 0.5 * (term1 + term2 + term3)
    else:
        raise NotImplementedError(f"velocity interpolation {scheme}")

    boundary_vn = jnp.where(
        fbc.is_(VELOCITY_INLET),
        jnp.einsum("fi,fi->f", fbc.vector, n, precision="highest"),
        jnp.einsum("fi,fi->f", v_own, n, precision="highest"),  # pressure inlet/outlet
    )
    return jnp.where(
        fbc.is_(WALL, SYMMETRY),
        0.0,
        jnp.where(fbc.is_(INTERIOR), interior, boundary_vn),
    )
