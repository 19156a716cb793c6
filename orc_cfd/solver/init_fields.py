"""Field initialization: Laplace pressure + potential-flow velocity.

Re-design of the reference's `initialize_flow_new` (solver.rs:354-696):
classify the boundary conditions, then

- pressure-constrained systems: solve the Laplace equation for p with
  Dirichlet values at pressure boundaries and zero normal gradient at
  walls/symmetry (solver.rs:414-509);
- velocity-constrained systems: solve a potential-flow psi system with
  flux sources at velocity inlets and psi = 0 at pressure outlets
  (solver.rs:511-601), then recover the velocity as the least-squares
  gradient of psi over interior neighbors (solver.rs:619-693);
- hybrid systems run BOTH (the reference's match statement can only
  reach the pressure arm for Hybrid, solver.rs:398-406 — a quirk, not
  behavior worth keeping).

Also provides `initialize_flow_ramp`, the reference's older
diffusion-ramp strategy (solver.rs:246-352).

The discrete Laplacian uses the reference's elementwise-reciprocal
coefficient recip(x_c - x_nb) . n_out * (A/V) (solver.rs:456-462); note
we apply the same A/V scaling to the pressure-outlet term of the psi
system, which the reference omits (solver.rs:563-571).
"""

from __future__ import annotations

import enum

import jax.numpy as jnp
import numpy as np

from orc_cfd.mesh.compile import CompiledMesh
from orc_cfd.mesh.zones import BoundaryTable, FaceCondition
from orc_cfd.ops.layout import take
from orc_cfd.ops.fields import (
    PRESSURE_INLET,
    PRESSURE_OUTLET,
    SYMMETRY,
    VELOCITY_INLET,
    WALL,
    device_bc,
    face_bc,
)
from orc_cfd.ops.spmv import EllMatrix
from orc_cfd.solver.krylov import iterative_solve
from orc_cfd.solver.simple import FlowState
from orc_cfd.utils.settings import (
    MatrixSolverSettings,
    PreconditionMethod,
    SolutionMethod,
)


class SystemConstraint(enum.Enum):
    PRESSURE_ONLY = "pressure_only"
    VELOCITY_ONLY = "velocity_only"
    HYBRID = "hybrid"
    # Body-force-driven periodic systems: no pressure or velocity BC
    # constrains the fields (flow is driven by a momentum source through
    # periodic wraps). Init falls back to zeros.
    UNCONSTRAINED = "unconstrained"


def check_boundary_conditions(
    mesh: CompiledMesh, table: BoundaryTable, angle_tol_deg: float = 5.0
) -> SystemConstraint:
    """Validate BC geometry and classify the system
    (reference: solver.rs:703-770 — with the angle tolerance actually in
    radians, fixing the degrees/radians inversion at solver.rs:711-713
    that made the reference's checks unreachable)."""
    normals = np.asarray(mesh.face_normal)
    zone_slot = np.asarray(mesh.face_zone_slot)
    tol = np.sin(np.deg2rad(angle_tol_deg))

    pressure_bcs = 0
    velocity_bcs = 0
    for zid, fz in table.zones.items():
        slot = table.slot_of_zone[zid]
        faces = zone_slot == slot
        v = np.asarray(fz.vector_value)
        vnorm = np.linalg.norm(v)
        if fz.zone_type == FaceCondition.WALL and vnorm > 0:
            velocity_bcs += 1
            cosines = np.abs(normals[faces] @ (v / vnorm))
            if (cosines > tol).any():
                raise ValueError(
                    f"wall velocity must be tangent to zone '{fz.name}' "
                    f"faces (max |cos| = {cosines.max():.3f})"
                )
        elif fz.zone_type == FaceCondition.VELOCITY_INLET:
            velocity_bcs += 1
            if vnorm == 0:
                raise ValueError(
                    f"velocity inlet zone '{fz.name}' has zero velocity"
                )
            cosines = np.abs(normals[faces] @ (v / vnorm))
            if (cosines < np.cos(np.deg2rad(angle_tol_deg))).any():
                raise ValueError(
                    f"velocity-inlet velocity must be face-normal in zone "
                    f"'{fz.name}' (min |cos| = {cosines.min():.3f})"
                )
        elif fz.zone_type in (
            FaceCondition.PRESSURE_INLET,
            FaceCondition.PRESSURE_OUTLET,
        ):
            pressure_bcs += 1

    if velocity_bcs > 0:
        if pressure_bcs > 1:
            return SystemConstraint.HYBRID
        return SystemConstraint.VELOCITY_ONLY
    if pressure_bcs > 0:
        return SystemConstraint.PRESSURE_ONLY
    if _has_periodic(table):
        return SystemConstraint.UNCONSTRAINED
    raise ValueError("you must set boundary conditions")


def _has_periodic(table: BoundaryTable) -> bool:
    return any(
        fz.zone_type
        in (FaceCondition.PERIODIC, FaceCondition.PERIODIC_SHADOW)
        for fz in table.zones.values()
    )


def _reciprocal(v):
    """Elementwise reciprocal with 0 -> 0 (reference: lib.rs:246-252)."""
    return jnp.where(v != 0.0, 1.0 / jnp.where(v == 0.0, 1.0, v), 0.0)


def _laplace_coeffs(mesh: CompiledMesh):
    """Per-(c,k) interior Laplacian coefficient and boundary-face
    variant (reference: solver.rs:456-472)."""
    cf = mesh.cell_faces
    n_out = mesh.cell_face_sign[..., None] * take(mesh.face_normal, cf)
    av = take(mesh.face_area, cf) / mesh.cell_volume[:, None]
    x_c = mesh.cell_centroid[:, None, :]
    # x_c - x_nbr from the stored owner->neighbor vectors (periodic
    # wraps see the neighbor's translated image).
    d_int = -mesh.cell_face_sign[..., None] * take(mesh.face_r_on, cf)
    d_bnd = x_c - take(mesh.face_centroid, cf)
    a_int = jnp.einsum("cki,cki->ck", _reciprocal(d_int), n_out, precision="highest") * av
    a_bnd = jnp.einsum("cki,cki->ck", _reciprocal(d_bnd), n_out, precision="highest") * av
    return a_int, a_bnd


_INIT_SOLVER_P = MatrixSolverSettings(
    solver_type=SolutionMethod.JACOBI,
    iterations=10,
    relaxation=0.1,
    relative_convergence_threshold=1e-6,
    preconditioner=PreconditionMethod.JACOBI,
)
_INIT_SOLVER_PSI = MatrixSolverSettings(
    solver_type=SolutionMethod.BICGSTAB,
    iterations=10,
    relaxation=0.1,
    relative_convergence_threshold=1e-6,
    preconditioner=PreconditionMethod.JACOBI,
)


def initialize_pressure_field(mesh: CompiledMesh, table: BoundaryTable):
    """Solve Laplace(p) = 0 with Dirichlet pressure BCs
    (reference: solver.rs:414-509, 10 Jacobi iterations)."""
    zc, zs, zv = device_bc(table, mesh.dtype)
    fbc = face_bc(mesh, zc, zs, zv)
    cf, m = mesh.cell_faces, mesh.cell_face_mask
    code, bc_scalar, _ = fbc.ck(mesh)
    interior = take(mesh.face_interior, cf) & m
    a_int, a_bnd = _laplace_coeffs(mesh)

    is_pbc = ((code == PRESSURE_INLET) | (code == PRESSURE_OUTLET)) & m
    a = jnp.where(interior, a_int, jnp.where(is_pbc, a_bnd, 0.0))
    b = jnp.sum(jnp.where(is_pbc, a_bnd * bc_scalar, 0.0), axis=1)
    A = EllMatrix(
        diag=jnp.sum(a, axis=1),
        off=jnp.where(interior, -a_int, 0.0),
        neighbors=mesh.cell_neighbors,
        offsets=mesh.neighbor_offsets,
        plan=mesh.slice_plan,
    )
    p, _ = iterative_solve(A, b, jnp.zeros_like(b), _INIT_SOLVER_P)
    return p


def initialize_velocity_field(mesh: CompiledMesh, table: BoundaryTable):
    """Potential-flow velocity init (reference: solver.rs:511-696):
    solve the psi system, then u = least-squares grad(psi) over interior
    neighbors."""
    zc, zs, zv = device_bc(table, mesh.dtype)
    fbc = face_bc(mesh, zc, zs, zv)
    cf, m = mesh.cell_faces, mesh.cell_face_mask
    code, _, bc_vec = fbc.ck(mesh)
    interior = take(mesh.face_interior, cf) & m
    a_int, a_bnd = _laplace_coeffs(mesh)
    n_out = mesh.cell_face_sign[..., None] * take(mesh.face_normal, cf)

    is_vin = (code == VELOCITY_INLET) & m
    is_pout = (code == PRESSURE_OUTLET) & m
    a = jnp.where(interior, a_int, jnp.where(is_pout, a_bnd, 0.0))
    # Inlet source: known boundary-normal gradient of psi, scaled by
    # A/V like every other term (the reference omits the scaling,
    # solver.rs:551-557, making the system dimensionally inconsistent).
    av = take(mesh.face_area, cf) / mesh.cell_volume[:, None]
    src = jnp.where(
        is_vin,
        -jnp.einsum("cki,cki->ck", bc_vec, n_out, precision="highest") * av,
        0.0,
    )
    b = jnp.sum(src, axis=1)
    A = EllMatrix(
        diag=jnp.sum(a, axis=1),
        off=jnp.where(interior, -a_int, 0.0),
        neighbors=mesh.cell_neighbors,
        offsets=mesh.neighbor_offsets,
        plan=mesh.slice_plan,
    )
    psi, _ = iterative_solve(A, b, jnp.zeros_like(b), _INIT_SOLVER_PSI)

    # Least-squares grad(psi) using interior neighbors only
    # (solver.rs:619-693), dropping the z column for 2D meshes instead
    # of runtime zero-column pruning.
    d = jnp.where(
        interior[..., None],
        mesh.cell_face_sign[..., None] * take(mesh.face_r_on, cf),
        0.0,
    )
    dpsi = jnp.where(interior, take(psi, mesh.cell_neighbors) - psi[:, None], 0.0)
    dim = mesh.dim
    dd = d[..., :dim]
    ata = jnp.einsum("cka,ckb->cab", dd, dd, precision="highest")
    atb = jnp.einsum("cka,ck->ca", dd, dpsi, precision="highest")
    # Ridge-regularize instead of hard-zeroing singular systems: cells
    # whose interior neighbors don't span all `dim` directions (e.g.
    # one-cell-thick 3D meshes have no z variation) still recover the
    # gradient components that ARE spanned, with ~0 in null directions.
    # (The reference prunes zero columns at runtime and zeroes the rest,
    # solver.rs:648-693.)
    tr = jnp.trace(ata, axis1=-2, axis2=-1)
    eye = jnp.eye(dim, dtype=ata.dtype)
    reg = (1e-10 * tr + 1e-300)[:, None, None] * eye
    g = jnp.linalg.solve(ata + reg, atb[..., None])[..., 0]
    g = jnp.nan_to_num(g)
    if dim == 2:
        g = jnp.pad(g, ((0, 0), (0, 1)))
    vel = g
    return vel, psi


def initialize_flow(
    mesh: CompiledMesh,
    table: BoundaryTable,
    mu: float,
    rho: float,
    validate: bool = True,
) -> FlowState:
    """BC-aware field initialization (reference: solver.rs:354-410,
    with Hybrid doing both arms)."""
    constraint = (
        check_boundary_conditions(mesh, table)
        if validate
        else _classify_only(table)
    )
    C = mesh.n_cells
    p = jnp.zeros((C,), mesh.dtype)
    vel = jnp.zeros((C, 3), mesh.dtype)
    if constraint in (SystemConstraint.PRESSURE_ONLY, SystemConstraint.HYBRID):
        p = initialize_pressure_field(mesh, table)
    if constraint in (SystemConstraint.VELOCITY_ONLY, SystemConstraint.HYBRID):
        vel, _ = initialize_velocity_field(mesh, table)
    return FlowState(vel=vel, p=p, mom_diag=jnp.ones((3, C), mesh.dtype))


def _classify_only(table: BoundaryTable) -> SystemConstraint:
    p = sum(
        fz.zone_type
        in (FaceCondition.PRESSURE_INLET, FaceCondition.PRESSURE_OUTLET)
        for fz in table.zones.values()
    )
    v = sum(
        fz.zone_type == FaceCondition.VELOCITY_INLET
        or (
            fz.zone_type == FaceCondition.WALL
            and np.linalg.norm(fz.vector_value) > 0
        )
        for fz in table.zones.values()
    )
    if v > 0:
        return (
            SystemConstraint.HYBRID if p > 1 else SystemConstraint.VELOCITY_ONLY
        )
    if p > 0:
        return SystemConstraint.PRESSURE_ONLY
    if _has_periodic(table):
        return SystemConstraint.UNCONSTRAINED
    raise ValueError("you must set boundary conditions")


def initialize_flow_ramp(
    mesh: CompiledMesh,
    table: BoundaryTable,
    mu: float,
    rho: float,
    iterations: int = 200,
) -> FlowState:
    """The reference's older strategy (solver.rs:246-352): initialize
    pressure, assemble a UD advection system at zero velocity, then
    solve momentum with the matrix blended from pure diffusion to
    advection+diffusion in steps of 0.2."""
    from orc_cfd.ops.assembly import diffusion_system, momentum_system
    from orc_cfd.ops.interpolation import face_flux, face_pressure
    from orc_cfd.utils.settings import (
        MomentumScheme,
        NumericalSettings,
        PressureInterpolation,
        VelocityInterpolation,
    )

    zc, zs, zv = device_bc(table, mesh.dtype)
    fbc = face_bc(mesh, zc, zs, zv)
    C = mesh.n_cells
    p = initialize_pressure_field(mesh, table)
    vel = jnp.zeros((C, 3), mesh.dtype)
    diff = diffusion_system(mesh, fbc, jnp.asarray(mu, mesh.dtype))
    settings = NumericalSettings(
        momentum=MomentumScheme.UD,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
    )
    flux = face_flux(mesh, fbc, vel, VelocityInterpolation.LINEAR_WEIGHTED)
    p_f = face_pressure(mesh, fbc, p, PressureInterpolation.LINEAR_WEIGHTED)
    A3, b3, _ = momentum_system(
        mesh, fbc, settings, rho, vel, flux, p_f, diff
    )
    solver = MatrixSolverSettings(
        solver_type=SolutionMethod.BICGSTAB,
        iterations=iterations,
        relaxation=0.5,
        relative_convergence_threshold=1e-6,
        preconditioner=PreconditionMethod.JACOBI,
    )
    sol = jnp.moveaxis(vel, -1, 0)
    for f in np.arange(1.0, -0.1, -0.2):
        # UD assembly returns the shared-matrix form ([C]/[C,K]).
        blend_diag = (1.0 - f) * A3.diag + f * diff.diag
        blend_off = (1.0 - f) * A3.off + f * diff.off

        def solve_one(bb, x0):
            Ai = EllMatrix(
                diag=blend_diag, off=blend_off, neighbors=A3.neighbors,
                offsets=A3.offsets, plan=A3.plan,
            )
            x, _ = iterative_solve(Ai, bb, x0, solver)
            return x

        import jax

        sol = jax.vmap(solve_one)(b3, sol)
    return FlowState(
        vel=jnp.moveaxis(sol, 0, -1), p=p, mom_diag=jnp.ones((3, C), mesh.dtype)
    )
