"""Cell-gradient reconstruction ops.

Green-Gauss (cell-based) and least-squares gradients as vectorized
[C,K]-gather reductions (reference: solver.rs:772-950). Gradients are
computed once per cell per outer iteration and reused everywhere (the
reference recomputes them per face inside flux/interpolation calls).

Least-squares here differs deliberately from the reference in two ways:
- boundary rows use the *difference* (phi_face - phi_cell), where the
  reference uses the absolute boundary value (solver.rs:830-845) — a
  bug that skews boundary-cell gradients;
- 2D meshes drop the z column statically instead of runtime
  zero-column pruning (solver.rs:648-654).
"""

from __future__ import annotations

import jax.numpy as jnp

from orc_cfd.mesh.compile import CompiledMesh
from orc_cfd.ops.fields import (
    PRESSURE_INLET,
    PRESSURE_OUTLET,
    FaceBC,
)
from orc_cfd.ops.interpolation import face_pressure, face_velocity
from orc_cfd.ops.layout import take
from orc_cfd.utils.settings import (
    GradientReconstruction,
    PressureInterpolation,
    VelocityInterpolation,
)


def _green_gauss(mesh: CompiledMesh, face_vals):
    """sum_f phi_f * n_out * A / V over each cell's faces.

    face_vals: [F] -> returns [C,3];  [F,3] -> returns [C,3,3] with
    row i = gradient of component i.
    """
    cf = mesh.cell_faces
    w = (
        mesh.cell_face_sign
        * take(mesh.face_area, cf)
        / mesh.cell_volume[:, None]
    )  # [C,K] signed area / volume (0 at padded slots)
    n = take(mesh.face_normal, cf)  # [C,K,3]
    phi = take(face_vals, cf)
    if phi.ndim == 2:  # scalar field
        return jnp.einsum("ck,cki->ci", w * phi, n, precision="highest")
    # vector field: outer(phi_f, n) summed -> [C,3,3]
    return jnp.einsum("ck,cki,ckj->cij", w, phi, n, precision="highest")


def _least_squares(mesh: CompiledMesh, d, b):
    """Solve per-cell normal equations (A^T A) g = A^T b.

    d: [C,K,3] displacement rows, b: [C,K] or [C,K,3] value deltas,
    masked rows must already be zeroed. Returns [C,3] or [C,3,3]
    (row i = gradient of component i).
    """
    dim = mesh.dim
    dd = d[..., :dim]
    ata = jnp.einsum("cka,ckb->cab", dd, dd, precision="highest")  # [C,dim,dim]
    if b.ndim == 2:
        atb = jnp.einsum("cka,ck->ca", dd, b, precision="highest")
        g = jnp.linalg.solve(ata, atb[..., None])[..., 0]
        if dim == 2:
            g = jnp.pad(g, ((0, 0), (0, 1)))
        return g
    atb = jnp.einsum("cka,cki->cia", dd, b, precision="highest")  # [C,3,dim]
    g = jnp.linalg.solve(ata[:, None], atb[..., None])[..., 0]  # [C,3,dim]
    if dim == 2:
        g = jnp.pad(g, ((0, 0), (0, 0), (0, 1)))
    return g


def _ls_rows(mesh: CompiledMesh):
    """Displacement rows for least squares: interior -> neighbor
    centroid delta; boundary -> face centroid delta; padded -> 0."""
    cf = mesh.cell_faces
    interior = take(mesh.face_interior, cf) & mesh.cell_face_mask
    # Cell->neighbor displacement via the stored owner->neighbor vector
    # (sign-flipped on neighbor-side rows); periodic wraps thereby see
    # the neighbor's translated image.
    d_int = mesh.cell_face_sign[..., None] * take(mesh.face_r_on, cf)
    d_bnd = take(mesh.face_centroid, cf) - mesh.cell_centroid[:, None, :]
    d = jnp.where(interior[..., None], d_int, d_bnd)
    return jnp.where(mesh.cell_face_mask[..., None], d, 0.0), interior


def _node_face_values(mesh: CompiledMesh, phi, phi_f_bc):
    """Vertex-interpolated face values for node-based Green-Gauss.

    Interior faces average the IDW vertex values (mesh/nodes.py);
    boundary faces keep the BC-aware face value `phi_f_bc` (vertex
    averages at boundaries would ignore the BC data). The reference's
    NodeBased variant panics (solver.rs:901); this implements it.
    """
    if mesh.nodes is None:
        raise ValueError(
            "node-based Green-Gauss needs vertex tables: load the mesh "
            "with read_mesh(..., nodes=True) / compile_mesh(..., "
            "nodes=True)"
        )
    from orc_cfd.mesh.nodes import node_face_values

    pf_node = node_face_values(mesh.nodes, phi)
    interior = mesh.face_interior
    if phi_f_bc.ndim == 2:
        interior = interior[:, None]
    return jnp.where(interior, pf_node, phi_f_bc)


def pressure_gradient(
    mesh: CompiledMesh,
    fbc: FaceBC,
    p,
    scheme: GradientReconstruction = GradientReconstruction.GREEN_GAUSS_CELL,
):
    """grad p per cell [C,3] (reference: solver.rs:874-950).

    Green-Gauss uses Linear face pressures, as the reference hardcodes
    (solver.rs:893)."""
    if scheme == GradientReconstruction.GREEN_GAUSS_CELL:
        pf = face_pressure(mesh, fbc, p, PressureInterpolation.LINEAR)
        return _green_gauss(mesh, pf)
    if scheme == GradientReconstruction.GREEN_GAUSS_NODE:
        pf = face_pressure(mesh, fbc, p, PressureInterpolation.LINEAR)
        return _green_gauss(mesh, _node_face_values(mesh, p, pf))
    if scheme == GradientReconstruction.LEAST_SQUARES:
        d, interior = _ls_rows(mesh)
        cf = mesh.cell_faces
        p_own = p[:, None]
        # boundary face value: zone pressure at pressure BCs, cell value
        # otherwise (zero delta).
        code, scalar_ck, _ = fbc.ck(mesh)
        is_pbc = (code == PRESSURE_INLET) | (code == PRESSURE_OUTLET)
        pf_bnd = jnp.where(is_pbc, scalar_ck, p_own)
        b = jnp.where(interior, take(p, mesh.cell_neighbors) - p_own, pf_bnd - p_own)
        b = jnp.where(mesh.cell_face_mask, b, 0.0)
        return _least_squares(mesh, d, b)
    raise NotImplementedError(f"gradient scheme {scheme}")


def velocity_gradient(
    mesh: CompiledMesh,
    fbc: FaceBC,
    vel,
    scheme: GradientReconstruction = GradientReconstruction.GREEN_GAUSS_CELL,
):
    """grad of (u,v,w) per cell [C,3,3], row i = grad of component i
    (reference: solver.rs:774-872). Green-Gauss uses Linear face
    velocities as the reference does (solver.rs:796)."""
    if scheme == GradientReconstruction.GREEN_GAUSS_CELL:
        vf = face_velocity(mesh, fbc, vel, VelocityInterpolation.LINEAR)
        return _green_gauss(mesh, vf)
    if scheme == GradientReconstruction.GREEN_GAUSS_NODE:
        vf = face_velocity(mesh, fbc, vel, VelocityInterpolation.LINEAR)
        return _green_gauss(mesh, _node_face_values(mesh, vel, vf))
    if scheme == GradientReconstruction.LEAST_SQUARES:
        d, interior = _ls_rows(mesh)
        cf = mesh.cell_faces
        v_own = vel[:, None, :]  # [C,1,3]
        vf = face_velocity(mesh, fbc, vel, VelocityInterpolation.LINEAR)
        b = jnp.where(
            interior[..., None],
            take(vel, mesh.cell_neighbors) - v_own,
            take(vf, cf) - v_own,
        )
        b = jnp.where(mesh.cell_face_mask[..., None], b, 0.0)
        return _least_squares(mesh, d, b)
    raise NotImplementedError(f"gradient scheme {scheme}")
