"""Node-based Green-Gauss gradients (the reference's NodeBased variant
panics, solver.rs:901; implemented here via IDW vertex interpolation,
mesh/nodes.py)."""

import numpy as np
import pytest

from orc_cfd.mesh import read_mesh
from orc_cfd.mesh.generate import write_tgrid
from orc_cfd.mesh.zones import FaceCondition
from orc_cfd.ops.fields import device_bc, face_bc
from orc_cfd.ops.gradients import pressure_gradient, velocity_gradient
from orc_cfd.utils.settings import GradientReconstruction

GG_NODE = GradientReconstruction.GREEN_GAUSS_NODE


def _load_box(tmp_path, nx, ny, nz, lengths):
    msh = tmp_path / "box.msh"
    write_tgrid(str(msh), nx, ny, nz, lengths=lengths)
    return read_mesh(str(msh), nodes=True)


def test_node_gg_exact_linear_interior(tmp_path):
    """On a uniform box the vertex stencil is symmetric, so IDW vertex
    values are exact for linear fields -> fully-interior cells
    reproduce the gradient of a linear field exactly."""
    import jax.numpy as jnp

    mesh, table = _load_box(tmp_path, 5, 4, 3, lengths=(5.0, 2.0, 1.5))
    zc, zs, zv = device_bc(table, dtype=mesh.dtype)
    fbc = face_bc(mesh, zc, zs, zv)
    cc = np.asarray(mesh.cell_centroid)
    g_true = np.array([0.7, -1.3, 2.1])
    p = jnp.asarray(cc @ g_true)
    grad = np.asarray(pressure_gradient(mesh, fbc, p, GG_NODE))
    # Fully-interior cells: every face interior.
    fint = np.asarray(mesh.face_interior)[np.asarray(mesh.cell_faces)]
    fint |= ~np.asarray(mesh.cell_face_mask)
    inner = fint.all(axis=1)
    assert inner.sum() >= 6
    np.testing.assert_allclose(
        grad[inner],
        np.tile(g_true, (int(inner.sum()), 1)),
        rtol=1e-10,
        atol=1e-12,
    )

    # Vector field: component i = linear with gradient row G[i].
    G = np.array([[0.5, 0.0, -0.25], [1.0, 2.0, 3.0], [0.0, -1.0, 0.5]])
    vel = jnp.asarray(cc @ G.T)
    gv = np.asarray(velocity_gradient(mesh, fbc, vel, GG_NODE))
    np.testing.assert_allclose(
        gv[inner], np.broadcast_to(G, (int(inner.sum()), 3, 3)),
        rtol=1e-10, atol=1e-12,
    )


def test_node_gg_requires_vertex_tables(tmp_path):
    import jax.numpy as jnp

    msh = tmp_path / "plain.msh"
    write_tgrid(str(msh), 3, 3, 1)
    mesh, table = read_mesh(str(msh))  # nodes=False
    zc, zs, zv = device_bc(table, dtype=mesh.dtype)
    fbc = face_bc(mesh, zc, zs, zv)
    with pytest.raises(ValueError, match="nodes=True"):
        pressure_gradient(
            mesh, fbc, jnp.zeros(mesh.n_cells, mesh.dtype), GG_NODE
        )


def test_node_gg_channel_flow_e2e(tmp_path):
    """Poiseuille with node-based gradients end-to-end (forces the
    face-major path: the ck-direct step only does GG-cell)."""
    from orc_cfd.solver.simple import initial_state, solve_steady
    from orc_cfd.utils.settings import (
        MatrixSolverSettings,
        MomentumScheme,
        NumericalSettings,
        PreconditionMethod,
        PressureInterpolation,
        SolutionMethod,
        VelocityInterpolation,
    )

    mesh, table = _load_box(tmp_path, 16, 12, 1, lengths=(0.002, 0.001, 0.0001))
    dp_dx = 5.0
    table.set("TOP_WALL", FaceCondition.WALL)
    table.set("BOTTOM_WALL", FaceCondition.WALL)
    table.set("INLET", FaceCondition.PRESSURE_INLET, scalar_value=dp_dx * 0.002)
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    settings = NumericalSettings(
        momentum=MomentumScheme.CD1,
        pressure_interpolation=PressureInterpolation.SECOND_ORDER,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
        gradient_reconstruction=GG_NODE,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB,
            iterations=50,
            preconditioner=PreconditionMethod.JACOBI,
        ),
        pressure_relaxation=0.02,
    )
    state, _ = solve_steady(
        mesh, table, settings, rho=1000.0, mu=0.001,
        state=initial_state(mesh), iterations=1500,
        reporting_interval=1500, verbose=False,
    )
    u = np.asarray(state.vel[:, 0])
    assert np.isfinite(u).all()
    u_mean_analytical = 0.001**2 / (12 * 0.001) * dp_dx
    assert abs(abs(u.mean()) - u_mean_analytical) / u_mean_analytical < 0.05, (
        u.mean(), u_mean_analytical,
    )


def test_use_ck_true_rejects_node_gradients(tmp_path):
    from orc_cfd.solver.simple import initial_state, solve_steady
    from orc_cfd.utils.settings import NumericalSettings

    mesh, table = _load_box(tmp_path, 4, 4, 1, lengths=(1.0, 1.0, 0.1))
    settings = NumericalSettings(gradient_reconstruction=GG_NODE)
    with pytest.raises(ValueError, match="green_gauss_cell"):
        solve_steady(
            mesh, table, settings, 1000.0, 0.001,
            state=initial_state(mesh), iterations=1, use_ck=True,
            verbose=False,
        )
