"""2D mesh end-to-end: pressure-driven duct on the reference's 2D_3x6
fixture (the reference's dormant test_2d case, main.rs:128-189)."""

import os

import numpy as np
import pytest

from orc_cfd.mesh import read_mesh
from orc_cfd.mesh.zones import FaceCondition
from orc_cfd.solver.init_fields import initialize_flow
from orc_cfd.solver.simple import solve_steady
from orc_cfd.utils.settings import (
    MatrixSolverSettings,
    MomentumScheme,
    NumericalSettings,
    PreconditionMethod,
    PressureInterpolation,
    SolutionMethod,
    VelocityInterpolation,
)


def test_2d_duct(reference_mesh_dir):
    mesh, table = read_mesh(os.path.join(reference_mesh_dir, "2D_3x6.msh"))
    assert mesh.dim == 2
    table.set("INLET", FaceCondition.PRESSURE_INLET, scalar_value=100.0)
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("TOP", FaceCondition.WALL)
    table.set("BOTTOM", FaceCondition.WALL)
    settings = NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB,
            iterations=40,
            preconditioner=PreconditionMethod.JACOBI,
        ),
        pressure_relaxation=0.05,
        momentum_relaxation=0.7,
    )
    rho, mu = 1000.0, 10.0  # viscous so it settles quickly
    state = initialize_flow(mesh, table, mu, rho)
    state, _ = solve_steady(
        mesh,
        table,
        settings,
        rho,
        mu,
        state=state,
        iterations=400,
        reporting_interval=400,
        verbose=False,
    )
    u = np.asarray(state.vel[:, 0])
    # Flow goes +x (high pressure at inlet), is finite and symmetric-ish
    # across the channel.
    assert np.isfinite(u).all()
    assert u.mean() > 0, u.mean()
    v = np.asarray(state.vel[:, 1])
    assert np.abs(v).max() < 0.5 * np.abs(u).max()
