"""The remaining reference configurations, end-to-end:

- channel_flow.msh with pressure inlet/outlet + QUICK/UMIST limiters
  (config 3)
- mixed-cell 3x3_cube.msh exercising the padded variable-face-count
  path (config 4)
"""

import os

import numpy as np
import pytest

from orc_cfd.mesh import read_mesh
from orc_cfd.mesh.zones import FaceCondition
from orc_cfd.solver.simple import initial_state, solve_steady
from orc_cfd.utils.settings import (
    MatrixSolverSettings,
    MomentumScheme,
    NumericalSettings,
    PreconditionMethod,
    PressureInterpolation,
    SolutionMethod,
    VelocityInterpolation,
    tvd_quick,
    tvd_umist,
)

SOLVER = MatrixSolverSettings(
    solver_type=SolutionMethod.BICGSTAB,
    iterations=50,
    preconditioner=PreconditionMethod.JACOBI,
)


@pytest.mark.parametrize("psi", [tvd_quick, tvd_umist])
def test_channel_flow_mesh_tvd(reference_mesh_dir, psi):
    """channel_flow.msh (1008 cells, graded), dp/dx-driven, TVD
    limiters. Compare against the analytical Poiseuille bulk velocity
    (the duct is 2 mm x 1 mm like the couette fixture)."""
    mesh, table = read_mesh(
        os.path.join(reference_mesh_dir, "channel_flow.msh")
    )
    dp_dx, mu, rho = 5.0, 0.001, 1000.0
    table.set("WALL", FaceCondition.WALL)
    table.set("INLET", FaceCondition.PRESSURE_INLET, scalar_value=dp_dx * 0.002)
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    settings = NumericalSettings(
        momentum=MomentumScheme.TVD,
        tvd_psi=psi,
        pressure_interpolation=PressureInterpolation.SECOND_ORDER,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
        matrix_solver=SOLVER,
        pressure_relaxation=0.02,
    )
    state, _ = solve_steady(
        mesh, table, settings, rho, mu,
        state=initial_state(mesh), iterations=1200, reporting_interval=1200,
        verbose=False,
    )
    u = np.asarray(state.vel[:, 0])
    assert np.isfinite(u).all()
    h = 0.001
    u_mean_analytical = h**2 / (12 * mu) * dp_dx  # 4.167e-4 (flow in -x)
    assert abs(abs(u.mean()) - u_mean_analytical) / u_mean_analytical < 0.1, (
        u.mean(), u_mean_analytical
    )


def test_3x3_cube_solve(reference_mesh_dir):
    """Mixed-zone 3x3_cube.msh driven by a pressure drop
    (main.rs:287-343's configuration, with assertions)."""
    mesh, table = read_mesh(os.path.join(reference_mesh_dir, "3x3_cube.msh"))
    table.set("INLET", FaceCondition.PRESSURE_INLET, scalar_value=1.0)
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("PERIODIC_-Z", FaceCondition.WALL)
    table.set("PERIODIC_+Z", FaceCondition.WALL)
    # remaining zones (walls) keep their default WALL typing
    for fz in table.zones.values():
        if fz.zone_type not in (
            FaceCondition.INTERIOR,
            FaceCondition.PRESSURE_INLET,
            FaceCondition.PRESSURE_OUTLET,
        ):
            table.set(fz.name, FaceCondition.WALL)
    settings = NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
        matrix_solver=SOLVER,
        pressure_relaxation=0.05,
    )
    mu, rho = 100.0, 1000.0
    state, _ = solve_steady(
        mesh, table, settings, rho, mu,
        state=initial_state(mesh), iterations=600, reporting_interval=600,
        verbose=False,
    )
    vel = np.asarray(state.vel)
    p = np.asarray(state.p)
    assert np.isfinite(vel).all() and np.isfinite(p).all()

    # Quantitative checks (unit-cube square duct, Stokes regime):
    # 1. Global mass conservation: net inlet flux == net outlet flux.
    from orc_cfd.ops.fields import device_bc, face_bc
    from orc_cfd.ops.interpolation import face_flux

    zc, zs, zv = device_bc(table, dtype=mesh.dtype)
    fbc = face_bc(mesh, zc, zs, zv)
    fl = np.asarray(
        face_flux(mesh, fbc, state.vel, VelocityInterpolation.LINEAR_WEIGHTED)
    )
    zslot = np.asarray(mesh.face_zone_slot)
    area = np.asarray(mesh.face_area)

    def zone_flux(name):
        slot = table.slot_of_zone[table.zone_by_name(name).zone_id]
        sel = zslot == slot
        return float((fl[sel] * area[sel]).sum())

    q_in, q_out = zone_flux("INLET"), zone_flux("OUTLET")
    assert abs(q_in + q_out) < 1e-3 * abs(q_in), (q_in, q_out)

    # 2. Fully developed: per-layer mean streamwise velocity uniform
    # along x, and pressure monotone from inlet (x=1) to outlet (x=0).
    cc = np.asarray(mesh.cell_centroid)
    layers = [np.abs(cc[:, 0] - x) < 0.1 for x in (1 / 6, 0.5, 5 / 6)]
    u_layer = [vel[m, 0].mean() for m in layers]
    assert max(u_layer) - min(u_layer) < 1e-3 * abs(np.mean(u_layer)), u_layer
    p_layer = [p[m].mean() for m in layers]
    assert p_layer[0] < p_layer[1] < p_layer[2], p_layer

    # 3. Bulk velocity within 50% of the square-duct analytical solution
    # u_mean = 0.035144 dp a^2 / (mu L) — a coarse-mesh sanity band (3
    # cells across the duct overshoots by ~38%); cross-flow negligible.
    u_analytic = 0.035144 * 1.0 / mu
    u_mean = abs(vel[:, 0].mean())
    assert abs(u_mean - u_analytic) < 0.5 * u_analytic, (u_mean, u_analytic)
    assert np.abs(vel[:, 1:]).max() < 0.05 * u_mean


def test_square_duct_refined_matches_analytical():
    """The 3x3_cube duct physics one refinement level up (9^3 generated
    unit cube, same pressure-driven Stokes square duct): the bulk
    velocity must land within 15% of the series solution
    u_mean = 0.035144 dp a^2 / (mu L) — closing the coarse test's 50%
    band."""
    from orc_cfd.mesh import structured_box_mesh

    mesh, table = structured_box_mesh(9, 9, 9, lengths=(1.0, 1.0, 1.0))
    table.set("INLET", FaceCondition.PRESSURE_INLET, scalar_value=1.0)
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("TOP_WALL", FaceCondition.WALL)
    table.set("BOTTOM_WALL", FaceCondition.WALL)
    table.set("PERIODIC_-Z", FaceCondition.WALL)
    table.set("PERIODIC_+Z", FaceCondition.WALL)
    settings = NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
        matrix_solver=SOLVER,
        pressure_relaxation=0.05,
    )
    mu, rho = 100.0, 1000.0
    state, _ = solve_steady(
        mesh, table, settings, rho, mu,
        state=initial_state(mesh), iterations=800, reporting_interval=800,
        verbose=False,
    )
    vel = np.asarray(state.vel)
    assert np.isfinite(vel).all()
    u_analytic = 0.035144 * 1.0 / mu
    u_mean = abs(vel[:, 0].mean())
    assert abs(u_mean - u_analytic) < 0.15 * u_analytic, (u_mean, u_analytic)
