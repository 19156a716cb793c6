"""Transient solver validation: impulsively-started Couette flow
(Stokes' problem between plates) against the analytical series
solution — the "transient iteration" capability the reference's roadmap
leaves unchecked (README.md:42)."""

import numpy as np
import pytest

from orc_cfd.mesh import structured_box_mesh
from orc_cfd.mesh.zones import FaceCondition
from orc_cfd.solver.simple import initial_state
from orc_cfd.solver.transient import solve_transient
from orc_cfd.utils.settings import (
    MatrixSolverSettings,
    MomentumScheme,
    NumericalSettings,
    PreconditionMethod,
    PressureInterpolation,
    SolutionMethod,
    VelocityInterpolation,
)

H = 1e-3  # channel height [m]
U = 1e-3  # wall velocity [m/s]
RHO, MU = 1000.0, 0.001
NU = MU / RHO


def couette_startup_analytical(y, t, n_terms=200):
    """u(y,t) for the top wall impulsively started at t=0."""
    u = y / H
    for n in range(1, n_terms + 1):
        u = u + (2.0 * (-1) ** n / (n * np.pi)) * np.exp(
            -(n**2) * np.pi**2 * NU * t / H**2
        ) * np.sin(n * np.pi * y / H)
    return U * u


def test_couette_startup():
    ny = 16
    mesh, table = structured_box_mesh(
        4, ny, 1, lengths=(4e-4, H, 1e-4)
    )
    table.set("TOP_WALL", FaceCondition.WALL, vector_value=(U, 0, 0))
    table.set("BOTTOM_WALL", FaceCondition.WALL)
    table.set("INLET", FaceCondition.PRESSURE_INLET, scalar_value=0.0)
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    settings = NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB,
            iterations=40,
            preconditioner=PreconditionMethod.JACOBI,
        ),
        momentum_relaxation=0.8,
        pressure_relaxation=0.2,
    )
    t_end = 0.1  # Fourier number 0.1 — profile still developing
    n_steps = 20
    state, metrics = solve_transient(
        mesh,
        table,
        settings,
        RHO,
        MU,
        dt=t_end / n_steps,
        n_steps=n_steps,
        inner_iterations=15,
        verbose=False,
    )
    cc = np.asarray(mesh.cell_centroid)
    u = np.asarray(state.vel[:, 0])
    # Take the centre x-column.
    col = np.abs(cc[:, 0] - 2e-4) < 1.1e-4 / 2 + 1e-9
    col = np.abs(cc[:, 0] - cc[:, 0].mean()) < 6e-5
    y = cc[col, 1]
    u_num = u[col]
    u_ana = couette_startup_analytical(y, t_end)
    # The developing profile must clearly differ from steady state...
    u_steady = U * y / H
    assert np.abs(u_ana - u_steady).max() > 0.2 * U
    # ...and the numerical solution must track the analytical one.
    err = np.abs(u_num - u_ana).max() / U
    assert err < 0.06, (err, list(zip(y, u_num, u_ana)))
    # March much further: must approach the steady linear profile
    # (tolerance covers the pressure-BC entrance effect at this short
    # channel plus per-step convergence residue).
    state2, _ = solve_transient(
        mesh, table, settings, RHO, MU,
        dt=0.1, n_steps=30, inner_iterations=20, state=state, verbose=False,
    )
    u2 = np.asarray(state2.vel[:, 0])[col]
    assert np.abs(u2 - u_steady).max() / U < 0.1


def test_transient_metrics_shape():
    mesh, table = structured_box_mesh(4, 4, 1, lengths=(1e-3, 1e-3, 1e-4))
    table.set("TOP_WALL", FaceCondition.WALL, vector_value=(1e-3, 0, 0))
    table.set("BOTTOM_WALL", FaceCondition.WALL)
    table.set("INLET", FaceCondition.PRESSURE_INLET)
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    settings = NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB, iterations=20
        ),
    )
    state, metrics = solve_transient(
        mesh, table, settings, RHO, MU, dt=0.01, n_steps=5,
        inner_iterations=4, verbose=False,
    )
    assert metrics.vel_avg.shape == (5, 3)
    assert np.isfinite(np.asarray(state.vel)).all()


def test_courant_numbers():
    """Co = dt * sum|u.n|A / (2V): uniform u through a unit-cell box
    gives Co = dt*|u|/h exactly (two crossed faces per direction)."""
    import jax.numpy as jnp

    from orc_cfd.solver.transient import courant_numbers

    mesh, table = structured_box_mesh(4, 4, 1, lengths=(4.0, 4.0, 1.0))
    u0, dt = 2.0, 0.25
    # Through-flow BCs so every cell sees both its x-faces fluxed
    # (walls zero the face flux, which is correct but makes the
    # expected value cell-position-dependent).
    table.set("INLET", FaceCondition.VELOCITY_INLET, vector_value=(u0, 0, 0))
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET)
    vel = jnp.tile(jnp.asarray([u0, 0.0, 0.0]), (mesh.n_cells, 1))
    avg, lo, hi = courant_numbers(mesh, table, vel, dt)
    # h = 1, |u| = 2, dt = 0.25 -> Co = 0.5 in every cell.
    np.testing.assert_allclose(float(avg), 0.5, rtol=1e-12)
    np.testing.assert_allclose(float(lo), 0.5, rtol=1e-12)
    np.testing.assert_allclose(float(hi), 0.5, rtol=1e-12)


def test_taylor_green_vortex_decay():
    """2D Taylor-Green vortex in a fully periodic box: the one exact
    UNSTEADY nonlinear Navier-Stokes solution (convection and pressure
    balance pointwise; each velocity component decays as e^(-2 nu t)).
    Validates transient marching + periodic wrap faces + pressure
    coupling together — none of the channel-flow validations exercise
    the nonlinear terms against an exact transient answer.

    Also pins the single-cell-axis SYMMETRY default (mesh/generate
    _box_zone_table): with the old z-wall default this decays ~3x too
    fast (parasitic 4 nu / Lz^2 drag) and the assertions below fail.
    """
    import dataclasses

    import jax.numpy as jnp

    from orc_cfd.utils.settings import (
        NumericalSettings as NS,
        RelaxationMode,
    )
    from orc_cfd.mesh import structured_box_mesh

    N = 32
    rho, mu = 1.0, 0.02  # nu = 0.02
    nu = mu / rho
    mesh, table = structured_box_mesh(
        N, N, 1, lengths=(2 * np.pi, 2 * np.pi, 1.0),
        periodic=("x", "y"), dtype=jnp.float64,
    )
    cc = np.asarray(mesh.cell_centroid)
    x, y = cc[:, 0], cc[:, 1]
    u0 = np.sin(x) * np.cos(y)
    v0 = -np.cos(x) * np.sin(y)
    p0 = rho / 4.0 * (np.cos(2 * x) + np.cos(2 * y))
    st = initial_state(mesh)
    st = dataclasses.replace(
        st,
        vel=jnp.asarray(np.stack([u0, v0, np.zeros_like(u0)], -1)),
        p=jnp.asarray(p0),
    )
    settings = NS(
        momentum=MomentumScheme.CD1,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
        pressure_relaxation=0.3,
        momentum_relaxation=0.7,
        relaxation_mode=RelaxationMode.IMPLICIT,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB,
            iterations=50,
            preconditioner=PreconditionMethod.JACOBI,
        ),
    )
    dt, nsteps = 0.05, 20  # t = 1.0
    st, _ = solve_transient(
        mesh, table, settings, rho, mu, dt, nsteps,
        inner_iterations=10, state=st, verbose=False,
    )
    t = dt * nsteps
    decay = np.exp(-2 * nu * t)
    u = np.asarray(st.vel[:, 0])
    v = np.asarray(st.vel[:, 1])
    err = max(np.abs(u - u0 * decay).max(), np.abs(v - v0 * decay).max())
    assert err < 5e-3, f"max pointwise error {err:.2e} vs exact decay"
    e_ratio = np.sum(u * u + v * v) / (decay**2 * np.sum(u0**2 + v0**2))
    assert abs(e_ratio - 1.0) < 5e-3, f"kinetic-energy ratio {e_ratio:.4f}"


def test_sharded_transient_matches_single_device():
    """Distributed implicit-Euler marching (parallel/sharded.
    solve_transient_sharded) reproduces the single-device trajectory —
    for both the parity SIMPLE and SIMPLE_FC couplings."""
    from orc_cfd.parallel.sharded import solve_transient_sharded
    from orc_cfd.utils.settings import PressureVelocityCoupling

    ny = 12
    mesh, table = structured_box_mesh(4, ny, 1, lengths=(4e-4, H, 1e-4))
    table.set("TOP_WALL", FaceCondition.WALL, vector_value=(U, 0, 0))
    table.set("BOTTOM_WALL", FaceCondition.WALL)
    table.set("INLET", FaceCondition.PRESSURE_INLET, scalar_value=0.0)
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    base = NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB,
            iterations=30,
            preconditioner=PreconditionMethod.JACOBI,
        ),
        momentum_relaxation=0.8,
        pressure_relaxation=0.2,
    )
    fc = base.replace(
        pressure_velocity_coupling=PressureVelocityCoupling.SIMPLE_FC,
        pressure_relaxation=0.3,
    )
    for settings, label in ((base, "simple"), (fc, "fc")):
        kw = dict(dt=0.005, n_steps=6, inner_iterations=10, verbose=False)
        s1, m1 = solve_transient(mesh, table, settings, RHO, MU, **kw)
        s4, m4 = solve_transient_sharded(
            mesh, table, settings, RHO, MU, n_devices=4, **kw
        )
        np.testing.assert_allclose(
            np.asarray(s4.vel), np.asarray(s1.vel),
            rtol=1e-6, atol=1e-12, err_msg=label,
        )
        np.testing.assert_allclose(
            np.asarray(s4.p), np.asarray(s1.p),
            rtol=1e-6, atol=1e-12, err_msg=label,
        )
        assert np.asarray(m4.vel_avg).shape == np.asarray(m1.vel_avg).shape
