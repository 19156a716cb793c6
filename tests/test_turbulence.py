"""k-epsilon turbulence model tests (the reference only declares the
enum, lib.rs:164-168; this framework implements and validates it).

Quantitative pin: the Re_tau=590 body-force-driven streamwise-periodic
channel (the standard wall-function validation rig, enabled by the
periodic BC layer) must reproduce the DNS bulk/centerline velocities
and the log law. Plus qualitative checks on a developing inlet-driven
channel."""

import numpy as np
import pytest

import jax.numpy as jnp

from orc_cfd.mesh import structured_box_mesh
from orc_cfd.mesh.zones import FaceCondition
from orc_cfd.solver.turbulence import (
    E_WALL,
    KAPPA,
    initial_turbulence,
    solve_steady_turbulent,
)
from orc_cfd.utils.settings import (
    MatrixSolverSettings,
    MomentumScheme,
    NumericalSettings,
    PreconditionMethod,
    PressureInterpolation,
    SolutionMethod,
    VelocityInterpolation,
)


def channel(nx=16, ny=12):
    mesh, table = structured_box_mesh(nx, ny, 1, lengths=(8.0, 2.0, 0.5))
    table.set("TOP_WALL", FaceCondition.WALL)
    table.set("BOTTOM_WALL", FaceCondition.WALL)
    table.set("INLET", FaceCondition.VELOCITY_INLET, vector_value=(1.0, 0, 0))
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    return mesh, table


SETTINGS = NumericalSettings(
    momentum=MomentumScheme.UD,
    pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
    velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
    matrix_solver=MatrixSolverSettings(
        solver_type=SolutionMethod.BICGSTAB,
        iterations=30,
        preconditioner=PreconditionMethod.JACOBI,
    ),
    momentum_relaxation=0.6,
    pressure_relaxation=0.05,
)


def test_turbulent_channel_develops():
    mesh, table = channel()
    rho, mu = 1.0, 1e-5  # Re_h = 2e5
    flow, turb, history = solve_steady_turbulent(
        mesh,
        table,
        SETTINGS,
        rho,
        mu,
        u_ref=1.0,
        iterations=200,
        reporting_interval=200,
        intensity=0.05,
        length_scale=0.14,
        verbose=False,
    )
    k = np.asarray(turb.k)
    eps = np.asarray(turb.eps)
    mu_t = np.asarray(turb.mu_t)
    vel = np.asarray(flow.vel)
    assert np.isfinite(vel).all() and np.isfinite(k).all()
    assert (k > 0).all() and (eps > 0).all() and (mu_t >= 0).all()
    # Eddy viscosity far above molecular in the developed region.
    assert mu_t.max() / mu > 50.0, mu_t.max() / mu
    # Mass conservation: bulk velocity ~ inlet velocity.
    u_mean = vel[:, 0].mean()
    assert abs(u_mean - 1.0) < 0.15, u_mean


@pytest.mark.parametrize("ny", [16, 10])
def test_channel_re_tau_590(ny):
    """Re_tau=590 periodic channel vs DNS (Moser, Kim & Mansour 1999:
    U_b+ ~= 18.5, U_c+ ~= 21.26) and the equilibrium log law.

    delta = u_tau = rho = 1, mu = 1/590, driven by the body force
    G = rho u_tau^2/delta through streamwise-periodic wraps — at steady
    state the total wall shear exactly balances G, so u_tau is imposed
    and U_b+ is the prediction. Two wall-cell placements in the log
    layer (ny=16 -> y+ = 36.9, ny=10 -> y+ = 59) so a single
    coincidentally-good y+ cannot carry the validation.
    """
    RE_TAU, H = 590.0, 2.0
    rho, u_tau = 1.0, 1.0
    mu = rho * u_tau * (H / 2) / RE_TAU
    G = rho * u_tau**2 / (H / 2)
    nx = 4
    mesh, table = structured_box_mesh(
        nx, ny, 1, lengths=(4.0, H, 0.2), periodic=("x",)
    )
    table.set("BOTTOM_WALL", FaceCondition.WALL)
    table.set("TOP_WALL", FaceCondition.WALL)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    vol = float(np.asarray(mesh.cell_volume)[0])

    def source(cc):
        s = jnp.zeros_like(cc)
        return s.at[:, 0].set(G * vol)

    settings = NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB, iterations=30
        ),
        momentum_source=source,
    )
    flow, turb, _ = solve_steady_turbulent(
        mesh, table, settings, rho, mu,
        u_ref=18.0, iterations=800, reporting_interval=800,
        intensity=0.05, length_scale=0.2 * H, verbose=False,
    )
    u = np.asarray(flow.vel)[:, 0].reshape(ny, nx)
    u_prof = u.mean(axis=1)
    # Bulk and centerline velocity in wall units vs DNS.
    U_b = u_prof.mean() / u_tau
    U_c = u_prof.max() / u_tau
    assert abs(U_b - 18.5) / 18.5 < 0.10, f"U_b+ = {U_b:.2f}"
    assert abs(U_c - 21.26) / 21.26 < 0.05, f"U_c+ = {U_c:.2f}"
    # Wall-adjacent cell on the log law u+ = ln(E y+)/kappa.
    yp1 = RE_TAU * (H / ny) / 2
    assert abs(u_prof[0] - np.log(E_WALL * yp1) / KAPPA) < 0.05 * u_prof[0]
    # Wall-adjacent k at the equilibrium value k+ = 1/sqrt(C_mu).
    k1 = np.asarray(turb.k).reshape(ny, nx).mean(axis=1)[0]
    assert abs(k1 - 0.09**-0.5) / 0.09**-0.5 < 0.10, k1
    # Seamless wrap: streamwise-invariant solution.
    assert np.abs(u.std(axis=1)).max() < 1e-3
    # Symmetric profile (to iteration-convergence level).
    np.testing.assert_allclose(u_prof, u_prof[::-1], rtol=1e-3)


def test_initial_turbulence_levels():
    mesh, _ = channel(4, 4)
    t = initial_turbulence(mesh, u_ref=2.0, intensity=0.1, length_scale=0.5, rho=1.0)
    k = float(np.asarray(t.k)[0])
    assert np.isclose(k, 1.5 * (0.1 * 2.0) ** 2)
    assert float(np.asarray(t.mu_t)[0]) > 0


def test_sharded_turbulent_matches_single_device():
    """The distributed RANS loop (sharded SIMPLE + sharded k/eps
    transport) reproduces the single-device trajectory."""
    from orc_cfd.solver.turbulence import solve_steady_turbulent_sharded

    RE_TAU, H = 590.0, 2.0
    rho, u_tau = 1.0, 1.0
    mu = rho * u_tau * (H / 2) / RE_TAU
    G = rho * u_tau**2 / (H / 2)
    nx, ny = 4, 16
    mesh, table = structured_box_mesh(
        nx, ny, 1, lengths=(4.0, H, 0.2), periodic=("x",)
    )
    table.set("BOTTOM_WALL", FaceCondition.WALL)
    table.set("TOP_WALL", FaceCondition.WALL)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    vol = float(np.asarray(mesh.cell_volume)[0])

    def source(cc):
        s = jnp.zeros_like(cc)
        return s.at[:, 0].set(G * vol)

    settings = NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB, iterations=30
        ),
        momentum_source=source,
    )
    # (a) Single-step semantic equivalence, tight: the sharded outer
    # step is the same math (reduction order aside).
    kw1 = dict(
        u_ref=18.0, iterations=1, reporting_interval=1,
        intensity=0.05, length_scale=0.2 * H, verbose=False,
    )
    f1, t1, _ = solve_steady_turbulent(mesh, table, settings, rho, mu, **kw1)
    f4, t4, _ = solve_steady_turbulent_sharded(
        mesh, table, settings, rho, mu, n_devices=4, **kw1
    )
    np.testing.assert_allclose(
        np.asarray(f4.vel), np.asarray(f1.vel), rtol=1e-9, atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(t4.k), np.asarray(t1.k), rtol=1e-9, atol=1e-12
    )
    # (b) Converged-state equivalence: inner-solver exit decisions flip
    # on rounding mid-trajectory (measured: divergence peaks ~iter 5
    # then contracts), but both runs must reach the same steady state.
    kw = dict(
        u_ref=18.0, iterations=400, reporting_interval=400,
        intensity=0.05, length_scale=0.2 * H, verbose=False,
    )
    flow1, tb1, _ = solve_steady_turbulent(
        mesh, table, settings, rho, mu, **kw
    )
    flow4, tb4, _ = solve_steady_turbulent_sharded(
        mesh, table, settings, rho, mu, n_devices=4, **kw
    )
    u1 = np.asarray(flow1.vel)[:, 0]
    u4 = np.asarray(flow4.vel)[:, 0]
    assert abs(u4.mean() - u1.mean()) < 5e-3 * abs(u1.mean())
    np.testing.assert_allclose(u4, u1, rtol=1e-2)
    np.testing.assert_allclose(
        np.asarray(tb4.mu_t), np.asarray(tb1.mu_t), rtol=5e-2, atol=1e-10
    )


def test_turbulent_channel_multigrid():
    """RANS + MULTIGRID: the geometric hierarchy is built once and
    plumbed through the outer step (previously this raised 'Multigrid
    needs a host-built hierarchy' from the p-solve). Same channel as
    test_turbulent_channel_develops; same physics bars."""
    mesh, table = channel()
    rho, mu = 1.0, 1e-5
    s = SETTINGS.replace(
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.MULTIGRID,
            iterations=30,
            multigrid_levels=3,
            multigrid_smoother_iterations=4,
            preconditioner=PreconditionMethod.JACOBI,
        )
    )
    flow, turb, history = solve_steady_turbulent(
        mesh, table, s, rho, mu, u_ref=1.0,
        iterations=200, reporting_interval=200,
        intensity=0.05, length_scale=0.14, verbose=False,
    )
    vel = np.asarray(flow.vel)
    k = np.asarray(turb.k)
    assert np.isfinite(vel).all() and np.isfinite(k).all()
    assert (k > 0).all()
    u_mean = vel[:, 0].mean()
    assert abs(u_mean - 1.0) < 0.15, u_mean


def test_sharded_turbulent_fc_matches_single_device():
    """Sharded RANS under the SIMPLE_FC coupling: per-device [C,K]
    fluxes are seeded inside shard_map and the outer step reproduces
    the single-device trajectory (the FC p-solve runs deflated — the
    body-force channel has no pressure zones)."""
    from orc_cfd.solver.turbulence import solve_steady_turbulent_sharded
    from orc_cfd.utils.settings import (
        PressureVelocityCoupling,
        RelaxationMode,
    )

    RE_TAU, H = 590.0, 2.0
    rho, u_tau = 1.0, 1.0
    mu = rho * u_tau * (H / 2) / RE_TAU
    G = rho * u_tau**2 / (H / 2)
    mesh, table = structured_box_mesh(
        4, 16, 1, lengths=(4.0, H, 0.2), periodic=("x",)
    )
    table.set("BOTTOM_WALL", FaceCondition.WALL)
    table.set("TOP_WALL", FaceCondition.WALL)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    vol = float(np.asarray(mesh.cell_volume)[0])

    def source(cc):
        s = jnp.zeros_like(cc)
        return s.at[:, 0].set(G * vol)

    settings = NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_velocity_coupling=PressureVelocityCoupling.SIMPLE_FC,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
        relaxation_mode=RelaxationMode.IMPLICIT,
        momentum_relaxation=0.6,
        pressure_relaxation=0.3,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB, iterations=30
        ),
        momentum_source=source,
    )
    # Single-step semantic equivalence (tight), then a longer run for
    # trajectory agreement through the flux state.
    kw1 = dict(
        u_ref=18.0, iterations=1, reporting_interval=1,
        intensity=0.05, length_scale=0.2 * H, verbose=False,
    )
    f1, t1, _ = solve_steady_turbulent(mesh, table, settings, rho, mu, **kw1)
    f4, t4, _ = solve_steady_turbulent_sharded(
        mesh, table, settings, rho, mu, n_devices=4, **kw1
    )
    np.testing.assert_allclose(
        np.asarray(f4.vel), np.asarray(f1.vel), rtol=1e-9, atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(t4.k), np.asarray(t1.k), rtol=1e-9, atol=1e-12
    )
    kw = dict(
        u_ref=18.0, iterations=300, reporting_interval=300,
        intensity=0.05, length_scale=0.2 * H, verbose=False,
    )
    flow1, tb1, _ = solve_steady_turbulent(
        mesh, table, settings, rho, mu, **kw
    )
    flow4, tb4, _ = solve_steady_turbulent_sharded(
        mesh, table, settings, rho, mu, n_devices=4, **kw
    )
    u1 = np.asarray(flow1.vel)[:, 0]
    u4 = np.asarray(flow4.vel)[:, 0]
    assert abs(u4.mean() - u1.mean()) < 5e-3 * abs(u1.mean())
    np.testing.assert_allclose(u4, u1, rtol=1e-2)
    np.testing.assert_allclose(
        np.asarray(tb4.mu_t), np.asarray(tb1.mu_t), rtol=5e-2, atol=1e-10
    )
