"""Mesh sequencing (solver/sequencing.py): prolongation correctness and
the cascade beating a cold start at equal fine-grid budget."""

import numpy as np

import jax.numpy as jnp

from orc_cfd.mesh.zones import FaceCondition
from orc_cfd.solver.sequencing import (
    prolong_state,
    solve_steady_sequenced,
    upsample_field,
)
from orc_cfd.solver.simple import initial_state, solve_steady
from orc_cfd.utils.settings import (
    MatrixSolverSettings,
    MomentumScheme,
    NumericalSettings,
    PreconditionMethod,
    PressureInterpolation,
    RelaxationMode,
    SolutionMethod,
    VelocityInterpolation,
)


def test_upsample_field():
    # 2x2x1 -> 4x4x1: each coarse value fills its 2x2 block.
    a = jnp.asarray(np.arange(4.0))
    up = np.asarray(upsample_field(a, (2, 2, 1), (4, 4, 1)))
    g = up.reshape(4, 4)
    np.testing.assert_allclose(g[:2, :2], 0.0)
    np.testing.assert_allclose(g[:2, 2:], 1.0)
    np.testing.assert_allclose(g[2:, :2], 2.0)
    np.testing.assert_allclose(g[2:, 2:], 3.0)
    # Vector fields keep their feature axis.
    v = jnp.asarray(np.arange(12.0).reshape(4, 3))
    upv = np.asarray(upsample_field(v, (2, 2, 1), (4, 4, 1)))
    assert upv.shape == (16, 3)


SETTINGS = NumericalSettings(
    momentum=MomentumScheme.UD,
    pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
    velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
    pressure_relaxation=0.1,
    momentum_relaxation=0.7,
    relaxation_mode=RelaxationMode.IMPLICIT,
    matrix_solver=MatrixSolverSettings(
        solver_type=SolutionMethod.BICGSTAB,
        iterations=30,
        preconditioner=PreconditionMethod.JACOBI,
    ),
)


def test_sequenced_cavity_beats_cold_start():
    """With the same fine-grid iteration budget, the cascade gets much
    closer to the developed cavity flow than a cold start (the whole
    point of sequencing)."""
    from orc_cfd.models.cavity import cavity_case

    def builder(nx, ny, nz):
        return cavity_case(n=nx, lid_velocity=1.0)

    fine_iters = 100
    rho, mu = 1.0, 1e-3
    seq_state, _ = solve_steady_sequenced(
        builder, [(16, 16, 1), (32, 32, 1), (64, 64, 1)], SETTINGS,
        rho, mu, iterations_per_level=800, final_iterations=fine_iters,
        reporting_interval=800, verbose=False,
    )
    mesh, table = builder(64, 64, 1)
    cold_state, _ = solve_steady(
        mesh, table, SETTINGS, rho, mu, state=initial_state(mesh),
        iterations=fine_iters, reporting_interval=fine_iters,
        verbose=False,
    )
    # Reference: a long fine-grid solve.
    ref_state, _ = solve_steady(
        mesh, table, SETTINGS, rho, mu, state=seq_state,
        iterations=4000, reporting_interval=4000, verbose=False,
    )
    ref = np.asarray(ref_state.vel)
    err_seq = np.abs(np.asarray(seq_state.vel) - ref).max()
    err_cold = np.abs(np.asarray(cold_state.vel) - ref).max()
    assert err_seq < 0.5 * err_cold, (err_seq, err_cold)
    assert np.isfinite(np.asarray(seq_state.vel)).all()
