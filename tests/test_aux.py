"""Auxiliary-subsystem tests: debug printers, determinism, recovery,
momentum-source hook, profiling helpers (SURVEY.md 5)."""

import numpy as np
import pytest

import jax.numpy as jnp

from orc_cfd.io.debug import ell_to_string, linear_system_to_string
from orc_cfd.ops.spmv import EllMatrix


def small_matrix(n=4):
    diag = jnp.arange(1.0, n + 1)
    off = jnp.full((n, 2), -0.5)
    nbr = jnp.asarray(
        [[(i - 1) % n, (i + 1) % n] for i in range(n)], dtype=jnp.int32
    )
    return EllMatrix(diag=diag, off=off, neighbors=nbr)


def test_debug_printers():
    A = small_matrix()
    s = ell_to_string(A)
    assert "1.00e+00" in s and s.count("\n") == 3
    ls = linear_system_to_string(A, jnp.asarray([1.0, 2, 3, 4]))
    assert "|" in ls
    big = EllMatrix(
        diag=jnp.ones(32),
        off=jnp.zeros((32, 2)),
        neighbors=jnp.zeros((32, 2), jnp.int32),
    )
    assert "*5=" in ell_to_string(big)


def test_determinism_same_inputs_bitwise():
    """Same inputs -> bit-identical results across runs (the
    stand-in for the reference's absent race detection, SURVEY.md 5)."""
    from orc_cfd.models.channel_flow import (
        ChannelFlowParameters,
        solve_channel_flow,
    )
    from orc_cfd.utils.settings import (
        MatrixSolverSettings,
        MomentumScheme,
        NumericalSettings,
        PressureInterpolation,
        SolutionMethod,
        VelocityInterpolation,
    )

    settings = NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB, iterations=20
        ),
    )
    params = ChannelFlowParameters(dp_dx=5.0)
    runs = [
        solve_channel_flow(
            params, settings, nx=4, ny=4, iterations=30,
            reporting_interval=30, verbose=False,
        )
        for _ in range(2)
    ]
    a = np.asarray(runs[0]["state"].vel)
    b = np.asarray(runs[1]["state"].vel)
    assert (a == b).all(), "nondeterministic results"


def test_recovery_backs_off_and_completes():
    from orc_cfd.models.channel_flow import couette_case, ChannelFlowParameters
    from orc_cfd.solver.recovery import solve_steady_with_recovery
    from orc_cfd.utils.settings import (
        MatrixSolverSettings,
        MomentumScheme,
        NumericalSettings,
        PressureInterpolation,
        SolutionMethod,
        VelocityInterpolation,
    )

    # Start with unstable relaxations; backoff should rescue the run.
    settings = NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.JACOBI,
            iterations=4,
            relaxation=1.9,  # over-relaxed smoother: diverges
            # Keep the divergent solver on the momentum path too (the
            # default momentum smoother is deliberately safe and would
            # rescue this run before the recovery layer gets to).
            momentum_iterations=None,
        ),
        pressure_relaxation=0.5,
        momentum_relaxation=1.0,
    )
    params = ChannelFlowParameters(dp_dx=500.0)
    mesh, table = couette_case(nx=4, ny=4, params=params)
    state, history, log = solve_steady_with_recovery(
        mesh,
        table,
        settings,
        params.rho,
        params.mu,
        iterations=40,
        reporting_interval=10,
        max_retries=5,
        verbose=False,
    )
    assert np.isfinite(np.asarray(state.vel)).all()
    # It must actually have recovered at least once to prove the path.
    assert len(log) >= 1
    assert log[0]["pressure_relaxation"] < 0.5


def test_momentum_source_hook():
    """A uniform body force in x on a closed cavity must accelerate the
    fluid in x."""
    from orc_cfd.models.cavity import cavity_case
    from orc_cfd.solver.simple import initial_state, solve_steady
    from orc_cfd.utils.settings import (
        MatrixSolverSettings,
        MomentumScheme,
        NumericalSettings,
        PressureInterpolation,
        SolutionMethod,
        VelocityInterpolation,
    )

    def source(centroids):
        s = jnp.zeros_like(centroids)
        return s.at[:, 0].set(1e-4)

    settings = NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB, iterations=20
        ),
        momentum_source=source,
    )
    mesh, table = cavity_case(n=4, lid_velocity=0.0)
    state, _ = solve_steady(
        mesh, table, settings, 1.0, 0.01,
        state=initial_state(mesh), iterations=20, reporting_interval=20,
        verbose=False, check_divergence=False,
    )
    # Bottom half drifts +x, top half returns -x (recirculation), but
    # the *forced* momentum must be nonzero.
    assert np.abs(np.asarray(state.vel[:, 0])).max() > 0


def test_measure_helpers():
    from orc_cfd.utils.profiling import Timer, measure

    import jax

    f = jax.jit(lambda x: x * 2.0)
    t = measure(f, jnp.ones(8), warmup=1, iters=3)
    assert t > 0
    timer = Timer()
    with timer.phase("a"):
        pass
    assert "a" in timer.report()


def test_momentum_source_dispatch():
    """momentum_source_term counts REQUIRED positional params only:
    capture-by-default-argument closures keep the 1-arg contract, and
    (centroids, volumes) sources receive the volume array."""
    import jax.numpy as jnp

    from orc_cfd.ops.fields import momentum_source_term

    cc = jnp.ones((5, 3))
    vol = jnp.full((5,), 2.0)

    one_arg = lambda c: c * 10.0
    np.testing.assert_allclose(
        np.asarray(momentum_source_term(one_arg, cc, vol)), 10.0
    )
    # The common capture idiom must NOT receive volumes in its
    # captured slot.
    captured = lambda c, _g=7.0: c * _g
    np.testing.assert_allclose(
        np.asarray(momentum_source_term(captured, cc, vol)), 7.0
    )
    two_arg = lambda c, v: c * v[:, None]
    np.testing.assert_allclose(
        np.asarray(momentum_source_term(two_arg, cc, vol)), 2.0
    )


def test_sharded_rans_multigrid_rejected():
    from orc_cfd.mesh import structured_box_mesh
    from orc_cfd.solver.turbulence import solve_steady_turbulent_sharded
    from orc_cfd.utils.settings import (
        MatrixSolverSettings,
        NumericalSettings,
        SolutionMethod,
    )

    mesh, table = structured_box_mesh(4, 4, 1)
    from orc_cfd.mesh.zones import FaceCondition

    table.set("INLET", FaceCondition.VELOCITY_INLET, vector_value=(1, 0, 0))
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET)
    settings = NumericalSettings(
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.MULTIGRID
        )
    )
    with pytest.raises(NotImplementedError, match="sharded RANS"):
        solve_steady_turbulent_sharded(
            mesh, table, settings, 1.0, 0.01, u_ref=1.0, n_devices=2,
            iterations=1, verbose=False,
        )
