"""Lid-driven cavity validation (Re = 100) against Ghia et al. (1982)
benchmark landmarks — the canonical enclosed recirculating flow, which
requires implicit (Patankar) momentum under-relaxation (the reference's
explicit correction-relaxation diverges on it)."""

import os

import numpy as np
import pytest

from orc_cfd.models.cavity import solve_cavity


def test_cavity_re100_ghia_landmarks():
    r = solve_cavity(
        n=32,
        reynolds=100.0,
        iterations=600,
        reporting_interval=600,
        verbose=False,
    )
    vel = np.asarray(r["state"].vel)
    assert np.isfinite(vel).all()
    # u on the vertical centerline: Ghia et al. report
    # u_min ~ -0.211 near y ~ 0.45 at Re=100; a 32^2 UD solution sits in
    # the same basin (coarser + more diffusive -> shallower minimum).
    y, u = r["u_centerline"]
    order = np.argsort(y)
    y, u = y[order], u[order]
    assert u.max() <= 1.0 + 1e-6  # bounded by the lid speed
    u_min = u.min()
    assert -0.30 < u_min < -0.10, u_min
    y_min = y[np.argmin(u)]
    assert 0.3 < y_min < 0.65, y_min
    # v on the horizontal centerline: antisymmetric-ish with
    # max ~ 0.18 / min ~ -0.25 at Re=100 (Ghia); coarse bounds.
    x, v = r["v_centerline"]
    assert 0.05 < v.max() < 0.35
    assert -0.40 < v.min() < -0.10
    # Enclosed flow: net mass flux through any horizontal cut is ~0 —
    # proxy: mean v ~ 0.
    assert abs(np.asarray(r["state"].vel)[:, 1].mean()) < 5e-3


def test_cavity_3d_stability():
    """3D cavities need tighter pressure relaxation than 2D: 0.1
    diverges from ~24^3 up, 0.02 converges monotonically (measured
    2026-08-16; scripts/bench_cavity.py bakes the same rule in). Pin
    the working configuration at 20^3."""
    import jax.numpy as jnp

    from orc_cfd.models.cavity import cavity_case
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

    settings = NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB,
            iterations=50,
            preconditioner=PreconditionMethod.JACOBI,
        ),
        pressure_relaxation=0.02,
        momentum_relaxation=0.7,
        relaxation_mode=RelaxationMode.IMPLICIT,
    )
    mesh, table = cavity_case(n=20, nz=20)
    state = initial_state(mesh)
    pcorrs = []
    for _ in range(3):
        state, hist = solve_steady(
            mesh, table, settings, 1.0, 1.0 / 100.0, state=state,
            iterations=100, reporting_interval=100, verbose=False,
        )
        pcorrs.append(float(np.asarray(hist[-1].p_corr_norm)[-1]))
    u = np.asarray(state.vel[:, 0])
    assert np.isfinite(u).all()
    # Bounded by the lid speed (plus small overshoot) and decreasing
    # corrections — the 0.1-relaxation failure mode is exponential
    # p_corr growth with u blowing past 2.
    assert -0.5 < u.min() and u.max() < 1.05, (u.min(), u.max())
    assert pcorrs[2] < pcorrs[0], pcorrs


@pytest.mark.skipif(
    "os.environ.get('ORC_SLOW', '0') != '1'",
    reason="heavy flagship validation: set ORC_SLOW=1 (minutes on "
    "a GPU, much longer on CPU)",
)
def test_cavity_re1000_ghia_flagship():
    """Flagship high-Re validation: mesh-sequenced
    256^2 Re=1000 cavity with the conservative second-order scheme
    (TVD_DC + Rhie-Chow) matches Ghia et al. (1982) Table I/II u- and
    v-midlines to <= 0.05 max abs error.

    Findings behind the configuration (scripts/cavity_convergence_probe
    .py, NOTES.md): f32 runs need compensated_state (on by default) to
    keep converging once increments fall below f32 epsilon; the
    in-matrix TVD inherits the reference's inflow-face CD degeneration
    and converges at UD-like accuracy, so TVD_DC is the scheme that
    carries this test; pressure_relaxation 0.1 limit-cycles at 256^2
    (p_corr grows 7.7e-3 -> 1.1e-1 over 160k iters) while 0.03
    converges monotonically to p_corr ~3e-5 with u_err 0.007 /
    v_err 0.020 (measured 2026-08-17).

    The ghia_v table is Ghia Table II's Re=1000 column verbatim; an
    earlier transcription had v(0.2266) from the x=0.1016 row and
    v(0.9531) from the Re=100 column (-0.22781), which manufactured a
    phantom 0.13 "error" at the one landmark after the real solver
    deficit was fixed.
    """
    import os

    import jax.numpy as jnp

    from orc_cfd.models.cavity import cavity_case
    from orc_cfd.solver.sequencing import solve_steady_sequenced
    from orc_cfd.utils.settings import (
        MatrixSolverSettings,
        MomentumScheme,
        NumericalSettings,
        PreconditionMethod,
        PressureInterpolation,
        RelaxationMode,
        SolutionMethod,
        VelocityInterpolation,
        tvd_umist,
    )

    ghia_y = [0.0547, 0.1016, 0.2813, 0.4531, 0.5, 0.6172, 0.7344, 0.9531]
    ghia_u = [-0.1812, -0.2973, -0.2781, -0.1065, -0.0608, 0.0570,
              0.1872, 0.4660]
    ghia_x = [0.0625, 0.2266, 0.5, 0.8047, 0.9531]
    ghia_v = [0.27485, 0.33075, 0.02526, -0.31966, -0.33714]

    n = 256
    settings = NumericalSettings(
        momentum=MomentumScheme.TVD_DC,
        tvd_psi=tvd_umist,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
        pressure_relaxation=0.03,
        momentum_relaxation=0.6,
        relaxation_mode=RelaxationMode.IMPLICIT,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB,
            iterations=50,
            preconditioner=PreconditionMethod.JACOBI,
        ),
    )

    def builder(nx, ny, nz):
        return cavity_case(n=nx, lid_velocity=1.0, dtype=jnp.float32)

    state, _ = solve_steady_sequenced(
        builder,
        [(64, 64, 1), (128, 128, 1), (256, 256, 1)],
        settings, 1.0, 1e-3,
        iterations_per_level=6000,
        final_iterations=60000,
        reporting_interval=2000,
        verbose=False,
    )
    u = np.asarray(state.vel)[:, 0].reshape(n, n)
    v = np.asarray(state.vel)[:, 1].reshape(n, n)
    yc = (np.arange(n) + 0.5) / n
    u_s = np.interp(ghia_y, yc, u[:, n // 2])
    v_s = np.interp(ghia_x, yc, v[n // 2, :])
    eu = np.abs(u_s - np.asarray(ghia_u)).max()
    ev = np.abs(v_s - np.asarray(ghia_v)).max()
    assert eu <= 0.05, dict(zip(ghia_y, np.abs(u_s - np.asarray(ghia_u))))
    assert ev <= 0.05, dict(zip(ghia_x, np.abs(v_s - np.asarray(ghia_v))))


def test_correction_forms_agree():
    """PressureCorrectionForm.CELL_DIFFERENCE (reference parity, 2x
    compact) and FACE_VALUE (consistent -(V/a) grad p') must converge
    to the SAME flow field — the correction form only shapes the
    trajectory, not the fixed point (at convergence p' -> 0 and the
    momentum/continuity equations alone set the answer). Run with
    Rhie-Chow (FACE_VALUE's stable pairing; see the enum docstring)."""
    from orc_cfd.models.cavity import cavity_case
    from orc_cfd.solver.simple import initial_state, solve_steady
    from orc_cfd.utils.settings import (
        MatrixSolverSettings,
        MomentumScheme,
        NumericalSettings,
        PreconditionMethod,
        PressureCorrectionForm,
        PressureInterpolation,
        RelaxationMode,
        SolutionMethod,
        VelocityInterpolation,
    )

    mesh, table = cavity_case(n=16, lid_velocity=1.0)
    base = NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
        relaxation_mode=RelaxationMode.IMPLICIT,
        momentum_relaxation=0.7,
        pressure_relaxation=0.1,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB,
            iterations=40,
            preconditioner=PreconditionMethod.JACOBI,
        ),
    )
    fields = {}
    for form in PressureCorrectionForm:
        s = base.replace(pressure_correction_form=form)
        st, hist = solve_steady(
            mesh, table, s, 1.0, 0.01, state=initial_state(mesh),
            iterations=2500, reporting_interval=2500, verbose=False,
        )
        assert not bool(np.any(np.asarray(hist[-1].diverged))), form
        assert float(hist[-1].p_corr_norm[-1]) < 1e-8, (
            form, float(hist[-1].p_corr_norm[-1]))
        fields[form] = np.asarray(st.vel)
    a, b = fields.values()
    np.testing.assert_allclose(a, b, rtol=0, atol=2e-7)
