"""Cold-start grid-refinement study for the Re=1000 cavity.

No mesh sequencing: each grid converges from rest. Reports the Ghia
Table I/II landmark errors per grid so the h-convergence of the
converged discrete solution is visible (the sequenced probes all froze
at u_err ~0.098-0.0997 regardless of scheme; the independent psi-omega
FD solver hits 0.022 at 129^2 — scripts/cavity_psi_omega_reference.py).

Usage: SCHEME=ud|dc python scripts/cavity_grid_study.py [grids...]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cavity_convergence_probe import GHIA_U, GHIA_V, GHIA_X, GHIA_Y, landmark_err


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from orc_cfd.backend import setup_compile_cache

    setup_compile_cache()

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
        tvd_umist,
    )

    scheme = os.environ.get("SCHEME", "ud")
    grids = [int(g) for g in sys.argv[1:]] or [64, 128, 256]
    solver = MatrixSolverSettings(
        solver_type=SolutionMethod.BICGSTAB,
        iterations=50,
        preconditioner=PreconditionMethod.JACOBI,
    )
    if scheme == "dc":
        settings = NumericalSettings(
            momentum=MomentumScheme.TVD_DC,
            tvd_psi=tvd_umist,
            pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
            velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
            pressure_relaxation=0.1,
            momentum_relaxation=0.7,
            relaxation_mode=RelaxationMode.IMPLICIT,
            matrix_solver=solver,
        )
    else:
        settings = NumericalSettings(
            momentum=MomentumScheme.UD,
            pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
            velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
            pressure_relaxation=0.1,
            momentum_relaxation=0.7,
            relaxation_mode=RelaxationMode.IMPLICIT,
            matrix_solver=solver,
        )

    for n in grids:
        mesh, table = cavity_case(n=n, lid_velocity=1.0, dtype=jnp.float32)
        state = initial_state(mesh)
        total = 0
        prev = None
        # Iterate until the landmark error stops moving (or a cap).
        for chunk in range(12):
            iters = 20000
            t0 = time.perf_counter()
            state, h = solve_steady(
                mesh, table, settings, 1.0, 1e-3,
                state=state, iterations=iters, reporting_interval=2000,
                verbose=False,
            )
            total += iters
            eu, ev = landmark_err(state, n)
            pc = float(np.asarray(h[-1].p_corr_norm)[-1])
            print(
                f"{scheme} {n:>4}^2 iters {total:>7}: u_err {eu:.4f} "
                f"v_err {ev:.4f}  p_corr {pc:.3e} "
                f"({time.perf_counter()-t0:.0f}s)",
                flush=True,
            )
            if prev is not None and abs(eu - prev) < 2e-4:
                break
            prev = eu
        if os.environ.get("PROBE_DETAIL", "0") == "1":
            landmark_err(state, n)


if __name__ == "__main__":
    main()
