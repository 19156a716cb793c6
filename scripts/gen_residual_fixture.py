"""Generate the residual-history regression fixtures.

The project's correctness target is a residual-history match at 1e-6
relative tolerance on couette_flow_128x64x1. The Rust reference cannot
be built in this environment (no cargo), so this framework's own f64
trajectories are the pinned fixtures (NOTES.md item 6): any future
change to solver semantics must reproduce them or consciously
regenerate them.

TWO fixtures since round 4 (the default coupling flipped to AUTO):
- residual_history_couette_r1.npz — the PARITY loop
  (pressure_velocity_coupling=SIMPLE, explicitly), byte-compatible
  with the round-1 fixture: the reference-trajectory pin. (The
  package DEFAULTS also produce this trajectory: AUTO resolves to
  SIMPLE under the default EXPLICIT relaxation.)
- residual_history_couette_fc_r4.npz — the FC loop under its
  recommended envelope (AUTO default + IMPLICIT relaxation,
  alpha_u 0.7 / alpha_p 0.3, where AUTO resolves to SIMPLE_FC): the
  FC-trajectory regression pin.

Deterministic setup: CPU backend, f64, the reference's VALIDATED
couette configuration with default numerics (CD1 + SecondOrder +
Rhie-Chow + Jacobi-preconditioned BiCGSTAB(50)).

Usage: python scripts/gen_residual_fixture.py
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FIXTURE = "tests/fixtures/residual_history_couette_r1.npz"
FIXTURE_FC = "tests/fixtures/residual_history_couette_fc_r4.npz"
ITERATIONS = 60


def build(coupling=None, fc_envelope=False):
    """coupling: None = the package default (AUTO) or an explicit
    PressureVelocityCoupling member. fc_envelope: add IMPLICIT
    relaxation at alpha_u 0.7 / alpha_p 0.3 (the recommended FC
    settings, under which AUTO resolves to SIMPLE_FC)."""
    from orc_cfd.mesh import read_mesh
    from orc_cfd.mesh.zones import FaceCondition
    from orc_cfd.solver.simple import initial_state, solve_steady
    from orc_cfd.utils.settings import (
        MatrixSolverSettings,
        NumericalSettings,
        PreconditionMethod,
        SolutionMethod,
    )

    mesh, table = read_mesh(
        "/root/reference/examples/couette_flow_128x64x1.msh"
    )
    table.set("TOP_WALL", FaceCondition.WALL, vector_value=(5e-4, 0.0, 0.0))
    table.set("BOTTOM_WALL", FaceCondition.WALL)
    table.set("INLET", FaceCondition.PRESSURE_INLET, scalar_value=0.02)
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    kw = {} if coupling is None else dict(
        pressure_velocity_coupling=coupling
    )
    if fc_envelope:
        from orc_cfd.utils.settings import RelaxationMode

        kw.update(
            relaxation_mode=RelaxationMode.IMPLICIT,
            momentum_relaxation=0.7,
            pressure_relaxation=0.3,
        )
    settings = NumericalSettings(
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB,
            iterations=50,
            preconditioner=PreconditionMethod.JACOBI,
        ),
        **kw,
    )
    state, history = solve_steady(
        mesh, table, settings, 1000.0, 0.001,
        state=initial_state(mesh), iterations=ITERATIONS,
        reporting_interval=ITERATIONS, verbose=False,
    )
    return history


def main():
    import numpy as np

    from orc_cfd.solver.simple import save_history
    from orc_cfd.utils.settings import PressureVelocityCoupling

    os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
    for path, coupling, fc_env in (
        (FIXTURE, PressureVelocityCoupling.SIMPLE, False),
        (FIXTURE_FC, None, True),
    ):
        history = build(coupling, fc_envelope=fc_env)
        save_history(path, history)
        with np.load(path) as z:
            print(f"wrote {path}:")
            for k in z.files:
                print(f"  {k}: {z[k].shape}")


if __name__ == "__main__":
    main()
