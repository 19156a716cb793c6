"""Lid-driven cavity case — the scale-out benchmark family.

A closed box with one moving wall (the lid); the canonical
wall-bounded recirculating benchmark. This is the multi-million-cell
configuration for multi-device scale-out (partitioned with halo
exchange between devices). All-wall BCs make it a VelocityOnly system
(the moving lid is the only forcing).
"""

from __future__ import annotations

from typing import Optional, Tuple

from orc_cfd.mesh import structured_box_mesh
from orc_cfd.mesh.zones import FaceCondition


def cavity_case(
    n: int = 64,
    nz: int = 1,
    lid_velocity: float = 1.0,
    size: float = 1.0,
    dtype=None,
):
    """n x n x nz unit cavity; +y wall is the moving lid."""
    kw = {} if dtype is None else dict(dtype=dtype)
    mesh, table = structured_box_mesh(
        n, n, nz, lengths=(size, size, size * nz / n), **kw
    )
    table.set("TOP_WALL", FaceCondition.WALL, vector_value=(lid_velocity, 0, 0))
    table.set("BOTTOM_WALL", FaceCondition.WALL)
    table.set("INLET", FaceCondition.WALL)
    table.set("OUTLET", FaceCondition.WALL)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    return mesh, table


def solve_cavity(
    n: int = 32,
    reynolds: float = 100.0,
    lid_velocity: float = 1.0,
    iterations: int = 500,
    reporting_interval: int = 100,
    settings=None,
    n_devices: int = 1,
    verbose: bool = True,
):
    """Solve the cavity at a given Reynolds number (rho = 1,
    mu = U L / Re). Returns the result state + diagnostics."""
    import numpy as np

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

    from orc_cfd.utils.settings import RelaxationMode

    # Enclosed recirculating flow: the reference's explicit
    # correction-relaxation diverges here; implicit (Patankar)
    # under-relaxation is required.
    settings = settings or NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB,
            iterations=50,
            preconditioner=PreconditionMethod.JACOBI,
        ),
        pressure_relaxation=0.1,
        momentum_relaxation=0.7,
        relaxation_mode=RelaxationMode.IMPLICIT,
    )
    rho = 1.0
    mu = lid_velocity * 1.0 / reynolds
    mesh, table = cavity_case(n=n, lid_velocity=lid_velocity)
    state = initial_state(mesh)
    if n_devices > 1:
        from orc_cfd.parallel.sharded import solve_steady_sharded

        state, history = solve_steady_sharded(
            mesh, table, settings, rho, mu, state=state,
            iterations=iterations, reporting_interval=reporting_interval,
            n_devices=n_devices, verbose=verbose,
        )
    else:
        state, history = solve_steady(
            mesh, table, settings, rho, mu, state=state,
            iterations=iterations, reporting_interval=reporting_interval,
            verbose=verbose,
        )
    vel = np.asarray(state.vel)
    cc = np.asarray(mesh.cell_centroid)
    # Diagnostics: centerline profiles (the Ghia-style cuts).
    mid_x = np.abs(cc[:, 0] - 0.5) < 0.51 / n
    mid_y = np.abs(cc[:, 1] - 0.5) < 0.51 / n
    return dict(
        mesh=mesh,
        table=table,
        state=state,
        history=history,
        u_centerline=(cc[mid_x, 1], vel[mid_x, 0]),
        v_centerline=(cc[mid_y, 0], vel[mid_y, 1]),
    )
