"""Transient (unsteady) solver: implicit-Euler SIMPLE time marching.

The reference's roadmap lists "Transient iteration" unchecked
(README.md:42); this is the real implementation. Each physical time
step adds the first-order implicit unsteady term rho V/dt (phi - phi^n)
to the momentum systems and runs `inner_iterations` SIMPLE
pressure-velocity iterations to converge the coupled step; the whole
time loop (outer scan over steps, inner scan over SIMPLE iterations)
compiles into a single device program.
"""

from __future__ import annotations

import time
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from orc_cfd.mesh.compile import CompiledMesh
from orc_cfd.mesh.zones import BoundaryTable
from orc_cfd.ops.assembly import diffusion_system
from orc_cfd.ops.fields import device_bc, face_bc
from orc_cfd.solver.simple import (
    CK_AUTO_MAX_CELLS,
    FlowState,
    SolverDivergedError,
    ck_simple_step,
    initial_state,
    simple_step,
)
from orc_cfd.utils.settings import NumericalSettings, SolutionMethod


def solve_transient(
    mesh: CompiledMesh,
    table: BoundaryTable,
    settings: NumericalSettings,
    rho: float,
    mu: float,
    dt: float,
    n_steps: int,
    inner_iterations: int = 20,
    state: Optional[FlowState] = None,
    report_interval: int = 0,
    verbose: bool = True,
    check_divergence: bool = True,
    use_ck: str | bool = "auto",
):
    """March `n_steps` implicit time steps of size `dt`.

    Returns (FlowState at t = n_steps*dt, per-step metrics pytree with
    leading axis [n_steps] from each step's final inner iteration).
    """
    table.validate_supported()
    from orc_cfd.utils.settings import PressureVelocityCoupling

    use_fc = (
        settings.resolved_coupling()
        == PressureVelocityCoupling.SIMPLE_FC
    )
    from orc_cfd.solver.simple import (
        table_has_pressure_bc,
        table_maybe_singular,
    )

    maybe_singular = (
        not table_has_pressure_bc(table)
        if use_fc
        else table_maybe_singular(table)
    )
    zc, zs, zv = device_bc(table, dtype=mesh.dtype)
    if state is None:
        state = initial_state(mesh)

    fbc = face_bc(mesh, zc, zs, zv)
    diff = diffusion_system(mesh, fbc, jnp.asarray(mu, mesh.dtype))
    rv_dt = rho * mesh.cell_volume / dt  # [C]

    ck = ck_diff = None
    if use_ck is True or (
        use_ck == "auto" and mesh.n_cells <= CK_AUTO_MAX_CELLS
    ):
        from orc_cfd.ops.ck_ops import build_ck_geometry, ck_bc, ck_diffusion

        ck = build_ck_geometry(mesh, len(table.zone_ids))
        ck_diff = ck_diffusion(
            mesh, ck, ck_bc(ck, zc, zs, zv), jnp.asarray(mu, mesh.dtype)
        )
    from orc_cfd.solver.simple import _pallas_asm_spec

    pallas_asm = _pallas_asm_spec(
        mesh, table, settings, ck, fc=use_fc
    )

    solver_extras = {}
    if settings.matrix_solver.solver_type == SolutionMethod.GAUSS_SEIDEL:
        from orc_cfd.solver.coloring import greedy_coloring

        colors, n_colors = greedy_coloring(mesh)
        solver_extras = dict(colors=colors, n_colors=n_colors)
    elif settings.matrix_solver.solver_type == SolutionMethod.MULTIGRID:
        from orc_cfd.solver.gmg import build_mg_hierarchy

        solver_extras = dict(
            mg_hierarchy=build_mg_hierarchy(mesh, diff, settings)
        )

    if use_fc and state.flux is None:
        # SIMPLE_FC: the stored conservative flux must exist before the
        # scan starts (fixed carry structure) — see solver/fc.py.
        import dataclasses as _dc

        if ck is not None:
            from orc_cfd.ops.ck_ops import ck_bc as _ckbc
            from orc_cfd.solver.fc import ck_initial_flux

            state = _dc.replace(
                state,
                flux=ck_initial_flux(
                    mesh, ck, _ckbc(ck, zc, zs, zv), settings, state
                ),
            )
        else:
            from orc_cfd.solver.simple import initial_flux

            state = _dc.replace(
                state,
                flux=initial_flux(mesh, zc, zs, zv, settings, state),
            )

    @jax.jit
    def run(state0, zc, zs, zv):
        def time_step(carry, _):
            s = carry
            vel_n = s.vel
            inertia = (rv_dt, vel_n)

            def inner(si, _):
                if use_fc:
                    if ck is not None:
                        from orc_cfd.solver.fc import ck_simple_step_fc

                        return ck_simple_step_fc(
                            mesh, ck, zc, zs, zv, settings, rho, mu,
                            ck_diff, si, solver_extras, inertia=inertia,
                            pallas_asm=pallas_asm,
                            maybe_singular=maybe_singular,
                        )
                    from orc_cfd.solver.fc import simple_step_fc

                    return simple_step_fc(
                        mesh, zc, zs, zv, settings, rho, mu, diff, si,
                        solver_extras, inertia=inertia,
                        maybe_singular=maybe_singular,
                    )
                if ck is not None:
                    return ck_simple_step(
                        mesh, ck, zc, zs, zv, settings, rho, mu, ck_diff,
                        si, solver_extras, inertia=inertia,
                        pallas_asm=pallas_asm,
                        maybe_singular=maybe_singular,
                    )
                return simple_step(
                    mesh, zc, zs, zv, settings, rho, mu, diff, si,
                    solver_extras, inertia=inertia,
                    maybe_singular=maybe_singular,
                )

            s2, metrics = lax.scan(inner, s, None, length=inner_iterations)
            last = jax.tree.map(lambda a: a[-1], metrics)
            return s2, last

        return lax.scan(time_step, state0, None, length=n_steps)

    t0 = time.perf_counter()
    state, metrics = run(state, zc, zs, zv)
    jax.block_until_ready(state)
    if verbose:
        dt_wall = time.perf_counter() - t0
        va = jax.device_get(metrics.vel_avg[-1])
        print(
            f"transient: {n_steps} steps x {inner_iterations} inner "
            f"iterations in {dt_wall:.2f}s; final avg velocity = "
            f"({va[0]:.2e}, {va[1]:.2e}, {va[2]:.2e})"
        )
    if check_divergence and bool(jax.device_get(jnp.any(metrics.diverged))):
        raise SolverDivergedError(n_steps)
    return state, metrics


def solve_transient_sharded(*args, **kw):
    """Multi-device implicit-Euler marching — see
    parallel/sharded.solve_transient_sharded (re-exported here so the
    transient surface parallels solve_steady / solve_steady_sharded)."""
    from orc_cfd.parallel.sharded import (
        solve_transient_sharded as _impl,
    )

    return _impl(*args, **kw)


def courant_numbers(mesh: CompiledMesh, table: BoundaryTable, vel, dt):
    """(avg, min, max) cell Courant numbers Co = dt * sum_f |u_f.n| A /
    (2 V) — the standard FV CFL estimate.

    A working implementation of the reference's dead stub
    (solver.rs:1229-1239, commented out with an empty loop body).
    Traceable; use it to pick `dt` for `solve_transient`.
    """
    from orc_cfd.ops.interpolation import face_flux
    from orc_cfd.ops.layout import take
    from orc_cfd.utils.settings import VelocityInterpolation

    zc, zs, zv = device_bc(table, dtype=mesh.dtype)
    fbc = face_bc(mesh, zc, zs, zv)
    flux = face_flux(mesh, fbc, vel, VelocityInterpolation.LINEAR)
    cf = mesh.cell_faces
    m = mesh.cell_face_mask
    outflow = jnp.where(
        m, jnp.abs(take(flux, cf)) * take(mesh.face_area, cf), 0.0
    )
    co = dt * jnp.sum(outflow, axis=1) / (2.0 * mesh.cell_volume)
    active = m.any(axis=1)
    inf = jnp.asarray(jnp.inf, co.dtype)
    return (
        jnp.sum(jnp.where(active, co, 0.0)) / jnp.sum(active),
        jnp.min(jnp.where(active, co, inf)),
        jnp.max(jnp.where(active, co, -inf)),
    )
