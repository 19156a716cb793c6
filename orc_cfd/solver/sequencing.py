"""Mesh sequencing (grid continuation) for steady solves.

Cold-started steady SIMPLE on a fine structured grid spends O(1e5)
outer iterations spinning up large-scale flow structures — the
effective pseudo-timestep shrinks with cell size, so global modes
develop at O(n) iterations per grid doubling. The standard production
remedy is to converge the flow on a coarse grid first and prolong it
up a cascade of refinements, finishing with a modest number of
fine-grid iterations (measured: a 1M-cell cavity reaches in ~4 minutes
a state that a cold start does not approach in 30k iterations —
scripts/cavity_ghia_1m.py).

Pure host-side orchestration over `solve_steady`: builds each level's
mesh with the user's `case_builder`, prolongs the state with
piecewise-constant upsampling (exactly the GMG prolongation operator,
applied across meshes on host), and reuses all of the solver's jitted
machinery per level. No reference counterpart (the reference has no
notion of mesh refinement).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from orc_cfd.solver.simple import FlowState, initial_state, solve_steady


def upsample_field(arr, dims_from: Tuple[int, int, int],
                   dims_to: Tuple[int, int, int]):
    """Piecewise-constant prolongation of a [C(,d)] cell field between
    structured boxes (cell id = i + nx*(j + ny*k)); each target dim
    must be an integer multiple of its source dim."""
    a = np.asarray(arr)
    feat = a.shape[1:]
    nxf, nyf, nzf = dims_from
    nxt, nyt, nzt = dims_to
    if a.shape[0] != nxf * nyf * nzf:
        raise ValueError(
            f"field has {a.shape[0]} cells, dims_from gives "
            f"{nxf * nyf * nzf}"
        )
    for t, f in zip(dims_to, dims_from):
        if t % f:
            raise ValueError(
                f"target dims {dims_to} must be multiples of source "
                f"dims {dims_from}"
            )
    a = a.reshape(nzf, nyf, nxf, *feat)
    a = np.repeat(a, nzt // nzf, axis=0)
    a = np.repeat(a, nyt // nyf, axis=1)
    a = np.repeat(a, nxt // nxf, axis=2)
    return jnp.asarray(a.reshape((nxt * nyt * nzt,) + feat))


def prolong_state(state: FlowState, dims_from, dims_to) -> FlowState:
    return FlowState(
        vel=upsample_field(state.vel, dims_from, dims_to),
        p=upsample_field(state.p, dims_from, dims_to),
        # mom_diag is component-major [3,C] (FlowState) — upsample the
        # cell axis, then restore the layout.
        mom_diag=jnp.moveaxis(
            upsample_field(
                jnp.moveaxis(state.mom_diag, 0, -1), dims_from, dims_to
            ),
            -1,
            0,
        ),
    )


def solve_steady_sequenced(
    case_builder: Callable,
    dims_schedule: Sequence[Tuple[int, int, int]],
    settings,
    rho: float,
    mu: float,
    iterations_per_level: int = 4000,
    final_iterations: Optional[int] = None,
    reporting_interval: int = 1000,
    verbose: bool = True,
    **solve_kwargs,
):
    """Run the steady solve up a grid cascade.

    `case_builder(nx, ny, nz) -> (mesh, table)` constructs each level
    (e.g. a closure over models.cavity.cavity_case or
    mesh.generate.structured_box_mesh + BC setup); `dims_schedule` is
    coarse -> fine, each dim an integer multiple of the previous.
    Returns (FlowState on the finest grid, per-level history list).
    """
    if final_iterations is None:
        final_iterations = iterations_per_level
    state = None
    histories = []
    prev_dims = None
    for li, dims in enumerate(dims_schedule):
        mesh, table = case_builder(*dims)
        if state is None:
            state = initial_state(mesh)
        else:
            state = prolong_state(state, prev_dims, dims)
        iters = (
            final_iterations
            if li + 1 == len(dims_schedule)
            else iterations_per_level
        )
        if verbose:
            print(f"[sequenced] level {dims}: {iters} iterations")
        state, h = solve_steady(
            mesh, table, settings, rho, mu,
            state=state, iterations=iters,
            reporting_interval=min(reporting_interval, iters),
            verbose=verbose, **solve_kwargs,
        )
        histories.append(h)
        prev_dims = dims
    return state, histories
