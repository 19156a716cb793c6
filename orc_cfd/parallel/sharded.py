"""Multi-device SIMPLE: shard_map over a 1-D device mesh.

Cells are partitioned (orc_cfd.parallel.partition); every [C]-indexed
array becomes a stacked [P, L] array sharded over the mesh axis. Inside
`shard_map` each device runs the *identical* single-device step code
(orc_cfd.solver.simple.simple_step) with a `ShardedComm` that:

- refreshes halo slots via `lax.ppermute` ring exchanges (ICI traffic),
- performs global reductions with `lax.psum`/`pmin`/`pmax` (BiCGSTAB
  dot products, residual norms, metrics, divergence flags).

This is the JAX-native equivalent of an NCCL/MPI layer (the reference
is single-threaded; SURVEY.md 2 specifies this as a required
first-class component of the rebuild).
"""

from __future__ import annotations

import time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from orc_cfd.mesh.zones import BoundaryTable
from orc_cfd.ops.assembly import diffusion_system
from orc_cfd.ops.fields import device_bc, face_bc
from orc_cfd.parallel.partition import Partition
from orc_cfd.solver.simple import (
    FlowState,
    SolverDivergedError,
    simple_step,
)
from orc_cfd.utils.settings import NumericalSettings, SolutionMethod

AXIS = "cells"


class ShardedComm:
    """Communication context used by simple_step inside shard_map."""

    def __init__(self, partition: Partition, send_idx, recv_idx):
        self.partition = partition
        self.send_idx = send_idx  # per-device rows, [s_d] each
        self.recv_idx = recv_idx

    def refresh(self, x):
        """Fill halo slots of x [L, ...] with owner-device values."""
        n = self.partition.n_parts
        for d, s_idx, r_idx in zip(
            self.partition.offsets, self.send_idx, self.recv_idx
        ):
            buf = x[s_idx]
            buf = lax.ppermute(
                buf, AXIS, perm=[(p, (p + d) % n) for p in range(n)]
            )
            x = x.at[r_idx].set(buf)
        return x

    def axis_sum(self, v):
        return lax.psum(v, AXIS)

    def axis_min(self, v):
        return lax.pmin(v, AXIS)

    def axis_max(self, v):
        if v.dtype == jnp.bool_:
            return lax.pmax(v.astype(jnp.int32), AXIS).astype(jnp.bool_)
        return lax.pmax(v, AXIS)


def scatter_tree(partition: Partition, tree):
    """Any pytree of global [C,...] arrays -> stacked local [P, L, ...]
    (host-side)."""
    og = np.asarray(partition.owned_global, dtype=np.int64)
    om = np.asarray(partition.owned_mask)
    Pn, L = og.shape

    def sc(arr):
        arr = np.asarray(arr)
        out = np.zeros((Pn, L) + arr.shape[1:], dtype=arr.dtype)
        out[om] = arr[og[om]]
        return jnp.asarray(out)

    return jax.tree.map(sc, tree)


def gather_tree(partition: Partition, tree, n_cells: int):
    """Pytree of stacked local [P, L, ...] arrays -> global [C, ...]
    (host-side)."""
    og = np.asarray(partition.owned_global, dtype=np.int64)
    om = np.asarray(partition.owned_mask)

    def ga(arr):
        arr = np.asarray(arr)
        out = np.zeros((n_cells,) + arr.shape[2:], dtype=arr.dtype)
        out[og[om]] = arr[om]
        return jnp.asarray(out)

    return jax.tree.map(ga, tree)


def scatter_state(partition: Partition, state: FlowState) -> FlowState:
    """Global FlowState [C] -> stacked local [P, L] (host-side). A
    stored flux (face-indexed, not cell-indexed) is dropped; the
    sharded FC runner re-seeds it per device from the fields."""
    import dataclasses as _dc

    if state.flux is not None:
        state = _dc.replace(state, flux=None)
    # scatter_tree partitions the LEADING axis; mom_diag is component-
    # major [3,C] (FlowState) — route it through cell-major and restore.
    state = _dc.replace(state, mom_diag=jnp.moveaxis(state.mom_diag, 0, -1))
    local = scatter_tree(partition, state)
    return _dc.replace(
        local, mom_diag=jnp.moveaxis(local.mom_diag, -1, 1)
    )


def gather_state(partition: Partition, local: FlowState, n_cells: int) -> FlowState:
    """Stacked local [P, L] -> global FlowState [C] (host-side).

    The stored SIMPLE_FC flux is FACE-indexed per partition (no global
    face numbering exists for the stacked locals) — it is dropped from
    the gathered state; solve_steady re-seeds it from the fields when a
    warm-started FC run needs one."""
    import dataclasses as _dc

    if local.flux is not None:
        local = _dc.replace(local, flux=None)
    # Inverse of scatter_state's mom_diag routing: [P,3,L] -> [P,L,3]
    # for the leading-axis gather, then back to component-major [3,C].
    local = _dc.replace(local, mom_diag=jnp.moveaxis(local.mom_diag, 1, -1))
    out = gather_tree(partition, local, n_cells)
    return _dc.replace(out, mom_diag=jnp.moveaxis(out.mom_diag, 0, -1))


def _refresh_state(comm, state):
    """State with halo slots refreshed — the FC initial flux reads
    neighbor values, so ghost slots must hold remote data first."""
    import dataclasses as _dcf

    import jax as _jax

    return _dcf.replace(
        state,
        vel=comm.refresh(state.vel),
        p=comm.refresh(state.p),
        # mom_diag is component-major [3,L] — refresh fills halo slots
        # along the leading cell axis, so map it over the components.
        mom_diag=_jax.vmap(comm.refresh)(state.mom_diag),
    )


def make_sharded_step(
    partition: Partition,
    settings: NumericalSettings,
    device_mesh: Mesh,
    n_steps: int = 1,
    use_ck: bool = False,
    n_zones: int = 0,
    mg_hierarchy=None,
    maybe_singular: bool = True,
    use_fc: bool = False,
    transient=None,  # (dt, inner_iterations) -> implicit time marching
    pallas_asm=None,  # static (cols, AsmSpec, interpret) -> fused kernels
):
    """Build the jitted shard_map'ed n-step SIMPLE runner.

    Returns run(local_state, zc, zs, zv, rho, mu) -> (state, metrics).

    `transient=(dt, inner_iterations)` switches the scan body from one
    SIMPLE iteration to one implicit-Euler TIME step (solver/transient
    semantics: inertia rho V/dt (phi - phi^n) in the momentum systems,
    `inner_iterations` SIMPLE iterations per step, metrics from each
    step's final inner iteration); `n_steps` then counts time steps.

    `use_ck=True` runs the gather-free (c,k)-direct step per device:
    the stacked per-partition CKGeometry is expanded once here (vmap
    over local meshes) and sharded alongside the mesh, and the step's
    neighbor shifts read ghost-layer slots refreshed by ppermute — the
    distributed SpMV/assembly stays on the roll path end-to-end when
    the partitioner preserved structured offsets (slab).

    `mg_hierarchy`: static geometric-multigrid levels built on the
    GLOBAL mesh (solver/gmg.py) — required for MULTIGRID runs. The
    fine-level smoother runs distributed; coarse corrections run
    replicated (gmg.gmg_solve_sharded)."""
    if settings.matrix_solver.solver_type == SolutionMethod.MULTIGRID:
        if not mg_hierarchy:
            raise ValueError(
                "sharded MULTIGRID needs a host-built hierarchy: "
                "solver/gmg.py (structured) or solver/amg.py (algebraic, "
                "built on the GLOBAL mesh)"
            )
    lm = partition.local_mesh

    stacked_ck = None
    if use_ck:
        from orc_cfd.ops.ck_ops import build_ck_geometry

        stacked_ck = jax.vmap(
            lambda m: build_ck_geometry(m, n_zones)
        )(lm)

    # Shard every stacked array's leading axis over the device mesh;
    # zone tables and scalars are replicated.
    shard = P(AXIS)
    repl = P()

    def step_fn(
        lmesh, ck, send_idx, recv_idx, owned, state, zc, zs, zv, rho, mu
    ):
        # shard_map delivers [1, ...] blocks: drop the part axis.
        sq = lambda t: jax.tree.map(lambda a: a[0], t)
        lmesh = sq(lmesh)
        send_idx = sq(send_idx)
        recv_idx = sq(recv_idx)
        state = sq(state)
        comm = ShardedComm(partition, send_idx, recv_idx)
        extras = {}
        if mg_hierarchy is not None:
            extras = dict(
                mg_hierarchy=mg_hierarchy, mg_owned=sq(owned)
            )
        if use_ck:
            from orc_cfd.ops.ck_ops import ck_bc, ck_diffusion
            from orc_cfd.solver.simple import ck_simple_step

            ck = sq(ck)
            bc = ck_bc(ck, zc, zs, zv)
            ck_diff = ck_diffusion(lmesh, ck, bc, mu)

            if use_fc:
                from orc_cfd.solver.fc import (
                    ck_initial_flux,
                    ck_simple_step_fc,
                )

                if state.flux is None:
                    import dataclasses as _dcf

                    state = _dcf.replace(
                        state,
                        flux=ck_initial_flux(
                            lmesh, ck, bc, settings,
                            _refresh_state(comm, state),
                        ),
                    )

                def step1(s, inertia):
                    return ck_simple_step_fc(
                        lmesh, ck, zc, zs, zv, settings, rho, mu, ck_diff,
                        s, extras, inertia=inertia, comm=comm,
                        pallas_asm=pallas_asm,
                        maybe_singular=maybe_singular,
                    )

            else:

                def step1(s, inertia):
                    return ck_simple_step(
                        lmesh, ck, zc, zs, zv, settings, rho, mu, ck_diff, s,
                        extras, inertia=inertia, comm=comm,
                        pallas_asm=pallas_asm,
                        maybe_singular=maybe_singular,
                    )

        else:
            fbc = face_bc(lmesh, zc, zs, zv)
            diff = diffusion_system(lmesh, fbc, mu)

            if use_fc:
                from orc_cfd.solver.fc import simple_step_fc
                from orc_cfd.solver.simple import initial_flux

                if state.flux is None:
                    import dataclasses as _dcf

                    state = _dcf.replace(
                        state,
                        flux=initial_flux(
                            lmesh, zc, zs, zv, settings,
                            _refresh_state(comm, state),
                        ),
                    )

                def step1(s, inertia):
                    return simple_step_fc(
                        lmesh, zc, zs, zv, settings, rho, mu, diff, s,
                        extras, inertia=inertia, comm=comm,
                        maybe_singular=maybe_singular,
                    )

            else:

                def step1(s, inertia):
                    return simple_step(
                        lmesh, zc, zs, zv, settings, rho, mu, diff, s,
                        extras, inertia=inertia, comm=comm,
                        maybe_singular=maybe_singular,
                    )

        if transient is not None:
            # Implicit-Euler time marching (solver/transient.py): the
            # unsteady rho V/dt (phi - phi^n) term is per-DEVICE data
            # (local cell volumes; halo/padding rows are masked inactive
            # by the assemblies).
            dt_t, inner_it = transient
            rv_dt = rho * lmesh.cell_volume / dt_t

            def body(s, _):
                inertia = (rv_dt, s.vel)
                s2, m = lax.scan(
                    lambda si, __: step1(si, inertia),
                    s, None, length=inner_it,
                )
                return s2, jax.tree.map(lambda a: a[-1], m)

            state, metrics = lax.scan(body, state, None, length=n_steps)
            add_axis0 = lambda t: jax.tree.map(lambda a: a[None], t)
            return add_axis0(state), metrics

        def body(s, _):
            return step1(s, None)

        # Kahan-compensated f32 state accumulation (same mechanism as
        # the single-device runner — see solver/simple._run_scan).
        use_comp = (
            settings.compensated_state
            and state.vel.dtype == jnp.float32
        )
        if use_comp:
            import dataclasses as _dc

            inner = body

            def body(carry, _):
                s, cv, cp = carry
                s2, metrics = inner(s, None)
                dv = (s2.vel - s.vel) + cv
                vel = s.vel + dv
                cv = dv - (vel - s.vel)
                dp = (s2.p - s.p) + cp
                p = s.p + dp
                cp = dp - (p - s.p)
                return (_dc.replace(s2, vel=vel, p=p), cv, cp), metrics

            (state, _, _), metrics = lax.scan(
                body,
                (state, jnp.zeros_like(state.vel), jnp.zeros_like(state.p)),
                None,
                length=n_steps,
            )
        else:
            state, metrics = lax.scan(body, state, None, length=n_steps)
        add_axis = lambda t: jax.tree.map(lambda a: a[None], t)
        return add_axis(state), metrics

    ck_spec = shard if stacked_ck is not None else repl
    mapped = jax.shard_map(
        step_fn,
        mesh=device_mesh,
        in_specs=(
            shard, ck_spec, shard, shard, shard, shard,
            repl, repl, repl, repl, repl,
        ),
        out_specs=(shard, repl),
        check_vma=False,
    )

    @jax.jit
    def run(local_state, zc, zs, zv, rho, mu):
        return mapped(
            lm,
            stacked_ck,
            partition.send_idx,
            partition.recv_idx,
            (partition.owned_mask, partition.owned_global),
            local_state,
            zc,
            zs,
            zv,
            rho,
            mu,
        )

    return run


def solve_steady_sharded(
    mesh,
    table: BoundaryTable,
    settings: NumericalSettings,
    rho: float,
    mu: float,
    state: Optional[FlowState] = None,
    iterations: int = 10,
    reporting_interval: int = 1,
    n_devices: Optional[int] = None,
    verbose: bool = True,
    check_divergence: bool = True,
    partition_method: str = "auto",
    use_ck: str | bool = "auto",
):
    """Multi-device drop-in for solve_steady: partitions the mesh over
    all available devices, runs the sharded SIMPLE loop, and returns the
    *global* FlowState plus metrics history.

    partition_method: "slab" (ghost layers, gather-free SpMV on
    structured meshes), "rcb", or "auto".

    use_ck: "auto" picks the gather-free (c,k)-direct step when the
    local partitions stayed on the structured-offset (roll) path and
    the settings are compatible (green_gauss_cell gradients, local
    size under the ck memory ceiling); True forces it; False forces
    the face-major step."""
    from orc_cfd.parallel.partition import partition_mesh
    from orc_cfd.solver.simple import CK_AUTO_MAX_CELLS, initial_state
    from orc_cfd.utils.settings import (
        GradientReconstruction,
        PressureVelocityCoupling,
    )

    use_fc = (
        settings.resolved_coupling()
        == PressureVelocityCoupling.SIMPLE_FC
    )

    table.validate_supported()
    devices = jax.devices()[: n_devices or len(jax.devices())]
    n = len(devices)
    device_mesh = Mesh(np.array(devices), (AXIS,))
    partition = partition_mesh(mesh, n, method=partition_method)
    reporting_interval = max(1, min(reporting_interval, iterations))

    ck_grad_ok = settings.gradient_reconstruction in (
        GradientReconstruction.GREEN_GAUSS_CELL,
        GradientReconstruction.LEAST_SQUARES,
    )
    if use_ck is True and not ck_grad_ok:
        raise ValueError(
            "use_ck=True requires green_gauss_cell or least_squares "
            f"gradients (the ck-direct step does not implement "
            f"{settings.gradient_reconstruction})"
        )
    n_local = partition.local_mesh.cell_volume.shape[1]
    if use_ck == "auto":
        use_ck = (
            ck_grad_ok
            and partition.local_mesh.neighbor_offsets is not None
            and n_local <= CK_AUTO_MAX_CELLS
        )

    zc, zs, zv = device_bc(table, dtype=mesh.dtype)
    if state is None:
        state = initial_state(mesh)
    local = scatter_state(partition, state)

    mg_h = None
    if settings.matrix_solver.solver_type == SolutionMethod.MULTIGRID:
        from orc_cfd.solver.gmg import build_gmg_hierarchy, infer_box_dims

        dims = (
            infer_box_dims(mesh.neighbor_offsets, mesh.n_cells)
            if mesh.neighbor_offsets is not None
            else None
        )
        if dims is not None:
            mg_h = build_gmg_hierarchy(
                dims, mesh.neighbor_offsets, settings.matrix_solver
            )
        else:
            # Irregular mesh: algebraic hierarchy built on the GLOBAL
            # mesh; level-0 restriction/Galerkin assemble from owned
            # rows + psum (amg.multigrid_solve_sharded).
            from orc_cfd.ops.fields import device_bc as _dbc
            from orc_cfd.ops.fields import face_bc as _fbc
            from orc_cfd.ops.assembly import diffusion_system as _dsys
            from orc_cfd.solver.amg import build_hierarchy

            _z = _dbc(table, mesh.dtype)
            mg_h = build_hierarchy(
                mesh,
                _dsys(mesh, _fbc(mesh, *_z), jnp.asarray(mu, mesh.dtype)),
                settings.matrix_solver,
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
    # Fused assembly kernels per device: the column constants come from
    # the GLOBAL uniform box (slab-local offsets/geometry are
    # identical); per-cell boundary flags come from the local ck masks
    # inside the step.
    from orc_cfd.solver.simple import _pallas_asm_spec

    pallas_asm = (
        _pallas_asm_spec(
            mesh, table, settings, ck=use_ck or None, fc=use_fc,
            sharded=True,
        )
        if use_ck and partition.local_mesh.neighbor_offsets is not None
        else None
    )
    run = make_sharded_step(
        partition, settings, device_mesh, n_steps=reporting_interval,
        use_ck=bool(use_ck), n_zones=len(table.zone_ids), mg_hierarchy=mg_h,
        maybe_singular=maybe_singular, use_fc=use_fc,
        pallas_asm=pallas_asm,
    )
    history = []
    done = 0
    t0 = time.perf_counter()
    while done < iterations:
        k = min(reporting_interval, iterations - done)
        if k != reporting_interval:
            run = make_sharded_step(
                partition, settings, device_mesh, n_steps=k,
                use_ck=bool(use_ck), n_zones=len(table.zone_ids),
                mg_hierarchy=mg_h, maybe_singular=maybe_singular,
                use_fc=use_fc, pallas_asm=pallas_asm,
            )
        local, metrics = run(local, zc, zs, zv, rho, mu)
        jax.block_until_ready(local)
        done += k
        history.append(metrics)
        if verbose:
            dt_ms = (time.perf_counter() - t0) * 1e3 / k
            t0 = time.perf_counter()
            va = jax.device_get(metrics.vel_avg[-1])
            print(
                f"[{n} devices] Iteration {done}: avg velocity = "
                f"({va[0]:.2e}, {va[1]:.2e}, {va[2]:.2e})\t"
                f"vel corr = {float(metrics.vel_corr_norm[-1]):.2e}\t"
                f"p corr = {float(metrics.p_corr_norm[-1]):.2e}\t"
                f"ms/iter = {dt_ms:.3g}"
            )
        if check_divergence and bool(jax.device_get(jnp.any(metrics.diverged))):
            raise SolverDivergedError(done)
    return gather_state(partition, local, mesh.n_cells), history


def solve_transient_sharded(
    mesh,
    table: BoundaryTable,
    settings: NumericalSettings,
    rho: float,
    mu: float,
    dt: float,
    n_steps: int,
    inner_iterations: int = 20,
    state: Optional[FlowState] = None,
    n_devices: Optional[int] = None,
    verbose: bool = True,
    check_divergence: bool = True,
    partition_method: str = "auto",
    use_ck: str | bool = "auto",
    report_interval: int = 0,
):
    """Multi-device drop-in for solver/transient.solve_transient:
    implicit-Euler time marching under `shard_map` — per-device inertia
    from local cell volumes, ghost-layer refresh before every neighbor
    shift, psum'd reductions in all solves. Returns the *global*
    FlowState at t = n_steps*dt plus per-time-step metrics (each step's
    final inner iteration), gathered over reporting chunks."""
    from orc_cfd.parallel.partition import partition_mesh
    from orc_cfd.solver.simple import (
        CK_AUTO_MAX_CELLS,
        initial_state,
        table_has_pressure_bc,
        table_maybe_singular,
    )
    from orc_cfd.utils.settings import (
        GradientReconstruction,
        PressureVelocityCoupling,
    )

    table.validate_supported()
    use_fc = (
        settings.resolved_coupling()
        == PressureVelocityCoupling.SIMPLE_FC
    )
    devices = jax.devices()[: n_devices or len(jax.devices())]
    n = len(devices)
    device_mesh = Mesh(np.array(devices), (AXIS,))
    partition = partition_mesh(mesh, n, method=partition_method)

    ck_grad_ok = settings.gradient_reconstruction in (
        GradientReconstruction.GREEN_GAUSS_CELL,
        GradientReconstruction.LEAST_SQUARES,
    )
    n_local = partition.local_mesh.cell_volume.shape[1]
    if use_ck == "auto":
        use_ck = (
            ck_grad_ok
            and partition.local_mesh.neighbor_offsets is not None
            and n_local <= CK_AUTO_MAX_CELLS
        )

    zc, zs, zv = device_bc(table, dtype=mesh.dtype)
    if state is None:
        state = initial_state(mesh)
    local = scatter_state(partition, state)

    mg_h = None
    if settings.matrix_solver.solver_type == SolutionMethod.MULTIGRID:
        from orc_cfd.solver.gmg import build_gmg_hierarchy, infer_box_dims

        dims = (
            infer_box_dims(mesh.neighbor_offsets, mesh.n_cells)
            if mesh.neighbor_offsets is not None
            else None
        )
        if dims is not None:
            mg_h = build_gmg_hierarchy(
                dims, mesh.neighbor_offsets, settings.matrix_solver
            )
        else:
            from orc_cfd.ops.assembly import diffusion_system as _dsys
            from orc_cfd.ops.fields import face_bc as _fbc
            from orc_cfd.solver.amg import build_hierarchy

            mg_h = build_hierarchy(
                mesh,
                _dsys(
                    mesh, _fbc(mesh, zc, zs, zv), jnp.asarray(mu, mesh.dtype)
                ),
                settings.matrix_solver,
            )

    maybe_singular = (
        not table_has_pressure_bc(table)
        if use_fc
        else table_maybe_singular(table)
    )
    from orc_cfd.solver.simple import _pallas_asm_spec

    pallas_asm = (
        _pallas_asm_spec(
            mesh, table, settings, ck=use_ck or None, fc=use_fc,
            sharded=True,
        )
        if use_ck and partition.local_mesh.neighbor_offsets is not None
        else None
    )
    chunk = n_steps if report_interval <= 0 else min(report_interval, n_steps)

    def make_run(k):
        return make_sharded_step(
            partition, settings, device_mesh, n_steps=k,
            use_ck=bool(use_ck), n_zones=len(table.zone_ids),
            mg_hierarchy=mg_h, maybe_singular=maybe_singular,
            use_fc=use_fc, transient=(dt, inner_iterations),
            pallas_asm=pallas_asm,
        )

    run = make_run(chunk)
    history = []
    done = 0
    t0 = time.perf_counter()
    while done < n_steps:
        k = min(chunk, n_steps - done)
        if k != chunk:
            run = make_run(k)
        local, metrics = run(local, zc, zs, zv, rho, mu)
        jax.block_until_ready(local)
        done += k
        history.append(metrics)
        if verbose:
            va = jax.device_get(metrics.vel_avg[-1])
            dt_ms = (time.perf_counter() - t0) * 1e3 / k
            t0 = time.perf_counter()
            print(
                f"[{n} devices] t = {done * dt:.4g} ({done} steps): avg "
                f"velocity = ({va[0]:.2e}, {va[1]:.2e}, {va[2]:.2e})  "
                f"ms/step = {dt_ms:.3g}"
            )
        if check_divergence and bool(
            jax.device_get(jnp.any(metrics.diverged))
        ):
            raise SolverDivergedError(done)
    metrics = jax.tree.map(
        lambda *xs: jnp.concatenate(xs), *history
    ) if len(history) > 1 else history[0]
    return gather_state(partition, local, mesh.n_cells), metrics
