"""Standard k-epsilon turbulence model (high-Re, wall functions).

The reference *declares* `TurbulenceModel::StandardKEpsilon` and a
commented-out assembly signature but implements nothing
(lib.rs:164-168, solver.rs:1152-1167, roadmap README.md:44). This is a
working implementation on the gather-free (c,k)-direct path:

- transport equations for k and epsilon with UD advection, variable
  face diffusivity (mu + mu_t/sigma), implicit destruction terms;
- turbulent viscosity mu_t = rho C_mu k^2/eps coupled into the momentum
  diffusion (rebuilt per outer iteration);
- standard equilibrium wall functions: log-law effective wall viscosity
  for momentum, production/dissipation overrides in wall-adjacent
  cells, fixed eps_P = C_mu^{3/4} k^{3/2}/(kappa y_p);
- inlet k/eps from turbulence intensity + length scale.

Validated quantitatively on the Re_tau=590 body-force-driven
streamwise-periodic channel (tests/test_turbulence.py::
test_channel_re_tau_590): U_b+ within 5% of the Moser-Kim-Mansour DNS
(19.4 vs 18.5), centerline U_c+ within 2% (21.7 vs 21.26),
wall-adjacent cell on the log law to ~1%, wall-adjacent k at the
equilibrium 1/sqrt(C_mu) to ~3%.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from orc_cfd.mesh.compile import CompiledMesh
from orc_cfd.ops.ck_ops import (
    CKBC,
    CKGeometry,
    build_ck_geometry,
    ck_bc,
    ck_diffusion,
    ck_velocity_gradient,
    nbr_values,
)
from orc_cfd.ops.spmv import EllMatrix
from orc_cfd.solver.krylov import iterative_solve
from orc_cfd.solver.simple import FlowState, ck_simple_step, initial_state
from orc_cfd.utils.settings import (
    MatrixSolverSettings,
    NumericalSettings,
)

C_MU = 0.09
C_1 = 1.44
C_2 = 1.92
SIGMA_K = 1.0
SIGMA_E = 1.3
KAPPA = 0.41
E_WALL = 9.793
YPLUS_LAM = 11.25  # viscous/log-layer crossover


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TurbState:
    k: jax.Array  # [C] turbulent kinetic energy
    eps: jax.Array  # [C] dissipation rate
    mu_t: jax.Array  # [C] eddy viscosity


def initial_turbulence(
    mesh: CompiledMesh, u_ref: float, intensity: float, length_scale: float,
    rho: float,
) -> TurbState:
    k0 = 1.5 * (intensity * max(abs(u_ref), 1e-12)) ** 2
    e0 = C_MU ** 0.75 * k0 ** 1.5 / max(length_scale, 1e-12)
    C = mesh.n_cells
    dt = mesh.dtype
    k = jnp.full((C,), k0, dt)
    eps = jnp.full((C,), e0, dt)
    return TurbState(k=k, eps=eps, mu_t=rho * C_MU * k * k / eps)


def _strain_sq(grad_vel):
    """S^2 = 2 S_ij S_ij from the velocity-gradient tensor [C,3,3]."""
    s = 0.5 * (grad_vel + jnp.swapaxes(grad_vel, -1, -2))
    return 2.0 * jnp.sum(s * s, axis=(-1, -2))


def _wall_adjacent(ck: CKGeometry, bc: CKBC):
    """(has_wall [C], y_p [C]) — distance to the nearest wall face of
    wall-adjacent cells (1 where none)."""
    from orc_cfd.ops.fields import WALL

    is_wall = (bc.code == WALL) & ck.mask & ~ck.interior
    has_wall = is_wall.any(axis=1)
    y = jnp.where(is_wall, ck.dist_fo, jnp.inf).min(axis=1)
    return has_wall, jnp.where(has_wall, y, 1.0)


def wall_viscosity(k, y_p, has_wall, rho, mu):
    """Log-law effective wall viscosity for the momentum wall flux."""
    u_star = C_MU ** 0.25 * jnp.sqrt(jnp.maximum(k, 1e-30))
    y_plus = rho * u_star * y_p / mu
    mu_log = rho * u_star * KAPPA * y_p / jnp.log(E_WALL * jnp.maximum(y_plus, 1.06))
    mu_w = jnp.where(y_plus > YPLUS_LAM, mu_log, mu)
    return jnp.where(has_wall, jnp.maximum(mu_w, mu), mu)


def ck_scalar_system(
    mesh, ck: CKGeometry, bc: CKBC, F, gamma_ck, diag_src, b_src,
    inlet_value,
):
    """UD advection-diffusion system for a turbulence scalar.

    gamma_ck: [C,K] face diffusivity. Walls/symmetry/outlets get zero
    flux; velocity & pressure inlets get Dirichlet `inlet_value`.
    """
    a_nb = jnp.where(ck.mask, jnp.minimum(F, 0.0), 0.0)
    a_p_adv = jnp.sum(jnp.where(ck.mask, -a_nb + F, 0.0), axis=1)

    from orc_cfd.ops.fields import PRESSURE_INLET, VELOCITY_INLET

    is_inlet = (
        ((bc.code == VELOCITY_INLET) | (bc.code == PRESSURE_INLET))
        & ck.mask
        & ~ck.interior
    )
    d_int = jnp.where(ck.interior, gamma_ck * ck.area / ck.dist_on, 0.0)
    d_in = jnp.where(is_inlet, gamma_ck * ck.area / ck.dist_fo, 0.0)
    diag = a_p_adv + jnp.sum(d_int + d_in, axis=1) + diag_src
    off = jnp.where(ck.interior, a_nb - d_int, 0.0)
    b = b_src + jnp.sum(d_in, axis=1) * inlet_value
    # UD inlet advection: a_nb=min(F,0) at inlet faces contributes
    # -a_nb*phi_in to the RHS (inflow F<0).
    b = b - jnp.sum(jnp.where(is_inlet, a_nb, 0.0), axis=1) * inlet_value

    active = ck.mask.any(axis=1)
    diag = jnp.where(active, diag, 1.0)
    b = jnp.where(active, b, 0.0)
    return (
        EllMatrix(
            diag=diag,
            off=off,
            # The shift path never reads `neighbors`; omitting it for
            # structured meshes prunes the [C,K] table from the jitted
            # executable's arguments (less per-dispatch layout work).
            neighbors=(
                None
                if mesh.neighbor_offsets is not None
                else mesh.cell_neighbors
            ),
            offsets=mesh.neighbor_offsets,
            plan=mesh.slice_plan,
        ),
        b,
    )


def turbulence_step(
    mesh, ck: CKGeometry, bc: CKBC, settings: NumericalSettings,
    rho, mu, flow: FlowState, turb: TurbState,
    k_in, eps_in, relax=0.7, comm=None, solver_extras=None,
):
    """One k/eps update given the current flow field. Runs unchanged
    under `shard_map` (like ck_simple_step): `comm.refresh` fills
    ghost-layer slots before every neighbor shift, and the scalar
    solves route their reductions through `comm`."""
    from orc_cfd.ops.ck_ops import ck_flux
    from orc_cfd.solver.simple import NullComm
    from orc_cfd.utils.settings import VelocityInterpolation

    comm = comm or NullComm()
    solver_extras = solver_extras or {}
    vel = comm.refresh(flow.vel)
    vel_nbr = nbr_values(mesh, vel, ck.interior)
    grad_v = ck_velocity_gradient(mesh, ck, bc, vel, vel_nbr=vel_nbr)
    flux = ck_flux(
        mesh, ck, bc, vel, VelocityInterpolation.LINEAR_WEIGHTED,
        vel_nbr=vel_nbr,
    )
    F = flux * ck.area * rho
    vol = mesh.cell_volume
    has_wall, y_p = _wall_adjacent(ck, bc)

    k = jnp.maximum(comm.refresh(turb.k), 1e-30)
    eps = jnp.maximum(comm.refresh(turb.eps), 1e-30)
    mu_t = comm.refresh(turb.mu_t)
    mu_t_f = mu + 0.5 * (mu_t[:, None] + nbr_values(mesh, mu_t, ck.interior))

    # Production: interior P_k = mu_t S^2; wall-adjacent cells use the
    # equilibrium wall-function form tau_w * u_star / (kappa y_p).
    s2 = _strain_sq(grad_v)
    p_k = mu_t * s2
    mu_w = wall_viscosity(k, y_p, has_wall, rho, mu)
    # Tangential cell velocity magnitude (wall velocity ~ 0 assumed for
    # the production estimate).
    u_mag = jnp.sqrt(jnp.sum(vel**2, axis=-1))
    tau_w = mu_w * u_mag / y_p
    u_star = C_MU ** 0.25 * jnp.sqrt(k)
    p_k_wall = tau_w * u_star / (KAPPA * y_p)
    p_k = jnp.where(has_wall, p_k_wall, p_k)

    # --- k equation ---
    gamma_k = mu + (mu_t_f - mu) / SIGMA_K
    diag_src_k = rho * eps / k * vol  # implicit destruction
    b_src_k = p_k * vol
    A_k, b_k = ck_scalar_system(
        mesh, ck, bc, F, gamma_k, diag_src_k, b_src_k, k_in
    )
    # Inactive rows (halo slots in sharded runs) are identity rows with
    # b=0, so the warm start must be ZERO there: a nonzero ghost x0
    # leaves a spurious per-ghost residual that inflates the global
    # Krylov dots (measured: r0 0.73 -> 6.0 on a 4-device channel, and
    # a 78% sharded-vs-single k difference after one partial solve).
    # The momentum solve already masks its x0 (simple.py solve paths).
    active = ck.mask.any(axis=1)
    k_sol, _ = iterative_solve(
        A_k, b_k, jnp.where(active, k, 0.0),
        settings.momentum_matrix_solver(),
        axis_sum=comm.axis_sum, refresh=comm.refresh, **solver_extras,
    )
    k_new = jnp.maximum(k + relax * (k_sol - k), 1e-30)

    # --- epsilon equation ---
    gamma_e = mu + (mu_t_f - mu) / SIGMA_E
    diag_src_e = C_2 * rho * eps / k * vol
    b_src_e = C_1 * (eps / k) * p_k * vol
    A_e, b_e = ck_scalar_system(
        mesh, ck, bc, F, gamma_e, diag_src_e, b_src_e, eps_in
    )
    # Wall-adjacent cells: fix eps to the equilibrium value.
    eps_wall = C_MU ** 0.75 * k_new ** 1.5 / (KAPPA * y_p)
    A_e = EllMatrix(
        diag=jnp.where(has_wall, 1.0, A_e.diag),
        off=jnp.where(has_wall[:, None], 0.0, A_e.off),
        neighbors=A_e.neighbors,
        offsets=A_e.offsets,
        plan=A_e.plan,
    )
    b_e = jnp.where(has_wall, eps_wall, b_e)
    e_sol, _ = iterative_solve(
        A_e, b_e, jnp.where(active, eps, 0.0),
        settings.momentum_matrix_solver(),
        axis_sum=comm.axis_sum, refresh=comm.refresh, **solver_extras,
    )
    eps_new = jnp.maximum(eps + relax * (e_sol - eps), 1e-30)

    mu_t_new = rho * C_MU * k_new * k_new / eps_new
    mu_t_new = jnp.clip(mu_t_new, 0.0, 1e5 * mu)
    return TurbState(k=k_new, eps=eps_new, mu_t=mu_t_new), mu_w


def rans_outer_step(
    mesh, ckg, bc0, zc, zs, zv, settings, rho, mu,
    k_in, eps_in, has_wall, y_p, is_wall_face, carry, comm=None,
    solver_extras=None,
):
    """One RANS outer iteration: SIMPLE step with mu_eff = mu + mu_t
    (log-law wall viscosity on wall faces), then one k/eps update.
    Shared by the single-device and sharded drivers (comm hooks)."""
    from orc_cfd.solver.simple import NullComm

    comm = comm or NullComm()
    flow, tb = carry
    mu_t = comm.refresh(tb.mu_t)
    mu_t_f = 0.5 * (mu_t[:, None] + nbr_values(mesh, mu_t, ckg.interior))
    mu_w = wall_viscosity(tb.k, y_p, has_wall, rho, mu)
    gamma = jnp.where(
        ckg.interior,
        mu + mu_t_f,
        jnp.where(is_wall_face, mu_w[:, None], mu + mu_t[:, None]),
    )
    ck_diff = ck_diffusion(mesh, ckg, bc0, gamma)
    # RANS runs always have wall zones (the wall-function machinery
    # requires them), so the parity p' system is statically anchored;
    # the FC full-p system anchors only through pressure zones —
    # body-force channels have none, so FC solves deflated
    # (maybe_singular=True is always safe; it is exact for anchored
    # systems too and the RANS loop is not the perf-critical path).
    from orc_cfd.utils.settings import PressureVelocityCoupling

    if (
        settings.resolved_coupling()
        == PressureVelocityCoupling.SIMPLE_FC
    ):
        from orc_cfd.solver.fc import ck_simple_step_fc

        flow2, metrics = ck_simple_step_fc(
            mesh, ckg, zc, zs, zv, settings, rho, mu, ck_diff, flow,
            solver_extras, comm=comm, maybe_singular=True,
        )
    else:
        flow2, metrics = ck_simple_step(
            mesh, ckg, zc, zs, zv, settings, rho, mu, ck_diff, flow,
            solver_extras, comm=comm, maybe_singular=False,
        )
    tb2, _ = turbulence_step(
        mesh, ckg, bc0, settings, rho, mu, flow2, tb, k_in, eps_in,
        comm=comm, solver_extras=solver_extras,
    )
    return (flow2, tb2), metrics


def solve_steady_turbulent(
    mesh: CompiledMesh,
    table,
    settings: NumericalSettings,
    rho: float,
    mu: float,
    u_ref: float,
    iterations: int = 500,
    reporting_interval: int = 100,
    intensity: float = 0.05,
    length_scale: float = 0.1,
    state: Optional[FlowState] = None,
    turb: Optional[TurbState] = None,
    verbose: bool = True,
):
    """Steady RANS loop: each outer iteration runs one SIMPLE step with
    mu_eff = mu + mu_t (wall faces use the log-law wall viscosity),
    then one k/eps update. Single-device, (c,k)-direct path."""
    import time

    from orc_cfd.ops.fields import WALL, device_bc

    table.validate_supported()
    zc, zs, zv = device_bc(table, dtype=mesh.dtype)
    ckg = build_ck_geometry(mesh, len(table.zone_ids))
    bc0 = ck_bc(ckg, zc, zs, zv)
    if state is None:
        state = initial_state(mesh)
    from orc_cfd.utils.settings import PressureVelocityCoupling

    if (
        settings.resolved_coupling()
        == PressureVelocityCoupling.SIMPLE_FC
        and state.flux is None
    ):
        import dataclasses as _dc

        from orc_cfd.solver.fc import ck_initial_flux

        state = _dc.replace(
            state, flux=ck_initial_flux(mesh, ckg, bc0, settings, state)
        )
    if turb is None:
        turb = initial_turbulence(mesh, u_ref, intensity, length_scale, rho)
    k_in = 1.5 * (intensity * abs(u_ref)) ** 2
    eps_in = C_MU ** 0.75 * k_in ** 1.5 / length_scale
    has_wall, y_p = _wall_adjacent(ckg, bc0)
    is_wall_face = (bc0.code == WALL) & ckg.mask & ~ckg.interior

    # Solver machinery the step can't build under jit (mirrors
    # solve_steady): the multigrid hierarchy / Gauss-Seidel coloring.
    # The AMG fallback needs the face-major diffusion system only for
    # its aggregation STRUCTURE — the laminar-mu coupling is fine even
    # though the RANS gamma varies per iteration (Galerkin values are
    # recomputed from the actual matrix every solve).
    from orc_cfd.utils.settings import SolutionMethod

    solver_extras = {}
    if settings.matrix_solver.solver_type == SolutionMethod.MULTIGRID:
        from orc_cfd.solver.gmg import build_mg_hierarchy

        diff = None
        from orc_cfd.solver.gmg import infer_box_dims

        if mesh.neighbor_offsets is None or (
            infer_box_dims(mesh.neighbor_offsets, mesh.n_cells) is None
        ):
            from orc_cfd.ops.assembly import diffusion_system
            from orc_cfd.ops.fields import face_bc

            fbc = face_bc(mesh, zc, zs, zv)
            diff = diffusion_system(mesh, fbc, jnp.asarray(mu, mesh.dtype))
        solver_extras = dict(
            mg_hierarchy=build_mg_hierarchy(mesh, diff, settings)
        )
    elif settings.matrix_solver.solver_type == SolutionMethod.GAUSS_SEIDEL:
        from orc_cfd.solver.coloring import greedy_coloring

        colors, n_colors = greedy_coloring(mesh)
        solver_extras = dict(colors=colors, n_colors=n_colors)

    def step(carry, _):
        return rans_outer_step(
            mesh, ckg, bc0, zc, zs, zv, settings, rho, mu,
            k_in, eps_in, has_wall, y_p, is_wall_face, carry,
            solver_extras=solver_extras,
        )

    run = jax.jit(
        lambda carry, n: lax.scan(step, carry, None, length=n),
        static_argnums=1,
    )
    carry = (state, turb)
    history = []
    done = 0
    t0 = time.perf_counter()
    reporting_interval = max(1, min(reporting_interval, iterations))
    while done < iterations:
        n = min(reporting_interval, iterations - done)
        carry, metrics = run(carry, n)
        jax.block_until_ready(carry)
        done += n
        history.append(metrics)
        if verbose:
            va = jax.device_get(metrics.vel_avg[-1])
            dt_ms = (time.perf_counter() - t0) * 1e3 / n
            t0 = time.perf_counter()
            print(
                f"[k-eps] iter {done}: avg velocity = ({va[0]:.2e}, "
                f"{va[1]:.2e}, {va[2]:.2e})  "
                f"mu_t/mu max = {float(jnp.max(carry[1].mu_t))/mu:.1f}  "
                f"ms/iter = {dt_ms:.3g}"
            )
    flow, tb = carry
    return flow, tb, history


def solve_steady_turbulent_sharded(
    mesh: CompiledMesh,
    table,
    settings: NumericalSettings,
    rho: float,
    mu: float,
    u_ref: float,
    iterations: int = 500,
    reporting_interval: int = 100,
    intensity: float = 0.05,
    length_scale: float = 0.1,
    state: Optional[FlowState] = None,
    turb: Optional[TurbState] = None,
    n_devices: Optional[int] = None,
    partition_method: str = "auto",
    verbose: bool = True,
    check_divergence: bool = True,
):
    """Multi-device RANS: the same outer step as solve_steady_turbulent
    under `shard_map` — per-device ck geometry, ppermute ghost-layer
    refresh before every neighbor shift (flow AND k/eps/mu_t fields),
    psum'd reductions in all four solves. Returns global
    (FlowState, TurbState, history)."""
    import time

    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P

    from orc_cfd.ops.fields import WALL, device_bc
    from orc_cfd.parallel.partition import partition_mesh
    from orc_cfd.parallel.sharded import (
        AXIS,
        ShardedComm,
        gather_tree,
        scatter_tree,
    )
    from orc_cfd.solver.simple import CK_AUTO_MAX_CELLS, SolverDivergedError
    from orc_cfd.utils.settings import GradientReconstruction, SolutionMethod

    table.validate_supported()
    if settings.matrix_solver.solver_type == SolutionMethod.MULTIGRID:
        raise NotImplementedError(
            "sharded RANS does not plumb the multigrid coarse-grid "
            "ownership data yet; use BICGSTAB/JACOBI for distributed "
            "turbulent runs (single-device RANS supports MULTIGRID)"
        )
    if (
        settings.gradient_reconstruction
        == GradientReconstruction.GREEN_GAUSS_NODE
    ):
        raise ValueError(
            "the ck-direct RANS step does not implement node-based "
            "Green-Gauss gradients"
        )
    devices = jax.devices()[: n_devices or len(jax.devices())]
    n = len(devices)
    device_mesh = Mesh(np.array(devices), (AXIS,))
    partition = partition_mesh(mesh, n, method=partition_method)
    lm = partition.local_mesh
    if lm.cell_volume.shape[1] > CK_AUTO_MAX_CELLS:
        raise ValueError(
            "per-device partition exceeds the ck geometry ceiling "
            f"({lm.cell_volume.shape[1]} > {CK_AUTO_MAX_CELLS}); use "
            "more devices"
        )
    from orc_cfd.utils.settings import PressureVelocityCoupling

    use_fc = (
        settings.resolved_coupling()
        == PressureVelocityCoupling.SIMPLE_FC
    )
    n_zones = len(table.zone_ids)
    stacked_ck = jax.vmap(lambda m: build_ck_geometry(m, n_zones))(lm)

    zc, zs, zv = device_bc(table, dtype=mesh.dtype)
    if state is None:
        state = initial_state(mesh)
    if state.flux is not None:
        # Per-device [C,K] fluxes are re-seeded inside shard_map (like
        # the laminar sharded FC runner, parallel/sharded.py) — the
        # global flux's halo rows would be stale after scattering.
        state = dataclasses.replace(state, flux=None)
    if turb is None:
        turb = initial_turbulence(mesh, u_ref, intensity, length_scale, rho)
    k_in = 1.5 * (intensity * abs(u_ref)) ** 2
    eps_in = C_MU ** 0.75 * k_in ** 1.5 / length_scale
    # scatter_tree partitions the LEADING axis; FlowState.mom_diag is
    # component-major [3,C] — route it through cell-major and restore
    # (same dance as parallel.sharded.scatter_state).
    state = dataclasses.replace(
        state, mom_diag=jnp.moveaxis(state.mom_diag, 0, -1)
    )
    local = scatter_tree(partition, (state, turb))
    local = (
        dataclasses.replace(
            local[0], mom_diag=jnp.moveaxis(local[0].mom_diag, -1, 1)
        ),
        local[1],
    )

    reporting_interval = max(1, min(reporting_interval, iterations))

    def make_run(n_steps):
        def step_fn(lmesh, ck, send_idx, recv_idx, carry, zc, zs, zv):
            sq = lambda t: jax.tree.map(lambda a: a[0], t)
            lmesh = sq(lmesh)
            ck = sq(ck)
            comm = ShardedComm(partition, sq(send_idx), sq(recv_idx))
            carry = sq(carry)
            bc0 = ck_bc(ck, zc, zs, zv)
            has_wall, y_p = _wall_adjacent(ck, bc0)
            is_wall_face = (bc0.code == WALL) & ck.mask & ~ck.interior
            if use_fc and carry[0].flux is None:
                from orc_cfd.parallel.sharded import _refresh_state
                from orc_cfd.solver.fc import ck_initial_flux

                seeded = dataclasses.replace(
                    carry[0],
                    flux=ck_initial_flux(
                        lmesh, ck, bc0, settings,
                        _refresh_state(comm, carry[0]),
                    ),
                )
                carry = (seeded, carry[1])

            def body(c, _):
                return rans_outer_step(
                    lmesh, ck, bc0, zc, zs, zv, settings, rho, mu,
                    k_in, eps_in, has_wall, y_p, is_wall_face, c,
                    comm=comm,
                )

            carry, metrics = lax.scan(body, carry, None, length=n_steps)
            add = lambda t: jax.tree.map(lambda a: a[None], t)
            return add(carry), metrics

        shard, repl = P(AXIS), P()
        mapped = jax.shard_map(
            step_fn,
            mesh=device_mesh,
            in_specs=(
                shard, shard, shard, shard, shard, repl, repl, repl,
            ),
            out_specs=(shard, repl),
            check_vma=False,
        )

        @jax.jit
        def run(carry, zc, zs, zv):
            return mapped(
                lm, stacked_ck, partition.send_idx, partition.recv_idx,
                carry, zc, zs, zv,
            )

        return run

    run = make_run(reporting_interval)
    history = []
    done = 0
    t0 = time.perf_counter()
    while done < iterations:
        k_steps = min(reporting_interval, iterations - done)
        if k_steps != reporting_interval:
            run = make_run(k_steps)
        local, metrics = run(local, zc, zs, zv)
        jax.block_until_ready(local)
        done += k_steps
        history.append(metrics)
        if verbose:
            va = jax.device_get(metrics.vel_avg[-1])
            dt_ms = (time.perf_counter() - t0) * 1e3 / k_steps
            t0 = time.perf_counter()
            print(
                f"[k-eps x{n}] iter {done}: avg velocity = "
                f"({va[0]:.2e}, {va[1]:.2e}, {va[2]:.2e})  "
                f"ms/iter = {dt_ms:.3g}"
            )
        if check_divergence and bool(
            jax.device_get(jnp.any(metrics.diverged))
        ):
            raise SolverDivergedError(done)
    local = (
        dataclasses.replace(
            local[0], mom_diag=jnp.moveaxis(local[0].mom_diag, 1, -1)
        ),
        local[1],
    )
    flow, tb = gather_tree(partition, local, mesh.n_cells)
    flow = dataclasses.replace(
        flow, mom_diag=jnp.moveaxis(flow.mom_diag, 0, -1)
    )
    return flow, tb, history
