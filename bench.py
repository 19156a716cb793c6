"""Benchmark: SIMPLE iterations/sec on the 128x64x1 couette case, plus
extended 1024^2 f32 cavity metrics, on the GPU.

Runs the reference's VALIDATED configuration (pressure-driven couette
with a moving wall, tests.rs:44-152 / main.rs:84-102) with the
reference's default discretization (CD1 + SecondOrder pressure +
Rhie-Chow face velocities, lib.rs:58-74) and 50-iteration
preconditioned BiCGSTAB, asserts the bulk velocity tracks the
analytical channel profile, and prints one JSON line per metric; the
couette headline is the last line. Every line names the platform,
device kind, device count and the card's name and power limit. A run
that finds no GPU fails.
"""

import json
import os
import sys
import time


def build_case():
    import jax.numpy as jnp

    from orc_cfd.mesh import structured_box_mesh
    from orc_cfd.mesh.zones import FaceCondition

    dtype = (
        jnp.float32
        if os.environ.get("BENCH_DTYPE", "f64") == "f32"
        else jnp.float64
    )
    mesh, table = structured_box_mesh(
        128, 64, 1, lengths=(0.002, 0.001, 0.0001), dtype=dtype
    )
    # BCs of the reference's VALIDATED case (solve_channel_flow,
    # tests.rs:60-76 with main.rs:84-102 parameters): moving top wall
    # 5e-4 m/s + streamwise dp/dx = 10 Pa/m. Analytical
    # u_mean = U/2 + h^2/(12 mu) dp/dx = 1.0833e-3 m/s.
    table.set("TOP_WALL", FaceCondition.WALL, vector_value=(5e-4, 0.0, 0.0))
    table.set("BOTTOM_WALL", FaceCondition.WALL)
    table.set("INLET", FaceCondition.PRESSURE_INLET, scalar_value=0.02)
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    return mesh, table


def main():
    import jax

    import orc_cfd  # noqa: F401  (enables x64)
    from orc_cfd.backend import device_tag, setup_compile_cache

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(
            f"bench.py: needs a GPU, found {jax.devices()[0].platform}"
        )
    setup_compile_cache()
    tag = device_tag()
    print(f"devices: {jax.devices()}", file=sys.stderr)
    from orc_cfd.solver.simple import initial_state, solve_steady
    from orc_cfd.utils.settings import (
        MatrixSolverSettings,
        NumericalSettings,
        PreconditionMethod,
        SolutionMethod,
    )

    mesh, table = build_case()
    # Solver: Jacobi-preconditioned BiCGSTAB with relative-residual
    # early exit (BENCH_SOLVER=multigrid selects the V-cycle the
    # reference recommends, lib.rs:33).
    solver_name = os.environ.get("BENCH_SOLVER", "bicgstab")
    mg_smooth = os.environ.get("BENCH_MG_SMOOTH")  # smoother iters/level
    settings = NumericalSettings(
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod(solver_name),
            iterations=50,
            preconditioner=PreconditionMethod.JACOBI,
            multigrid_smoother_iterations=(
                int(mg_smooth) if mg_smooth else None
            ),
        ),
    )
    rho, mu = 1000.0, 0.001
    state = initial_state(mesh)

    n_iters = int(os.environ.get("BENCH_ITERS", "100"))
    # Build one chunk runner and time its SECOND dispatch so compile
    # time and constant upload stay out of the measurement.
    import jax.numpy as jnp

    from orc_cfd.ops.assembly import diffusion_system
    from orc_cfd.ops.fields import device_bc, face_bc
    from orc_cfd.solver.simple import _make_chunk_runner

    zc, zs, zv = device_bc(table, dtype=mesh.dtype)
    fbc = face_bc(mesh, zc, zs, zv)
    diff = diffusion_system(mesh, fbc, jnp.asarray(mu, mesh.dtype))
    ck = ck_diff = None
    if os.environ.get("BENCH_CK", "1") == "1":
        from orc_cfd.ops.ck_ops import build_ck_geometry, ck_bc, ck_diffusion

        ck = build_ck_geometry(mesh, len(table.zone_ids))
        ck_diff = ck_diffusion(mesh, ck, ck_bc(ck, zc, zs, zv), jnp.asarray(mu, mesh.dtype))
    extras = {}
    if settings.matrix_solver.solver_type == SolutionMethod.MULTIGRID:
        from orc_cfd.solver.gmg import build_mg_hierarchy

        extras = dict(mg_hierarchy=build_mg_hierarchy(mesh, diff, settings))
    run = _make_chunk_runner(
        mesh, settings, diff, n_iters, extras, ck=ck, ck_diff=ck_diff,
        maybe_singular=False,
    )
    import numpy as np

    t0 = time.perf_counter()
    state, _ = jax.block_until_ready(run(state, zc, zs, zv, rho, mu))
    print(f"warmup (incl. compile): {time.perf_counter()-t0:.1f}s", file=sys.stderr)

    # Median of several dependent dispatches.
    times = []
    for _i in range(5):
        t0 = time.perf_counter()
        state, _ = jax.block_until_ready(run(state, zc, zs, zv, rho, mu))
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[len(times) // 2]
    print(
        "dispatch times: " + ", ".join(f"{t:.3f}s" for t in times),
        file=sys.stderr,
    )

    u = np.asarray(state.vel[:, 0])
    assert np.isfinite(u).all(), "benchmark produced non-finite fields"
    u_mean_analytical = 5e-4 / 2 + 1e-3**2 / (12 * 0.001) * 10.0
    print(
        f"sanity: u_mean={u.mean():.3e} (analytical "
        f"{u_mean_analytical:.3e}) u_min={u.min():.3e} u_max={u.max():.3e}",
        file=sys.stderr,
    )
    # After warmup + measured run (>= 2 * BENCH_ITERS iterations) the
    # bulk velocity must be tracking the analytical value.
    assert abs(u.mean() - u_mean_analytical) / u_mean_analytical < 0.25, (
        "benchmark physics drifted from the analytical solution"
    )
    iters_per_sec = n_iters / dt
    print(
        f"{n_iters} SIMPLE iterations in {dt:.2f}s -> "
        f"{iters_per_sec:.2f} iters/sec ({1e3*dt/n_iters:.2f} ms/iter)",
        file=sys.stderr,
    )

    # Extended metrics first; the couette headline stays the last line.
    if os.environ.get("BENCH_EXTENDED", "1") == "1":
        for line in extended_metrics():
            print(json.dumps({**line, **tag}))
    dtype_name = os.environ.get("BENCH_DTYPE", "f64")
    print(
        json.dumps(
            {
                "metric": "SIMPLE iters/sec, couette_128x64x1, "
                f"CD1+SecondOrder+RhieChow+{solver_name}(50), {dtype_name}",
                "value": iters_per_sec,
                "unit": "iters/sec",
                **tag,
            }
        )
    )


def _scan_slope(f, x0, n=512):
    """Per-step time of f from two scan lengths (n and n/8), each the
    median of three runs closed by block_until_ready."""
    import time

    import jax
    from jax import lax

    def run(n_steps):
        g = jax.jit(
            lambda x: lax.scan(lambda c, _: (f(c), None), x, None,
                               length=n_steps)[0]
        )
        jax.block_until_ready(g(x0))
        ts = []
        for _i in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(g(x0))
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[1]

    n0 = max(1, n // 8)
    return (run(n) - run(n0)) / (n - n0)


def extended_metrics():
    """1M-cell f32 cavity ms/iter, f32 shift-SpMV GB/s and flux+matrix
    assembly GB/s (unfused and fused) at 1M cells."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from orc_cfd.mesh import structured_box_mesh
    from orc_cfd.ops.spmv import ell_spmv

    lines = []
    n_ext = int(os.environ.get("BENCH_EXT_N", "1024"))

    # --- f32 shift SpMV roofline at 1M cells (1024^2) ---
    mesh, table = structured_box_mesh(n_ext, n_ext, 1, dtype=jnp.float32)
    C, K = mesh.cell_neighbors.shape
    interior = np.asarray(
        mesh.face_interior[mesh.cell_faces] & mesh.cell_face_mask
    )
    rng = np.random.default_rng(0)
    diag = jnp.asarray(rng.standard_normal(C), jnp.float32)
    off = jnp.asarray(rng.standard_normal((C, K)) * interior, jnp.float32)
    x = jnp.asarray(rng.standard_normal(C), jnp.float32)
    t = _scan_slope(
        lambda v: ell_spmv(diag, off, None, v, mesh.neighbor_offsets), x
    )
    gbps = C * 4 * (K + 3) / t / 1e9
    lines.append(
        {
            "metric": f"shift SpMV bandwidth, {n_ext}^2 f32",
            "value": gbps,
            "unit": "GB/s",
        }
    )

    # --- flux + momentum + p-correction assembly bandwidth at 1M ---
    from orc_cfd.ops.ck_ops import (
        build_ck_geometry,
        ck_bc,
        ck_diffusion,
        ck_flux,
        ck_momentum,
        ck_pressure_correction,
        nbr_values,
    )
    from orc_cfd.ops.fields import device_bc
    from orc_cfd.utils.settings import NumericalSettings

    from orc_cfd.mesh.zones import FaceCondition

    table.set("TOP_WALL", FaceCondition.WALL, vector_value=(1.0, 0.0, 0.0))
    zc, zs, zv = device_bc(table, dtype=jnp.float32)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    bc = ck_bc(ck, zc, zs, zv)
    ud = NumericalSettings()
    from orc_cfd.utils.settings import (
        MomentumScheme,
        PressureInterpolation,
        VelocityInterpolation,
    )
    import dataclasses as _dc

    ud = _dc.replace(
        ud,
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
    )
    diff3 = ck_diffusion(mesh, ck, bc, jnp.asarray(1e-3, jnp.float32))

    def assemble(state):
        vel, p, mom_diag = state
        vel_nbr = nbr_values(mesh, vel, ck.interior)
        mom_diag_nbr = nbr_values(mesh, mom_diag, ck.interior)
        flux = ck_flux(
            mesh, ck, bc, vel, ud.velocity_interpolation,
            p=p, mom_diag=mom_diag, mom_diag_nbr=mom_diag_nbr,
            vel_nbr=vel_nbr,
        )
        F = flux * ck.area
        from orc_cfd.ops.ck_ops import ck_face_pressure

        p_f = ck_face_pressure(mesh, ck, bc, p, ud.pressure_interpolation)
        A3, b3, _pe = ck_momentum(
            mesh, ck, bc, ud, 1.0, vel, F, p_f, *diff3
        )
        Ap, bp = ck_pressure_correction(mesh, ck, bc, 1.0, F, mom_diag)
        # Feed outputs back so the scan carries the full assembly.
        # Shared-matrix momentum (UD/CD1/TVD_DC) returns diag [C] and
        # b [C,3]; component-dependent schemes return [3,C]/[3,C,K].
        b3c = b3 if b3.shape[0] == vel.shape[0] else jnp.moveaxis(b3, 0, -1)
        d3 = A3.diag
        d3c = d3[:, None] if d3.ndim == 1 else jnp.moveaxis(d3, 0, -1)
        new_vel = vel + 1e-12 * b3c
        new_p = p + 1e-12 * bp
        new_md = mom_diag + 1e-12 * d3c
        return (new_vel, new_p, new_md)

    st0 = (
        jnp.asarray(rng.standard_normal((C, 3)) * 1e-3, jnp.float32),
        jnp.asarray(rng.standard_normal(C) * 1e-3, jnp.float32),
        jnp.ones((C, 3), jnp.float32),
    )
    t_asm = _scan_slope(assemble, st0, n=128)
    # Min-algorithmic traffic: read vel 3C + p C + mom_diag 3C; write
    # SHARED momentum off [C,K] + diag C + b 3C + pc off C,K + diag C
    # + b C + flux C (f32).
    bytes_asm = C * 4 * (3 + 1 + 3 + K + 1 + 3 + K + 1 + 1 + 1)
    gbps_asm = bytes_asm / t_asm / 1e9
    lines.append(
        {
            "metric": (
                f"flux+momentum+p-corr assembly bandwidth, {n_ext}^2 f32"
            ),
            "value": gbps_asm,
            "unit": "GB/s",
        }
    )

    # --- FUSED assembly bandwidth (the shipped default path) ---
    # momentum_assembly + pc_assembly back-to-back, as one SIMPLE
    # iteration issues them (ops/pallas_assembly.py). Minimum traffic:
    # mom reads u,v,w,p + flags, writes diag/off/b3; pc reads u,v,w,md
    # + flags, writes diag/off/b.
    from orc_cfd.models.cavity import cavity_case as _cavity
    from orc_cfd.solver.simple import _pallas_asm_spec as _spec
    from orc_cfd.utils.settings import (
        MatrixSolverSettings as _MSS,
        PreconditionMethod as _PM,
        RelaxationMode as _RM,
        SolutionMethod as _SM,
    )

    mesh_f, table_f = _cavity(n=n_ext, dtype=jnp.float32)
    s_f = _dc.replace(
        ud,
        relaxation_mode=_RM.IMPLICIT,
        momentum_relaxation=0.7,
        matrix_solver=_MSS(
            solver_type=_SM.BICGSTAB, iterations=50,
            preconditioner=_PM.JACOBI,
        ),
    )
    ck_f = build_ck_geometry(mesh_f, len(table_f.zone_ids))
    spec = _spec(mesh_f, table_f, s_f, ck_f)
    if spec is not None:
        from orc_cfd.ops.pallas_assembly import (
            bc_value_table,
            momentum_assembly,
            pack_flags,
            pc_assembly,
        )

        cols, aspec, interp = spec
        zc_f, zs_f, zv_f = device_bc(table_f, dtype=jnp.float32)
        flags = pack_flags(ck_f.interior, ck_f.mask)
        bcv = bc_value_table(zs_f, zv_f)
        Cf = mesh_f.n_cells
        Kf = len(cols)

        def fused_pair(st):
            vel, p, md = st
            mdiag, moff, b3 = momentum_assembly(
                vel, p, bcv, flags, cols, 1.0, 1e-3, 0.7,
                spec=aspec, interpret=interp,
            )
            pdiag, poff, bp = pc_assembly(
                vel, mdiag, bcv, flags, cols, 1.0,
                spec=aspec, interpret=interp,
            )
            b3c = jnp.moveaxis(b3, 0, -1)
            return (
                vel + 1e-12 * b3c,
                p + 1e-12 * bp,
                md + 1e-12 * pdiag,
            )

        st0 = (
            jnp.asarray(rng.standard_normal((Cf, 3)) * 1e-3, jnp.float32),
            jnp.asarray(rng.standard_normal(Cf) * 1e-3, jnp.float32),
            jnp.ones((Cf,), jnp.float32),
        )
        t_fused = _scan_slope(fused_pair, st0, n=128)
        bytes_fused = Cf * 4 * ((4 + 1 + 1 + Kf + 3) + (4 + 1 + 1 + Kf + 1))
        gbps_fused = bytes_fused / t_fused / 1e9
        lines.append(
            {
                "metric": (
                    f"FUSED momentum+p-corr assembly bandwidth, "
                    f"{n_ext}^2 f32 (shipped default)"
                ),
                "value": gbps_fused,
                "unit": "GB/s",
            }
        )

    # --- FUSED assembly, reference-default schemes (CD1 + SecondOrder
    # pressure + Rhie-Chow — lib.rs:58-74), the Green-Gauss pressure
    # gradient computed in-kernel (AsmSpec.gg). The first line counts
    # the bytes of the unfused formulation (gradient pass + grad-p
    # reads), the second the kernel's own algorithmic minimum.
    s_rc = _dc.replace(
        s_f,
        momentum=MomentumScheme.CD1,
        pressure_interpolation=PressureInterpolation.SECOND_ORDER,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
    )
    spec_rc = _spec(mesh_f, table_f, s_rc, ck_f)
    if spec_rc is not None:
        from orc_cfd.ops.ck_ops import ck_bc as _ckbc2
        from orc_cfd.ops.ck_ops import ck_pressure_gradient as _ckgp
        from orc_cfd.ops.pallas_assembly import (
            bc_value_table,
            momentum_assembly,
            pack_flags,
            pc_assembly,
        )

        cols, aspec, interp = spec_rc
        zc_f, zs_f, zv_f = device_bc(table_f, dtype=jnp.float32)
        flags = pack_flags(ck_f.interior, ck_f.mask)
        bcv = bc_value_table(zs_f, zv_f)
        bc_f = _ckbc2(ck_f, zc_f, zs_f, zv_f)
        Cf = mesh_f.n_cells
        Kf = len(cols)

        def fused_rc(st):
            vel, p, md = st
            grad_p = (
                None if aspec.gg else _ckgp(mesh_f, ck_f, bc_f, p)
            )
            mdiag, moff, b3 = momentum_assembly(
                vel, p, bcv, flags, cols, 1.0, 1e-3, 0.7,
                grad_p=grad_p, mom_diag=md,
                spec=aspec, interpret=interp,
            )
            pdiag, poff, bp = pc_assembly(
                vel, mdiag, bcv, flags, cols, 1.0,
                p=p, grad_p=grad_p, spec=aspec, interpret=interp,
            )
            b3c = jnp.moveaxis(b3, 0, -1)
            return (
                vel + 1e-12 * b3c,
                p + 1e-12 * bp,
                md + 1e-12 * pdiag,
            )

        st0 = (
            jnp.asarray(rng.standard_normal((Cf, 3)) * 1e-3, jnp.float32),
            jnp.asarray(rng.standard_normal(Cf) * 1e-3, jnp.float32),
            jnp.ones((Cf,), jnp.float32),
        )
        t_rc = _scan_slope(fused_rc, st0, n=128)
        # Unfused traffic accounting: gradient pass
        # (read p C, write gp 2C for a 2D box) + momentum (read u,v,w,p
        # 4C + gp 2C + md C + flags C, write diag C + off KC + b 3C) +
        # pc (read u,v,w,md,p,gp 7C + flags C, write diag C + off KC +
        # b C).
        bytes_rc = Cf * 4 * (
            (1 + 2) + (4 + 2 + 1 + 1 + 1 + Kf + 3) + (7 + 1 + 1 + Kf + 1)
        )
        # In-kernel-GG accounting: momentum reads
        # u,v,w,p,md,flags (6C), writes diag + off + b (4C + KC); pc
        # reads u,v,w,md,p,flags (6C), writes diag + off + b (2C + KC).
        bytes_gg = Cf * 4 * ((6 + 4 + Kf) + (6 + 2 + Kf))
        gbps_rc = bytes_rc / t_rc / 1e9
        gbps_gg = bytes_gg / t_rc / 1e9
        lines.append(
            {
                "metric": (
                    f"FUSED assembly bandwidth, CD1+SecondOrder+RhieChow "
                    f"(reference-default schemes), {n_ext}^2 f32"
                ),
                "value": gbps_rc,
                "unit": "GB/s",
            }
        )
        if aspec.gg:
            lines.append(
                {
                    "metric": (
                        f"FUSED assembly CD1+SecondOrder+RhieChow, "
                        f"in-kernel-GG traffic accounting, {n_ext}^2 f32"
                    ),
                    "value": gbps_gg,
                    "unit": "GB/s",
                }
            )

    # --- 1M-cell f32 cavity ms/iter (the scale-table headline) ---
    from orc_cfd.models.cavity import cavity_case
    from orc_cfd.solver.simple import _make_chunk_runner, initial_state
    from orc_cfd.utils.settings import (
        MatrixSolverSettings,
        PreconditionMethod,
        RelaxationMode,
        SolutionMethod,
    )
    import time as _time

    mesh_c, table_c = cavity_case(n=n_ext, dtype=jnp.float32)
    settings = NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
        pressure_relaxation=0.1,
        momentum_relaxation=0.7,
        relaxation_mode=RelaxationMode.IMPLICIT,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB,
            iterations=50,
            preconditioner=PreconditionMethod.JACOBI,
        ),
    )
    zc, zs, zv = device_bc(table_c, dtype=jnp.float32)
    from orc_cfd.ops.assembly import diffusion_system
    from orc_cfd.ops.fields import face_bc

    mu = jnp.asarray(1e-3, jnp.float32)
    fbc = face_bc(mesh_c, zc, zs, zv)
    diff = diffusion_system(mesh_c, fbc, mu)
    ck_c = build_ck_geometry(mesh_c, len(table_c.zone_ids))
    ck_diff = ck_diffusion(mesh_c, ck_c, ck_bc(ck_c, zc, zs, zv), mu)
    # Fused assembly kernels, exactly as solve_steady enables them by
    # default for this (eligible) config.
    from orc_cfd.solver.simple import _pallas_asm_spec

    pallas_asm = _pallas_asm_spec(mesh_c, table_c, settings, ck_c)
    n_it = 25
    run = _make_chunk_runner(
        mesh_c, settings, diff, n_it, {}, ck=ck_c, ck_diff=ck_diff,
        pallas_asm=pallas_asm,
        maybe_singular=False,
    )
    state = initial_state(mesh_c)
    state, _ = jax.block_until_ready(run(state, zc, zs, zv, 1.0, 1e-3))
    times = []
    for _i in range(5):
        t0 = _time.perf_counter()
        state, _ = jax.block_until_ready(run(state, zc, zs, zv, 1.0, 1e-3))
        times.append(_time.perf_counter() - t0)
    ms_iter = sorted(times)[len(times) // 2] / n_it * 1e3
    lines.append(
        {
            "metric": f"cavity {n_ext}^2 f32 UD BiCGSTAB(50)",
            "value": ms_iter,
            "unit": "ms/iter",
        }
    )

    # --- same cavity under the REFERENCE-DEFAULT scheme set (CD1 +
    # SecondOrder pressure + Rhie-Chow, lib.rs:58-74): the end-to-end
    # cost of the numerics the reference actually ships.
    s_ref = _dc.replace(
        settings,
        momentum=MomentumScheme.CD1,
        pressure_interpolation=PressureInterpolation.SECOND_ORDER,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
    )
    pallas_ref = _pallas_asm_spec(mesh_c, table_c, s_ref, ck_c)
    run_r = _make_chunk_runner(
        mesh_c, s_ref, diff, n_it, {}, ck=ck_c, ck_diff=ck_diff,
        pallas_asm=pallas_ref, maybe_singular=False,
    )
    state = initial_state(mesh_c)
    state, _ = jax.block_until_ready(run_r(state, zc, zs, zv, 1.0, 1e-3))
    times = []
    for _i in range(5):
        t0 = _time.perf_counter()
        state, _ = jax.block_until_ready(run_r(state, zc, zs, zv, 1.0, 1e-3))
        times.append(_time.perf_counter() - t0)
    ms_ref = sorted(times)[len(times) // 2] / n_it * 1e3
    lines.append(
        {
            "metric": (
                f"cavity {n_ext}^2 f32 CD1+SecondOrder+RhieChow "
                f"(reference-default schemes)"
            ),
            "value": ms_ref,
            "unit": "ms/iter",
        }
    )
    return lines


if __name__ == "__main__":
    main()
