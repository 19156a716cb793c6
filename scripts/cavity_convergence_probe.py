"""Probe: is the Re=1000 cavity core-vortex deficit under-convergence?

Runs the mesh-sequenced cascade to n^2, then KEEPS iterating at the
final level, printing the Ghia Table I/II landmark errors every chunk.
If the error keeps shrinking with iterations, the round-2 "systematic
~20% deficit" was false convergence (small p_corr norm while the core
vortex still spins up on the viscous timescale L^2/nu = Re).

Usage: python scripts/cavity_convergence_probe.py [n] [extra_chunks]
  env SCHEME=ud|tvd  (default ud)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GHIA_Y = [0.0547, 0.1016, 0.2813, 0.4531, 0.5, 0.6172, 0.7344, 0.9531]
GHIA_U = [-0.1812, -0.2973, -0.2781, -0.1065, -0.0608, 0.0570, 0.1872, 0.4660]
GHIA_X = [0.0625, 0.2266, 0.5, 0.8047, 0.9531]
GHIA_V = [0.27485, 0.33075, 0.02526, -0.31966, -0.33714]


def landmark_err(state, n):
    import numpy as np

    u = np.asarray(state.vel)[:, 0].reshape(n, n)
    v = np.asarray(state.vel)[:, 1].reshape(n, n)
    yc = (np.arange(n) + 0.5) / n
    u_mid = u[:, n // 2]
    v_mid = v[n // 2, :]
    import os as _os

    u_s = np.interp(GHIA_Y, yc, u_mid)
    v_s = np.interp(GHIA_X, yc, v_mid)
    eu = max(abs(us - ug) for us, ug in zip(u_s, GHIA_U))
    ev = max(abs(vs - vg) for vs, vg in zip(v_s, GHIA_V))
    if _os.environ.get("PROBE_DETAIL", "0") == "1":
        for yg, us, ug in zip(GHIA_Y, u_s, GHIA_U):
            print(f"    u(y={yg:.4f}) = {us: .4f}  ghia {ug: .4f}")
        for xg, vs, vg in zip(GHIA_X, v_s, GHIA_V):
            print(f"    v(x={xg:.4f}) = {vs: .4f}  ghia {vg: .4f}")
    return eu, ev


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from orc_cfd.backend import setup_compile_cache

    setup_compile_cache()

    from orc_cfd.models.cavity import cavity_case
    from orc_cfd.solver.simple import FlowState, initial_state, solve_steady
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

    n_final = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    dtype = (
        jnp.float64 if os.environ.get("DTYPE", "f32") == "f64"
        else jnp.float32
    )
    extra_chunks = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    re = 1000.0
    scheme = os.environ.get("SCHEME", "ud")

    solver = MatrixSolverSettings(
        solver_type=SolutionMethod.BICGSTAB,
        iterations=50,
        preconditioner=PreconditionMethod.JACOBI,
    )
    settings_ud = NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
        pressure_relaxation=0.1,
        momentum_relaxation=0.7,
        relaxation_mode=RelaxationMode.IMPLICIT,
        matrix_solver=solver,
    )
    settings_tvd = NumericalSettings(
        momentum=MomentumScheme.TVD,
        tvd_psi=tvd_umist,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
        pressure_relaxation=0.05,
        momentum_relaxation=0.6,
        relaxation_mode=RelaxationMode.IMPLICIT,
        matrix_solver=solver,
    )
    settings_dc = NumericalSettings(
        momentum=MomentumScheme.TVD_DC,
        tvd_psi=tvd_umist,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
        # 0.1 limit-cycles at 256^2 (p_corr grows without bound);
        # 0.03 converges monotonically (measured 2026-08-17).
        pressure_relaxation=0.03,
        momentum_relaxation=0.6,
        relaxation_mode=RelaxationMode.IMPLICIT,
        matrix_solver=solver,
    )
    settings_cd1 = NumericalSettings(
        momentum=MomentumScheme.CD1,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
        pressure_relaxation=0.1,
        momentum_relaxation=0.7,
        relaxation_mode=RelaxationMode.IMPLICIT,
        matrix_solver=solver,
    )
    settings = {
        "tvd": settings_tvd, "dc": settings_dc, "cd1": settings_cd1
    }.get(scheme, settings_ud)
    # VEL=lw|rc overrides the final-level velocity interpolation (the
    # RC-vs-LW isolation experiment for the Ghia deficit).
    vel_override = os.environ.get("VEL")
    if vel_override:
        import dataclasses as _dc

        settings = _dc.replace(
            settings,
            velocity_interpolation={
                "lw": VelocityInterpolation.LINEAR_WEIGHTED,
                "rc": VelocityInterpolation.RHIE_CHOW,
            }[vel_override],
        )
    # PR=/MR= override the final-level relaxation factors (limit-cycle
    # isolation: relaxation imbalance vs limiter chatter).
    import dataclasses as _dc0

    if os.environ.get("PR"):
        settings = _dc0.replace(
            settings, pressure_relaxation=float(os.environ["PR"])
        )
    if os.environ.get("MR"):
        settings = _dc0.replace(
            settings, momentum_relaxation=float(os.environ["MR"])
        )
    # PSI=one|va|umist overrides the limiter (deferred-CD / van Albada
    # isolation experiments for the limiter-clipping hypothesis).
    psi_override = os.environ.get("PSI")
    if psi_override:
        import dataclasses as _dc

        def psi_one(r):
            return jnp.ones_like(r)

        def psi_va(r):  # van Albada: smooth, psi(1)=1, clips r<0
            return jnp.where(r > 0.0, (r * r + r) / (r * r + 1.0), 0.0)

        settings = _dc.replace(
            settings,
            tvd_psi={
                "one": psi_one, "va": psi_va, "umist": tvd_umist
            }[psi_override],
        )

    def upsample(arr, n_from, n_to):
        a = np.asarray(arr)
        feat = a.shape[1:]
        a = a.reshape(n_from, n_from, *feat)
        r = n_to // n_from
        a = np.repeat(np.repeat(a, r, axis=0), r, axis=1)
        return jnp.asarray(a.reshape((n_to * n_to,) + feat))

    levels = []
    n = n_final
    while n >= 64:
        levels.append(n)
        n //= 2
    levels.reverse()

    state = None
    for i, n in enumerate(levels[:-1]):
        mesh, table = cavity_case(n=n, lid_velocity=1.0, dtype=dtype)
        if state is None:
            state = initial_state(mesh)
        else:
            state = FlowState(
                vel=upsample(state.vel, levels[i - 1], n),
                p=upsample(state.p, levels[i - 1], n),
                mom_diag=upsample(state.mom_diag, levels[i - 1], n),
            )
        t0 = time.perf_counter()
        state, h = solve_steady(
            mesh, table, settings_ud, 1.0, 1.0 / re,
            state=state, iterations=4000, reporting_interval=1000,
            verbose=False,
        )
        print(f"level {n}: 4000 iters {time.perf_counter()-t0:.0f}s",
              file=sys.stderr, flush=True)

    n = n_final
    mesh, table = cavity_case(n=n, lid_velocity=1.0, dtype=dtype)
    if state is not None and len(levels) > 1:
        state = FlowState(
            vel=upsample(state.vel, levels[-2], n),
            p=upsample(state.p, levels[-2], n),
            mom_diag=upsample(state.mom_diag, levels[-2], n),
        )
    else:
        state = initial_state(mesh)

    chunk = int(os.environ.get("CHUNK", "20000"))
    rep = int(os.environ.get("REPORT", "1000"))
    total = 0
    for j in range(extra_chunks):
        t0 = time.perf_counter()
        state, h = solve_steady(
            mesh, table, settings, 1.0, 1.0 / re,
            state=state, iterations=chunk, reporting_interval=rep,
            verbose=False,
        )
        total += chunk
        pc = float(np.asarray(h[-1].p_corr_norm)[-1])
        eu, ev = landmark_err(state, n)
        print(
            f"{scheme} {n}^2 iters {total:>7}: u_err {eu:.4f} v_err {ev:.4f}"
            f"  p_corr {pc:.3e}  ({time.perf_counter()-t0:.0f}s)",
            flush=True,
        )


if __name__ == "__main__":
    main()
