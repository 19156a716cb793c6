#!/usr/bin/env python3
"""Run the SIMPLE main path once on the GPU and check what comes out.

    python chip_smoke.py             # phases (a)-(c) on one card
    python chip_smoke.py --chips 4   # phase (d) only, over four cards

(a) CLI, f64: `orc_cfd.cli run` (in-process) on a generated 2048^2 lid-
    driven cavity with the examples/cavity.toml numerics (4.2M cells)
    for 50 SIMPLE iterations, writing the checkpoint and the metrics
    history; then solve_channel_flow (128x64, the README numerics)
    against the analytical Couette/Poiseuille profile.
(b) Library, f32: solve_steady on the 2048^2 f32 cavity under implicit
    relaxation with UD/LinearWeighted and with CD1+SecondOrder+RhieChow,
    fused Triton assembly against the plain XLA ck path.
(c) Irregular mesh: a randomly permuted, RCM-reordered 1024^2 cavity in
    f32 and f64 against the structured run, matched by cell centroid.
(d) Four cards: the 2048^2 f64 cavity sharded over four devices against
    one device, and the f32 fused-assembly configuration sharded.

Everything runs in this one process, which opens the card(s) once. Any
platform but `gpu` is refused. A failed check raises, so the script
exits non-zero; only a full pass prints the last line,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
#: Scratch for the CLI phase's files (inside the checkout, git-ignored).
OUT_DIR = os.path.join(HERE, ".smoke_out")

#: One fused assembly call vs the XLA ck reference on the same fields:
#: the same few flops per entry in another order, so a few f32 ulps.
ASSEMBLY_RTOL = 1e-5
#: f32 runs that differ only in rounding (kernel vs XLA arithmetic,
#: neighbor-sum order, psum vs serial dots), compared one SIMPLE
#: iteration at a time from a common state. Rounding (~1e-7) passes
#: through the momentum and pressure solves of one iteration; 1e-4
#: leaves room for their amplification where the pressure solve
#: converges. Free f32 runs are not compared over many iterations:
#: BiCGSTAB's data-dependent exit (1e-3 relative residual) takes a
#: different count once the runs differ by rounding. Where the
#: pressure solve does not converge in its 50 iterations (the 2048^2
#: CD1+SecondOrder+RhieChow cavity on the SIMPLE_FC loop) it answers
#: 1-ulp differences with differences of 1e-2 to 0.4 in one step, in
#: both f32 paths alike (measured on the H100), so phase_fused runs
#: those schemes on the parity loop and checks the FC kernels call for
#: call.
F32_RTOL = 1e-4
#: The same comparisons in f64, as tests/test_distributed.py pins on
#: CPU.
F64_RTOL = 1e-8

_compile_seconds = [0.0]


def _on_event(name, secs, **_):
    if name.startswith("/jax/core/compile"):
        _compile_seconds[0] += secs


def _rel(a, b):
    """max|a - b| / max|b| over all entries."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


class Checks(list):
    """Failed checks of one phase, collected so the phase still reports
    every number it measured before main() fails it."""

    def __call__(self, cond, msg):
        if not cond:
            self.append(msg)


def _cavity_settings(scheme="ud", solver_iterations=50):
    """examples/cavity.toml numerics; scheme "ud" (UD + LinearWeighted)
    or "ref" (CD1 + SecondOrder + Rhie-Chow, the reference default)."""
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

    if scheme == "ud":
        schemes = dict(
            momentum=MomentumScheme.UD,
            pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
            velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
        )
    else:
        schemes = dict(
            momentum=MomentumScheme.CD1,
            pressure_interpolation=PressureInterpolation.SECOND_ORDER,
            velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
        )
    return NumericalSettings(
        **schemes,
        pressure_relaxation=0.1,
        momentum_relaxation=0.7,
        relaxation_mode=RelaxationMode.IMPLICIT,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB,
            iterations=solver_iterations,
            preconditioner=PreconditionMethod.JACOBI,
        ),
    )


CASE_TOML = """\
[case]
iterations = {iters}
reporting_interval = {report}
checkpoint_file = "{ckpt}"

[case.generate]
nx = {n}
ny = {n}
nz = 1
lengths = [1.0, 1.0, {dz}]

[fluid]
rho = 1.0
mu = 0.01

[numerics]
momentum = "ud"
pressure_interpolation = "linear_weighted"
velocity_interpolation = "linear_weighted"
pressure_relaxation = 0.1
momentum_relaxation = 0.7
relaxation_mode = "implicit"

[numerics.solver]
type = "bicgstab"
iterations = 50

[boundaries.TOP_WALL]
type = "wall"
velocity = [1.0, 0.0, 0.0]

[boundaries.BOTTOM_WALL]
type = "wall"

[boundaries.INLET]
type = "wall"

[boundaries.OUTLET]
type = "wall"

[boundaries."PERIODIC_-Z"]
type = "symmetry"

[boundaries."PERIODIC_+Z"]
type = "symmetry"
"""


def phase_cli(n=2048, iterations=50, channel=(128, 64, 2000)):
    """(a): the CLI on a generated f64 cavity, then the channel flow
    against its analytical profile."""
    import numpy as np

    from orc_cfd import cli
    from orc_cfd.models.channel_flow import (
        ChannelFlowParameters,
        solve_channel_flow,
    )
    from orc_cfd.utils.settings import NumericalSettings

    check = Checks()
    os.makedirs(OUT_DIR, exist_ok=True)
    case_path = os.path.join(OUT_DIR, "cavity.toml")
    ckpt = os.path.join(OUT_DIR, "cavity.npz")
    hist = os.path.join(OUT_DIR, "history.npz")
    with open(case_path, "w") as f:
        f.write(
            CASE_TOML.format(
                iters=iterations, report=max(1, iterations // 5),
                ckpt=ckpt, n=n, dz=1.0 / n,
            )
        )
    rc = cli.main(["run", case_path, "--history", hist])
    check(rc == 0, f"cli run returned {rc}")
    with np.load(ckpt) as z:
        vel, p, it = z["vel"], z["p"], int(z["iteration"])
    with np.load(hist) as h:
        pc, vc = h["p_corr_norm"], h["vel_corr_norm"]
    check(vel.dtype == np.float64, f"CLI solution dtype {vel.dtype}")
    check(it == iterations, f"checkpoint at iteration {it}")
    check(vel.shape == (n * n, 3) and p.shape == (n * n,),
          f"solution shapes {vel.shape} {p.shape}")
    check(np.isfinite(vel).all() and np.isfinite(p).all(),
          "non-finite solution fields")
    check(len(pc) == iterations, f"history has {len(pc)} rows")
    check(np.isfinite(pc).all() and np.isfinite(vc).all(),
          "non-finite metrics")
    # The run settles: velocity corrections shrink (first vs last
    # fifth) and pressure corrections fall from their start-up peak.
    k = max(1, iterations // 5)
    check(vc[-k:].mean() < vc[:k].mean(),
          f"vel_corr did not go down: {vc[:k].mean():.3e} -> "
          f"{vc[-k:].mean():.3e}")
    check(pc[-1] < pc.max(),
          f"p_corr did not go down: peak {pc.max():.3e}, last {pc[-1]:.3e}")
    out = dict(
        cavity_cells=n * n,
        p_corr_first=float(pc[0]), p_corr_peak=float(pc.max()),
        p_corr_last=float(pc[-1]),
        vel_corr_first=float(vc[0]), vel_corr_last=float(vc[-1]),
    )
    del vel, p
    gc.collect()

    nx, ny, its = channel
    params = ChannelFlowParameters(
        top_wall_velocity=5e-4, dp_dx=10.0, mu=1e-3, rho=1e3
    )
    res = solve_channel_flow(
        params, NumericalSettings(), nx=nx, ny=ny, iterations=its,
        reporting_interval=its, verbose=False,
    )
    out["channel_passed"] = bool(res["passed"])
    check(out["channel_passed"], f"channel flow failed validation: {res}")
    return out, check


def _solve(mesh, table, settings, iterations, state=None):
    """(final state, stacked history) of `iterations` SIMPLE steps."""
    from orc_cfd.solver.simple import (
        initial_state,
        solve_steady,
        stack_history,
    )

    state, hist = solve_steady(
        mesh, table, settings, 1.0, 0.01,
        state=initial_state(mesh) if state is None else state,
        iterations=iterations, reporting_interval=iterations,
        verbose=False,
    )
    return state, stack_history(hist)


def _with_asm(mode, fn):
    """Run fn() with ORC_PALLAS_ASM=mode ("0": XLA ck path)."""
    old = os.environ.get("ORC_PALLAS_ASM")
    os.environ["ORC_PALLAS_ASM"] = mode
    try:
        return fn()
    finally:
        if old is None:
            os.environ.pop("ORC_PALLAS_ASM")
        else:
            os.environ["ORC_PALLAS_ASM"] = old


def _assembly_check(mesh, table, settings, spec, vel, p, md, fc=False):
    """One fused momentum + pressure-correction assembly against the
    XLA ck functions on the same fields; max relative error of each
    output. `fc`: the SIMPLE_FC kernels (stored face flux in, full-p
    pressure system out) against solver/fc.py's ck functions, with the
    interpolated flux of `vel` as the stored flux."""
    import jax.numpy as jnp

    from orc_cfd.ops.ck_ops import (
        build_ck_geometry,
        ck_bc,
        ck_diffusion,
        ck_face_pressure,
        ck_flux,
        ck_momentum,
        ck_pressure_correction,
        ck_pressure_gradient,
        nbr_values,
    )
    from orc_cfd.ops.fields import device_bc
    from orc_cfd.ops.pallas_assembly import (
        bc_value_table,
        fc_momentum_assembly,
        fc_pc_assembly,
        momentum_assembly,
        pack_flags,
        pc_assembly,
    )
    from orc_cfd.solver.fc import (
        ck_d_coeffs,
        ck_fc_pressure_system,
        ck_flux_h,
    )

    rho, mu = 1.0, 0.01
    cols, aspec, interp = spec
    zc, zs, zv = device_bc(table, dtype=mesh.dtype)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    bc = ck_bc(ck, zc, zs, zv)
    md3 = md[:, None] * jnp.ones((1, 3), md.dtype)
    grad_p = gp_nbr = None
    if aspec.rc or aspec.p_so:
        grad_p = ck_pressure_gradient(mesh, ck, bc, p)
        gp_nbr = nbr_values(mesh, grad_p, ck.interior)
    flux = ck_flux(
        mesh, ck, bc, vel, settings.velocity_interpolation, p=p,
        grad_p=grad_p, grad_p_nbr=gp_nbr, mom_diag=md3,
    )
    F = flux * ck.area * rho
    p_f = ck_face_pressure(
        mesh, ck, bc, p, settings.pressure_interpolation,
        grad_p=grad_p, grad_p_nbr=gp_nbr,
    )
    A, b, _ = ck_momentum(
        mesh, ck, bc, settings, rho, vel, F, p_f,
        *ck_diffusion(mesh, ck, bc, jnp.asarray(mu, mesh.dtype)),
    )
    flags = pack_flags(ck.interior, ck.mask)
    bcv = bc_value_table(zs, zv)
    gp_in = None if aspec.gg else grad_p
    alpha = settings.momentum_relaxation
    if fc:
        P, bp = ck_fc_pressure_system(
            mesh, ck, bc, rho,
            ck_flux_h(mesh, ck, bc, vel, settings.velocity_interpolation,
                      p=p, grad_p=grad_p, mom_diag=md3),
            ck_d_coeffs(mesh, ck, bc, rho, md3),
        )
        got = fc_momentum_assembly(
            vel, p, flux, bcv, flags, cols, rho, mu, alpha, grad_p=gp_in,
            spec=aspec, interpret=interp,
        ) + fc_pc_assembly(
            vel, md, bcv, flags, cols, rho, grad_p=gp_in, spec=aspec,
            interpret=interp,
        )[:3]
    else:
        P, bp = ck_pressure_correction(mesh, ck, bc, rho, F, md3)
        got = momentum_assembly(
            vel, p, bcv, flags, cols, rho, mu, alpha, grad_p=gp_in,
            mom_diag=md, spec=aspec, interpret=interp,
        ) + pc_assembly(
            vel, md, bcv, flags, cols, rho, p=p, grad_p=gp_in,
            spec=aspec, interpret=interp,
        )
    want = (A.diag, A.off, b, P.diag, P.off, bp)
    names = ("mom_diag", "mom_off", "mom_b", "pc_diag", "pc_off", "pc_b")
    return {k: _rel(g, w) for k, g, w in zip(names, got, want)}


def phase_fused(n=2048, iterations=10, interpret=False):
    """(b): the fused Triton assembly against the XLA ck path, f32,
    both scheme sets, on the parity SIMPLE loop (for the Rhie-Chow set
    that is the in-kernel Green-Gauss gradient). Along the XLA run's
    trajectory, each of `iterations` SIMPLE steps is taken by both
    paths, and by the XLA path in f64, from the same state. The scheme
    passes when the two f32 paths agree to F32_RTOL at every step, or
    else when the fused path's step errors against f64 are distributed
    like the XLA f32 path's (median and maximum within twice XLA's),
    as where an unconverged f32 pressure solve amplifies rounding in
    both paths alike (see F32_RTOL). The assembly itself is compared
    call for call at the last state; for the Rhie-Chow set also with
    the grad-p input that sharded runs use, and through the SIMPLE_FC
    kernels that solve_steady takes for it under AUTO coupling.
    `interpret` runs the kernels in interpret mode (CPU rehearsal)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from orc_cfd.models.cavity import cavity_case
    from orc_cfd.ops.ck_ops import build_ck_geometry
    from orc_cfd.solver.simple import _pallas_asm_spec, initial_state
    from orc_cfd.utils.settings import PressureVelocityCoupling

    check = Checks()
    kernel_mode = "force" if interpret else "1"
    mesh, table = cavity_case(n=n, dtype=jnp.float32)
    mesh64, _ = cavity_case(n=n, dtype=jnp.float64)
    out = {}
    for scheme in ("ud", "ref"):
        auto = _cavity_settings(scheme)
        settings = dataclasses.replace(
            auto, pressure_velocity_coupling=PressureVelocityCoupling.SIMPLE
        )
        ck = build_ck_geometry(mesh, len(table.zone_ids))
        spec, fc_spec = (
            _with_asm(
                kernel_mode,
                lambda: _pallas_asm_spec(mesh, table, settings, ck, fc=fc),
            )
            for fc in (False, True)
        )
        del ck
        if spec is None:
            check(False, f"{scheme}: fused assembly not selected")
            continue
        state = initial_state(mesh)
        steps = []
        for i in range(iterations):
            sx, hx = _with_asm(
                "0", lambda: _solve(mesh, table, settings, 1, state)
            )
            sk, hk = _with_asm(
                kernel_mode,
                lambda: _solve(mesh, table, settings, 1, state),
            )
            s64, _ = _solve(
                mesh64, table, settings, 1,
                jax.tree.map(lambda x: x.astype(jnp.float64), state),
            )
            du, dp = _rel(sk.vel, sx.vel), _rel(sk.p, sx.p)
            ek, ex = _rel(sk.vel, s64.vel), _rel(sx.vel, s64.vel)
            steps.append(dict(
                du=du, dp=dp, kernel_vs_f64=ek, xla_vs_f64=ex,
                pc_iters=int(hk.pc_iters[-1]),
            ))
            check(bool(jnp.isfinite(sk.vel).all()),
                  f"{scheme} step {i}: non-finite fused step")
            state = sx
        out[f"{scheme}_steps"] = steps
        du = max(st["du"] for st in steps)
        ek = np.array([st["kernel_vs_f64"] for st in steps])
        ex = np.array([st["xla_vs_f64"] for st in steps])
        check(du <= F32_RTOL or (
            np.median(ek) <= 2.0 * np.median(ex)
            and ek.max() <= 2.0 * ex.max()
        ), f"{scheme}: fused vs XLA step {du:.3e} > {F32_RTOL} and fused"
           f" vs f64 (median {np.median(ek):.3e}, max {ek.max():.3e}) "
           f"beyond twice XLA's (median {np.median(ex):.3e}, max "
           f"{ex.max():.3e})")
        specs = [("", spec, False)]
        if spec[1].gg:
            specs.append(("_gradp", (spec[0], spec[1]._replace(gg=False),
                                     spec[2]), False))
        if auto.resolved_coupling() == PressureVelocityCoupling.SIMPLE_FC:
            specs.append(("_fc", fc_spec, True))
        for tag, sp, fc in specs:
            errs = _assembly_check(
                mesh, table, settings, sp, state.vel, state.p,
                state.mom_diag[0], fc=fc,
            )
            for k, e in errs.items():
                out[f"{scheme}{tag}_asm_{k}"] = e
                check(e <= ASSEMBLY_RTOL,
                      f"{scheme}{tag}: fused {k} vs XLA ck {e:.3e} > "
                      f"{ASSEMBLY_RTOL}")
        del state, sx, sk, s64
        gc.collect()
    return out, check


def permuted_cavity(n, dtype, seed=0):
    """The n x n lid cavity with randomly permuted cell ids, compiled
    through the generic path (RCM reordering + slice plan)."""
    import numpy as np

    from orc_cfd.mesh.compile import compile_from_arrays
    from orc_cfd.models.cavity import cavity_case

    mesh, table = cavity_case(n=n, dtype=dtype)
    rng = np.random.default_rng(seed)
    C = mesh.n_cells
    perm = rng.permutation(C)
    inv = np.empty(C, np.int64)
    inv[perm] = np.arange(C)
    interior = np.asarray(mesh.face_interior)
    m2 = compile_from_arrays(
        dim=2,
        face_owner=inv[np.asarray(mesh.face_owner)],
        face_neighbor=np.where(
            interior, inv[np.asarray(mesh.face_neighbor)], -1
        ),
        face_area=np.asarray(mesh.face_area),
        face_normal=np.asarray(mesh.face_normal),
        face_centroid=np.asarray(mesh.face_centroid),
        face_zone_slot=np.asarray(mesh.face_zone_slot),
        cell_centroid=np.asarray(mesh.cell_centroid)[perm],
        cell_volume=np.asarray(mesh.cell_volume)[perm],
        dtype=dtype,
    )
    return mesh, m2, table


def phase_irregular(n=1024, iterations=10):
    """(c): permuted (RCM + slice plan) vs structured cavity, matched by
    cell centroid: f64 after `iterations` SIMPLE steps, f32 after one
    (see F32_RTOL)."""
    import jax.numpy as jnp
    import numpy as np

    check = Checks()
    out = {}
    for dtype in (jnp.float32, jnp.float64):
        name = jnp.dtype(dtype).name
        mesh_s, mesh_i, table = permuted_cavity(n, dtype)
        check(mesh_i.neighbor_offsets is None
              and mesh_i.slice_plan is not None,
              f"{name}: permuted mesh did not take the irregular path")
        settings = _cavity_settings("ud")
        its = iterations if name == "float64" else 1
        vs = np.asarray(_solve(mesh_s, table, settings, its)[0].vel)
        vi = np.asarray(_solve(mesh_i, table, settings, its)[0].vel)
        cs = np.asarray(mesh_s.cell_centroid)
        ci = np.asarray(mesh_i.cell_centroid)
        ks = np.lexsort((cs[:, 0], cs[:, 1], cs[:, 2]))
        ki = np.lexsort((ci[:, 0], ci[:, 1], ci[:, 2]))
        check(np.isfinite(vi).all(), f"{name}: non-finite irregular run")
        du = _rel(vi[ki], vs[ks])
        out[f"{name}_rel_du"] = du
        rtol = F32_RTOL if name == "float32" else F64_RTOL
        check(du <= rtol,
              f"{name}: irregular vs structured {du:.3e} > {rtol}")
        del mesh_s, mesh_i, vs, vi
        gc.collect()
    return out, check


def phase_sharded(n=2048, iterations=10, n_devices=4, interpret=False):
    """(d): the UD cavity sharded over n_devices against one device:
    f64 for `iterations` steps, and f32 with the fused assembly for one
    step (longer f32 runs split on the solvers' exit counts, see
    F32_RTOL)."""
    import jax.numpy as jnp
    import numpy as np

    from orc_cfd.models.cavity import cavity_case
    from orc_cfd.parallel.sharded import solve_steady_sharded
    from orc_cfd.solver.simple import _pallas_asm_spec, initial_state

    check = Checks()
    out = {}
    kernel_mode = "force" if interpret else "1"
    cases = (
        ("float64", jnp.float64, "ud", iterations, F64_RTOL),
        ("float32", jnp.float32, "ud", 1, F32_RTOL),
    )
    for name, dtype, scheme, its, rtol in cases:
        mesh, table = cavity_case(n=n, dtype=dtype)
        settings = _cavity_settings(scheme)
        fused = _with_asm(
            kernel_mode,
            lambda: _pallas_asm_spec(mesh, table, settings, True,
                                     sharded=True),
        ) is not None
        out[f"{name}_fused_assembly"] = fused
        check(fused == (name == "float32"),
              f"{name}: fused assembly selected = {fused}")

        def sharded():
            return solve_steady_sharded(
                mesh, table, settings, 1.0, 0.01,
                state=initial_state(mesh), iterations=its,
                reporting_interval=its, n_devices=n_devices,
                verbose=False,
            )

        st, hist = _with_asm(kernel_mode, sharded)
        devs = hist[0].vel_avg.sharding.device_set
        out[f"{name}_devices"] = sorted(d.id for d in devs)
        check(len(devs) == n_devices,
              f"{name}: sharded step ran on {len(devs)} devices")
        vs = np.asarray(st.vel)
        v1 = np.asarray(
            _with_asm(
                kernel_mode, lambda: _solve(mesh, table, settings, its)
            )[0].vel
        )
        check(np.isfinite(vs).all(), f"{name}: non-finite sharded run")
        du = _rel(vs, v1)
        out[f"{name}_rel_du"] = du
        check(du <= rtol,
              f"{name}: sharded vs one device {du:.3e} > {rtol}")
        del st, hist, vs, v1, mesh
        gc.collect()
    return out, check


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    import jax

    import orc_cfd  # noqa: F401  (enables x64)
    from orc_cfd.backend import card, setup_compile_cache

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, found platform {dev.platform!r}",
              file=sys.stderr)
        return 2
    if len(devices) < args.chips:
        print(f"chip_smoke: --chips {args.chips} but {len(devices)} "
              f"device(s) visible", file=sys.stderr)
        return 2
    setup_compile_cache()
    jax.monitoring.register_event_duration_secs_listener(_on_event)
    print(f"device_kind: {dev.device_kind}  devices: {len(devices)}",
          flush=True)

    if args.chips == 4:
        phases = [("d_sharded", phase_sharded)]
    else:
        phases = [
            ("a_cli_f64", phase_cli),
            ("b_fused_f32", phase_fused),
            ("c_irregular", phase_irregular),
        ]
    try:
        for name, fn in phases:
            c0, t0 = _compile_seconds[0], time.perf_counter()
            res, failed = fn()
            stats = dev.memory_stats() or {}
            print(json.dumps({
                "phase": name, "ok": not failed, **res,
                "failures": failed,
                "seconds": time.perf_counter() - t0,
                "compile_seconds": _compile_seconds[0] - c0,
                "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
            }), flush=True)
            if failed:
                raise AssertionError(f"phase {name} failed: {failed}")
    finally:
        shutil.rmtree(OUT_DIR, ignore_errors=True)
    print(card())
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(devices),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
