"""Bring-up measurements on the GPU: the fused Triton assembly against
the XLA ck path, the momentum smoother per sweep, and the irregular-
mesh SpMV (plain ELL gather vs slice plan).

    python scripts/bench_bringup.py [--n 2048] [--n-irr 1024]

Each result is one JSON line on stdout (also appended to
chiprun_out/bringup.jsonl), tagged with the platform, device kind,
device count and the card's name and power limit. Every timing ends in
block_until_ready; the reported value is the median of the repeats.
Run parent/change comparisons inside one process or one call only.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "chiprun_out", "bringup.jsonl",
)


TAG = {}


def emit(**kw):
    line = json.dumps({**kw, **TAG})
    print(line, flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def timed(f, *args, reps=7):
    """Median wall seconds of f(*args) closed by block_until_ready
    (after one warm-up call, which compiles)."""
    import jax

    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def slope(step, x0, n_lo=16, n_hi=128):
    """Per-step seconds of `step` from two scan lengths."""
    import jax
    from jax import lax

    def run(n):
        return jax.jit(
            lambda x: lax.scan(lambda c, _: (step(c), None), x, None,
                               length=n)[0]
        )

    lo, hi = run(n_lo), run(n_hi)
    return (timed(hi, x0) - timed(lo, x0)) / (n_hi - n_lo)


def trace_device_ns(f, *args):
    """Device time of one call of f from a jax.profiler trace: total
    event duration per line of the first GPU plane, plus the ten
    longest kernels by name (summed)."""
    import jax
    from jax.profiler import ProfileData

    jax.block_until_ready(f(*args))
    d = tempfile.mkdtemp(prefix="trace_", dir=os.path.dirname(OUT))
    with jax.profiler.trace(d):
        jax.block_until_ready(f(*args))
    pb = sorted(glob.glob(f"{d}/plugins/profile/*/*.xplane.pb"))[-1]
    pd = ProfileData.from_file(pb)
    lines, kernels = {}, {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU:0"):
            continue
        for line in plane.lines:
            tot = 0.0
            for ev in line.events:
                tot += ev.duration_ns
                if "Stream" in line.name or "Ops" in line.name:
                    kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.duration_ns
            lines[line.name] = tot
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:10])
    import shutil

    shutil.rmtree(d, ignore_errors=True)
    return lines, top


def assembly(n):
    """Fused Triton assembly vs XLA ck (the parity-loop kernels):
    isolated assembly time and its device time from a trace."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from chip_smoke import _cavity_settings
    from orc_cfd.models.cavity import cavity_case
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
        momentum_assembly,
        pack_flags,
        pc_assembly,
    )
    from orc_cfd.solver.simple import _pallas_asm_spec

    mesh, table = cavity_case(n=n, dtype=jnp.float32)
    C = mesh.n_cells
    zc, zs, zv = device_bc(table, dtype=jnp.float32)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    bc = ck_bc(ck, zc, zs, zv)
    mu = jnp.asarray(0.01, jnp.float32)
    diff3 = ck_diffusion(mesh, ck, bc, mu)
    rng = np.random.default_rng(0)
    vel = jnp.asarray(rng.standard_normal((C, 3)) * 0.1, jnp.float32)
    p = jnp.asarray(rng.standard_normal(C) * 0.05, jnp.float32)
    md = jnp.asarray(rng.uniform(0.5, 2.0, C), jnp.float32)
    flags = pack_flags(ck.interior, ck.mask)
    bcv = bc_value_table(zs, zv)

    for scheme in ("ud", "ref"):
        settings = _cavity_settings(scheme)
        asm = _pallas_asm_spec(mesh, table, settings, ck)
        cols, aspec, interp = asm

        @jax.jit
        def fused(vel, p, md):
            gp = None
            if (aspec.rc or aspec.p_so) and not aspec.gg:
                gp = ck_pressure_gradient(mesh, ck, bc, p)
            m = momentum_assembly(
                vel, p, bcv, flags, cols, 1.0, mu, 0.7, grad_p=gp,
                mom_diag=md, spec=aspec, interpret=interp,
            )
            c = pc_assembly(
                vel, md, bcv, flags, cols, 1.0, p=p, grad_p=gp,
                spec=aspec, interpret=interp,
            )
            return m + c

        @jax.jit
        def xla(vel, p, md):
            md3 = md[:, None] * jnp.ones((1, 3), md.dtype)
            gp = gpn = None
            if aspec.rc or aspec.p_so:
                gp = ck_pressure_gradient(mesh, ck, bc, p)
                gpn = nbr_values(mesh, gp, ck.interior)
            flux = ck_flux(
                mesh, ck, bc, vel, settings.velocity_interpolation, p=p,
                grad_p=gp, grad_p_nbr=gpn, mom_diag=md3,
            )
            F = flux * ck.area
            p_f = ck_face_pressure(
                mesh, ck, bc, p, settings.pressure_interpolation,
                grad_p=gp, grad_p_nbr=gpn,
            )
            A, b, _ = ck_momentum(
                mesh, ck, bc, settings, 1.0, vel, F, p_f, *diff3
            )
            P, bp = ck_pressure_correction(mesh, ck, bc, 1.0, F, md3)
            return (A.diag, A.off, b, P.diag, P.off, bp)

        for name, f in (("triton", fused), ("xla", xla), ("xla", xla),
                        ("triton", fused)):
            t = timed(f, vel, p, md)
            emit(metric="assembly_isolated", scheme=scheme, path=name,
                 cells=C, ms=t * 1e3)
        for name, f in (("triton", fused), ("xla", xla)):
            lines, top = trace_device_ns(f, vel, p, md)
            emit(metric="assembly_trace", scheme=scheme, path=name,
                 cells=C, line_ns=lines, top_kernels_ns=top)


def simple_e2e(n):
    """SIMPLE ms/iter end to end with the fused assembly on and off,
    on the runner solve_steady builds (for CD1+SecondOrder+RhieChow
    under implicit relaxation that is the SIMPLE_FC loop and its
    kernels), plus the device-time breakdown of one traced iteration."""
    import dataclasses

    import jax.numpy as jnp

    from chip_smoke import _cavity_settings
    from orc_cfd.models.cavity import cavity_case
    from orc_cfd.ops.ck_ops import build_ck_geometry, ck_bc, ck_diffusion
    from orc_cfd.ops.fields import device_bc
    from orc_cfd.solver.fc import ck_initial_flux
    from orc_cfd.solver.simple import (
        _make_chunk_runner,
        _pallas_asm_spec,
        initial_state,
        table_has_pressure_bc,
        table_maybe_singular,
    )
    from orc_cfd.utils.settings import PressureVelocityCoupling

    mesh, table = cavity_case(n=n, dtype=jnp.float32)
    C = mesh.n_cells
    zc, zs, zv = device_bc(table, dtype=jnp.float32)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    bc = ck_bc(ck, zc, zs, zv)
    mu = jnp.asarray(0.01, jnp.float32)
    ck_diff = ck_diffusion(mesh, ck, bc, mu)
    for scheme in ("ud", "ref"):
        settings = _cavity_settings(scheme)
        use_fc = (settings.resolved_coupling()
                  == PressureVelocityCoupling.SIMPLE_FC)
        singular = (not table_has_pressure_bc(table) if use_fc
                    else table_maybe_singular(table))
        asm = _pallas_asm_spec(mesh, table, settings, ck, fc=use_fc)
        st0 = initial_state(mesh)
        if use_fc:
            st0 = dataclasses.replace(
                st0, flux=ck_initial_flux(mesh, ck, bc, settings, st0)
            )
        runs, one = {}, {}
        for name, a in (("triton", asm), ("xla", None)):
            runs[name], one[name] = (
                _make_chunk_runner(
                    mesh, settings, None, k, {}, ck=ck, ck_diff=ck_diff,
                    pallas_asm=a, maybe_singular=singular, use_fc=use_fc,
                )
                for k in (10, 1)
            )
        for name in ("triton", "xla", "xla", "triton"):
            t = timed(lambda s: runs[name](s, zc, zs, zv, 1.0, mu), st0,
                      reps=5)
            emit(metric="simple_ms_per_iter", scheme=scheme, path=name,
                 coupling="fc" if use_fc else "simple", cells=C,
                 ms=t * 1e3 / 10)
        for name in ("triton", "xla"):
            lines, top = trace_device_ns(
                lambda s: one[name](s, zc, zs, zv, 1.0, mu), st0
            )
            emit(metric="simple_iteration_trace", scheme=scheme,
                 path=name, coupling="fc" if use_fc else "simple",
                 cells=C, line_ns=lines, top_kernels_ns=top)


def smoother(n):
    """Damped-Jacobi momentum smoother on the shared [3,C] system:
    seconds and bytes per sweep."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from orc_cfd.mesh import structured_box_mesh
    from orc_cfd.ops.spmv import EllMatrix
    from orc_cfd.solver.krylov import jacobi_smooth_solve

    for dtype in (jnp.float32, jnp.float64):
        mesh, _ = structured_box_mesh(n, n, 1, dtype=dtype)
        C = mesh.n_cells
        offsets = mesh.neighbor_offsets
        interior = np.asarray(
            mesh.face_interior[mesh.cell_faces] & mesh.cell_face_mask
        )
        rng = np.random.default_rng(1)
        off = rng.uniform(-1, 0, interior.shape) * interior
        A = EllMatrix(
            diag=jnp.asarray(1.0 + np.abs(off).sum(1), dtype),
            off=jnp.asarray(off, dtype), neighbors=None, offsets=offsets,
        ).split_columns()
        b = jnp.asarray(rng.standard_normal((3, C)), dtype)

        def solve(sweeps):
            return jax.jit(jax.vmap(
                lambda bb, xx: jacobi_smooth_solve(A, bb, xx, sweeps, 0.8)[0]
            ))

        lo, hi = solve(2), solve(34)
        t = (timed(hi, b, b) - timed(lo, b, b)) / 32
        K = len(A.off)
        w = jnp.dtype(dtype).itemsize
        # Minimum per sweep: coefficients once (K off + 1/diag) and,
        # per component, read x and b/diag and write x.
        nbytes = C * w * (K + 1 + 3 * 3)
        emit(metric="smoother_per_sweep", dtype=jnp.dtype(dtype).name,
             cells=C, us=t * 1e6, bytes=nbytes, gbps=nbytes / t / 1e9)


def irregular(n):
    """Permuted, RCM-reordered cavity: SpMV by plain ELL gather vs the
    slice plan (both XLA), per SpMV and per SIMPLE iteration."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from chip_smoke import _cavity_settings, permuted_cavity
    from orc_cfd.ops.spmv import EllMatrix
    from orc_cfd.solver.simple import initial_state, solve_steady

    for dtype in (jnp.float32, jnp.float64):
        _, mesh, table = permuted_cavity(n, dtype)
        C, K = mesh.cell_neighbors.shape
        w = jnp.dtype(dtype).itemsize
        interior = np.asarray(
            mesh.face_interior[mesh.cell_faces] & mesh.cell_face_mask
        )
        rng = np.random.default_rng(2)
        off = jnp.asarray(rng.standard_normal((C, K)) * interior, dtype)
        A = EllMatrix(
            diag=jnp.asarray(rng.standard_normal(C) + 5, dtype), off=off,
            neighbors=mesh.cell_neighbors, plan=mesh.slice_plan,
        )
        x = jnp.asarray(rng.standard_normal(C), dtype)
        plain = dataclasses.replace(A, plan=None)
        sliced = A.prepare()
        for name, M in (("gather", plain), ("slice", sliced),
                        ("slice", sliced), ("gather", plain)):
            t = slope(M.matvec, x)
            nbytes = C * (w * (K + 3) + 4 * K)
            emit(metric="irregular_spmv", dtype=jnp.dtype(dtype).name,
                 path=name, cells=C, us=t * 1e6, gbps=nbytes / t / 1e9,
                 n_max=mesh.slice_plan.n_max, tile=mesh.slice_plan.tile)
        settings = _cavity_settings("ud")
        for name, m in (("slice", mesh),
                        ("gather", dataclasses.replace(mesh,
                                                       slice_plan=None))):
            def run(m=m):
                return solve_steady(
                    m, table, settings, 1.0, 0.01, state=initial_state(m),
                    iterations=10, reporting_interval=10, verbose=False,
                )[0]

            t = timed(run, reps=3)
            emit(metric="irregular_simple_ms_per_iter",
                 dtype=jnp.dtype(dtype).name, path=name, cells=C,
                 ms=t * 1e3 / 10)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--n-irr", type=int, default=1024)
    ap.add_argument("--only",
                    default="assembly,e2e,smoother,irregular")
    args = ap.parse_args()

    import jax

    import orc_cfd  # noqa: F401  (enables x64)
    from orc_cfd.backend import device_tag, setup_compile_cache

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("bench_bringup: needs a GPU")
    setup_compile_cache()
    TAG.update(device_tag())
    only = args.only.split(",")
    with jax.default_matmul_precision("highest"):
        if "assembly" in only:
            assembly(args.n)
        if "e2e" in only:
            simple_e2e(args.n)
        if "smoother" in only:
            smoother(args.n)
        if "irregular" in only:
            irregular(args.n_irr)


if __name__ == "__main__":
    main()
