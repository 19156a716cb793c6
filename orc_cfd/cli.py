"""Command-line interface.

The reference's "CLI" is two positional args on a hard-coded case
(main.rs:51-61, roadmap item "Implement CLI" unchecked, README.md:48).
This is the real one:

    orc-cfd run case.toml [--iterations N] [--devices N|all]
    orc-cfd info mesh.msh
    orc-cfd init-case > case.toml
    orc-cfd bench
"""

from __future__ import annotations

import argparse
import sys
import time


def cmd_run(args):
    import jax

    from orc_cfd.io.checkpoint import load_or_initialize, save_checkpoint
    from orc_cfd.io.data import write_data, write_gradients
    from orc_cfd.utils.config import build_problem, load_case

    import os

    if not os.path.exists(args.case):
        print(f"error: case file not found: {args.case}", file=sys.stderr)
        return 2
    case = load_case(args.case)
    if args.iterations:
        case.iterations = args.iterations
    if args.devices:
        case.devices = args.devices
    if case.mesh_path and not os.path.exists(case.mesh_path):
        print(
            f"error: mesh file not found: {case.mesh_path}", file=sys.stderr
        )
        return 2
    # Validate/create output locations BEFORE the solve so a typo'd path
    # fails in milliseconds, not after minutes of iterations.
    for out in (
        case.data_file,
        case.gradients_file,
        case.checkpoint_file,
        args.vtk or case.vtk_file,
        args.history,
    ):
        if not out:
            continue
        parent = os.path.dirname(os.path.abspath(out))
        try:
            os.makedirs(parent, exist_ok=True)
        except OSError as e:
            print(
                f"error: cannot create output directory {parent}: {e}",
                file=sys.stderr,
            )
            return 2
        if not os.access(parent, os.W_OK):
            print(
                f"error: output directory not writable: {parent}",
                file=sys.stderr,
            )
            return 2
    mesh, table = build_problem(case)
    print(
        f"mesh: {mesh.n_cells} cells / {mesh.n_faces} faces "
        f"(K={mesh.max_faces_per_cell}, {mesh.dim}D)"
    )
    state = load_or_initialize(
        case.data_file or case.checkpoint_file, mesh, table, case.mu, case.rho
    )
    t0 = time.perf_counter()
    turb = None  # set by the turbulence arm; checkpointed when present
    n_dev = (
        len(jax.devices()) if case.devices == "all" else int(case.devices)
    )
    if case.turbulence:
        from orc_cfd.solver.turbulence import (
            solve_steady_turbulent,
            solve_steady_turbulent_sharded,
        )

        tb = case.turbulence
        # Resume k/eps/mu_t too when the checkpoint carries them.
        turb0 = None
        if case.checkpoint_file and os.path.exists(case.checkpoint_file):
            from orc_cfd.io.checkpoint import load_checkpoint

            try:
                _, turb0, _ = load_checkpoint(
                    case.checkpoint_file, mesh, with_turbulence=True
                )
            except ValueError:
                pass  # different mesh: fresh turbulence init
        kw = dict(
            u_ref=float(tb.get("u_ref", 1.0)),
            iterations=case.iterations,
            reporting_interval=case.reporting_interval,
            intensity=float(tb.get("intensity", 0.05)),
            length_scale=float(tb.get("length_scale", 0.1)),
            state=state,
            turb=turb0,
        )
        if n_dev > 1:
            state, turb, history = solve_steady_turbulent_sharded(
                mesh, table, case.settings, case.rho, case.mu,
                n_devices=n_dev, **kw,
            )
        else:
            state, turb, history = solve_steady_turbulent(
                mesh, table, case.settings, case.rho, case.mu, **kw
            )
    elif case.time:
        from orc_cfd.solver.transient import solve_transient

        tm = case.time
        state, metrics = solve_transient(
            mesh,
            table,
            case.settings,
            case.rho,
            case.mu,
            dt=float(tm["dt"]),
            n_steps=int(tm.get("steps", 100)),
            inner_iterations=int(tm.get("inner_iterations", 15)),
            state=state,
        )
        history = [metrics]
    elif n_dev > 1:
        from orc_cfd.parallel.sharded import solve_steady_sharded

        state, history = solve_steady_sharded(
            mesh,
            table,
            case.settings,
            case.rho,
            case.mu,
            state=state,
            iterations=case.iterations,
            reporting_interval=case.reporting_interval,
            n_devices=n_dev,
        )
    elif case.sequencing:
        from orc_cfd.solver.sequencing import solve_steady_sequenced
        from orc_cfd.utils.config import sequencing_schedule

        seq = dict(case.sequencing)
        schedule = sequencing_schedule(case)

        def case_builder(nx, ny, nz):
            m, t = build_problem(case, dims=(nx, ny, nz))
            return m, t

        state, histories = solve_steady_sequenced(
            case_builder,
            schedule,
            case.settings,
            case.rho,
            case.mu,
            iterations_per_level=int(seq.get("iterations_per_level", 4000)),
            final_iterations=case.iterations,
            reporting_interval=case.reporting_interval,
        )
        # Final level == the case mesh; keep its history for outputs.
        history = histories[-1]
    else:
        from orc_cfd.solver.simple import solve_steady

        state, history = solve_steady(
            mesh,
            table,
            case.settings,
            case.rho,
            case.mu,
            state=state,
            iterations=case.iterations,
            reporting_interval=case.reporting_interval,
        )
    print(f"Complete in {time.perf_counter() - t0:.1f}s.")

    if case.data_file:
        write_data(case.data_file, mesh, state.vel, state.p)
        print(f"wrote {case.data_file}")
    if case.gradients_file:
        from orc_cfd.ops.fields import device_bc, face_bc
        from orc_cfd.ops.gradients import pressure_gradient, velocity_gradient

        zc, zs, zv = device_bc(table, mesh.dtype)
        fbc = face_bc(mesh, zc, zs, zv)
        gv = velocity_gradient(
            mesh, fbc, state.vel, case.settings.gradient_reconstruction
        )
        gp = pressure_gradient(
            mesh, fbc, state.p, case.settings.gradient_reconstruction
        )
        write_gradients(case.gradients_file, mesh, gv, gp)
        print(f"wrote {case.gradients_file}")
    if case.checkpoint_file:
        save_checkpoint(
            case.checkpoint_file, mesh, state, case.iterations, turb=turb
        )
        print(f"wrote {case.checkpoint_file}")
    vtk_path = args.vtk or case.vtk_file
    if vtk_path:
        import tempfile

        from orc_cfd.io.vtk import write_solution_vtk

        if case.mesh_path:
            if mesh.cell_order is not None:
                # RCM-reordered compiled mesh: map fields back to the
                # raw-file cell order the VTK topology uses.
                import dataclasses as _dc

                import jax.numpy as jnp

                from orc_cfd.mesh.compile import to_raw_order

                state = _dc.replace(
                    state,
                    vel=to_raw_order(mesh, state.vel),
                    p=to_raw_order(mesh, state.p),
                    # to_raw_order permutes the leading cell axis;
                    # mom_diag is component-major [3,C].
                    mom_diag=jnp.moveaxis(
                        to_raw_order(
                            mesh, jnp.moveaxis(state.mom_diag, 0, -1)
                        ),
                        -1,
                        0,
                    ),
                )
            write_solution_vtk(vtk_path, case.mesh_path, state)
        else:
            from orc_cfd.mesh.generate import write_tgrid

            g = dict(case.generate)
            with tempfile.NamedTemporaryFile("w", suffix=".msh") as tf:
                write_tgrid(
                    tf.name,
                    int(g.get("nx", 8)),
                    int(g.get("ny", 8)),
                    int(g.get("nz", 1)),
                    lengths=tuple(g.get("lengths", (1.0, 1.0, 1.0))),
                )
                write_solution_vtk(vtk_path, tf.name, state)
        print(f"wrote {vtk_path}")
    if args.history:
        from orc_cfd.solver.simple import save_history

        save_history(args.history, history)
        print(f"wrote {args.history}")
    return 0


def cmd_info(args):
    from orc_cfd.mesh import read_mesh

    mesh, table = read_mesh(args.mesh, verbose=True)
    import numpy as np

    cc = np.asarray(mesh.cell_centroid)
    print(
        f"domain extents: x ({cc[:,0].min():.3e}, {cc[:,0].max():.3e})  "
        f"y ({cc[:,1].min():.3e}, {cc[:,1].max():.3e})  "
        f"z ({cc[:,2].min():.3e}, {cc[:,2].max():.3e})"
    )
    print(f"total volume: {np.asarray(mesh.cell_volume).sum():.6e}")
    return 0


def cmd_init_case(args):
    from orc_cfd.utils.config import default_case_toml

    sys.stdout.write(default_case_toml())
    return 0


def cmd_plot(args):
    import os

    from orc_cfd.plotting import plot_2d, plot_face_velocities

    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
    written = []
    if args.data is not None:
        root = args.data
        if root.endswith(".csv"):
            root = root[:-4]
        if not os.path.exists(root + ".csv"):
            print(
                f"error: data file not found: {root}.csv", file=sys.stderr
            )
            return 2
        written += plot_2d(root, title=args.title, out_dir=args.out_dir)
    if args.face_velocity_files:
        missing = [
            f for f in args.face_velocity_files if not os.path.exists(f)
        ]
        if missing:
            print(
                f"error: face-velocity file not found: {missing[0]}",
                file=sys.stderr,
            )
            return 2
        written += plot_face_velocities(
            args.face_velocity_files, out_dir=args.out_dir,
            title=args.title,
        )
    if args.data is None and not args.face_velocity_files:
        print(
            "error: give a data root and/or --face-velocity-files",
            file=sys.stderr,
        )
        return 2
    for f in written:
        print(f"wrote {f}")
    return 0


def cmd_bench(args):
    import runpy

    runpy.run_path("bench.py", run_name="__main__")
    return 0


def main(argv=None):
    from orc_cfd.backend import setup_compile_cache

    setup_compile_cache()
    ap = argparse.ArgumentParser(
        prog="orc-cfd",
        description="Unstructured finite-volume CFD (JAX)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="run a case file")
    p_run.add_argument("case")
    p_run.add_argument("--iterations", type=int, default=None)
    p_run.add_argument("--devices", default=None)
    p_run.add_argument(
        "--vtk",
        default=None,
        help="write the solution as a legacy VTK unstructured grid "
        "(overrides the case file's vtk_file)",
    )
    p_run.add_argument(
        "--history",
        default=None,
        help="write per-iteration metrics (residual history, corrections, "
        "Peclet stats) to this npz file",
    )
    p_run.set_defaults(fn=cmd_run)

    p_info = sub.add_parser("info", help="inspect a mesh")
    p_info.add_argument("mesh")
    p_info.set_defaults(fn=cmd_info)

    p_init = sub.add_parser("init-case", help="print a default case file")
    p_init.set_defaults(fn=cmd_init_case)

    p_plot = sub.add_parser(
        "plot",
        help="contour/quiver/profile plots from a solution data file "
        "(the reference plotter's capability surface, headless)",
    )
    p_plot.add_argument(
        "data",
        nargs="?",
        default=None,
        help="solution data root or .csv path (as written by `run`; "
        "<root>_gradients.csv and <root>_analytical.csv are picked up "
        "when present)",
    )
    p_plot.add_argument(
        "--face-velocity-files",
        "-f",
        nargs="+",
        default=None,
        help="face-velocity files (io.data.write_face_velocities) for "
        "the multi-file comparison figure (reference: "
        "plot_output.py:220-260)",
    )
    p_plot.add_argument("--title", default=None)
    p_plot.add_argument("--out-dir", default=None)
    p_plot.set_defaults(fn=cmd_plot)

    p_bench = sub.add_parser("bench", help="run the benchmark")
    p_bench.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
