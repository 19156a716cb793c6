"""CLI + case-file tests."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from orc_cfd.utils.config import build_problem, default_case_toml, parse_case
from orc_cfd.utils.settings import (
    MomentumScheme,
    PressureInterpolation,
    SolutionMethod,
    VelocityInterpolation,
)

CASE = """
[case]
iterations = 40
reporting_interval = 20
[case.generate]
nx = 6
ny = 6
nz = 1
lengths = [0.002, 0.001, 0.0001]

[fluid]
rho = 1000.0
mu = 0.001

[numerics]
momentum = "ud"
pressure_interpolation = "linear_weighted"
velocity_interpolation = "linear_weighted"
pressure_relaxation = 0.03

[numerics.solver]
type = "bicgstab"
iterations = 30

[boundaries.TOP_WALL]
type = "wall"
velocity = [5e-4, 0.0, 0.0]

[boundaries.BOTTOM_WALL]
type = "wall"

[boundaries.INLET]
type = "pressure_inlet"
pressure = 0.01

[boundaries.OUTLET]
type = "pressure_outlet"
pressure = 0.0

[boundaries."PERIODIC_-Z"]
type = "symmetry"

[boundaries."PERIODIC_+Z"]
type = "symmetry"
"""


def test_parse_case():
    case = parse_case(CASE)
    assert case.iterations == 40
    assert case.settings.momentum == MomentumScheme.UD
    assert case.settings.matrix_solver.solver_type == SolutionMethod.BICGSTAB
    assert case.settings.pressure_relaxation == 0.03
    mesh, table = build_problem(case)
    assert mesh.n_cells == 36
    fz = table.zone_by_name("TOP_WALL")
    assert fz.vector_value == (5e-4, 0.0, 0.0)


def test_default_case_parses():
    case = parse_case(default_case_toml().replace(
        'mesh = "examples/couette_flow_128x64x1.msh"', ""
    ).replace("# [case.generate]", "[case.generate]").replace(
        "# nx = 128", "nx = 4"
    ).replace("# ny = 64", "ny = 4").replace("# nz = 1", "nz = 1").replace(
        "# lengths = [0.002, 0.001, 0.0001]", "lengths = [0.002, 0.001, 0.0001]"
    ))
    assert case.settings.velocity_interpolation == VelocityInterpolation.RHIE_CHOW
    assert case.settings.pressure_interpolation == PressureInterpolation.SECOND_ORDER


def test_bad_scheme_message():
    with pytest.raises(ValueError, match="unknown momentum scheme 'warp'"):
        parse_case("[case]\nmesh='x'\n[numerics]\nmomentum='warp'\n")


def test_cli_run_end_to_end(tmp_path):
    """Drive the CLI as a subprocess: run a small case, write outputs,
    then warm-restart from them."""
    case_path = tmp_path / "case.toml"
    data = tmp_path / "sol.csv"
    ck = tmp_path / "ck.npz"
    case_path.write_text(
        CASE
        + f'\n[case.outputs]\n'
    )
    # Append output paths into [case] (tomllib requires them inside the
    # table, so rebuild the text).
    text = CASE.replace(
        "[case]",
        f'[case]\ndata_file = "{data}"\ncheckpoint_file = "{ck}"',
        1,
    )
    case_path.write_text(text)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "orc_cfd", "run", str(case_path)],
        capture_output=True,
        text=True,
        env=env,
        cwd=REPO,
        timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert data.exists() and ck.exists()
    assert "Complete in" in out.stdout
    # Warm restart must pick up the data file; also exercise --vtk on a
    # generated-mesh case (round-trips through a temp TGRID file).
    vtk = tmp_path / "sol.vtk"
    out2 = subprocess.run(
        [sys.executable, "-m", "orc_cfd", "run", str(case_path),
         "--iterations", "5", "--vtk", str(vtk)],
        capture_output=True,
        text=True,
        env=env,
        cwd=REPO,
        timeout=600,
    )
    assert out2.returncode == 0, out2.stderr[-2000:]
    assert vtk.exists()
    from orc_cfd.io.vtk import read_vtk_cell_data

    assert read_vtk_cell_data(str(vtk))["velocity"].shape == (36, 3)
    # Plot the solution we just wrote (headless Agg).
    out3 = subprocess.run(
        [sys.executable, "-m", "orc_cfd", "plot", str(data)],
        capture_output=True,
        text=True,
        env=env,
        cwd=REPO,
        timeout=300,
    )
    assert out3.returncode == 0, out3.stderr[-2000:]
    png = tmp_path / "sol_contour_plots.png"
    assert png.exists() and png.stat().st_size > 10_000


def test_cli_init_case():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "orc_cfd", "init-case"],
        capture_output=True,
        text=True,
        env=env,
        cwd=REPO,
        timeout=300,
    )
    assert out.returncode == 0
    assert "[numerics.solver]" in out.stdout


@pytest.mark.parametrize(
    "example",
    sorted(
        f for f in os.listdir(os.path.join(REPO, "examples"))
        if f.endswith(".toml")
    ),
)
def test_example_cases_parse_and_build(example):
    """Every shipped example case file must parse and build its mesh +
    BC table (catches example rot without running the solves)."""
    from orc_cfd.utils.config import build_problem, load_case

    case = load_case(os.path.join(REPO, "examples", example))
    # Shrink generated meshes so the build is instant.
    if case.generate:
        case.generate = dict(case.generate, nx=4, ny=4, nz=min(2, int(case.generate.get("nz", 1))))
    mesh, table = build_problem(case)
    assert mesh.n_cells > 0
    table.validate_supported()


def test_case_periodic_body_force(tmp_path):
    """A TOML case can express the body-force-driven periodic channel:
    generate-with-periodic + fluid.body_force -> Poiseuille."""
    from orc_cfd.utils.config import build_problem, parse_case

    case = parse_case(
        """
[case]
iterations = 500
reporting_interval = 250

[case.generate]
nx = 8
ny = 16
nz = 1
lengths = [2.0, 1.0, 0.1]
periodic = ["x"]

[fluid]
rho = 1.0
mu = 0.1
body_force = [1.0, 0.0, 0.0]

[numerics]
momentum = "ud"
pressure_interpolation = "linear_weighted"
velocity_interpolation = "rhie_chow"
pressure_relaxation = 0.01

[numerics.solver]
type = "bicgstab"
iterations = 30

[boundaries.TOP_WALL]
type = "wall"

[boundaries.BOTTOM_WALL]
type = "wall"

[boundaries."PERIODIC_-Z"]
type = "symmetry"

[boundaries."PERIODIC_+Z"]
type = "symmetry"
"""
    )
    assert case.body_force == (1.0, 0.0, 0.0)
    mesh, table = build_problem(case)
    assert case.settings.momentum_source is not None
    from orc_cfd.solver.simple import initial_state, solve_steady

    state, _ = solve_steady(
        mesh, table, case.settings, case.rho, case.mu,
        state=initial_state(mesh), iterations=case.iterations,
        reporting_interval=case.reporting_interval, verbose=False,
    )
    u = np.asarray(state.vel)[:, 0].reshape(16, 8)
    y = (np.arange(16) + 0.5) / 16
    u_exact = 1.0 / (2 * 0.1) * y * (1 - y)
    err = np.abs(u.mean(axis=1) - u_exact).max() / u_exact.max()
    assert err < 5e-3, err


def test_run_sequenced_case(tmp_path):
    """[case.sequencing] drives the grid cascade from the CLI
    (solver/sequencing.py surfaced in TOML)."""
    case = tmp_path / "seq.toml"
    out = tmp_path / "seq.csv"
    case.write_text(
        f"""
[case]
iterations = 30
reporting_interval = 30
data_file = "{out}"

[case.generate]
nx = 16
ny = 16
nz = 1
lengths = [1.0, 1.0, 0.0625]

[case.sequencing]
levels = 3
iterations_per_level = 20

[fluid]
rho = 1.0
mu = 0.01

[numerics]
momentum = "ud"
pressure_interpolation = "linear_weighted"
velocity_interpolation = "linear_weighted"
relaxation_mode = "implicit"
momentum_relaxation = 0.7
pressure_relaxation = 0.1

[numerics.solver]
type = "bicgstab"
iterations = 25
preconditioner = "jacobi"

[boundaries.TOP_WALL]
type = "wall"
velocity = [1.0, 0.0, 0.0]

[boundaries."PERIODIC_-Z"]
type = "symmetry"

[boundaries."PERIODIC_+Z"]
type = "symmetry"
"""
    )
    from orc_cfd.cli import main

    rc = main(["run", str(case)])
    assert rc in (0, None)
    assert out.exists()
    import numpy as np

    from orc_cfd.utils.config import load_case, sequencing_schedule

    c = load_case(str(case))
    assert sequencing_schedule(c) == [(4, 4, 1), (8, 8, 1), (16, 16, 1)]


def test_sequencing_schedule_stops_at_odd_dims(tmp_path):
    """Halving must stop at the first odd dim: every adjacent pair in
    the schedule must be integer-divisible or the prolongation step
    (solver/sequencing.upsample_field) raises mid-cascade."""
    case = tmp_path / "case.toml"
    case.write_text(
        """
[case]
iterations = 1
[case.generate]
kind = "cavity"
nx = 100
ny = 100
nz = 1
[case.sequencing]
levels = 4
"""
    )
    from orc_cfd.utils.config import load_case, sequencing_schedule

    dims = sequencing_schedule(load_case(str(case)))
    assert dims == [(25, 25, 1), (50, 50, 1), (100, 100, 1)]
    for coarse, fine in zip(dims, dims[1:]):
        assert all(
            f % c == 0 for c, f in zip(coarse, fine) if c > 1
        ), (coarse, fine)
