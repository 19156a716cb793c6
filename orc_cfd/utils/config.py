"""TOML case files: mesh + boundary conditions + fluid + numerics.

The reference has no file-based configuration — settings are Rust
structs edited in source, BCs are set programmatically, and
`read_settings`/`write_settings` are empty stubs (io.rs:517,664;
README.md:49,51). This module provides the real thing: a complete case
is one declarative TOML file.

Example:

    [case]
    mesh = "examples/couette_flow_128x64x1.msh"
    iterations = 1000
    reporting_interval = 100

    [fluid]
    rho = 1000.0
    mu = 0.001

    [numerics]
    momentum = "cd1"            # ud | cd1 | tvd_lud | tvd_quick | tvd_umist
    pressure_interpolation = "second_order"
    velocity_interpolation = "rhie_chow"
    pressure_relaxation = 0.01

    [numerics.solver]
    type = "multigrid"          # jacobi | gauss_seidel | bicgstab | multigrid
    iterations = 50

    [boundaries.TOP_WALL]
    type = "wall"
    velocity = [1e-3, 0.0, 0.0]

    [boundaries.INLET]
    type = "pressure_inlet"
    pressure = 10.0
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from orc_cfd.mesh.zones import FaceCondition
from orc_cfd.utils.settings import (
    DiffusionScheme,
    RelaxationMode,
    GradientReconstruction,
    MatrixSolverSettings,
    MomentumScheme,
    NumericalSettings,
    PreconditionMethod,
    PressureInterpolation,
    RestrictionMethod,
    SolutionMethod,
    PressureCorrectionForm,
    PressureVelocityCoupling,
    VelocityInterpolation,
    tvd_lud,
    tvd_quick,
    tvd_umist,
)

_BC_TYPES = {
    "interior": FaceCondition.INTERIOR,
    "wall": FaceCondition.WALL,
    "pressure_inlet": FaceCondition.PRESSURE_INLET,
    "pressure_outlet": FaceCondition.PRESSURE_OUTLET,
    "symmetry": FaceCondition.SYMMETRY,
    "velocity_inlet": FaceCondition.VELOCITY_INLET,
    # Periodic pairs are merged into interior faces at mesh compile;
    # the types remain settable for bookkeeping/round-trip fidelity.
    "periodic": FaceCondition.PERIODIC,
    "periodic_shadow": FaceCondition.PERIODIC_SHADOW,
}

_MOMENTUM = {
    "ud": (MomentumScheme.UD, None),
    "cd1": (MomentumScheme.CD1, None),
    "cd2": (MomentumScheme.CD2, None),
    "tvd_lud": (MomentumScheme.TVD, tvd_lud),
    "tvd_quick": (MomentumScheme.TVD, tvd_quick),
    "tvd_umist": (MomentumScheme.TVD, tvd_umist),
    # Deferred-correction TVD (orc_cfd extension; see
    # MomentumScheme.TVD_DC) — the conservative second-order scheme.
    "tvd_dc_lud": (MomentumScheme.TVD_DC, tvd_lud),
    "tvd_dc_quick": (MomentumScheme.TVD_DC, tvd_quick),
    "tvd_dc_umist": (MomentumScheme.TVD_DC, tvd_umist),
}


@dataclasses.dataclass
class Case:
    mesh_path: Optional[str]
    generate: Optional[dict]  # {nx, ny, nz, lengths}
    iterations: int
    reporting_interval: int
    time: Optional[dict]  # {dt, steps, inner_iterations} -> transient run
    # Mesh-sequencing cascade ([case.sequencing], solver/sequencing.py):
    # {dims = [[nx,ny,nz], ...]} explicit coarse->fine schedule, or
    # {levels = N} halving the generated dims N-1 times; plus optional
    # iterations_per_level (default 4000). Final-level iteration count
    # is case.iterations. Only for generated structured boxes.
    sequencing: Optional[dict]
    turbulence: Optional[dict]  # {model, intensity, length_scale, u_ref}
    data_file: Optional[str]
    gradients_file: Optional[str]
    checkpoint_file: Optional[str]
    vtk_file: Optional[str]
    rho: float
    mu: float
    # Constant body force per unit volume [fx, fy, fz] (None = off);
    # becomes a momentum_source closure over the mesh cell volumes in
    # build_problem. Drives streamwise-periodic channels.
    body_force: Optional[Tuple[float, float, float]]
    settings: NumericalSettings
    boundaries: Dict[str, dict]
    devices: Any  # int | "all"


def _enum_of(table: dict, value: str, what: str):
    try:
        return table[value.lower()]
    except KeyError:
        raise ValueError(
            f"unknown {what} '{value}'; options: {sorted(table)}"
        ) from None


def parse_case(text: str) -> Case:
    import tomllib

    doc = tomllib.loads(text)
    case = doc.get("case", {})
    fluid = doc.get("fluid", {})
    num = doc.get("numerics", {})
    sol = num.get("solver", {})
    run = doc.get("run", {})

    momentum, psi = _enum_of(_MOMENTUM, num.get("momentum", "cd1"), "momentum scheme")
    solver = MatrixSolverSettings(
        solver_type=_enum_of(
            {m.value: m for m in SolutionMethod},
            sol.get("type", "multigrid"),
            "solver",
        ),
        iterations=int(sol.get("iterations", 50)),
        relaxation=float(sol.get("relaxation", 0.5)),
        relative_convergence_threshold=float(sol.get("convergence", 1e-3)),
        preconditioner=_enum_of(
            {m.value: m for m in PreconditionMethod},
            sol.get("preconditioner", "jacobi"),
            "preconditioner",
        ),
        multigrid_levels=int(sol.get("multigrid_levels", 3)),
        multigrid_smoother_iterations=(
            int(sol["smoother_iterations"])
            if "smoother_iterations" in sol
            else None
        ),
        multigrid_restriction=_enum_of(
            {m.value: m for m in RestrictionMethod},
            sol.get("multigrid_restriction", "strongest"),
            "restriction",
        ),
        compensated_f32=bool(sol.get("compensated_f32", False)),
        # momentum_iterations = 0 -> disable the fixed-count momentum
        # smoother (solve momentum with the configured solver instead).
        momentum_iterations=(
            (int(sol["momentum_iterations"]) or None)
            if "momentum_iterations" in sol
            else MatrixSolverSettings.momentum_iterations
        ),
    )
    settings = NumericalSettings(
        momentum=momentum,
        tvd_psi=psi,
        diffusion=DiffusionScheme.CD,
        pressure_interpolation=_enum_of(
            {m.value: m for m in PressureInterpolation},
            num.get("pressure_interpolation", "second_order"),
            "pressure interpolation",
        ),
        velocity_interpolation=_enum_of(
            {m.value: m for m in VelocityInterpolation},
            num.get("velocity_interpolation", "rhie_chow"),
            "velocity interpolation",
        ),
        pressure_correction_form=_enum_of(
            {m.value: m for m in PressureCorrectionForm},
            num.get("pressure_correction_form", "cell_difference"),
            "pressure correction form",
        ),
        pressure_velocity_coupling=_enum_of(
            {m.value: m for m in PressureVelocityCoupling},
            num.get("pressure_velocity_coupling", "auto"),
            "pressure-velocity coupling",
        ),
        gradient_reconstruction=_enum_of(
            {m.value: m for m in GradientReconstruction},
            num.get("gradient_reconstruction", "green_gauss_cell"),
            "gradient reconstruction",
        ),
        momentum_relaxation=float(num.get("momentum_relaxation", 0.5)),
        relaxation_mode=_enum_of(
            {m.value: m for m in RelaxationMode},
            num.get("relaxation_mode", "explicit"),
            "relaxation mode",
        ),
        pressure_relaxation=float(num.get("pressure_relaxation", 0.01)),
        matrix_solver=solver,
    )

    gen = case.get("generate")
    mesh_path = case.get("mesh")
    if not mesh_path and not gen:
        raise ValueError("case must specify `mesh` or `generate`")
    return Case(
        mesh_path=mesh_path,
        generate=gen,
        iterations=int(case.get("iterations", 100)),
        reporting_interval=int(case.get("reporting_interval", 10)),
        time=doc.get("time"),
        sequencing=case.get("sequencing"),
        turbulence=doc.get("turbulence"),
        data_file=case.get("data_file"),
        gradients_file=case.get("gradients_file"),
        checkpoint_file=case.get("checkpoint_file"),
        vtk_file=case.get("vtk_file"),
        rho=float(fluid.get("rho", 1000.0)),
        mu=float(fluid.get("mu", 0.001)),
        body_force=(
            tuple(float(c) for c in fluid["body_force"])
            if "body_force" in fluid
            else None
        ),
        settings=settings,
        boundaries=doc.get("boundaries", {}),
        devices=run.get("devices", 1),
    )


def load_case(path: str) -> Case:
    with open(path) as f:
        return parse_case(f.read())


def build_problem(case: Case, dims=None):
    """(mesh, table) with BCs from the case file applied.

    `dims=(nx, ny, nz)` overrides the generated box resolution (the
    mesh-sequencing cascade rebuilds each level through this)."""
    need_nodes = (
        case.settings.gradient_reconstruction
        == GradientReconstruction.GREEN_GAUSS_NODE
    )
    if case.mesh_path:
        if dims is not None:
            raise ValueError(
                "[case.sequencing] needs [case.generate] (a TGRID mesh "
                "file cannot be re-generated at coarser resolutions)"
            )
        from orc_cfd.mesh import read_mesh

        mesh, table = read_mesh(case.mesh_path, nodes=need_nodes)
    else:
        from orc_cfd.mesh import structured_box_mesh

        if need_nodes:
            raise ValueError(
                "green_gauss_node needs the mesh file's vertex topology; "
                "write the generated mesh with write_tgrid and point "
                "`mesh` at it instead of using [case.generate]"
            )
        g = dict(case.generate)
        if dims is None:
            dims = (int(g.get("nx", 8)), int(g.get("ny", 8)),
                    int(g.get("nz", 1)))
        mesh, table = structured_box_mesh(
            *dims,
            lengths=tuple(g.get("lengths", (1.0, 1.0, 1.0))),
            periodic=tuple(g.get("periodic", ())),
        )
    for name, spec in case.boundaries.items():
        kind = _enum_of(_BC_TYPES, spec.get("type", "wall"), "BC type")
        table.set(
            name,
            kind,
            scalar_value=spec.get("pressure"),
            vector_value=spec.get("velocity"),
        )
    # Periodic types are only valid as bookkeeping on zones whose face
    # pairs were merged away at mesh compile. A LIVE zone retyped
    # "periodic" would silently match no BC arm in the solver, so
    # reject it loudly here.
    import numpy as np

    face_slots = np.asarray(mesh.face_zone_slot)
    for zid, fz in table.zones.items():
        if fz.zone_type in (
            FaceCondition.PERIODIC,
            FaceCondition.PERIODIC_SHADOW,
        ):
            slot = table.slot_of_zone[zid]
            if (face_slots == slot).any():
                raise ValueError(
                    f"zone '{fz.name}' is typed {fz.zone_type.name} but "
                    f"still has faces: periodic pairs must come from the "
                    f"mesh (TGRID `(18` sections or generate.periodic), "
                    f"not from retyping a live boundary"
                )
    if case.body_force is not None:
        import jax.numpy as jnp

        f = jnp.asarray(case.body_force, mesh.dtype)

        # Two-arg form: the assembly passes LOCAL centroids+volumes, so
        # the same closure works single-device and under shard_map
        # (closing over the global volume array would shape-mismatch
        # the per-device blocks).
        def momentum_source(cc, vol, _f=f):
            return _f[None, :] * vol[:, None]

        case.settings = case.settings.replace(
            momentum_source=momentum_source
        )
    return mesh, table


def default_case_toml() -> str:
    """A complete, commented default case file (the `write_settings`
    the reference never implemented)."""
    return """\
[case]
# A TGRID mesh file (or replace with the [case.generate] block below).
mesh = "examples/couette_flow_128x64x1.msh"
iterations = 1000
reporting_interval = 100
data_file = "out/solution.csv"        # also the warm-start source
gradients_file = "out/gradients.csv"
checkpoint_file = "out/checkpoint.npz"
# vtk_file = "out/solution.vtk"       # legacy VTK for ParaView/VisIt

# Alternative to `mesh`: generate a structured box. NOTE: keep this
# sub-table *after* the plain [case] keys (TOML table scoping).
# [case.generate]
# nx = 128
# ny = 64
# nz = 1
# lengths = [0.002, 0.001, 0.0001]
# periodic = ["x"]          # translationally-periodic axes (wrap faces)

[fluid]
rho = 1000.0
mu = 0.001
# Constant body force per unit volume — the standard driver for
# streamwise-periodic channels:
# body_force = [1.0, 0.0, 0.0]

[numerics]
momentum = "cd1"                      # ud | cd1 | tvd_lud | tvd_quick | tvd_umist
pressure_interpolation = "second_order"  # linear | linear_weighted | second_order
velocity_interpolation = "rhie_chow"  # linear | linear_weighted | rhie_chow
# pressure_correction_form = "cell_difference"  # cell_difference (reference parity) | face_value (consistent; pair with rhie_chow)
# pressure_velocity_coupling = "auto"  # auto (DEFAULT: simple_fc under rhie_chow + implicit relaxation, else simple) | simple_fc (conservative stored fluxes; alpha_p ~0.3 with implicit relaxation) | simple (reference parity)
gradient_reconstruction = "green_gauss_cell"  # green_gauss_cell | green_gauss_node | least_squares
momentum_relaxation = 0.5
relaxation_mode = "explicit"         # implicit (Patankar) for enclosed flows
pressure_relaxation = 0.01

[numerics.solver]
type = "multigrid"                    # jacobi | gauss_seidel | bicgstab | multigrid
iterations = 50
relaxation = 0.5
convergence = 1e-3
preconditioner = "jacobi"             # none | jacobi
# compensated_f32 = true              # f64-accumulated reductions for f32 runs
# momentum_iterations = 6             # fixed-count momentum smoother sweeps (0 = full solver)

[boundaries.TOP_WALL]
type = "wall"
velocity = [0.0, 0.0, 0.0]

[boundaries.BOTTOM_WALL]
type = "wall"

[boundaries.INLET]
type = "velocity_inlet"
velocity = [1e-3, 0.0, 0.0]

[boundaries.OUTLET]
type = "pressure_outlet"
pressure = 0.0

[boundaries."PERIODIC_-Z"]
type = "symmetry"

[boundaries."PERIODIC_+Z"]
type = "symmetry"

[run]
devices = 1                           # or "all" for a sharded run

# Uncomment for a RANS run with the standard k-epsilon model
# (validated vs the Re_tau=590 DNS, tests/test_turbulence.py):
# [turbulence]
# model = "k_epsilon"
# intensity = 0.05
# length_scale = 0.1
# u_ref = 1.0

# Uncomment for a transient (implicit-Euler time-marching) run:
# [time]
# dt = 0.01
# steps = 100
# inner_iterations = 15
"""


def sequencing_schedule(case: Case):
    """Coarse->fine (nx, ny, nz) schedule from [case.sequencing]."""
    if not case.sequencing:
        return None
    seq = dict(case.sequencing)
    if "dims" in seq:
        dims = [tuple(int(d) for d in row) for row in seq["dims"]]
        if any(len(d) != 3 for d in dims):
            raise ValueError("sequencing.dims rows must be [nx, ny, nz]")
        return dims
    levels = int(seq.get("levels", 1))
    g = dict(case.generate or {})
    fine = (int(g.get("nx", 8)), int(g.get("ny", 8)), int(g.get("nz", 1)))
    dims = [fine]
    for _ in range(levels - 1):
        nx, ny, nz = dims[0]
        # Prolongation (solver/sequencing.upsample_field) requires each
        # finer dim to be an integer multiple of the coarser one, so
        # halving is only legal while every >1 dim is even; stop the
        # cascade at the first odd dim instead of crashing mid-run at
        # the prolongation step.
        if any(d > 1 and d % 2 for d in (nx, ny, nz)):
            break
        coarser = tuple(d // 2 if d > 1 else d for d in (nx, ny, nz))
        if coarser == dims[0]:
            break
        dims.insert(0, coarser)
    return dims
