"""Structured geometric multigrid (solver/gmg.py).

Galerkin coarse operators are pinned against dense R A P products, the
V-cycle against known solutions, and the full SIMPLE loop under
SolutionMethod.MULTIGRID against the BiCGSTAB trajectory's converged
fields. (Reference multigrid: linear_algebra.rs:65-141 — which fails
its own known-solution test, linear_algebra.rs:344-345.)
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from orc_cfd.mesh.generate import structured_box_mesh
from orc_cfd.mesh.zones import FaceCondition
from orc_cfd.ops.assembly import diffusion_system
from orc_cfd.ops.fields import device_bc, face_bc
from orc_cfd.ops.spmv import EllMatrix
from orc_cfd.solver.gmg import (
    GmgLevel,
    build_gmg_hierarchy,
    build_mg_hierarchy,
    galerkin,
    gmg_solve,
    infer_box_dims,
    prolong,
    restrict,
)
from orc_cfd.utils.settings import (
    MatrixSolverSettings,
    MatrixSolverSettings as MSS,
    MomentumScheme,
    NumericalSettings,
    PreconditionMethod,
    PressureInterpolation,
    SolutionMethod,
    VelocityInterpolation,
)

MG = MSS(
    solver_type=SolutionMethod.MULTIGRID,
    iterations=30,
    multigrid_levels=4,
    multigrid_smoother_iterations=4,
    relative_convergence_threshold=1e-10,
    preconditioner=PreconditionMethod.NONE,
)


def test_infer_box_dims():
    # (nx, ny, nz) recovered up to an axis relabeling that preserves
    # strides; what matters is stride consistency, checked via volume.
    for nx, ny, nz, per in ((16, 12, 1, ()), (8, 6, 4, ()), (12, 8, 1, ("x",))):
        mesh, _ = structured_box_mesh(nx, ny, nz, periodic=per)
        dims = infer_box_dims(mesh.neighbor_offsets, mesh.n_cells)
        assert dims is not None
        assert np.prod(dims) == mesh.n_cells
    # Irregular offsets: no box.
    assert infer_box_dims((1, -1, 5, -5, 9, -9), 100) is None


def _dense(A, C):
    Ad = np.zeros((C, C))
    Ad[np.arange(C), np.arange(C)] = np.asarray(A.diag)
    nb = np.asarray(A.neighbors)
    off = np.asarray(A.off)
    for k in range(nb.shape[1]):
        np.add.at(Ad, (np.arange(C), nb[:, k]), off[:, k])
    return Ad


def _diffusion_matrix(mesh, table, shift=0.1):
    zc, zs, zv = device_bc(table, mesh.dtype)
    fbc = face_bc(mesh, zc, zs, zv)
    d = diffusion_system(mesh, fbc, jnp.asarray(1.0, mesh.dtype))
    return EllMatrix(
        diag=d.diag + shift,
        off=d.off,
        neighbors=mesh.cell_neighbors,
        offsets=mesh.neighbor_offsets,
    )


@pytest.mark.parametrize(
    "nx,ny,nz,per",
    [(16, 12, 1, ()), (15, 9, 1, ()), (8, 6, 4, ()), (12, 8, 1, ("x",))],
)
def test_galerkin_matches_dense(nx, ny, nz, per):
    """Block-sum Galerkin == dense R A P on even/odd/3D/periodic boxes."""
    mesh, table = structured_box_mesh(nx, ny, nz, periodic=per)
    dims = infer_box_dims(mesh.neighbor_offsets, mesh.n_cells)
    h = build_gmg_hierarchy(dims, mesh.neighbor_offsets, MG)
    assert h
    A = _diffusion_matrix(mesh, table)
    C = mesh.n_cells
    Ad = _dense(A, C)
    l0 = h[0]
    Pj = jax.jit(lambda e: prolong(e, l0))
    Rd = np.stack(
        [np.asarray(Pj(jnp.asarray(row))) for row in np.eye(l0.n_coarse)]
    )
    Ac_dense = Rd @ Ad @ Rd.T
    empty = np.abs(Ac_dense).sum(1) == 0
    Ac_dense[empty, empty] = 1.0  # identity rows for all-padding blocks
    Ac = jax.jit(lambda a: galerkin(a, l0))(A)
    nC = l0.n_coarse
    Acd = np.zeros((nC, nC))
    Acd[np.arange(nC), np.arange(nC)] = np.asarray(Ac.diag)
    for j, d in enumerate(l0.coarse_offsets):
        idx = (np.arange(nC) + d) % nC
        np.add.at(Acd, (np.arange(nC), idx), np.asarray(Ac.off[:, j]))
    np.testing.assert_allclose(Acd, Ac_dense, atol=1e-12)
    # Restriction/prolongation are transposes: <R r, e> == <r, P e>.
    rng = np.random.default_rng(0)
    r = jnp.asarray(rng.standard_normal(C))
    e = jnp.asarray(rng.standard_normal(nC))
    lhs = float(jnp.dot(restrict(r, l0), e))
    rhs = float(jnp.dot(r, prolong(e, l0)))
    assert abs(lhs - rhs) < 1e-10 * max(abs(lhs), 1.0)


def test_vcycle_known_solution():
    mesh, table = structured_box_mesh(16, 12, 1)
    dims = infer_box_dims(mesh.neighbor_offsets, mesh.n_cells)
    h = build_gmg_hierarchy(dims, mesh.neighbor_offsets, MG)
    A = _diffusion_matrix(mesh, table)
    C = mesh.n_cells
    rng = np.random.default_rng(1)
    xs = rng.standard_normal(C)
    b = jnp.asarray(_dense(A, C) @ xs)
    solve = jax.jit(lambda b, x: gmg_solve(A, b, x, MG, h)[0])
    x = jnp.zeros(C, A.diag.dtype)
    for _ in range(8):
        x = solve(b, x)
    np.testing.assert_allclose(np.asarray(x), xs, rtol=1e-6, atol=1e-8)


def test_build_mg_hierarchy_dispatch():
    """Structured meshes get the geometric hierarchy; irregular ones
    fall back to AMG levels."""
    mesh, table = structured_box_mesh(8, 8, 1)
    zc, zs, zv = device_bc(table, mesh.dtype)
    fbc = face_bc(mesh, zc, zs, zv)
    diff = diffusion_system(mesh, fbc, jnp.asarray(1.0, mesh.dtype))

    class FakeSettings:
        matrix_solver = MG

    h = build_mg_hierarchy(mesh, diff, FakeSettings)
    assert isinstance(h[0], GmgLevel)


def test_simple_with_gmg_matches_bicgstab():
    """Full SIMPLE under MULTIGRID (geometric) converges to the same
    cavity fields as BiCGSTAB."""
    from orc_cfd.models.cavity import cavity_case
    from orc_cfd.solver.simple import initial_state, solve_steady

    from orc_cfd.utils.settings import RelaxationMode

    mesh, table = cavity_case(n=16, lid_velocity=1.0)
    # Enclosed flow: implicit (Patankar) relaxation is the stable
    # configuration (explicit diverges on cavities once the momentum
    # solves actually converge — see tests/test_cavity.py docstring).
    base = NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
        relaxation_mode=RelaxationMode.IMPLICIT,
        momentum_relaxation=0.7,
        pressure_relaxation=0.1,
        matrix_solver=MSS(
            solver_type=SolutionMethod.BICGSTAB,
            iterations=40,
            preconditioner=PreconditionMethod.JACOBI,
        ),
    )
    mg = base.replace(
        matrix_solver=MSS(
            solver_type=SolutionMethod.MULTIGRID,
            iterations=40,
            multigrid_levels=3,
            multigrid_smoother_iterations=5,
            preconditioner=PreconditionMethod.JACOBI,
        )
    )
    kw = dict(iterations=1000, reporting_interval=1000, verbose=False)
    s_ref, _ = solve_steady(
        mesh, table, base, 1.0, 0.01, state=initial_state(mesh), **kw
    )
    s_mg, _ = solve_steady(
        mesh, table, mg, 1.0, 0.01, state=initial_state(mesh), **kw
    )
    # Different inner solvers converge along different trajectories;
    # compare fields on the O(1) velocity scale (lid speed = 1).
    np.testing.assert_allclose(
        np.asarray(s_mg.vel), np.asarray(s_ref.vel), rtol=0, atol=5e-3
    )
    np.testing.assert_allclose(
        np.asarray(s_mg.p), np.asarray(s_ref.p), rtol=0, atol=5e-3
    )


@pytest.mark.parametrize("ck", [False, "auto"])
def test_sharded_multigrid_matches_single_device(ck):
    """Distributed MULTIGRID (fine level distributed, coarse levels
    replicated) reproduces the single-device trajectory."""
    from orc_cfd.parallel.sharded import solve_steady_sharded
    from orc_cfd.solver.simple import initial_state, solve_steady

    mesh, table = structured_box_mesh(8, 8, 1, lengths=(0.002, 0.001, 0.0001))
    table.set("TOP_WALL", FaceCondition.WALL, vector_value=(5e-4, 0, 0))
    table.set("INLET", FaceCondition.PRESSURE_INLET, scalar_value=0.01)
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    settings = NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
        matrix_solver=MSS(
            solver_type=SolutionMethod.MULTIGRID,
            iterations=25,
            multigrid_levels=3,
            multigrid_smoother_iterations=5,
            preconditioner=PreconditionMethod.JACOBI,
        ),
    )
    kw = dict(iterations=20, reporting_interval=20, verbose=False)
    ref_state, _ = solve_steady(
        mesh, table, settings, 1000.0, 0.001,
        state=initial_state(mesh), **kw,
    )
    sh_state, _ = solve_steady_sharded(
        mesh, table, settings, 1000.0, 0.001,
        state=initial_state(mesh), n_devices=4, use_ck=ck, **kw,
    )
    np.testing.assert_allclose(
        np.asarray(sh_state.vel), np.asarray(ref_state.vel),
        rtol=1e-8, atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(sh_state.p), np.asarray(ref_state.p),
        rtol=1e-8, atol=1e-12,
    )


def test_gmg_periodic_poiseuille():
    """MULTIGRID solves the periodic channel (wrap offsets at every
    level)."""
    from tests.test_periodic import body_force_settings, periodic_channel
    from orc_cfd.solver.simple import initial_state, solve_steady

    nx, ny, H = 8, 16, 1.0
    mesh, table = periodic_channel(nx=nx, ny=ny, H=H)
    settings = body_force_settings(
        mesh,
        1.0,
        matrix_solver=MSS(
            solver_type=SolutionMethod.MULTIGRID,
            iterations=30,
            multigrid_levels=3,
            multigrid_smoother_iterations=5,
            preconditioner=PreconditionMethod.JACOBI,
        ),
    )
    state, _ = solve_steady(
        mesh, table, settings, 1.0, 0.1,
        state=initial_state(mesh), iterations=400,
        reporting_interval=200, verbose=False,
    )
    u = np.asarray(state.vel)[:, 0].reshape(ny, nx)
    y = (np.arange(ny) + 0.5) * (H / ny)
    u_exact = 1.0 / (2 * 0.1) * y * (H - y)
    err = np.abs(u.mean(axis=1) - u_exact).max() / u_exact.max()
    assert err < 5e-3, err
