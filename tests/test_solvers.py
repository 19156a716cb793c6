"""Linear-solver tests.

Port of the reference's only cargo test, `validate_iterative_solvers`
(linear_algebra.rs:309-378): a 100x100 diagonally-dominant system with
known solution x_i = 2i, solved by each method to ||r|| < 1e-3 — and
unlike the reference, multigrid and Gauss-Seidel must pass it too.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from orc_cfd.ops.spmv import EllMatrix
from orc_cfd.solver.krylov import iterative_solve
from orc_cfd.utils.settings import (
    MatrixSolverSettings,
    PreconditionMethod,
    SolutionMethod,
)

TOL = 1e-3
N = 100


def reference_test_system():
    """The tridiagonal-ish system of linear_algebra.rs:315-334."""
    diag = np.ones(N)
    neighbors = np.tile(np.arange(N)[:, None], (1, 2))
    off = np.zeros((N, 2))
    for i in range(N):
        for s, j in enumerate((i - 1, i + 1)):
            if 0 <= j < N and j != 0 and j != N - 1:
                neighbors[i, s] = j
                off[i, s] = -0.25
    x_true = 2.0 * np.arange(N)
    A = EllMatrix(
        diag=jnp.asarray(diag),
        off=jnp.asarray(off),
        neighbors=jnp.asarray(neighbors, dtype=jnp.int32),
    )
    b = A.matvec(jnp.asarray(x_true))
    return A, b, x_true


def dense(A):
    n = A.n
    M = np.diag(np.asarray(A.diag))
    off = np.asarray(A.off)
    nbr = np.asarray(A.neighbors)
    for i in range(n):
        for k in range(nbr.shape[1]):
            M[i, nbr[i, k]] += off[i, k]
    return M


def test_spmv_matches_dense():
    A, b, x_true = reference_test_system()
    M = dense(A)
    x = np.random.default_rng(0).standard_normal(N)
    np.testing.assert_allclose(np.asarray(A.matvec(jnp.asarray(x))), M @ x, rtol=1e-12)


@pytest.mark.parametrize(
    "method",
    [SolutionMethod.JACOBI, SolutionMethod.BICGSTAB, SolutionMethod.GAUSS_SEIDEL],
)
@pytest.mark.parametrize(
    "precond", [PreconditionMethod.JACOBI, PreconditionMethod.NONE]
)
def test_reference_known_solution(method, precond):
    A, b, x_true = reference_test_system()
    settings = MatrixSolverSettings(
        solver_type=method,
        iterations=50,
        relaxation=0.5,
        relative_convergence_threshold=TOL / N**3,
        preconditioner=precond,
    )
    kw = {}
    if method == SolutionMethod.GAUSS_SEIDEL:
        # 2-color (even/odd) is a valid coloring of a tridiagonal graph.
        kw = dict(colors=jnp.asarray(np.arange(N) % 2), n_colors=2)
    x, info = iterative_solve(A, b, jnp.zeros(N), settings, **kw)
    r = np.asarray(A.matvec(x) - b)
    assert np.linalg.norm(r) < TOL, f"{method}: |r|={np.linalg.norm(r)}"
    assert not bool(info.diverged)


def test_jacobi_smooth_known_solution():
    """JACOBI_SMOOTH (the fixed-count momentum smoother) contracts the
    reference system's residual monotonically and converges with enough
    sweeps — no adaptive exit, so accuracy is sweep-count-controlled."""
    A, b, x_true = reference_test_system()
    settings = MatrixSolverSettings(
        solver_type=SolutionMethod.JACOBI_SMOOTH,
        iterations=200,
        relaxation=0.8,
    )
    x, info = iterative_solve(A, b, jnp.zeros(N), settings)
    r = np.asarray(A.matvec(x) - b)
    assert np.linalg.norm(r) < TOL, np.linalg.norm(r)
    assert not bool(info.diverged)
    assert int(info.iterations) == 200
    # Fewer sweeps -> larger residual, but still contracted from entry.
    import dataclasses

    x6, _ = iterative_solve(
        A, b, jnp.zeros(N), dataclasses.replace(settings, iterations=6)
    )
    r6 = np.linalg.norm(np.asarray(A.matvec(x6) - b))
    assert np.linalg.norm(r) < r6 < np.linalg.norm(np.asarray(b))


def test_batched_solve_matches_individual():
    """vmap'ed batched solve (how u/v/w are solved) must equal three
    individual solves."""
    import jax

    A, b, x_true = reference_test_system()
    rng = np.random.default_rng(1)
    scale = jnp.asarray([1.0, 2.0, 0.5])
    diag3 = A.diag * scale[:, None]
    off3 = A.off * scale[:, None, None]
    b3 = jnp.stack([b, b * 3.0, b - 1.0])
    settings = MatrixSolverSettings(
        solver_type=SolutionMethod.BICGSTAB,
        iterations=40,
        preconditioner=PreconditionMethod.JACOBI,
    )

    def solve_one(d, o, bb):
        Ai = EllMatrix(diag=d, off=o, neighbors=A.neighbors)
        x, info = iterative_solve(Ai, bb, jnp.zeros(N), settings)
        return x

    batched = jax.vmap(solve_one)(diag3, off3, b3)
    for i in range(3):
        single = solve_one(diag3[i], off3[i], b3[i])
        np.testing.assert_allclose(np.asarray(batched[i]), np.asarray(single), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("restriction", ["strongest", "injection"])
def test_multigrid_known_solution(restriction):
    """The reference excludes Multigrid from this test because it fails
    (linear_algebra.rs:344-345). Ours must pass it, with both
    aggregation strategies."""
    from orc_cfd.solver.amg import build_hierarchy_from_matrix
    from orc_cfd.utils.settings import RestrictionMethod

    A, b, x_true = reference_test_system()
    settings = MatrixSolverSettings(
        solver_type=SolutionMethod.MULTIGRID,
        iterations=50,
        relaxation=0.5,
        relative_convergence_threshold=TOL / N**3,
        preconditioner=PreconditionMethod.JACOBI,
        multigrid_restriction=RestrictionMethod(restriction),
    )
    hierarchy = build_hierarchy_from_matrix(
        np.asarray(A.diag), np.asarray(A.off), np.asarray(A.neighbors), settings
    )
    assert len(hierarchy) >= 1
    x, info = iterative_solve(
        A, b, jnp.zeros(N), settings, mg_hierarchy=hierarchy
    )
    r = np.asarray(A.matvec(x) - b)
    assert np.linalg.norm(r) < TOL, np.linalg.norm(r)
    np.testing.assert_allclose(np.asarray(x), x_true, atol=5e-2)


def test_multigrid_galerkin_matches_dense():
    """A_c = R A R^T computed by the static scatter must equal the dense
    triple product."""
    from orc_cfd.solver.amg import (
        build_hierarchy_from_matrix,
        galerkin_values,
    )

    A, b, _ = reference_test_system()
    settings = MatrixSolverSettings(solver_type=SolutionMethod.MULTIGRID)
    hierarchy = build_hierarchy_from_matrix(
        np.asarray(A.diag), np.asarray(A.off), np.asarray(A.neighbors), settings
    )
    lvl = hierarchy[0]
    agg = np.asarray(lvl.agg)
    n_c = lvl.n_coarse
    R = np.zeros((n_c, N))
    R[agg, np.arange(N)] = 1.0
    dense_coarse = R @ dense(A) @ R.T
    Ac = galerkin_values(A, lvl)
    Mc = dense(Ac)
    np.testing.assert_allclose(Mc, dense_coarse, rtol=1e-12, atol=1e-12)


def test_structured_offsets_spmv_matches_gather():
    """Structured meshes detect constant ELL column offsets; the
    shift-based SpMV must equal the gather-based one exactly."""
    from orc_cfd.mesh import structured_box_mesh
    from orc_cfd.ops.spmv import ell_spmv

    mesh, _ = structured_box_mesh(5, 4, 3)
    assert mesh.neighbor_offsets is not None
    nx = 5
    assert set(mesh.neighbor_offsets) >= {-1, 1, -nx, nx}
    rng = np.random.default_rng(0)
    C, K = mesh.cell_neighbors.shape
    # Coefficients must be zero wherever the entry is not a real
    # interior neighbor (the assembly guarantees this).
    interior = np.asarray(mesh.face_interior[mesh.cell_faces] & mesh.cell_face_mask)
    off = jnp.asarray(rng.standard_normal((C, K)) * interior)
    diag = jnp.asarray(rng.standard_normal(C))
    x = jnp.asarray(rng.standard_normal(C))
    y_shift = ell_spmv(diag, off, mesh.cell_neighbors, x, mesh.neighbor_offsets)
    y_gather = ell_spmv(diag, off, mesh.cell_neighbors, x, None)
    # Equal up to summation-order rounding (sequential shift-adds vs a
    # single K-axis reduction).
    np.testing.assert_allclose(
        np.asarray(y_shift), np.asarray(y_gather), rtol=1e-12, atol=1e-13
    )
    # And every nonzero coefficient's neighbor is exactly c + offset.
    delta = np.asarray(mesh.cell_neighbors) - np.arange(C)[:, None]
    for k, d in enumerate(mesh.neighbor_offsets):
        assert (delta[:, k][interior[:, k]] == d).all()


def test_structured_offsets_on_reference_mesh(reference_mesh_dir):
    """The Fluent-generated couette fixture should also be detected as
    structured (lexicographic cell numbering) — and if not, the gather
    path must still be used transparently."""
    import os

    from orc_cfd.mesh import read_mesh

    mesh, _ = read_mesh(
        os.path.join(reference_mesh_dir, "couette_flow_8x8x1.msh")
    )
    # Either detection succeeded (offsets consistent) or fell back.
    if mesh.neighbor_offsets is not None:
        nbrs = np.asarray(mesh.cell_neighbors)
        interior = np.asarray(
            mesh.face_interior[mesh.cell_faces] & mesh.cell_face_mask
        )
        C = mesh.n_cells
        delta = nbrs - np.arange(C)[:, None]
        for k, d in enumerate(mesh.neighbor_offsets):
            assert (delta[:, k][interior[:, k]] == d).all()


def test_jacobi_detects_divergence():
    # A non-diagonally-dominant system that Jacobi blows up on.
    diag = jnp.full((N,), 0.1)
    A0, b, _ = reference_test_system()
    A = EllMatrix(diag=diag, off=A0.off * 40.0, neighbors=A0.neighbors)
    settings = MatrixSolverSettings(
        solver_type=SolutionMethod.JACOBI,
        iterations=200,
        relaxation=1.0,
        preconditioner=PreconditionMethod.NONE,
    )
    x, info = iterative_solve(A, b, jnp.zeros(N), settings)
    assert bool(info.diverged)


def test_multigrid_tuned_smoother():
    """A cheap V-cycle (5 smoother sweeps/level, accurate coarsest
    solve) must still pass the known-solution test — this is the
    production configuration; the reference runs the full iteration
    count at every level."""
    from orc_cfd.solver.amg import build_hierarchy_from_matrix

    A, b, x_true = reference_test_system()
    settings = MatrixSolverSettings(
        solver_type=SolutionMethod.MULTIGRID,
        iterations=50,
        relative_convergence_threshold=TOL / N**3,
        preconditioner=PreconditionMethod.JACOBI,
        multigrid_smoother_iterations=5,
    )
    hierarchy = build_hierarchy_from_matrix(
        np.asarray(A.diag), np.asarray(A.off), np.asarray(A.neighbors), settings
    )
    x, info = iterative_solve(
        A, b, jnp.zeros(N), settings, mg_hierarchy=hierarchy
    )
    r = np.asarray(A.matvec(x) - b)
    assert np.linalg.norm(r) < TOL, np.linalg.norm(r)
    np.testing.assert_allclose(np.asarray(x), x_true, atol=5e-2)


def test_compensated_f32_reductions():
    """compensated_f32: f32 dot products accumulate in double width —
    the reduction error drops from f32-summation scale to ~f32 eps of
    the result (SURVEY §7 design stance)."""
    from orc_cfd.solver.krylov import (
        _dot,
        _dot_comp,
        _identity_sum,
        bicgstab_solve,
    )

    rng = np.random.default_rng(3)
    n = 200_000
    # Ill-conditioned sum: large cancelling pairs + small signal.
    big = rng.standard_normal(n // 2) * 1e4
    a64 = np.concatenate([big, -big]) + rng.standard_normal(n)
    b64 = np.ones(n)
    a32 = jnp.asarray(a64, jnp.float32)
    b32 = jnp.asarray(b64, jnp.float32)
    exact = float(np.sum(np.asarray(a32, np.float64)))
    plain = float(_dot(a32, b32, _identity_sum))
    comp = float(_dot_comp(a32, b32, _identity_sum))
    assert abs(comp - exact) <= abs(plain - exact)
    assert abs(comp - exact) < 1e-6 * np.sum(np.abs(a64))
    # Output dtype stays f32 (no f64 leaks into the Krylov state).
    assert _dot_comp(a32, b32, _identity_sum).dtype == jnp.float32

    # Solver-level: an f32 solve with compensation converges at least
    # as tightly as without on the reference system.
    A, b, x_true = reference_test_system()
    A32 = EllMatrix(
        diag=A.diag.astype(jnp.float32),
        off=A.off.astype(jnp.float32),
        neighbors=A.neighbors,
    )
    b32v = b.astype(jnp.float32)
    x_p, _ = bicgstab_solve(
        A32, b32v, jnp.zeros(N, jnp.float32), 60, compensated=False
    )
    x_c, info_c = bicgstab_solve(
        A32, b32v, jnp.zeros(N, jnp.float32), 60, compensated=True
    )
    assert x_c.dtype == jnp.float32
    r_c = np.linalg.norm(np.asarray(A32.matvec(x_c) - b32v))
    assert np.isfinite(r_c)
    np.testing.assert_allclose(
        np.asarray(x_c), x_true, rtol=2e-4, atol=2e-4
    )


def test_deflated_bicgstab_singular_system():
    """Constant-nullspace deflation (krylov.constant_deflation): a
    singular-but-consistent system — a 1D periodic Poisson ring, the
    structure of the p' system on a fully periodic domain — must solve
    to the zero-mean representative without NaN/blowup. Without the
    projection, the Jacobi-preconditioned operator loses
    range(A) ⊥ 1 and post-convergence BiCGSTAB steps amplify a
    roundoff-seeded constant (measured |x| > 1e10 spikes)."""
    from orc_cfd.solver.krylov import bicgstab_solve, constant_deflation

    n = 64
    neighbors = np.stack(
        [(np.arange(n) - 1) % n, (np.arange(n) + 1) % n], axis=1
    )
    A = EllMatrix(
        diag=jnp.full((n,), 2.0),
        off=jnp.full((n, 2), -1.0),
        neighbors=jnp.asarray(neighbors, jnp.int32),
    )
    x_true = jnp.asarray(np.sin(2 * np.pi * np.arange(n) / n))
    x_true = x_true - jnp.mean(x_true)
    b = A.matvec(x_true)  # consistent RHS (sum ~ 0)
    project = constant_deflation(jnp.asarray(1.0))
    Ap, inv_d = A.jacobi_preconditioned()
    x, info = bicgstab_solve(
        Ap, b * inv_d, jnp.zeros((n,)), 200,
        convergence_threshold=1e-12, project=project,
    )
    assert not bool(info.diverged)
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_true), atol=1e-8)
    assert abs(float(jnp.mean(x))) < 1e-10


def test_fully_periodic_domain_simple_runs():
    """End-to-end singular-p'-system coverage: a FULLY periodic box
    (every boundary zone merged at compile) exercises the deflated
    pressure solve inside the SIMPLE step — without deflation this
    diverges on the p' constant mode. Body-force driven so the flow is
    nontrivial; asserts bounded fields and the zero-mean p' gauge."""
    from orc_cfd.mesh import structured_box_mesh
    from orc_cfd.solver.simple import initial_state, solve_steady
    from orc_cfd.utils.settings import (
        MomentumScheme,
        NumericalSettings,
        PressureInterpolation,
        RelaxationMode,
        VelocityInterpolation,
    )

    mesh, table = structured_box_mesh(
        8, 8, 4, lengths=(1.0, 1.0, 0.5), periodic=("x", "y", "z"),
        dtype=jnp.float64,
    )
    settings = NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
        relaxation_mode=RelaxationMode.IMPLICIT,
        momentum_relaxation=0.7,
        pressure_relaxation=0.1,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB,
            iterations=50,
            preconditioner=PreconditionMethod.JACOBI,
        ),
        momentum_source=lambda cc, vol: jnp.stack(
            [vol, jnp.zeros_like(vol), jnp.zeros_like(vol)], axis=-1
        ),
    )
    state, hist = solve_steady(
        mesh, table, settings, 1.0, 0.1,
        state=initial_state(mesh), iterations=40, reporting_interval=40,
        verbose=False,
    )
    assert not bool(np.any(np.asarray(hist[-1].diverged)))
    vel = np.asarray(state.vel)
    p = np.asarray(state.p)
    assert np.isfinite(vel).all() and np.isfinite(p).all()
    # The gauge: p' is projected to zero mean every iteration, so the
    # accumulated p stays zero-mean too (fully periodic: no anchor).
    assert abs(p.mean()) < 1e-8 * (abs(p).max() + 1e-30)
