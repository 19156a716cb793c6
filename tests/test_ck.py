"""Equivalence of the gather-free (c,k)-direct step against the
face-major reference implementation, across schemes and meshes."""

import numpy as np
import pytest

import jax.numpy as jnp

from orc_cfd.mesh import read_mesh, structured_box_mesh
from orc_cfd.mesh.zones import FaceCondition
from orc_cfd.ops.assembly import diffusion_system
from orc_cfd.ops.fields import device_bc, face_bc
from orc_cfd.ops.ck_ops import build_ck_geometry, ck_bc, ck_diffusion
from orc_cfd.solver.simple import (
    ck_simple_step,
    initial_state,
    simple_step,
    solve_steady,
)
from orc_cfd.utils.settings import (
    GradientReconstruction,
    MatrixSolverSettings,
    MomentumScheme,
    NumericalSettings,
    PreconditionMethod,
    PressureInterpolation,
    SolutionMethod,
    VelocityInterpolation,
    tvd_umist,
)

RHO, MU = 1000.0, 0.001


def make_case(nx=8, ny=6):
    mesh, table = structured_box_mesh(
        nx, ny, 1, lengths=(0.002, 0.001, 0.0001)
    )
    table.set("TOP_WALL", FaceCondition.WALL, vector_value=(5e-4, 0, 0))
    table.set("INLET", FaceCondition.PRESSURE_INLET, scalar_value=0.01)
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    return mesh, table


SCHEMES = {
    "robust": NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB,
            iterations=25,
            preconditioner=PreconditionMethod.JACOBI,
        ),
    ),
    "default": NumericalSettings(
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB,
            iterations=25,
            preconditioner=PreconditionMethod.JACOBI,
        ),
    ),
    "tvd": NumericalSettings(
        momentum=MomentumScheme.TVD,
        tvd_psi=tvd_umist,
        pressure_interpolation=PressureInterpolation.LINEAR,
        velocity_interpolation=VelocityInterpolation.LINEAR,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB,
            iterations=25,
            preconditioner=PreconditionMethod.JACOBI,
        ),
    ),
    "cd2": NumericalSettings(
        momentum=MomentumScheme.CD2,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB,
            iterations=25,
            preconditioner=PreconditionMethod.JACOBI,
        ),
    ),
    "tvd_dc": NumericalSettings(
        momentum=MomentumScheme.TVD_DC,
        tvd_psi=tvd_umist,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB,
            iterations=25,
            preconditioner=PreconditionMethod.JACOBI,
        ),
    ),
    # Least-squares gradients on the ck path (gather-free LSQ rows from
    # CKGeometry.r_on) vs the face-major LSQ — with TVD so both the
    # pressure- and velocity-gradient variants are exercised.
    "lsq": NumericalSettings(
        momentum=MomentumScheme.TVD,
        tvd_psi=tvd_umist,
        gradient_reconstruction=GradientReconstruction.LEAST_SQUARES,
        pressure_interpolation=PressureInterpolation.SECOND_ORDER,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB,
            iterations=25,
            preconditioner=PreconditionMethod.JACOBI,
        ),
    ),
}


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_ck_step_matches_face_major(scheme):
    settings = SCHEMES[scheme]
    mesh, table = make_case()
    zc, zs, zv = device_bc(table, mesh.dtype)
    fbc = face_bc(mesh, zc, zs, zv)
    diff = diffusion_system(mesh, fbc, jnp.asarray(MU, mesh.dtype))
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    bc0 = ck_bc(ck, zc, zs, zv)
    ckd = ck_diffusion(mesh, ck, bc0, jnp.asarray(MU, mesh.dtype))

    # Diffusion systems identical.
    np.testing.assert_allclose(
        np.asarray(ckd[0]), np.asarray(diff.diag), rtol=1e-13
    )
    np.testing.assert_allclose(
        np.asarray(ckd[2]), np.asarray(diff.b), rtol=1e-13, atol=1e-20
    )

    # Run steps through both paths from a nontrivial state.
    rng = np.random.default_rng(0)
    state = initial_state(
        mesh,
        vel=rng.standard_normal((mesh.n_cells, 3)) * 1e-4,
        p=rng.standard_normal(mesh.n_cells) * 1e-3,
    )
    # Non-smooth limiters (TVD) flip branches on rounding-level input
    # differences, so multi-step state comparison is meaningful only for
    # smooth schemes; one step suffices to pin the TVD path.
    n_steps = 1 if settings.momentum == MomentumScheme.TVD else 3
    s_fm, s_ck = state, state
    for _ in range(n_steps):
        s_fm, m_fm = simple_step(
            mesh, zc, zs, zv, settings, RHO, MU, diff, s_fm
        )
        s_ck, m_ck = ck_simple_step(
            mesh, ck, zc, zs, zv, settings, RHO, MU, ckd, s_ck
        )
    # Summation-order rounding is amplified by the Krylov iterations;
    # equivalence here is structural, not bitwise.
    np.testing.assert_allclose(
        np.asarray(s_ck.vel), np.asarray(s_fm.vel), rtol=3e-5, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(s_ck.p), np.asarray(s_fm.p), rtol=3e-5, atol=1e-12
    )
    np.testing.assert_allclose(
        float(m_ck.p_corr_norm), float(m_fm.p_corr_norm), rtol=1e-4
    )


def test_ck_on_unstructured_fallback(reference_mesh_dir):
    """The ck path must also work (via the gather fallback) on meshes
    without detected structure — e.g. after forcing offsets off."""
    import dataclasses
    import os

    mesh, table = read_mesh(
        os.path.join(reference_mesh_dir, "couette_flow_8x8x1.msh")
    )
    mesh = dataclasses.replace(mesh, neighbor_offsets=None)
    table.set("WALL", FaceCondition.WALL)
    table.set("INLET", FaceCondition.VELOCITY_INLET, vector_value=(1e-3, 0, 0))
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    settings = SCHEMES["robust"]
    zc, zs, zv = device_bc(table, mesh.dtype)
    fbc = face_bc(mesh, zc, zs, zv)
    diff = diffusion_system(mesh, fbc, jnp.asarray(MU, mesh.dtype))
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    bc0 = ck_bc(ck, zc, zs, zv)
    ckd = ck_diffusion(mesh, ck, bc0, jnp.asarray(MU, mesh.dtype))
    state = initial_state(mesh)
    s_fm, _ = simple_step(mesh, zc, zs, zv, settings, RHO, MU, diff, state)
    s_ck, _ = ck_simple_step(
        mesh, ck, zc, zs, zv, settings, RHO, MU, ckd, state
    )
    np.testing.assert_allclose(
        np.asarray(s_ck.vel), np.asarray(s_fm.vel), rtol=1e-8, atol=1e-14
    )


def test_solve_steady_ck_flag():
    """use_ck True and False produce the same converged answer."""
    mesh, table = make_case()
    settings = SCHEMES["robust"]
    r1, _ = solve_steady(
        mesh, table, settings, RHO, MU, iterations=50,
        reporting_interval=50, verbose=False, use_ck=True,
    )
    r2, _ = solve_steady(
        mesh, table, settings, RHO, MU, iterations=50,
        reporting_interval=50, verbose=False, use_ck=False,
    )
    np.testing.assert_allclose(
        np.asarray(r1.vel), np.asarray(r2.vel), rtol=1e-4, atol=1e-12
    )


@pytest.mark.parametrize(
    "dims,per",
    [((6, 5, 1), ()), ((4, 3, 3), ()), ((5, 4, 3), ("x",)), ((1, 6, 4), ())],
)
def test_uniform_ck_geometry_matches_expanded(dims, per):
    """UniformCKGeometry (per-column constants + masks) reproduces the
    expanded [C,K] geometry exactly on uniform boxes."""
    import dataclasses

    from orc_cfd.ops.ck_ops import UniformCKGeometry

    mesh, table = structured_box_mesh(*dims, periodic=per)
    assert mesh.ck_constants is not None
    g_u = build_ck_geometry(mesh, len(table.zone_ids))
    assert isinstance(g_u, UniformCKGeometry)
    mesh_e = dataclasses.replace(mesh, ck_constants=None)
    g_e = build_ck_geometry(mesh_e, len(table.zone_ids))

    m = np.asarray(g_e.mask)
    np.testing.assert_array_equal(np.asarray(g_u.mask), m)
    np.testing.assert_array_equal(
        np.asarray(g_u.interior), np.asarray(g_e.interior)
    )
    for name in ("area", "n_out", "w", "r_cf", "r_on", "dist_on",
                 "dist_fo"):
        a = np.asarray(getattr(g_u, name))
        b = np.asarray(getattr(g_e, name))
        np.testing.assert_allclose(
            a, b, rtol=1e-13, atol=1e-15, err_msg=name
        )
    # Zone slots only matter where a real face exists.
    zu = np.asarray(g_u.zone_slot)
    ze = np.asarray(g_e.zone_slot)
    np.testing.assert_array_equal(zu[m], ze[m])


def test_uniform_ck_step_matches_expanded():
    """A full ck SIMPLE step with the constants-based geometry matches
    the expanded-geometry step."""
    import dataclasses

    mesh, table = make_case()
    assert mesh.ck_constants is not None
    settings = SCHEMES["default"]
    zc, zs, zv = device_bc(table, mesh.dtype)
    g_u = build_ck_geometry(mesh, len(table.zone_ids))
    mesh_e = dataclasses.replace(mesh, ck_constants=None)
    g_e = build_ck_geometry(mesh_e, len(table.zone_ids))
    bc_u = ck_bc(g_u, zc, zs, zv)
    bc_e = ck_bc(g_e, zc, zs, zv)
    d_u = ck_diffusion(mesh, g_u, bc_u, jnp.asarray(MU, mesh.dtype))
    d_e = ck_diffusion(mesh_e, g_e, bc_e, jnp.asarray(MU, mesh.dtype))
    np.testing.assert_allclose(
        np.asarray(d_u[0]), np.asarray(d_e[0]), rtol=1e-12
    )
    rng = np.random.default_rng(2)
    state = initial_state(
        mesh,
        vel=rng.standard_normal((mesh.n_cells, 3)) * 1e-4,
        p=rng.standard_normal(mesh.n_cells) * 1e-3,
    )
    s_u, m_u = ck_simple_step(
        mesh, g_u, zc, zs, zv, settings, RHO, MU, d_u, state
    )
    s_e, m_e = ck_simple_step(
        mesh_e, g_e, zc, zs, zv, settings, RHO, MU, d_e, state
    )
    np.testing.assert_allclose(
        np.asarray(s_u.vel), np.asarray(s_e.vel), rtol=1e-8, atol=1e-14
    )
    np.testing.assert_allclose(
        np.asarray(s_u.p), np.asarray(s_e.p), rtol=1e-8, atol=1e-14
    )


def test_ck_constants_gating():
    """2D-periodic boxes put leftover z-faces in per-row columns, so
    they must NOT carry per-column constants; 3D-periodic and plain
    boxes must."""
    assert structured_box_mesh(6, 5, 1, periodic=("x",))[0].ck_constants is None
    assert structured_box_mesh(6, 5, 1)[0].ck_constants is not None
    assert structured_box_mesh(5, 4, 3, periodic=("x",))[0].ck_constants is not None


def test_solve_steady_ck_irregular_mesh():
    """solve_steady on an IRREGULAR mesh with the ck path: the runner
    must NOT trim the index tables the gather fallback reads
    (regression: trim_for_ck applied unconditionally broke this)."""
    import dataclasses

    mesh, table = make_case(6, 5)
    mesh = dataclasses.replace(
        mesh, neighbor_offsets=None, ck_constants=None
    )
    settings = SCHEMES["robust"]
    r1, _ = solve_steady(
        mesh, table, settings, RHO, MU, iterations=30,
        reporting_interval=30, verbose=False, use_ck=True,
    )
    r2, _ = solve_steady(
        mesh, table, settings, RHO, MU, iterations=30,
        reporting_interval=30, verbose=False, use_ck=False,
    )
    np.testing.assert_allclose(
        np.asarray(r1.vel), np.asarray(r2.vel), rtol=1e-4, atol=1e-12
    )
