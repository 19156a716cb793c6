"""Fused assembly kernels vs the ck reference implementation
(interpret mode — runs on CPU; the GPU path is the same kernel
compiled through Triton).

Covers the full round-4 scheme window: UD / CD1 / TVD_DC momentum,
Linear[Weighted] / Rhie-Chow face velocities, Linear[Weighted] /
SecondOrder face pressures, velocity-inlet columns, the transient
inertia term, SIMPLE_FC, and the sharded runtime."""

import numpy as np
import pytest

import jax.numpy as jnp

from orc_cfd.models.cavity import cavity_case
from orc_cfd.mesh.generate import structured_box_mesh
from orc_cfd.mesh.zones import FaceCondition
from orc_cfd.ops.ck_ops import (
    build_ck_geometry,
    ck_bc,
    ck_diffusion,
    ck_face_pressure,
    ck_flux,
    ck_momentum,
    ck_pressure_gradient,
    ck_velocity_gradient,
    nbr_values,
)
from orc_cfd.ops.fields import device_bc
from orc_cfd.ops.pallas_assembly import (
    AsmSpec,
    bc_value_table,
    column_specs,
    momentum_assembly,
    pack_flags,
)
from orc_cfd.utils.settings import (
    MomentumScheme,
    NumericalSettings,
    PressureInterpolation,
    RelaxationMode,
    VelocityInterpolation,
    tvd_umist,
)


def _couette():
    mesh, table = structured_box_mesh(
        16, 8, 1, lengths=(0.002, 0.001, 0.0001), dtype=jnp.float32
    )
    table.set("TOP_WALL", FaceCondition.WALL, vector_value=(5e-4, 0, 0))
    table.set("INLET", FaceCondition.PRESSURE_INLET, scalar_value=0.01)
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    return mesh, table


def _vinlet_channel():
    mesh, table = structured_box_mesh(
        16, 8, 1, lengths=(0.002, 0.001, 0.0001), dtype=jnp.float32
    )
    table.set(
        "INLET", FaceCondition.VELOCITY_INLET, vector_value=(1e-3, 0, 0)
    )
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    return mesh, table


CASES = {
    "cavity": lambda: cavity_case(n=20, dtype=jnp.float32),
    "cavity3d": lambda: cavity_case(n=8, nz=8, dtype=jnp.float32),
    "couette": _couette,
    "vinlet": _vinlet_channel,
}

# (momentum scheme, velocity interp, pressure interp) windows the
# kernels cover; "default" is the reference's own default scheme set
# (lib.rs:58-74).
SCHEMES = {
    "ud-linear": (
        MomentumScheme.UD,
        VelocityInterpolation.LINEAR_WEIGHTED,
        PressureInterpolation.LINEAR_WEIGHTED,
    ),
    "default": (
        MomentumScheme.CD1,
        VelocityInterpolation.RHIE_CHOW,
        PressureInterpolation.SECOND_ORDER,
    ),
    "tvd_dc-rc": (
        MomentumScheme.TVD_DC,
        VelocityInterpolation.RHIE_CHOW,
        PressureInterpolation.LINEAR_WEIGHTED,
    ),
    "ud-so": (
        MomentumScheme.UD,
        VelocityInterpolation.LINEAR_WEIGHTED,
        PressureInterpolation.SECOND_ORDER,
    ),
}


def _settings(key):
    mom, vi, pi = SCHEMES[key]
    return NumericalSettings(
        momentum=mom,
        tvd_psi=tvd_umist if mom == MomentumScheme.TVD_DC else None,
        pressure_interpolation=pi,
        velocity_interpolation=vi,
        momentum_relaxation=0.7,
        relaxation_mode=RelaxationMode.IMPLICIT,
    )


def _spec_for(mesh, settings):
    mom, vi, pi = (
        settings.momentum,
        settings.velocity_interpolation,
        settings.pressure_interpolation,
    )
    return AsmSpec(
        scheme={
            MomentumScheme.UD: "ud",
            MomentumScheme.CD1: "cd1",
            MomentumScheme.TVD_DC: "tvd_dc",
        }[mom],
        rc=vi == VelocityInterpolation.RHIE_CHOW,
        p_so=pi == PressureInterpolation.SECOND_ORDER,
        psi=settings.tvd_psi,
        vol=float(mesh.cell_volume[0]),
    )


def _fields(mesh, seed=3):
    rng = np.random.default_rng(seed)
    C = mesh.n_cells
    vel = jnp.asarray(rng.standard_normal((C, 3)) * 0.1, jnp.float32)
    p = jnp.asarray(rng.standard_normal(C) * 0.05, jnp.float32)
    md = jnp.asarray(rng.uniform(0.5, 2.0, C), jnp.float32)
    return vel, p, md


def _ck_reference(mesh, table, settings, vel, p, md, rho, mu, inertia=None):
    """The XLA ck path's momentum system — exactly what ck_simple_step
    assembles (gradients from the iteration-start fields)."""
    zc, zs, zv = device_bc(table, dtype=mesh.dtype)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    bc = ck_bc(ck, zc, zs, zv)
    diff3 = ck_diffusion(mesh, ck, bc, jnp.asarray(mu, mesh.dtype))
    md3 = md[:, None] * jnp.ones((1, 3), md.dtype)
    need_gp = (
        settings.velocity_interpolation == VelocityInterpolation.RHIE_CHOW
        or settings.pressure_interpolation
        == PressureInterpolation.SECOND_ORDER
    )
    grad_p = grad_p_nbr = None
    if need_gp:
        grad_p = ck_pressure_gradient(mesh, ck, bc, p)
        grad_p_nbr = nbr_values(mesh, grad_p, ck.interior)
    grad_v = (
        ck_velocity_gradient(mesh, ck, bc, vel)
        if settings.momentum == MomentumScheme.TVD_DC
        else None
    )
    flux = ck_flux(
        mesh, ck, bc, vel, settings.velocity_interpolation, p=p,
        grad_p=grad_p, grad_p_nbr=grad_p_nbr, mom_diag=md3,
    )
    F = flux * ck.area * rho
    p_f = ck_face_pressure(
        mesh, ck, bc, p, settings.pressure_interpolation,
        grad_p=grad_p, grad_p_nbr=grad_p_nbr,
    )
    A, b, pe = ck_momentum(
        mesh, ck, bc, settings, rho, vel, F, p_f, *diff3,
        grad_vel=grad_v, inertia=inertia,
    )
    return A, b, (ck, bc, grad_p, grad_v)


def _kernel_inputs(mesh, table):
    zc, zs, zv = device_bc(table, dtype=jnp.float32)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    cols = column_specs(mesh, table)
    assert cols is not None
    flags = pack_flags(ck.interior, ck.mask)
    bcv = bc_value_table(zs, zv)
    return ck, cols, flags, bcv


@pytest.mark.parametrize("gg", [False, True], ids=["plane", "gg"])
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_momentum_assembly_matches_ck(name, scheme, gg):
    """gg=True: the kernel computes the Green-Gauss pressure gradient
    IN-KERNEL from the doubled-halo p window (AsmSpec.gg, round 5)
    instead of reading streamed grad-p planes; both must match the ck
    reference."""
    mesh, table = CASES[name]()
    assert mesh.ck_constants is not None
    settings = _settings(scheme)
    if gg and not (
        settings.velocity_interpolation == VelocityInterpolation.RHIE_CHOW
        or settings.pressure_interpolation
        == PressureInterpolation.SECOND_ORDER
    ):
        pytest.skip("gg only reads the gradient under RC / SecondOrder")
    rho, mu = 1.0, 1e-3
    vel, p, md = _fields(mesh)

    A_ref, b_ref, (ck, bc, grad_p, grad_v) = _ck_reference(
        mesh, table, settings, vel, p, md, rho, mu
    )
    assert A_ref.diag.ndim == 1  # shared-matrix form

    _, cols, flags, bcv = _kernel_inputs(mesh, table)
    spec = _spec_for(mesh, settings)._replace(gg=gg)
    diag, off, b3 = momentum_assembly(
        vel, p, bcv, flags, cols, rho, mu, 0.7,
        grad_p=None if gg else grad_p, mom_diag=md, grad_vel=grad_v,
        spec=spec, interpret=True,
    )
    np.testing.assert_allclose(
        np.asarray(diag), np.asarray(A_ref.diag), rtol=2e-5, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(off), np.asarray(A_ref.off), rtol=2e-5, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(b3), np.asarray(b_ref), rtol=2e-5, atol=1e-6
    )


@pytest.mark.parametrize("name", ["cavity", "cavity3d"])
def test_momentum_assembly_inertia(name):
    """Transient inertia term: kernel == ck with
    inertia=(rho V/dt, vel^n)."""
    mesh, table = CASES[name]()
    settings = _settings("default")
    rho, mu = 1.0, 1e-3
    vel, p, md = _fields(mesh, seed=5)
    rng = np.random.default_rng(6)
    C = mesh.n_cells
    vel_n = jnp.asarray(rng.standard_normal((C, 3)) * 0.1, jnp.float32)
    rv_dt = rho * mesh.cell_volume / jnp.asarray(0.01, jnp.float32)
    inertia = (rv_dt, vel_n)

    A_ref, b_ref, (ck, bc, grad_p, grad_v) = _ck_reference(
        mesh, table, settings, vel, p, md, rho, mu, inertia=inertia
    )
    _, cols, flags, bcv = _kernel_inputs(mesh, table)
    spec = _spec_for(mesh, settings)
    diag, off, b3 = momentum_assembly(
        vel, p, bcv, flags, cols, rho, mu, 0.7,
        grad_p=grad_p, mom_diag=md, grad_vel=grad_v, inertia=inertia,
        spec=spec, interpret=True,
    )
    np.testing.assert_allclose(
        np.asarray(diag), np.asarray(A_ref.diag), rtol=2e-5, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(b3), np.asarray(b_ref), rtol=2e-5, atol=1e-6
    )


@pytest.mark.parametrize("gg", [False, True], ids=["plane", "gg"])
@pytest.mark.parametrize("scheme", ["ud-linear", "default"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_pc_assembly_matches_ck(name, scheme, gg):
    from orc_cfd.ops.ck_ops import ck_pressure_correction
    from orc_cfd.ops.pallas_assembly import pc_assembly

    mesh, table = CASES[name]()
    settings = _settings(scheme)
    if gg and scheme != "default":
        pytest.skip("the pc kernel reads the gradient only under RC")
    rho = 1.0
    vel, p, md = _fields(mesh, seed=7)

    zc, zs, zv = device_bc(table, dtype=mesh.dtype)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    bc = ck_bc(ck, zc, zs, zv)
    md3 = md[:, None] * jnp.ones((1, 3), md.dtype)
    rc = (
        settings.velocity_interpolation == VelocityInterpolation.RHIE_CHOW
    )
    grad_p = ck_pressure_gradient(mesh, ck, bc, p) if rc else None
    gp_nbr = nbr_values(mesh, grad_p, ck.interior) if rc else None
    flux = ck_flux(
        mesh, ck, bc, vel, settings.velocity_interpolation,
        p=p, grad_p=grad_p, grad_p_nbr=gp_nbr, mom_diag=md3,
    )
    F2 = flux * ck.area * rho
    A_ref, b_ref = ck_pressure_correction(mesh, ck, bc, rho, F2, md3)

    _, cols, flags, bcv = _kernel_inputs(mesh, table)
    spec = _spec_for(mesh, settings)._replace(gg=gg)
    diag, off, b = pc_assembly(
        vel, md, bcv, flags, cols, rho,
        p=p, grad_p=None if gg else grad_p, spec=spec, interpret=True,
    )
    np.testing.assert_allclose(
        np.asarray(diag), np.asarray(A_ref.diag), rtol=2e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(off), np.asarray(A_ref.off), rtol=2e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(b), np.asarray(b_ref), rtol=2e-5, atol=1e-6
    )


@pytest.mark.parametrize("scheme", ["ud-linear", "default", "tvd_dc-rc"])
@pytest.mark.parametrize("name", ["cavity", "cavity3d", "vinlet"])
def test_fc_momentum_assembly_matches_ck(name, scheme):
    """SIMPLE_FC fused momentum kernel vs ck_momentum fed with a stored
    [C,K] flux (solver/fc.py's momentum call)."""
    from orc_cfd.ops.pallas_assembly import fc_momentum_assembly

    mesh, table = CASES[name]()
    settings = _settings(scheme)
    rho, mu = 1.0, 1e-3
    vel, p, md = _fields(mesh, seed=11)
    rng = np.random.default_rng(12)
    C = mesh.n_cells

    zc, zs, zv = device_bc(table, dtype=mesh.dtype)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    bc = ck_bc(ck, zc, zs, zv)
    diff3 = ck_diffusion(mesh, ck, bc, jnp.asarray(mu, mesh.dtype))
    # An arbitrary antisymmetric-per-face "stored" flux: use the plain
    # interpolated flux of a DIFFERENT velocity field, so the test
    # cannot pass by re-deriving flux from vel.
    vel2 = jnp.asarray(rng.standard_normal((C, 3)) * 0.1, jnp.float32)
    flux = ck_flux(
        mesh, ck, bc, vel2, VelocityInterpolation.LINEAR_WEIGHTED,
    )
    F = flux * ck.area * rho
    need_gp = (
        settings.pressure_interpolation
        == PressureInterpolation.SECOND_ORDER
    )
    grad_p = (
        ck_pressure_gradient(mesh, ck, bc, p)
        if need_gp or settings.velocity_interpolation
        == VelocityInterpolation.RHIE_CHOW
        else None
    )
    gp_nbr = (
        nbr_values(mesh, grad_p, ck.interior)
        if grad_p is not None
        else None
    )
    grad_v = (
        ck_velocity_gradient(mesh, ck, bc, vel)
        if settings.momentum == MomentumScheme.TVD_DC
        else None
    )
    p_f = ck_face_pressure(
        mesh, ck, bc, p, settings.pressure_interpolation,
        grad_p=grad_p, grad_p_nbr=gp_nbr,
    )
    A_ref, b_ref, _pe = ck_momentum(
        mesh, ck, bc, settings, rho, vel, F, p_f, *diff3, grad_vel=grad_v
    )
    assert A_ref.diag.ndim == 1

    _, cols, flags, bcv = _kernel_inputs(mesh, table)
    spec = _spec_for(mesh, settings)
    diag, off, b3 = fc_momentum_assembly(
        vel, p, flux, bcv, flags, cols, rho, mu, 0.7,
        grad_p=grad_p, grad_vel=grad_v, spec=spec, interpret=True,
    )
    np.testing.assert_allclose(
        np.asarray(diag), np.asarray(A_ref.diag), rtol=2e-5, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(off), np.asarray(A_ref.off), rtol=2e-5, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(b3), np.asarray(b_ref), rtol=2e-5, atol=1e-6
    )


@pytest.mark.parametrize("scheme", ["ud-linear", "default"])
@pytest.mark.parametrize("name", ["cavity", "cavity3d", "vinlet"])
def test_fc_pc_assembly_matches_ck(name, scheme):
    """SIMPLE_FC fused full-p assembly vs ck_flux_h + ck_d_coeffs +
    ck_fc_pressure_system."""
    from orc_cfd.ops.pallas_assembly import fc_pc_assembly
    from orc_cfd.solver.fc import (
        ck_d_coeffs,
        ck_fc_pressure_system,
        ck_flux_h,
    )

    mesh, table = CASES[name]()
    settings = _settings(scheme)
    rho = 1.0
    vel, p, md = _fields(mesh, seed=13)

    zc, zs, zv = device_bc(table, dtype=mesh.dtype)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    bc = ck_bc(ck, zc, zs, zv)
    md3 = md[:, None] * jnp.ones((1, 3), md.dtype)
    rc = (
        settings.velocity_interpolation == VelocityInterpolation.RHIE_CHOW
    )
    grad_p = ck_pressure_gradient(mesh, ck, bc, p) if rc else None
    fh_ref = ck_flux_h(
        mesh, ck, bc, vel, settings.velocity_interpolation,
        p=p, grad_p=grad_p, mom_diag=md3,
    )
    d_ref = ck_d_coeffs(mesh, ck, bc, rho, md3)
    A_ref, b_ref = ck_fc_pressure_system(mesh, ck, bc, rho, fh_ref, d_ref)

    _, cols, flags, bcv = _kernel_inputs(mesh, table)
    spec = _spec_for(mesh, settings)
    diag, off, b, fh = fc_pc_assembly(
        vel, md, bcv, flags, cols, rho,
        grad_p=grad_p, spec=spec, interpret=True,
    )
    np.testing.assert_allclose(
        np.asarray(diag), np.asarray(A_ref.diag), rtol=2e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(off), np.asarray(A_ref.off), rtol=2e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(b), np.asarray(b_ref), rtol=2e-5, atol=1e-6
    )
    mask = np.asarray(ck.mask)
    np.testing.assert_allclose(
        np.asarray(fh) * mask, np.asarray(fh_ref) * mask,
        rtol=2e-5, atol=1e-7,
    )


def _solver_settings(scheme, fc=False, pr=0.1):
    from orc_cfd.utils.settings import (
        MatrixSolverSettings,
        PreconditionMethod,
        PressureVelocityCoupling,
        SolutionMethod,
    )

    s = _settings(scheme)
    return s.replace(
        pressure_relaxation=pr,
        pressure_velocity_coupling=(
            PressureVelocityCoupling.SIMPLE_FC
            if fc
            else PressureVelocityCoupling.SIMPLE
        ),
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB,
            iterations=25,
            preconditioner=PreconditionMethod.JACOBI,
        ),
    )


@pytest.mark.parametrize(
    "scheme,fc",
    [("ud-linear", False), ("default", False), ("tvd_dc-rc", False),
     ("ud-linear", True), ("default", True)],
)
def test_solve_steady_with_fused_assembly(monkeypatch, scheme, fc):
    """End-to-end SIMPLE[_FC] with the fused kernels (interpreter mode
    via ORC_PALLAS_ASM=force) matches the stock ck path."""
    from orc_cfd.solver.simple import initial_state, solve_steady

    mesh, table = cavity_case(n=16, dtype=jnp.float32)
    settings = _solver_settings(scheme, fc=fc, pr=0.3 if fc else 0.1)
    # The FC cavity is unanchored (constant-mode deflation), so 1-ulp
    # differences between kernel and XLA arithmetic are amplified
    # mid-trajectory; pin the converged FC state (cf. the sharded test).
    iters = 80 if fc else 40
    kw = dict(
        state=initial_state(mesh), iterations=iters,
        reporting_interval=iters, verbose=False,
    )

    monkeypatch.setenv("ORC_PALLAS_ASM", "0")
    ref, _ = solve_steady(mesh, table, settings, 1.0, 0.01, **kw)
    monkeypatch.setenv("ORC_PALLAS_ASM", "force")
    kw["state"] = initial_state(mesh)
    fused, _ = solve_steady(mesh, table, settings, 1.0, 0.01, **kw)
    np.testing.assert_allclose(
        np.asarray(fused.vel), np.asarray(ref.vel), rtol=2e-4, atol=2e-6
    )
    np.testing.assert_allclose(
        np.asarray(fused.p), np.asarray(ref.p), rtol=2e-4, atol=2e-5
    )


@pytest.mark.parametrize("fc", [False, True])
def test_solve_transient_with_fused_assembly(monkeypatch, fc):
    """Time marching with the fused kernels (incl. the inertia term)
    matches the stock ck path."""
    from orc_cfd.solver.simple import initial_state
    from orc_cfd.solver.transient import solve_transient

    mesh, table = cavity_case(n=12, dtype=jnp.float32)
    settings = _solver_settings("default", fc=fc, pr=0.3 if fc else 0.1)
    kw = dict(
        dt=0.05, n_steps=4, inner_iterations=6,
        state=initial_state(mesh), verbose=False,
    )

    monkeypatch.setenv("ORC_PALLAS_ASM", "0")
    ref, _ = solve_transient(mesh, table, settings, 1.0, 0.01, **kw)
    monkeypatch.setenv("ORC_PALLAS_ASM", "force")
    kw["state"] = initial_state(mesh)
    fused, _ = solve_transient(mesh, table, settings, 1.0, 0.01, **kw)
    np.testing.assert_allclose(
        np.asarray(fused.vel), np.asarray(ref.vel), rtol=2e-4, atol=2e-6
    )
    np.testing.assert_allclose(
        np.asarray(fused.p), np.asarray(ref.p), rtol=2e-4, atol=2e-5
    )


@pytest.mark.parametrize("fc", [False, True])
def test_solve_steady_sharded_with_fused_assembly(monkeypatch, fc):
    """Sharded SIMPLE[_FC] with the fused kernels per device matches the
    single-device fused run (8 virtual CPU devices, interpret mode)."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs the multi-device CPU mesh")
    from orc_cfd.parallel.sharded import solve_steady_sharded
    from orc_cfd.solver.simple import initial_state, solve_steady

    mesh, table = cavity_case(n=16, dtype=jnp.float32)
    settings = _solver_settings("default", fc=fc, pr=0.3 if fc else 0.1)
    # The FC cavity is unanchored: its full-p solve runs constant-mode
    # DEFLATION, so mid-trajectory f32 rounding (kernel vs XLA, psum vs
    # serial dots) is amplified through the gauge each iteration —
    # measured max|dvel| 1.7e-5 at 25 iters shrinking to 7.5e-7 at 120.
    # Pin the CONVERGED state for FC; the anchored parity loop is pinned
    # mid-trajectory against the single-device fused run.
    iters = 120 if fc else 25
    kw = dict(iterations=iters, reporting_interval=iters, verbose=False)

    monkeypatch.setenv("ORC_PALLAS_ASM", "force")
    sharded, _ = solve_steady_sharded(
        mesh, table, settings, 1.0, 0.01,
        state=initial_state(mesh), **kw,
    )
    if fc:
        monkeypatch.setenv("ORC_PALLAS_ASM", "0")
        ref, _ = solve_steady_sharded(
            mesh, table, settings, 1.0, 0.01,
            state=initial_state(mesh), **kw,
        )
        tol = dict(rtol=2e-4, atol=5e-6)
    else:
        ref, _ = solve_steady(
            mesh, table, settings, 1.0, 0.01,
            state=initial_state(mesh), **kw,
        )
        tol = dict(rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        np.asarray(sharded.vel), np.asarray(ref.vel), **tol
    )
    np.testing.assert_allclose(
        np.asarray(sharded.p), np.asarray(ref.p),
        rtol=tol["rtol"], atol=2e-5 if fc else 1e-6,
    )


@pytest.mark.parametrize("n", [23, 37])
def test_partial_last_block(n):
    """C not a multiple of BLOCK (529 and 1369 cells over 512-cell
    programs): the masked stores of the last, partial block must match
    the ck reference like every other cell."""
    from orc_cfd.ops.ck_ops import ck_pressure_correction
    from orc_cfd.ops.pallas_assembly import BLOCK, pc_assembly

    mesh, table = cavity_case(n=n, dtype=jnp.float32)
    assert mesh.n_cells % BLOCK != 0
    settings = _settings("default")
    rho, mu = 1.0, 1e-3
    vel, p, md = _fields(mesh, seed=17)
    A_ref, b_ref, (ck, bc, grad_p, _) = _ck_reference(
        mesh, table, settings, vel, p, md, rho, mu
    )
    _, cols, flags, bcv = _kernel_inputs(mesh, table)
    assert flags.dtype == jnp.int8
    spec = _spec_for(mesh, settings)._replace(gg=True)
    diag, off, b3 = momentum_assembly(
        vel, p, bcv, flags, cols, rho, mu, 0.7, mom_diag=md, spec=spec,
        interpret=True,
    )
    assert diag.shape == (mesh.n_cells,) and b3.shape == (3, mesh.n_cells)
    np.testing.assert_allclose(
        np.asarray(diag), np.asarray(A_ref.diag), rtol=2e-5, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(off), np.asarray(A_ref.off), rtol=2e-5, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(b3), np.asarray(b_ref), rtol=2e-5, atol=1e-6
    )
    md3 = md[:, None] * jnp.ones((1, 3), md.dtype)
    flux = ck_flux(
        mesh, ck, bc, vel, settings.velocity_interpolation, p=p,
        grad_p=grad_p, grad_p_nbr=nbr_values(mesh, grad_p, ck.interior),
        mom_diag=md3,
    )
    P_ref, bp_ref = ck_pressure_correction(
        mesh, ck, bc, rho, flux * ck.area * rho, md3
    )
    pdiag, poff, bp = pc_assembly(
        vel, md, bcv, flags, cols, rho, p=p, spec=spec, interpret=True
    )
    np.testing.assert_allclose(
        np.asarray(pdiag), np.asarray(P_ref.diag), rtol=2e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(poff), np.asarray(P_ref.off), rtol=2e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(bp), np.asarray(bp_ref), rtol=2e-5, atol=1e-6
    )


def _pallas_eqns(jaxpr):
    """Every pallas_call equation inside a closed jaxpr, recursively."""
    from jax.extend import core

    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            found.append(eqn)
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                if isinstance(sub, core.ClosedJaxpr):
                    found += _pallas_eqns(sub.jaxpr)
                elif isinstance(sub, core.Jaxpr):
                    found += _pallas_eqns(sub)
    return found


def _dtypes(jaxpr):
    """dtypes of the values in a jaxpr, recursively. Weakly typed
    scalars (Python literals, converted to the array dtype where they
    are used) are left out."""
    from jax.extend import core

    out = set()
    for eqn in jaxpr.eqns:
        for v in list(eqn.invars) + list(eqn.outvars):
            if hasattr(v.aval, "dtype") and not v.aval.weak_type:
                out.add(str(v.aval.dtype))
        for p in eqn.params.values():
            for sub in p if isinstance(p, (tuple, list)) else (p,):
                if isinstance(sub, core.ClosedJaxpr):
                    out |= _dtypes(sub.jaxpr)
                elif isinstance(sub, core.Jaxpr):
                    out |= _dtypes(sub)
    return out


@pytest.mark.parametrize(
    "kernel", ["momentum", "fc_momentum", "pc", "fc_pc"]
)
def test_kernels_lower_for_cuda_in_f32(kernel):
    """Each kernel lowers through the Triton route for CUDA (checked on
    the CPU by cross-lowering; the GPU compiler itself runs only on the
    card), and its body holds no f64 value even with x64 enabled."""
    import jax

    from orc_cfd.ops import pallas_assembly as PA

    mesh, table = CASES["cavity3d"]()
    settings = _settings("tvd_dc-rc")
    _, cols, flags, bcv = _kernel_inputs(mesh, table)
    spec = _spec_for(mesh, settings)
    C, K = mesh.n_cells, len(cols)
    f32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)
    fns = {
        "momentum": lambda v, p, g, md, gv: PA.momentum_assembly(
            v, p, bcv, flags, cols, 1.0, 1e-3, 0.7, grad_p=g, mom_diag=md,
            grad_vel=gv, inertia=(md, v), spec=spec,
        ),
        "fc_momentum": lambda v, p, g, md, gv: PA.fc_momentum_assembly(
            v, p, jnp.zeros((C, K), jnp.float32), bcv, flags, cols, 1.0,
            1e-3, 0.7, grad_p=g, grad_vel=gv, spec=spec,
        ),
        "pc": lambda v, p, g, md, gv: PA.pc_assembly(
            v, md, bcv, flags, cols, 1.0, p=p, grad_p=g, spec=spec
        ),
        "fc_pc": lambda v, p, g, md, gv: PA.fc_pc_assembly(
            v, md, bcv, flags, cols, 1.0, grad_p=g, spec=spec
        ),
    }
    args = (f32(C, 3), f32(C), f32(C, 3), f32(C), f32(C, 3, 3))
    hlo = (
        jax.jit(fns[kernel]).trace(*args)
        .lower(lowering_platforms=("cuda",)).as_text()
    )
    assert "__gpu$xla.gpu.triton" in hlo
    eqns = _pallas_eqns(jax.make_jaxpr(fns[kernel])(*args).jaxpr)
    assert len(eqns) == 1
    kernel_dtypes = _dtypes(eqns[0].params["jaxpr"])
    assert "float64" not in kernel_dtypes, kernel_dtypes


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["ud-linear", "default"])
def test_compiled_kernels_match_ck_on_gpu(gpu_only, scheme):
    """The kernels as the GPU compiles them (no interpret mode) against
    the ck reference, momentum and pressure correction."""
    mesh, table = cavity_case(n=64, dtype=jnp.float32)
    settings = _settings(scheme)
    vel, p, md = _fields(mesh, seed=19)
    A_ref, b_ref, _ = _ck_reference(
        mesh, table, settings, vel, p, md, 1.0, 1e-3
    )
    _, cols, flags, bcv = _kernel_inputs(mesh, table)
    spec = _spec_for(mesh, settings)._replace(
        gg=settings.velocity_interpolation == VelocityInterpolation.RHIE_CHOW
    )
    diag, off, b3 = momentum_assembly(
        vel, p, bcv, flags, cols, 1.0, 1e-3, 0.7, mom_diag=md, spec=spec,
    )
    np.testing.assert_allclose(
        np.asarray(diag), np.asarray(A_ref.diag), rtol=2e-5, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(off), np.asarray(A_ref.off), rtol=2e-5, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(b3), np.asarray(b_ref), rtol=2e-5, atol=1e-6
    )
