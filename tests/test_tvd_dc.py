"""Deferred-correction TVD (MomentumScheme.TVD_DC).

Pins the properties that distinguish it from the reference's in-matrix
TVD (discretization.rs:233-287, which silently uses a CD face value on
every inflow face — see MomentumScheme.TVD_DC):

- exact conservation: the deferred source telescopes to zero over the
  domain (each interior face contributes the same limited face value
  to both adjacent cells);
- with psi == 1 the scheme's residual equals CD1's on interior cells
  (the DC split changes the iteration path, not the discretization);
- it converges on the lid-driven cavity and is MORE accurate than UD
  against the Ghia Re=100 benchmark on a coarse grid.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from orc_cfd.models.cavity import cavity_case
from orc_cfd.ops.assembly import diffusion_system, momentum_system
from orc_cfd.ops.fields import device_bc, face_bc
from orc_cfd.ops.gradients import velocity_gradient
from orc_cfd.ops.interpolation import face_flux, face_pressure
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

SOLVER = MatrixSolverSettings(
    solver_type=SolutionMethod.BICGSTAB,
    iterations=50,
    preconditioner=PreconditionMethod.JACOBI,
)


def _settings(scheme, psi=tvd_umist, **kw):
    base = dict(
        momentum=scheme,
        tvd_psi=psi if scheme in (MomentumScheme.TVD, MomentumScheme.TVD_DC)
        else None,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
        pressure_relaxation=0.1,
        momentum_relaxation=0.7,
        relaxation_mode=RelaxationMode.IMPLICIT,
        matrix_solver=SOLVER,
    )
    base.update(kw)
    return NumericalSettings(**base)


def _assemble(mesh, table, settings, vel, p):
    fbc = face_bc(mesh, *device_bc(table, mesh.dtype))
    mom_diag = jnp.ones((mesh.n_cells, 3), mesh.dtype)
    grad_v = velocity_gradient(
        mesh, fbc, vel, settings.gradient_reconstruction
    )
    flux = face_flux(
        mesh, fbc, vel, settings.velocity_interpolation,
        p=p, mom_diag=mom_diag,
    )
    p_f = face_pressure(mesh, fbc, p, settings.pressure_interpolation)
    diff = diffusion_system(mesh, fbc, 0.01)
    return momentum_system(
        mesh, fbc, settings, 1.0, vel, flux, p_f, diff, grad_vel=grad_v
    )


def _rand_state(mesh, seed=0):
    rng = np.random.default_rng(seed)
    vel = jnp.asarray(rng.standard_normal((mesh.n_cells, 3)) * 0.1)
    p = jnp.asarray(rng.standard_normal(mesh.n_cells) * 0.01)
    return vel, p


def test_deferred_source_conserves():
    """sum_c (b_tvd_dc - b_ud) == 0: the limited face increments cancel
    pairwise across interior faces."""
    mesh, table = cavity_case(n=12, dtype=jnp.float64)
    vel, p = _rand_state(mesh)
    _, b_dc, _ = _assemble(
        mesh, table, _settings(MomentumScheme.TVD_DC), vel, p
    )
    _, b_ud, _ = _assemble(mesh, table, _settings(MomentumScheme.UD), vel, p)
    total = np.asarray(jnp.sum(b_dc - b_ud, axis=1))
    np.testing.assert_allclose(total, 0.0, atol=1e-12)


def test_psi_one_matches_cd_on_interior_cells():
    """With psi == 1 the TVD_DC residual A@v - b equals CD1's wherever
    all faces are interior (boundary faces use UD by design) — checked
    on a fully periodic box, where every face is interior."""
    from orc_cfd.mesh.generate import structured_box_mesh

    mesh, table = structured_box_mesh(
        8, 8, 3, periodic=("x", "y", "z"), dtype=jnp.float64
    )
    assert bool(np.asarray(mesh.face_interior).all())
    vel, p = _rand_state(mesh, seed=3)
    one = lambda r: jnp.ones_like(r)
    A_dc, b_dc, _ = _assemble(
        mesh, table, _settings(MomentumScheme.TVD_DC, psi=one), vel, p
    )
    A_cd, b_cd, _ = _assemble(mesh, table, _settings(MomentumScheme.CD1), vel, p)
    v3 = jnp.moveaxis(vel, -1, 0)  # [3, C]
    r_dc = A_dc.matvec(v3) - b_dc
    r_cd = A_cd.matvec(v3) - b_cd
    np.testing.assert_allclose(
        np.asarray(r_dc), np.asarray(r_cd), rtol=1e-10, atol=1e-12
    )


def test_cavity_re100_ghia_midline():
    """Ghia et al. (1982) Re=100 Table I u-midline on a 48^2 grid:
    converged TVD_DC matches every landmark to <= 0.025 (profile
    linearly interpolated between cell centers)."""
    from orc_cfd.solver.simple import initial_state, solve_steady

    ghia_y = [0.0547, 0.1016, 0.1719, 0.2813, 0.4531, 0.5,
              0.6172, 0.7344, 0.8516, 0.9531]
    ghia_u = [-0.03717, -0.06434, -0.10150, -0.15662, -0.21090,
              -0.20581, -0.13641, 0.00332, 0.23151, 0.68717]
    n = 48
    mesh, table = cavity_case(n=n, dtype=jnp.float64)
    settings = _settings(
        MomentumScheme.TVD_DC,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
    )
    state, _ = solve_steady(
        mesh, table, settings, 1.0, 1e-2,
        state=initial_state(mesh), iterations=6000,
        reporting_interval=2000, verbose=False,
    )
    u = np.asarray(state.vel)[:, 0].reshape(n, n)
    yc = (np.arange(n) + 0.5) / n
    u_mid = np.interp(ghia_y, yc, u[:, n // 2])
    err = np.abs(u_mid - np.asarray(ghia_u))
    assert err.max() < 0.025, dict(zip(ghia_y, err))
