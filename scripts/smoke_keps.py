"""Smoke: Re_tau=590 body-force-driven periodic channel, k-epsilon with
wall functions. Target: U_b+ within ~10% of DNS (Moser et al. 1999:
Re_b = 10935 per half-height => U_b+ ~= 18.5; Dean's correlation gives
~18.2)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"

import jax
import jax.numpy as jnp
import numpy as np

from orc_cfd.mesh.generate import structured_box_mesh
from orc_cfd.mesh.zones import FaceCondition
from orc_cfd.solver.turbulence import (
    KAPPA,
    E_WALL,
    solve_steady_turbulent,
)
from orc_cfd.utils.settings import (
    MatrixSolverSettings,
    MomentumScheme,
    NumericalSettings,
    PressureInterpolation,
    SolutionMethod,
    VelocityInterpolation,
)

RE_TAU = 590.0
delta = 1.0  # half height
H = 2 * delta
rho, u_tau = 1.0, 1.0
mu = rho * u_tau * delta / RE_TAU
G = rho * u_tau**2 / delta  # body force per volume

nx, ny = 4, int(sys.argv[1]) if len(sys.argv) > 1 else 16
iters = int(sys.argv[2]) if len(sys.argv) > 2 else 2000

mesh, table = structured_box_mesh(
    nx, ny, 1, lengths=(4.0, H, 0.2), periodic=("x",)
)
table.set("BOTTOM_WALL", FaceCondition.WALL)
table.set("TOP_WALL", FaceCondition.WALL)
table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)

yp_plus = RE_TAU * (H / ny) / 2
print(f"first-cell y+ = {yp_plus:.1f} (want 30..300)")

vol = float(np.asarray(mesh.cell_volume)[0])


def source(cc):
    s = jnp.zeros_like(cc)
    return s.at[:, 0].set(G * vol)


settings = NumericalSettings(
    momentum=MomentumScheme.UD,
    pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
    velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
    matrix_solver=MatrixSolverSettings(
        solver_type=SolutionMethod.BICGSTAB, iterations=30
    ),
    momentum_source=source,
)

flow, turb, hist = solve_steady_turbulent(
    mesh, table, settings, rho, mu,
    u_ref=18.0, iterations=iters, reporting_interval=max(iters // 8, 1),
    intensity=0.05, length_scale=0.2 * H, verbose=True,
)

u = np.asarray(flow.vel)[:, 0].reshape(ny, nx)
u_prof = u.mean(axis=1)
y = (np.arange(ny) + 0.5) * (H / ny)
U_b = u_prof.mean()
print(f"\nU_b+ = {U_b / u_tau:.2f}  (DNS ~18.5, Dean ~18.2)")
print(f"U_c+ = {u_prof.max():.2f}  (DNS ~21.3)")
yp = np.minimum(y, H - y) * RE_TAU
loglaw = np.log(E_WALL * yp) / KAPPA
for i in range(ny // 2):
    print(f"  y+={yp[i]:7.1f}  u+={u_prof[i]:6.2f}  log-law={loglaw[i]:6.2f}")
print("k+ wall-adj:", np.asarray(turb.k).reshape(ny, nx).mean(axis=1)[0],
      "(equil ~ 1/sqrt(C_mu) = 3.33)")
print("mu_t/mu max:", float(np.max(np.asarray(turb.mu_t))) / mu)
print("streamwise uniformity:", np.abs(u.std(axis=1)).max())
