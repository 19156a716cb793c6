"""Smoke test: body-force-driven periodic Poiseuille channel.

u(y) = G/(2 mu) * y * (H - y); U_b = G H^2 / (12 mu).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_enable_x64", True)

from orc_cfd.mesh.generate import structured_box_mesh
from orc_cfd.mesh.zones import FaceCondition
from orc_cfd.solver.simple import initial_state, solve_steady
from orc_cfd.utils.settings import (
    MatrixSolverSettings,
    MomentumScheme,
    NumericalSettings,
    PressureInterpolation,
    SolutionMethod,
    VelocityInterpolation,
)

nx, ny = 8, 32
H = 1.0
mu, rho, G = 0.1, 1.0, 1.0

mesh, table = structured_box_mesh(
    nx, ny, 1, lengths=(2.0, H, 0.1), periodic=("x",)
)
print("offsets:", mesh.neighbor_offsets, "K =", mesh.max_faces_per_cell)
table.set("BOTTOM_WALL", FaceCondition.WALL)
table.set("TOP_WALL", FaceCondition.WALL)
table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)

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

for use_ck in ("auto", False):
    state, hist = solve_steady(
        mesh,
        table,
        settings,
        rho,
        mu,
        state=initial_state(mesh),
        iterations=800,
        reporting_interval=200,
        verbose=True,
        use_ck=use_ck,
    )
    vel = np.asarray(state.vel)
    u = vel[:, 0].reshape(1, ny, nx)  # [z,y,x] with x fastest
    y = (np.arange(ny) + 0.5) * (H / ny)
    u_prof = u[0].mean(axis=1)
    u_exact = G / (2 * mu) * y * (H - y)
    err = np.abs(u_prof - u_exact).max() / u_exact.max()
    print(f"use_ck={use_ck}: max u = {u_prof.max():.4f} "
          f"(exact {u_exact.max():.4f}), rel err = {err:.2e}")
    print("streamwise uniformity:", np.abs(u[0].std(axis=1)).max())
    print("cross-flow |v|max:", np.abs(vel[:, 1]).max())
