"""Translational-periodic boundary conditions.

The reference enumerates Periodic/PeriodicShadow codes (mesh.rs:31-33)
and parses-then-skips the `(18` shadow-pair sections (io.rs:176-179) —
it has no periodic solver path. Here pairs are merged into interior
faces at compile time (mesh/compile.py:_merge_periodic) with the
translation baked into the face geometry, so the whole solver stack
(face-major AND the gather-free ck path) handles periodicity through
the ordinary interior-face code.

Physics pin: a body-force-driven streamwise-periodic channel must
reproduce plane Poiseuille flow — the validation rig the reference
cannot express (and the prerequisite for quantitative k-epsilon
validation).
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from orc_cfd.mesh.generate import structured_box_mesh, write_tgrid
from orc_cfd.mesh.tgrid import parse_tgrid, read_mesh
from orc_cfd.mesh.zones import FaceCondition
from orc_cfd.solver.simple import initial_state, solve_steady
from orc_cfd.utils.settings import (
    GradientReconstruction,
    MatrixSolverSettings,
    MomentumScheme,
    NumericalSettings,
    PressureInterpolation,
    SolutionMethod,
    VelocityInterpolation,
)


def periodic_channel(nx=8, ny=24, H=1.0, dtype=jnp.float64):
    mesh, table = structured_box_mesh(
        nx, ny, 1, lengths=(2.0, H, 0.1), periodic=("x",), dtype=dtype
    )
    table.set("BOTTOM_WALL", FaceCondition.WALL)
    table.set("TOP_WALL", FaceCondition.WALL)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    return mesh, table


def body_force_settings(mesh, G, **kw):
    vol = float(np.asarray(mesh.cell_volume)[0])

    def source(cc):
        s = jnp.zeros_like(cc)
        return s.at[:, 0].set(G * vol)

    defaults = dict(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB, iterations=30
        ),
        momentum_source=source,
    )
    defaults.update(kw)
    return NumericalSettings(**defaults)


def test_structured_periodic_topology():
    nx, ny = 6, 4
    mesh, table = structured_box_mesh(nx, ny, 1, periodic=("x",))
    offs = mesh.neighbor_offsets
    assert offs is not None, "periodic mesh must stay structured"
    assert nx - 1 in offs and -(nx - 1) in offs, offs
    # 2D: the wrap offsets fit in the existing K=6 columns.
    assert mesh.max_faces_per_cell == 6
    # Every x-plane face is interior now (ny per plane, nx planes).
    fi = np.asarray(mesh.face_interior)
    nrm = np.asarray(mesh.face_normal)
    x_faces = np.abs(nrm[:, 0]) > 0.5
    assert fi[x_faces].all()
    assert x_faces.sum() == nx * ny
    # Wrap faces: neighbor = owner - (nx-1).
    own = np.asarray(mesh.face_owner)
    nbr = np.asarray(mesh.face_neighbor)
    wrap = x_faces & (nbr != own) & ((own - nbr) == nx - 1)
    assert wrap.sum() == ny
    # The zone table keeps the periodic zones for bookkeeping.
    types = {fz.zone_type for fz in table.zones.values()}
    assert FaceCondition.PERIODIC in types
    assert FaceCondition.PERIODIC_SHADOW in types
    table.validate_supported()  # periodic zones must not be rejected


def test_periodic_topology_3d_widens_ell():
    mesh, _ = structured_box_mesh(4, 3, 3, periodic=("x",))
    offs = mesh.neighbor_offsets
    assert offs is not None
    assert 3 in offs and -3 in offs  # wrap offsets +/-(nx-1)
    assert mesh.max_faces_per_cell == 8  # 6 faces + 2 wrap columns


def test_periodic_requires_two_cells():
    with pytest.raises(ValueError, match="at least 2 cells"):
        structured_box_mesh(4, 4, 1, periodic=("z",))


@pytest.mark.parametrize("use_ck", ["auto", False])
def test_periodic_poiseuille(use_ck):
    """Body-force-driven periodic channel == plane Poiseuille."""
    nx, ny, H = 8, 24, 1.0
    mu, rho, G = 0.1, 1.0, 1.0
    mesh, table = periodic_channel(nx, ny, H)
    settings = body_force_settings(mesh, G)
    state, _ = solve_steady(
        mesh, table, settings, rho, mu,
        state=initial_state(mesh), iterations=600,
        reporting_interval=200, verbose=False, use_ck=use_ck,
    )
    vel = np.asarray(state.vel)
    u = vel[:, 0].reshape(ny, nx)
    y = (np.arange(ny) + 0.5) * (H / ny)
    u_exact = G / (2 * mu) * y * (H - y)
    err = np.abs(u.mean(axis=1) - u_exact).max() / u_exact.max()
    assert err < 5e-3, f"profile error {err:.2e}"
    # Streamwise invariance: the wrap must be seamless.
    assert np.abs(u.std(axis=1)).max() < 1e-8 * u.max()
    assert np.abs(vel[:, 1]).max() < 1e-8 * u.max()
    # Global momentum balance: wall shear == body force.
    ub = u.mean()
    assert abs(ub - G * H**2 / (12 * mu)) / (G * H**2 / (12 * mu)) < 5e-3


def test_periodic_gradients():
    """Cell gradients of a periodic field are seamless across the wrap
    for every reconstruction scheme."""
    from orc_cfd.ops.fields import device_bc, face_bc
    from orc_cfd.ops.gradients import pressure_gradient

    nx, ny, L = 32, 4, 2.0
    mesh, table = structured_box_mesh(
        nx, ny, 1, lengths=(L, 1.0, 0.1), periodic=("x",)
    )
    zc, zs, zv = device_bc(table, mesh.dtype)
    fbc = face_bc(mesh, zc, zs, zv)
    x = np.asarray(mesh.cell_centroid)[:, 0]
    k = 2 * np.pi / L
    phi = jnp.asarray(np.sin(k * x))
    want = k * np.cos(k * x)
    for scheme in (
        GradientReconstruction.GREEN_GAUSS_CELL,
        GradientReconstruction.LEAST_SQUARES,
    ):
        g = np.asarray(pressure_gradient(mesh, fbc, phi, scheme))
        # Central-difference of sin: amplitude factor sin(kh)/(kh).
        h = L / nx
        factor = np.sin(k * h) / (k * h)
        err = np.abs(g[:, 0] - factor * want).max() / np.abs(want).max()
        assert err < 2e-2, f"{scheme}: {err:.2e}"


def test_tgrid_periodic_roundtrip(tmp_path):
    """write_tgrid(periodic=...) -> parser retains the (18 pairs ->
    compile merges them -> same topology as the analytic generator."""
    nx, ny = 6, 5
    path = os.path.join(tmp_path, "per.msh")
    write_tgrid(path, nx, ny, 1, lengths=(1.2, 1.0, 0.1), periodic=("x",))
    with open(path) as f:
        text = f.read()
    assert "(18" in text
    raw = parse_tgrid(text)
    assert raw.periodic_pairs.shape == (ny, 2)
    ztypes = {fz.zone_type for fz in raw.face_zones.values()}
    assert FaceCondition.PERIODIC in ztypes
    assert FaceCondition.PERIODIC_SHADOW in ztypes

    mesh, table = read_mesh(path, native=False)
    ref, _ = structured_box_mesh(
        nx, ny, 1, lengths=(1.2, 1.0, 0.1), periodic=("x",)
    )
    assert mesh.n_cells == ref.n_cells
    assert mesh.n_faces == ref.n_faces
    assert set(mesh.neighbor_offsets) == set(ref.neighbor_offsets)
    # Same wrap topology: sorted (owner, neighbor) interior pairs match.
    def pairs(m):
        fi = np.asarray(m.face_interior)
        o = np.asarray(m.face_owner)[fi]
        n = np.asarray(m.face_neighbor)[fi]
        return set(map(tuple, np.sort(np.stack([o, n], 1), axis=1)))

    assert pairs(mesh) == pairs(ref)
    # And the periodic translation is baked into r_on identically
    # (each mesh has its own face ordering; compare sorted norms).
    def interior_ron_norms(m):
        fi = np.asarray(m.face_interior)
        return np.sort(
            np.linalg.norm(np.asarray(m.face_r_on)[fi], axis=1)
        )

    assert np.allclose(interior_ron_norms(mesh), interior_ron_norms(ref))


def test_tgrid_periodic_native(tmp_path):
    from orc_cfd.mesh.native import native_available, parse_tgrid_native

    if not native_available():
        pytest.skip("native parser unavailable")
    nx, ny = 6, 5
    path = os.path.join(tmp_path, "per.msh")
    write_tgrid(path, nx, ny, 1, lengths=(1.2, 1.0, 0.1), periodic=("x",))
    raw_n = parse_tgrid_native(path)
    with open(path) as f:
        raw_p = parse_tgrid(f.read())
    np.testing.assert_array_equal(raw_n.periodic_pairs, raw_p.periodic_pairs)


def test_periodic_solve_from_tgrid(tmp_path):
    """A solve through the full TGRID path matches the analytic-mesh
    solve (same physics, same wrap)."""
    nx, ny, H = 6, 16, 1.0
    mu, rho, G = 0.1, 1.0, 1.0
    path = os.path.join(tmp_path, "chan.msh")
    write_tgrid(path, nx, ny, 1, lengths=(1.0, H, 0.1), periodic=("x",))
    mesh, table = read_mesh(path, native=False)
    table.zone_by_name("BOTTOM_WALL").zone_type = FaceCondition.WALL
    table.zone_by_name("TOP_WALL").zone_type = FaceCondition.WALL
    table.zone_by_name("PERIODIC_-Z").zone_type = FaceCondition.SYMMETRY
    table.zone_by_name("PERIODIC_+Z").zone_type = FaceCondition.SYMMETRY
    table._rebuild()
    settings = body_force_settings(mesh, G)
    state, _ = solve_steady(
        mesh, table, settings, rho, mu,
        state=initial_state(mesh), iterations=400,
        reporting_interval=200, verbose=False,
    )
    u = np.asarray(state.vel)[:, 0]
    y = np.asarray(mesh.cell_centroid)[:, 1]
    u_exact = G / (2 * mu) * y * (H - y)
    err = np.abs(u - u_exact).max() / u_exact.max()
    assert err < 5e-3, f"profile error {err:.2e}"


@pytest.mark.parametrize("ck", ["auto", False])
def test_sharded_periodic_matches(ck):
    """Distributed solve on a periodic mesh == single-device: wrap
    offsets stay within slabs (periodicity transverse to the partition
    axis), so ghost-layer refreshes cover them."""
    from orc_cfd.parallel.sharded import solve_steady_sharded

    mesh, table = periodic_channel(nx=8, ny=8)
    settings = body_force_settings(mesh, 1.0)
    args = (mesh, table, settings, 1.0, 0.1)
    kw = dict(iterations=20, reporting_interval=20, verbose=False)
    ref_state, _ = solve_steady(*args, state=initial_state(mesh), **kw)
    sh_state, _ = solve_steady_sharded(
        *args, state=initial_state(mesh), n_devices=4, use_ck=ck, **kw
    )
    # The exact pressure field here is identically zero, so p is pure
    # solver noise; psum-vs-serial reduction ordering can flip an
    # early-exit iteration count between runs, wobbling that noise.
    # Assert equality at 1e-8 RELATIVE TO THE FLOW SCALE, not machine
    # eps of a zero field.
    scale = float(np.abs(np.asarray(ref_state.vel)).max())
    np.testing.assert_allclose(
        np.asarray(sh_state.vel), np.asarray(ref_state.vel),
        rtol=1e-8, atol=1e-8 * scale,
    )
    np.testing.assert_allclose(
        np.asarray(sh_state.p), np.asarray(ref_state.p),
        rtol=1e-8, atol=1e-8 * scale,
    )


def test_unconstrained_classification():
    from orc_cfd.solver.init_fields import (
        SystemConstraint,
        check_boundary_conditions,
        initialize_flow,
    )

    mesh, table = periodic_channel()
    c = check_boundary_conditions(mesh, table)
    assert c == SystemConstraint.UNCONSTRAINED
    state = initialize_flow(mesh, table, 0.1, 1.0)
    assert np.asarray(state.vel).max() == 0.0
