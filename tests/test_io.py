"""Data I/O + checkpoint/warm-start tests (reference: io.rs:519-662,
tests.rs:84-86)."""

import os
import re

import numpy as np
import pytest

from orc_cfd.io.data import read_data, rust_sci, write_data, write_gradients
from orc_cfd.io.checkpoint import (
    load_checkpoint,
    load_or_initialize,
    save_checkpoint,
)
from orc_cfd.mesh import structured_box_mesh
from orc_cfd.mesh.zones import FaceCondition
from orc_cfd.solver.simple import initial_state


def test_rust_sci_format():
    assert rust_sci(0.000156, 2) == "1.56e-4"
    assert rust_sci(-1500.0, 2) == "-1.50e3"
    assert rust_sci(0.0, 2) == "0.00e0"
    assert rust_sci(1.0, 0) == "1e0"


def test_plotter_regex_compatibility(tmp_path):
    """The reference plotter's regex (plot_output.py:139-141) must match
    every line we write."""
    mesh, _ = structured_box_mesh(2, 2, 1)
    rng = np.random.default_rng(0)
    vel = rng.standard_normal((mesh.n_cells, 3)) * 1e-3
    p = rng.standard_normal(mesh.n_cells) * 100
    path = tmp_path / "out.csv"
    write_data(path, mesh, vel, p)
    FLOAT = "[\\d|\\.|e|\\-]+"
    VECTOR = f"\\(({FLOAT}),\\s+({FLOAT}),\\s+({FLOAT})\\)"
    pattern = re.compile(f"{VECTOR}\\t{VECTOR}\\t({FLOAT})")
    for line in open(path):
        assert pattern.match(line), f"plotter regex rejects: {line!r}"


def test_data_roundtrip(tmp_path):
    mesh, _ = structured_box_mesh(3, 2, 2)
    rng = np.random.default_rng(1)
    vel = rng.standard_normal((mesh.n_cells, 3))
    p = rng.standard_normal(mesh.n_cells)
    path = tmp_path / "data.csv"
    write_data(path, mesh, vel, p, precision=12)
    vel2, p2 = read_data(path)
    np.testing.assert_allclose(vel2, vel, rtol=1e-11)
    np.testing.assert_allclose(p2, p, rtol=1e-11)


def test_gradients_file(tmp_path):
    mesh, _ = structured_box_mesh(2, 2, 1)
    C = mesh.n_cells
    gv = np.arange(C * 9, dtype=float).reshape(C, 3, 3)
    gp = np.arange(C * 3, dtype=float).reshape(C, 3)
    path = tmp_path / "grads.csv"
    write_gradients(path, mesh, gv, gp)
    lines = open(path).read().strip().split("\n")
    assert len(lines) == C
    # Parse the way the reference plotter does (plot_output.py:155-163).
    _, vel_grad, p_grad = [
        s.split(", ")
        for s in lines[1].replace("(", "").replace(")", "").split("\t")
    ]
    assert len(vel_grad) == 9 and len(p_grad) == 3
    np.testing.assert_allclose(
        np.array(vel_grad, dtype=float).reshape(3, 3), gv[1]
    )


def test_checkpoint_roundtrip(tmp_path):
    mesh, _ = structured_box_mesh(3, 3, 1)
    state = initial_state(mesh)
    state = state.__class__(
        vel=state.vel + 1.5, p=state.p - 2.0, mom_diag=state.mom_diag * 3.0
    )
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, mesh, state, iteration=42)
    state2, it = load_checkpoint(path, mesh)
    assert it == 42
    np.testing.assert_allclose(np.asarray(state2.vel), np.asarray(state.vel))
    np.testing.assert_allclose(np.asarray(state2.p), np.asarray(state.p))
    # Wrong mesh -> refused.
    other, _ = structured_box_mesh(3, 3, 2)
    with pytest.raises(ValueError, match="different mesh"):
        load_checkpoint(path, other)


def test_warm_start_semantics(tmp_path):
    """load_or_initialize: existing file -> resume; missing -> fresh
    init (tests.rs:84-86)."""
    mesh, table = structured_box_mesh(3, 3, 1)
    table.set("INLET", FaceCondition.PRESSURE_INLET, scalar_value=1.0)
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.0)
    missing = str(tmp_path / "absent.npz")
    st = load_or_initialize(missing, mesh, table, mu=0.001, rho=1000.0)
    assert st.vel.shape == (mesh.n_cells, 3)

    # Text-format warm start.
    data = tmp_path / "warm.csv"
    vel = np.full((mesh.n_cells, 3), 0.25)
    p = np.full(mesh.n_cells, 7.0)
    write_data(data, mesh, vel, p, precision=10)
    st2 = load_or_initialize(str(data), mesh, table, mu=0.001, rho=1000.0)
    np.testing.assert_allclose(np.asarray(st2.vel), 0.25, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(st2.p), 7.0, rtol=1e-9)


# ---------------------------------------------------------------- VTK


def test_vtk_2d_polygon_areas(reference_mesh_dir, tmp_path):
    """2D mesh -> VTK_POLYGON cells whose shoelace areas reproduce the
    mesh cell volumes (loop ordering + connectivity are both right)."""
    from orc_cfd.io.vtk import write_vtk
    from orc_cfd.mesh import read_mesh
    from orc_cfd.mesh.tgrid import parse_tgrid

    msh = os.path.join(reference_mesh_dir, "2D_3x6.msh")
    mesh, _ = read_mesh(msh)
    with open(msh) as f:
        raw = parse_tgrid(f.read())
    out = tmp_path / "mesh2d.vtk"
    write_vtk(str(out), raw, cell_data={"volume": np.asarray(mesh.cell_volume)})
    lines = out.read_text().splitlines()
    pts_i = next(i for i, l in enumerate(lines) if l.startswith("POINTS"))
    n_pts = int(lines[pts_i].split()[1])
    pts = np.array(
        [[float(x) for x in lines[pts_i + 1 + i].split()] for i in range(n_pts)]
    )
    cells_i = next(i for i, l in enumerate(lines) if l.startswith("CELLS"))
    n_cells = int(lines[cells_i].split()[1])
    assert n_cells == mesh.n_cells
    vol = np.asarray(mesh.cell_volume)
    for c in range(n_cells):
        tok = [int(t) for t in lines[cells_i + 1 + c].split()]
        loop = tok[1:]
        assert len(loop) == tok[0] >= 3
        xy = pts[loop][:, :2]
        area = 0.5 * abs(
            np.sum(xy[:, 0] * np.roll(xy[:, 1], -1) - np.roll(xy[:, 0], -1) * xy[:, 1])
        )
        np.testing.assert_allclose(area, vol[c], rtol=1e-12)
    types_i = next(i for i, l in enumerate(lines) if l.startswith("CELL_TYPES"))
    assert all(lines[types_i + 1 + c] == "7" for c in range(n_cells))


def test_vtk_3d_polyhedron_roundtrip(tmp_path):
    """3D box -> VTK_POLYHEDRON face streams; cell data round-trips."""
    from orc_cfd.io.vtk import read_vtk_cell_data, write_vtk
    from orc_cfd.mesh.generate import write_tgrid
    from orc_cfd.mesh.tgrid import parse_tgrid

    msh = tmp_path / "box.msh"
    write_tgrid(str(msh), 4, 3, 2, lengths=(4.0, 3.0, 2.0))
    with open(msh) as f:
        raw = parse_tgrid(f.read())
    out = tmp_path / "box.vtk"
    scalar = np.arange(raw.n_cells, dtype=float)
    vec = np.stack([scalar, 2 * scalar, -scalar], axis=1)
    write_vtk(str(out), str(msh), cell_data={"s": scalar, "velocity": vec})
    lines = out.read_text().splitlines()
    types_i = next(i for i, l in enumerate(lines) if l.startswith("CELL_TYPES"))
    assert all(
        lines[types_i + 1 + c] == "42" for c in range(raw.n_cells)
    )  # VTK_POLYHEDRON
    # Every hex cell's face stream: 6 faces x 4 nodes -> 1 + 6*5 = 31 ints.
    cells_i = next(i for i, l in enumerate(lines) if l.startswith("CELLS"))
    for c in range(raw.n_cells):
        tok = [int(t) for t in lines[cells_i + 1 + c].split()]
        assert tok[0] == 31 and tok[1] == 6
    data = read_vtk_cell_data(str(out))
    np.testing.assert_allclose(data["s"], scalar)
    np.testing.assert_allclose(data["velocity"], vec)


def test_vtk_solution_write(tmp_path):
    """write_solution_vtk packages a FlowState; field-size mismatch is
    rejected."""
    from orc_cfd.io.vtk import read_vtk_cell_data, write_solution_vtk, write_vtk
    from orc_cfd.mesh.generate import write_tgrid
    from orc_cfd.solver.simple import initial_state
    from orc_cfd.mesh import read_mesh

    msh = tmp_path / "s.msh"
    write_tgrid(str(msh), 3, 3, 1)
    mesh, _ = read_mesh(str(msh))
    state = initial_state(mesh)
    out = tmp_path / "s.vtk"
    write_solution_vtk(str(out), str(msh), state)
    data = read_vtk_cell_data(str(out))
    assert data["velocity"].shape == (mesh.n_cells, 3)
    assert data["pressure"].shape == (mesh.n_cells,)
    with pytest.raises(ValueError, match="entries for"):
        write_vtk(str(tmp_path / "bad.vtk"), str(msh), {"x": np.zeros(5)})


def test_debug_dump_structured_no_neighbors():
    """ell_to_string handles structured matrices that omit `neighbors`
    (the shift path's EllMatrices carry None since round 2)."""
    import jax.numpy as jnp

    from orc_cfd.io.debug import ell_to_string, linear_system_to_string
    from orc_cfd.mesh.generate import structured_box_mesh
    from orc_cfd.ops.ck_ops import build_ck_geometry, ck_bc, ck_diffusion
    from orc_cfd.ops.fields import device_bc
    from orc_cfd.ops.spmv import EllMatrix

    mesh, table = structured_box_mesh(3, 3, 1)
    zc, zs, zv = device_bc(table, mesh.dtype)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    bc = ck_bc(ck, zc, zs, zv)
    dd, doff, _ = ck_diffusion(mesh, ck, bc, jnp.asarray(1.0, mesh.dtype))
    A = EllMatrix(
        diag=dd, off=doff, neighbors=None, offsets=mesh.neighbor_offsets
    )
    s = ell_to_string(A)
    assert s.count("\n") == mesh.n_cells - 1
    s2 = linear_system_to_string(A, jnp.ones(mesh.n_cells), max_dense_cols=4)
    assert "|" in s2


def test_checkpoint_turbulence_roundtrip(tmp_path):
    """RANS checkpoints carry k/eps/mu_t and restore them; plain
    checkpoints still load with with_turbulence=True (turb=None)."""
    import jax.numpy as jnp

    from orc_cfd.io.checkpoint import load_checkpoint, save_checkpoint
    from orc_cfd.mesh.generate import structured_box_mesh
    from orc_cfd.solver.simple import initial_state
    from orc_cfd.solver.turbulence import initial_turbulence

    mesh, _ = structured_box_mesh(4, 4, 1)
    state = initial_state(mesh)
    turb = initial_turbulence(mesh, 1.0, 0.05, 0.1, 1.0)
    p = os.path.join(tmp_path, "ck.npz")
    save_checkpoint(p, mesh, state, 7, turb=turb)
    s2, t2, it = load_checkpoint(p, mesh, with_turbulence=True)
    assert it == 7
    np.testing.assert_allclose(np.asarray(t2.k), np.asarray(turb.k))
    np.testing.assert_allclose(np.asarray(t2.mu_t), np.asarray(turb.mu_t))
    # Plain checkpoint: turb comes back None.
    p2 = os.path.join(tmp_path, "plain.npz")
    save_checkpoint(p2, mesh, state, 3)
    s3, t3, it3 = load_checkpoint(p2, mesh, with_turbulence=True)
    assert t3 is None and it3 == 3
    # Legacy signature unchanged.
    s4, it4 = load_checkpoint(p2, mesh)
    assert it4 == 3


def test_checkpoint_fc_flux_roundtrip(tmp_path):
    """SIMPLE_FC's conservative stored flux travels with the
    checkpoint (resuming without it would re-seed from interpolation
    and lose exact conservation)."""
    import dataclasses

    import jax.numpy as jnp

    mesh, _ = structured_box_mesh(3, 3, 1)
    state = initial_state(mesh)
    K = mesh.cell_neighbors.shape[1]
    flux = jnp.arange(mesh.n_cells * K, dtype=mesh.dtype).reshape(-1, K)
    state = dataclasses.replace(state, flux=flux)
    path = str(tmp_path / "fc.npz")
    save_checkpoint(path, mesh, state, iteration=3)
    state2, it = load_checkpoint(path, mesh)
    assert it == 3
    assert state2.flux is not None
    np.testing.assert_allclose(np.asarray(state2.flux), np.asarray(flux))
    # A non-FC checkpoint round-trips with flux=None (previous test's
    # behavior preserved).
    save_checkpoint(path, mesh, initial_state(mesh))
    s3, _ = load_checkpoint(path, mesh)
    assert s3.flux is None


def test_face_velocities_write_plot_cycle(tmp_path):
    """write_face_velocities rows parse exactly the way the reference
    plotter parses them (plot_output.py:233-244), and
    plot_face_velocities renders a multi-file comparison figure."""
    import jax.numpy as jnp

    from orc_cfd.io.data import write_face_velocities
    from orc_cfd.ops.fields import device_bc, face_bc
    from orc_cfd.ops.interpolation import face_velocity
    from orc_cfd.plotting import _read_face_velocities, plot_face_velocities

    mesh, table = structured_box_mesh(6, 4, 1)
    table.set("TOP_WALL", FaceCondition.WALL, vector_value=(1.0, 0, 0))
    zc, zs, zv = device_bc(table, dtype=mesh.dtype)
    fbc = face_bc(mesh, zc, zs, zv)
    rng = np.random.default_rng(5)
    files = []
    for i in range(2):
        vel = jnp.asarray(rng.standard_normal((mesh.n_cells, 3)) * 0.1)
        fv = face_velocity(mesh, fbc, vel)
        path = tmp_path / f"faces_{i}.csv"
        write_face_velocities(path, mesh, fv)
        # Round trip through the plot parser (the reference's parse
        # shape: id \t (x, y, z) \t (u, v, w)).
        x, y, u, v = _read_face_velocities(path)
        np.testing.assert_allclose(
            x, np.asarray(mesh.face_centroid)[:, 0], rtol=1e-5, atol=1e-8
        )
        np.testing.assert_allclose(
            u, np.asarray(fv)[:, 0], rtol=1e-5, atol=1e-8
        )
        files.append(str(path))
    written = plot_face_velocities(files, out_dir=str(tmp_path))
    assert written and os.path.exists(written[0])
    assert os.path.getsize(written[0]) > 10_000
