"""Mesh ingest + geometry tests.

Mirrors the reference's inline geometry assertions on regular grids
(reference: main.rs:157-172, 304-326) and extends them: exact areas,
volumes, centroids, normals, zone tables, parser round-trips against the
generator, and cross-checks against the reference's shipped fixtures.
"""

import os

import numpy as np
import pytest

from orc_cfd.mesh import (
    parse_tgrid,
    read_mesh,
    structured_box_mesh,
    write_tgrid,
)
from orc_cfd.mesh.zones import FaceCondition


def check_mesh_invariants(mesh):
    C, F, K = mesh.n_cells, mesh.n_faces, mesh.max_faces_per_cell
    owner = np.asarray(mesh.face_owner)
    neighbor = np.asarray(mesh.face_neighbor)
    interior = np.asarray(mesh.face_interior)
    normal = np.asarray(mesh.face_normal)
    area = np.asarray(mesh.face_area)
    cc = np.asarray(mesh.cell_centroid)
    fc = np.asarray(mesh.face_centroid)

    # Unit normals, positive areas/volumes.
    np.testing.assert_allclose(np.linalg.norm(normal, axis=1), 1.0, rtol=1e-12)
    assert (area > 0).all()
    assert (np.asarray(mesh.cell_volume) > 0).all()

    # Outward-from-owner convention.
    d = np.einsum("fi,fi->f", normal, fc - cc[owner])
    assert (d > 0).all()
    # ... and therefore inward for the neighbor.
    dn = np.einsum("fi,fi->f", normal, fc - cc[neighbor])
    assert (dn[interior] < 0).all()
    # Boundary faces have neighbor == owner (self-gather convention).
    assert (neighbor[~interior] == owner[~interior]).all()

    # ELL tables: each face appears once per adjacent cell with the right
    # sign, padded slots are masked.
    cf = np.asarray(mesh.cell_faces)
    mask = np.asarray(mesh.cell_face_mask)
    sign = np.asarray(mesh.cell_face_sign)
    nbrs = np.asarray(mesh.cell_neighbors)
    count = np.zeros(F, dtype=int)
    for c in range(C):
        for k in range(K):
            if not mask[c, k]:
                assert sign[c, k] == 0
                assert nbrs[c, k] == c
                continue
            f = cf[c, k]
            count[f] += 1
            if sign[c, k] == 1.0:
                assert owner[f] == c
                assert nbrs[c, k] == (neighbor[f] if interior[f] else c)
            else:
                assert sign[c, k] == -1.0
                assert neighbor[f] == c
                assert nbrs[c, k] == owner[f]
    np.testing.assert_array_equal(count, 1 + interior.astype(int))

    # Divergence consistency: sum of outward area vectors of a closed
    # cell is ~0 (exact for exact geometry).
    for c in range(min(C, 32)):
        s = np.zeros(3)
        for k in range(K):
            if mask[c, k]:
                f = cf[c, k]
                s += sign[c, k] * normal[f] * area[f]
        np.testing.assert_allclose(s, 0.0, atol=1e-9)


def test_structured_box_geometry():
    mesh, table = structured_box_mesh(3, 4, 5, lengths=(3.0, 2.0, 1.0))
    assert mesh.n_cells == 60
    hx, hy, hz = 1.0, 0.5, 0.2
    np.testing.assert_allclose(np.asarray(mesh.cell_volume), hx * hy * hz)
    check_mesh_invariants(mesh)
    # Total boundary area = surface of the box.
    interior = np.asarray(mesh.face_interior)
    area = np.asarray(mesh.face_area)
    expected = 2 * (3.0 * 2.0 + 3.0 * 1.0 + 2.0 * 1.0)
    np.testing.assert_allclose(area[~interior].sum(), expected)


def test_tgrid_roundtrip(tmp_path):
    path = str(tmp_path / "box.msh")
    write_tgrid(path, 3, 4, 2, lengths=(1.5, 1.0, 0.5))
    mesh, table = read_mesh(path)
    gen_mesh, gen_table = structured_box_mesh(3, 4, 2, lengths=(1.5, 1.0, 0.5))
    assert mesh.n_cells == gen_mesh.n_cells
    assert mesh.n_faces == gen_mesh.n_faces
    check_mesh_invariants(mesh)
    np.testing.assert_allclose(
        np.sort(np.asarray(mesh.cell_volume)),
        np.sort(np.asarray(gen_mesh.cell_volume)),
        rtol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(mesh.cell_volume).sum(), 1.5 * 1.0 * 0.5, rtol=1e-12
    )
    names = {fz.name for fz in table.zones.values()}
    assert {"FLUID", "INLET", "OUTLET", "TOP_WALL", "BOTTOM_WALL"} <= names


# --- reference fixture meshes (skipped when unavailable) -----------------


def test_reference_2d_3x6(reference_mesh_dir):
    """Geometry assertions mirrored from the reference's test_2d
    (main.rs:128-172): 3x6 grid of 1/3 x 1/3 m cells... actually
    2 m x 1 m domain -> cells 1/3 m x 1/3 m."""
    mesh, table = read_mesh(os.path.join(reference_mesh_dir, "2D_3x6.msh"))
    assert mesh.dim == 2
    assert mesh.n_cells == 18
    cell_w, cell_h = 2.0 / 6.0, 1.0 / 3.0
    np.testing.assert_allclose(
        np.asarray(mesh.cell_volume), cell_w * cell_h, rtol=1e-10
    )
    area = np.asarray(mesh.face_area)
    assert area.min() >= min(cell_w, cell_h) - 1e-3
    assert area.max() <= max(cell_w, cell_h) + 1e-3
    check_mesh_invariants(mesh)
    names = {fz.name for fz in table.zones.values()}
    assert {"INLET", "OUTLET", "TOP", "BOTTOM"} <= names


def test_reference_3x3_cube(reference_mesh_dir):
    """Mirrors test_3d_3x3 (main.rs:287-326): 1 m cube, 27 cells of
    (1/3)^3 volume, faces (1/3)^2."""
    mesh, table = read_mesh(os.path.join(reference_mesh_dir, "3x3_cube.msh"))
    assert mesh.dim == 3
    assert mesh.n_cells == 27
    a = (1.0 / 3.0) ** 2
    v = (1.0 / 3.0) ** 3
    np.testing.assert_allclose(np.asarray(mesh.cell_volume), v, atol=1e-4)
    area = np.asarray(mesh.face_area)
    np.testing.assert_allclose(area, a, atol=1e-3)
    check_mesh_invariants(mesh)


def test_reference_3d_1x3(reference_mesh_dir):
    mesh, table = read_mesh(os.path.join(reference_mesh_dir, "3D_1x3.msh"))
    assert mesh.n_cells == 3
    np.testing.assert_allclose(np.asarray(mesh.cell_volume), 1.0, atol=1e-4)
    check_mesh_invariants(mesh)
    names = {fz.name for fz in table.zones.values()}
    assert {"INLET", "OUTLET", "WALL"} <= names


def test_reference_couette_8x8(reference_mesh_dir):
    mesh, table = read_mesh(
        os.path.join(reference_mesh_dir, "couette_flow_8x8x1.msh")
    )
    assert mesh.n_cells == 64
    check_mesh_invariants(mesh)
    names = {fz.name for fz in table.zones.values()}
    # The 8x8 fixture merges top/bottom walls into one WALL zone.
    assert {
        "INLET",
        "OUTLET",
        "WALL",
        "PERIODIC_-Z",
        "PERIODIC_+Z",
    } <= names
    # Domain: 2 mm x 1 mm channel (tests.rs:53-54).
    cc = np.asarray(mesh.cell_centroid)
    assert cc[:, 0].max() < 2.1e-3 and cc[:, 1].max() < 1.1e-3


def test_reference_couette_128x64(reference_mesh_dir):
    mesh, table = read_mesh(
        os.path.join(reference_mesh_dir, "couette_flow_128x64x1.msh")
    )
    # The fixture declares 8001 cells / 32194 faces (its name notwithstanding).
    assert mesh.n_cells == 8001
    assert mesh.n_faces == 32194
    names = {fz.name for fz in table.zones.values()}
    assert {"INLET", "OUTLET", "TOP_WALL", "BOTTOM_WALL"} <= names
    # Closed-cell divergence check, vectorized over all cells.
    s = np.einsum(
        "ck,cki->ci",
        np.asarray(mesh.cell_face_sign)
        * np.asarray(mesh.face_area)[np.asarray(mesh.cell_faces)],
        np.asarray(mesh.face_normal)[np.asarray(mesh.cell_faces)],
    )
    np.testing.assert_allclose(s, 0.0, atol=1e-12)


def test_bc_table_mutation():
    mesh, table = structured_box_mesh(2, 2, 1)
    table.set("INLET", FaceCondition.VELOCITY_INLET, vector_value=(1.0, 0, 0))
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.0)
    slot = table.slot_of_zone[table.zone_by_name("INLET").zone_id]
    assert table.codes[slot] == int(FaceCondition.VELOCITY_INLET)
    np.testing.assert_allclose(table.vector[slot], [1.0, 0, 0])
    with pytest.raises(KeyError):
        table.set("NOPE", FaceCondition.WALL)


def test_structured_fast_matches_generic():
    """The analytic CompiledMesh construction (_structured_compile)
    is semantically identical to the generic face-list ->
    compile_from_arrays path: same face multiset (geometry + zones),
    same offsets, and bit-equal dense diffusion systems."""
    import jax.numpy as jnp

    from orc_cfd.mesh.generate import (
        _structured_box_mesh_generic,
        structured_box_mesh,
    )
    from orc_cfd.ops.assembly import diffusion_system
    from orc_cfd.ops.fields import device_bc, face_bc

    cases = [
        dict(nx=5, ny=4, nz=1),
        dict(nx=4, ny=3, nz=3),
        dict(nx=6, ny=5, nz=1, periodic=("x",)),
        dict(nx=4, ny=4, nz=4, periodic=("y",)),
        dict(nx=3, ny=4, nz=5, periodic=("x", "z")),
        dict(nx=2, ny=7, nz=1),
        dict(nx=1, ny=6, nz=1),
    ]
    for case in cases:
        kw = dict(lengths=(1.7, 0.9, 0.4), **case)
        mesh_f, table_f = structured_box_mesh(**kw)
        mesh_g, table_g = _structured_box_mesh_generic(
            case["nx"], case["ny"], case["nz"], (1.7, 0.9, 0.4),
            (0.0, 0.0, 0.0), None, jnp.float64, case.get("periodic", ()),
        )
        assert table_f.codes == table_g.codes, case
        assert mesh_f.n_cells == mesh_g.n_cells, case
        assert mesh_f.n_faces == mesh_g.n_faces, case
        assert set(mesh_f.neighbor_offsets) == set(
            mesh_g.neighbor_offsets
        ), case
        assert (
            mesh_f.max_faces_per_cell == mesh_g.max_faces_per_cell
        ), case

        # Face multiset: geometry + BC + interpolation data must agree
        # (orderings differ; compare sorted canonical rows).
        def face_rows(m):
            cols = np.column_stack(
                [
                    np.asarray(m.face_centroid),
                    np.asarray(m.face_normal),
                    np.asarray(m.face_area)[:, None],
                    np.asarray(m.face_zone_slot)[:, None],
                    np.asarray(m.face_interior)[:, None],
                    np.asarray(m.face_lw)[:, None],
                    np.asarray(m.face_r_on),
                    np.asarray(m.face_dist_on)[:, None],
                    np.asarray(m.face_dist_fo)[:, None],
                    np.asarray(m.face_owner)[:, None],
                    np.asarray(m.face_neighbor)[:, None],
                ]
            )
            return cols[np.lexsort(cols.T[::-1])]

        np.testing.assert_allclose(
            face_rows(mesh_f), face_rows(mesh_g), atol=1e-12,
            err_msg=str(case),
        )

        # Dense diffusion matrices (diag + scattered off) identical:
        # the ultimate check that the ELL tables encode the same
        # operator regardless of column placement.
        def dense_diffusion(mesh, table):
            zc, zs, zv = device_bc(table, mesh.dtype)
            fbc = face_bc(mesh, zc, zs, zv)
            d = diffusion_system(mesh, fbc, jnp.asarray(1.0))
            C = mesh.n_cells
            M = np.zeros((C, C))
            M[np.arange(C), np.arange(C)] = np.asarray(d.diag)
            nb = np.asarray(mesh.cell_neighbors)
            off = np.asarray(d.off)
            for kk in range(nb.shape[1]):
                np.add.at(M, (np.arange(C), nb[:, kk]), off[:, kk])
            return M, np.asarray(d.b)

        Mf, bf = dense_diffusion(mesh_f, table_f)
        Mg, bg = dense_diffusion(mesh_g, table_g)
        np.testing.assert_allclose(Mf, Mg, atol=1e-13, err_msg=str(case))
        np.testing.assert_allclose(bf, bg, atol=1e-13, err_msg=str(case))
