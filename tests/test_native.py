"""Native (C++) TGRID parser: must agree exactly with the Python parser
on every fixture."""

import glob
import os

import numpy as np
import pytest

from orc_cfd.mesh.tgrid import parse_tgrid
from orc_cfd.mesh import read_mesh, write_tgrid

native = pytest.importorskip("orc_cfd.mesh.native")

if not native.native_available():
    pytest.skip("g++ toolchain unavailable", allow_module_level=True)


def assert_same(rn, rp):
    assert rn.dim == rp.dim
    assert rn.n_cells == rp.n_cells
    assert rn.n_faces == rp.n_faces
    np.testing.assert_allclose(rn.points, rp.points)
    np.testing.assert_array_equal(rn.face_cells, rp.face_cells)
    np.testing.assert_array_equal(rn.face_zone_id, rp.face_zone_id)
    for a, b in zip(rn.face_nodes, rp.face_nodes):
        np.testing.assert_array_equal(a, b)
    zn = {z.zone_id: (z.name, z.zone_type) for z in rn.face_zones.values()}
    zp = {z.zone_id: (z.name, z.zone_type) for z in rp.face_zones.values()}
    assert zn == zp


@pytest.mark.parametrize(
    "name",
    [
        "2D_2x4.msh",
        "2D_3x6.msh",
        "3D_1x3.msh",
        "3x3_cube.msh",
        "couette_flow_8x8x1.msh",
        "couette_flow_128x64x1.msh",
        "channel_flow.msh",
    ],
)
def test_native_matches_python(reference_mesh_dir, name):
    path = os.path.join(reference_mesh_dir, name)
    if not os.path.exists(path):
        pytest.skip(f"{name} not present")
    rn = native.parse_tgrid_native(path)
    rp = parse_tgrid(open(path).read())
    assert_same(rn, rp)


def test_native_on_generated(tmp_path):
    path = str(tmp_path / "gen.msh")
    write_tgrid(path, 4, 3, 2)
    rn = native.parse_tgrid_native(path)
    rp = parse_tgrid(open(path).read())
    assert_same(rn, rp)


def test_native_error_on_garbage(tmp_path):
    path = str(tmp_path / "garbage.msh")
    open(path, "w").write("hello\nworld\n")
    with pytest.raises(ValueError, match="native TGRID parse failed"):
        native.parse_tgrid_native(path)


def test_read_mesh_native_flag(reference_mesh_dir):
    path = os.path.join(reference_mesh_dir, "couette_flow_8x8x1.msh")
    m1, _ = read_mesh(path, native=True)
    m2, _ = read_mesh(path, native=False)
    np.testing.assert_allclose(
        np.asarray(m1.cell_volume), np.asarray(m2.cell_volume)
    )
    np.testing.assert_array_equal(
        np.asarray(m1.cell_neighbors), np.asarray(m2.cell_neighbors)
    )
