"""Irregular-mesh fast path: RCM reordering + slice-plan SpMV
(orc_cfd/mesh/reorder.py, ops/spmv.slice_spmv).

The reference's CSR SpMV is ordering-agnostic on CPU
(linear_algebra.rs:65-141); here irregular meshes get an RCM ordering + per-tile
distinct-delta slice schedule at compile time. These tests pin:
- the permutation is a permutation and bounds the bandwidth,
- slice SpMV == gather SpMV exactly (same sparsity, random values),
- an end-to-end solve on an irregular mesh matches the gather path.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from orc_cfd.mesh.reorder import build_slice_plan, rcm_permutation
from orc_cfd.ops.spmv import EllMatrix


def _random_irregular_mesh(n=17, seed=0):
    """A structured box run through a random cell permutation so that
    no structured offsets exist — compile_from_arrays then applies RCM
    and builds a slice plan."""
    from orc_cfd.models.cavity import cavity_case

    rng = np.random.default_rng(seed)
    mesh, table = cavity_case(n=n, dtype=jnp.float64)
    assert mesh.neighbor_offsets is not None
    # Rebuild with permuted cells via compile_from_arrays.
    from orc_cfd.mesh.compile import compile_from_arrays

    C = mesh.n_cells
    perm = rng.permutation(C)
    inv = np.empty(C, np.int64)
    inv[perm] = np.arange(C)
    owner = inv[np.asarray(mesh.face_owner)]
    interior = np.asarray(mesh.face_interior)
    neighbor = np.where(interior, inv[np.asarray(mesh.face_neighbor)], -1)
    m2 = compile_from_arrays(
        dim=2,
        face_owner=owner,
        face_neighbor=neighbor,
        face_area=np.asarray(mesh.face_area),
        face_normal=np.asarray(mesh.face_normal),
        face_centroid=np.asarray(mesh.face_centroid),
        face_zone_slot=np.asarray(mesh.face_zone_slot),
        cell_centroid=np.asarray(mesh.cell_centroid)[perm],
        cell_volume=np.asarray(mesh.cell_volume)[perm],
        dtype=jnp.float64,
    )
    return m2, table


def test_rcm_is_permutation_and_bounds_bandwidth():
    mesh, _ = _random_irregular_mesh(23)
    C = mesh.n_cells
    assert mesh.neighbor_offsets is None
    assert mesh.cell_order is not None
    order = np.asarray(mesh.cell_order)
    assert sorted(order.tolist()) == list(range(C))
    # Bandwidth after RCM must be far below C (random order would be ~C).
    nbrs = np.asarray(mesh.cell_neighbors)
    interior = (
        np.asarray(mesh.face_interior)[np.asarray(mesh.cell_faces)]
        & np.asarray(mesh.cell_face_mask)
    )
    delta = np.abs(nbrs - np.arange(C)[:, None])[interior]
    assert delta.max() <= 6 * int(np.sqrt(C)) + 8


def test_slice_plan_covers_every_entry():
    mesh, _ = _random_irregular_mesh(19)
    plan = mesh.slice_plan
    assert plan is not None
    nbrs = np.asarray(mesh.cell_neighbors)
    interior = (
        np.asarray(mesh.face_interior)[np.asarray(mesh.cell_faces)]
        & np.asarray(mesh.cell_face_mask)
    )
    C, K = nbrs.shape
    starts = np.asarray(plan.starts)
    col_of = np.asarray(plan.col_of)
    rows, cols = np.nonzero(interior)
    t = rows // plan.tile
    p = rows % plan.tile
    # Padded index the slice reads for this entry == padded neighbor.
    got = starts[t, col_of[rows, cols]] + p
    want = nbrs[rows, cols] + plan.pad_lo
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_slice_spmv_matches_gather(batch):
    mesh, _ = _random_irregular_mesh(21, seed=3)
    C, K = mesh.cell_neighbors.shape
    rng = np.random.default_rng(7)
    interior = (
        np.asarray(mesh.face_interior)[np.asarray(mesh.cell_faces)]
        & np.asarray(mesh.cell_face_mask)
    )
    off = jnp.asarray(
        rng.standard_normal((*batch, C, K)) * interior, jnp.float64
    )
    diag = jnp.asarray(rng.standard_normal((*batch, C)) + 5.0)
    x = jnp.asarray(rng.standard_normal((*batch, C)))
    A = EllMatrix(
        diag=diag, off=off, neighbors=mesh.cell_neighbors,
        plan=mesh.slice_plan,
    )
    y_gather = EllMatrix(
        diag=diag, off=off, neighbors=mesh.cell_neighbors
    ).matvec(x)
    if batch:
        # vmapped prepare+matvec (the momentum-solve shape)
        y_slice = jax.vmap(
            lambda d, o, xi: EllMatrix(
                diag=d, off=o, neighbors=mesh.cell_neighbors,
                plan=mesh.slice_plan,
            ).prepare().matvec(xi)
        )(diag, off, x)
    else:
        y_slice = A.prepare().matvec(x)
    np.testing.assert_allclose(
        np.asarray(y_slice), np.asarray(y_gather), rtol=1e-12, atol=1e-12
    )


def test_jacobi_preconditioned_slice_layout():
    mesh, _ = _random_irregular_mesh(13, seed=5)
    C, K = mesh.cell_neighbors.shape
    rng = np.random.default_rng(11)
    interior = (
        np.asarray(mesh.face_interior)[np.asarray(mesh.cell_faces)]
        & np.asarray(mesh.cell_face_mask)
    )
    off = jnp.asarray(rng.standard_normal((C, K)) * interior)
    diag = jnp.asarray(rng.standard_normal(C) + 5.0)
    x = jnp.asarray(rng.standard_normal(C))
    A = EllMatrix(
        diag=diag, off=off, neighbors=mesh.cell_neighbors,
        plan=mesh.slice_plan,
    )
    Ap, _ = A.prepare().jacobi_preconditioned()
    Ag, _ = EllMatrix(
        diag=diag, off=off, neighbors=mesh.cell_neighbors
    ).jacobi_preconditioned()
    np.testing.assert_allclose(
        np.asarray(Ap.matvec(x)), np.asarray(Ag.matvec(x)),
        rtol=1e-12, atol=1e-12,
    )


def test_irregular_solve_matches_structured():
    """The same physical box solved in structured order and in a
    random (-> RCM) order must give the same flow field (up to the
    cell relabeling)."""
    from orc_cfd.models.cavity import cavity_case
    from orc_cfd.solver.simple import initial_state, solve_steady
    from orc_cfd.utils.settings import (
        MatrixSolverSettings,
        MomentumScheme,
        NumericalSettings,
        PreconditionMethod,
        PressureInterpolation,
        RelaxationMode,
        SolutionMethod,
        VelocityInterpolation,
    )

    n = 12
    mesh_s, table = cavity_case(n=n, dtype=jnp.float64)
    mesh_i, _ = _random_irregular_mesh(n, seed=9)
    assert mesh_i.slice_plan is not None
    settings = NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
        pressure_relaxation=0.1,
        momentum_relaxation=0.7,
        relaxation_mode=RelaxationMode.IMPLICIT,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB,
            iterations=50,
            preconditioner=PreconditionMethod.JACOBI,
        ),
    )
    st_s, _ = solve_steady(
        mesh_s, table, settings, 1.0, 0.01,
        state=initial_state(mesh_s), iterations=60,
        reporting_interval=30, verbose=False,
    )
    st_i, _ = solve_steady(
        mesh_i, table, settings, 1.0, 0.01,
        state=initial_state(mesh_i), iterations=60,
        reporting_interval=30, verbose=False,
    )
    # Match cells by centroid.
    cs = np.asarray(mesh_s.cell_centroid)
    ci = np.asarray(mesh_i.cell_centroid)
    key_s = np.lexsort((cs[:, 0], cs[:, 1], cs[:, 2]))
    key_i = np.lexsort((ci[:, 0], ci[:, 1], ci[:, 2]))
    np.testing.assert_allclose(
        np.asarray(st_i.vel)[key_i],
        np.asarray(st_s.vel)[key_s],
        rtol=1e-8, atol=1e-10,
    )


def test_null_comm_refresh_is_sentinel():
    """The single-device comm hook must BE the krylov no-op sentinel:
    `iterative_solve` gates the slice-plan fast path (EllMatrix
    .prepare()) on `refresh is _no_refresh`, so a plain bound method
    would silently route every irregular-mesh SIMPLE solve onto the
    element-gather SpMV."""
    from orc_cfd.solver.krylov import _no_refresh
    from orc_cfd.solver.simple import NullComm

    assert NullComm().refresh is _no_refresh
    assert NullComm.refresh is _no_refresh


def test_text_io_raw_order_round_trip(tmp_path):
    """Text data files use RAW mesh cell order (the format's implicit
    schema, io.rs:519-571): an RCM-compiled mesh must write rows in
    raw order and warm-start back into compiled order."""
    from orc_cfd.io.checkpoint import load_or_initialize
    from orc_cfd.io.data import read_data, write_data

    mesh, table = _random_irregular_mesh(9)
    assert mesh.cell_order is not None
    C = mesh.n_cells
    # A recognizable compiled-order field: p[c] = raw id of cell c.
    order = np.asarray(mesh.cell_order)
    p = jnp.asarray(order, mesh.dtype)
    vel = jnp.stack([p, 2 * p, jnp.zeros_like(p)], axis=-1)
    path = tmp_path / "data.csv"
    write_data(path, mesh, vel, p)

    # On disk: row i (raw cell i) must hold value i.
    vel_raw, p_raw = read_data(path)
    np.testing.assert_allclose(p_raw, np.arange(C), atol=1e-12)

    # Warm start maps back into compiled order.
    state = load_or_initialize(str(path), mesh, table, 0.01, 1.0)
    np.testing.assert_allclose(np.asarray(state.p), order, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(state.vel)[:, 1], 2 * order, atol=1e-9
    )
