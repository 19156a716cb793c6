"""Distributed tests: a partitioned run must match the single-device
run (the test tier the reference never had — SURVEY.md 4e). Runs on the
8-device virtual CPU mesh configured in conftest."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from orc_cfd.mesh import structured_box_mesh
from orc_cfd.mesh.zones import FaceCondition
from orc_cfd.parallel.partition import partition_mesh, rcb_partition
from orc_cfd.parallel.sharded import (
    gather_state,
    scatter_state,
    solve_steady_sharded,
)
from orc_cfd.solver.simple import initial_state, solve_steady
from orc_cfd.utils.settings import (
    MatrixSolverSettings,
    MomentumScheme,
    NumericalSettings,
    PreconditionMethod,
    PressureInterpolation,
    SolutionMethod,
    VelocityInterpolation,
)


def case(nx=8, ny=8, nz=1):
    mesh, table = structured_box_mesh(
        nx, ny, nz, lengths=(0.002, 0.001, 0.0001)
    )
    table.set("TOP_WALL", FaceCondition.WALL, vector_value=(5e-4, 0, 0))
    table.set("INLET", FaceCondition.PRESSURE_INLET, scalar_value=0.01)
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    return mesh, table


def test_rcb_partition_balance():
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((1000, 3))
    for n in (2, 3, 8):
        parts = rcb_partition(pts, n)
        counts = np.bincount(parts, minlength=n)
        assert counts.min() >= 1000 // n - 2
        assert counts.max() <= 1000 // n + 2


@pytest.mark.parametrize("method", ["slab", "rcb"])
def test_partition_roundtrip_state(method):
    mesh, table = case()
    part = partition_mesh(mesh, 4, method=method)
    rng = np.random.default_rng(1)
    st = initial_state(
        mesh,
        vel=rng.standard_normal((mesh.n_cells, 3)),
        p=rng.standard_normal(mesh.n_cells),
    )
    local = scatter_state(part, st)
    back = gather_state(part, local, mesh.n_cells)
    np.testing.assert_allclose(np.asarray(back.vel), np.asarray(st.vel))
    np.testing.assert_allclose(np.asarray(back.p), np.asarray(st.p))


def test_halo_refresh_correctness():
    """After refresh, each device's halo slots hold the owner's values."""
    from jax.sharding import Mesh
    from jax import shard_map
    from jax import lax
    from orc_cfd.parallel.sharded import AXIS, ShardedComm

    mesh, table = case(8, 4, 1)
    n = 4
    part = partition_mesh(mesh, n)
    # Global field = global cell index (recognizable values).
    st = initial_state(
        mesh,
        vel=np.tile(np.arange(mesh.n_cells, dtype=float)[:, None], (1, 3)),
        p=np.arange(mesh.n_cells, dtype=float),
    )
    local = scatter_state(part, st)
    device_mesh = Mesh(np.array(jax.devices()[:n]), (AXIS,))

    def f(send_idx, recv_idx, x):
        sq = lambda t: jax.tree.map(lambda a: a[0], t)
        comm = ShardedComm(part, sq(send_idx), sq(recv_idx))
        return comm.refresh(sq(x))[None]

    from jax.sharding import PartitionSpec as P

    refreshed = jax.jit(
        shard_map(
            f,
            mesh=device_mesh,
            in_specs=(P(AXIS), P(AXIS), P(AXIS)),
            out_specs=P(AXIS),
            check_vma=False,
        )
    )(part.send_idx, part.recv_idx, local.p)

    refreshed = np.asarray(refreshed)
    c_max, h_max = part.c_max, part.h_max
    # For each part, halo slot k must equal the global id of halo cell k.
    lm = part.local_mesh
    # Reconstruct halos from cell_neighbors: halo slots that are
    # actually referenced must match their global cell value.
    nbrs = np.asarray(lm.cell_neighbors)
    mask = np.asarray(lm.cell_face_mask)
    og = np.asarray(part.owned_global)
    om = np.asarray(part.owned_mask)
    interior = np.asarray(lm.face_interior)
    cf = np.asarray(lm.cell_faces)
    for p in range(n):
        for c in range(c_max):
            if not om[p, c]:
                continue
            for k in range(nbrs.shape[2]):
                if not mask[p, c, k]:
                    continue
                j = nbrs[p, c, k]
                if j >= c_max:  # halo reference
                    # The refreshed halo value is the owning device's
                    # global cell id: check it's a real cell id and is a
                    # face-neighbor of cell og[p, c] globally.
                    v = refreshed[p, j]
                    assert v == int(v) and 0 <= v < mesh.n_cells
                    g = og[p, c]
                    g_nbrs = np.asarray(mesh.cell_neighbors)[g]
                    assert int(v) in set(g_nbrs.tolist()), (p, c, k, v)


SETTINGS = NumericalSettings(
    momentum=MomentumScheme.UD,
    pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
    velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
    matrix_solver=MatrixSolverSettings(
        solver_type=SolutionMethod.BICGSTAB,
        iterations=30,
        preconditioner=PreconditionMethod.JACOBI,
    ),
)


@pytest.mark.parametrize(
    "n_devices,method,ck",
    [
        (2, "slab", "auto"),
        (8, "slab", True),  # gather-free (c,k)-direct step per device
        (8, "slab", False),  # face-major step per device
        (4, "rcb", "auto"),  # rcb drops offsets -> auto = face-major
    ],
)
def test_sharded_matches_single_device(n_devices, method, ck):
    """The distributed SIMPLE loop must reproduce the single-device
    trajectory (tolerance covers reduction-order differences), with both
    the ghost-layer slab partitioner (structured, gather-free SpMV) and
    the general RCB partitioner, on both per-device step formulations
    (face-major and ck-direct)."""
    mesh, table = case()
    state0 = initial_state(mesh)
    ref_state, _ = solve_steady(
        mesh,
        table,
        SETTINGS,
        1000.0,
        0.001,
        state=state0,
        iterations=20,
        reporting_interval=20,
        verbose=False,
    )
    sh_state, _ = solve_steady_sharded(
        mesh,
        table,
        SETTINGS,
        1000.0,
        0.001,
        state=initial_state(mesh),
        iterations=20,
        reporting_interval=20,
        n_devices=n_devices,
        verbose=False,
        partition_method=method,
        use_ck=ck,
    )
    np.testing.assert_allclose(
        np.asarray(sh_state.vel),
        np.asarray(ref_state.vel),
        rtol=1e-8,
        atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(sh_state.p),
        np.asarray(ref_state.p),
        rtol=1e-8,
        atol=1e-12,
    )


def test_rhie_chow_sharded_matches():
    """Default schemes (Rhie-Chow + SecondOrder) through the sharded
    path: halo exchange of gradients and momentum diagonals."""
    mesh, table = case(8, 4, 1)
    settings = SETTINGS.replace(
        pressure_interpolation=PressureInterpolation.SECOND_ORDER,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
    )
    ref_state, _ = solve_steady(
        mesh, table, settings, 1000.0, 0.001,
        state=initial_state(mesh), iterations=10, reporting_interval=10,
        verbose=False,
    )
    sh_state, _ = solve_steady_sharded(
        mesh, table, settings, 1000.0, 0.001,
        state=initial_state(mesh), iterations=10, reporting_interval=10,
        n_devices=4, verbose=False,
    )
    np.testing.assert_allclose(
        np.asarray(sh_state.vel), np.asarray(ref_state.vel), rtol=1e-8, atol=1e-12
    )


def test_graft_entry():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    ge.dryrun_multichip(8)


def test_graft_entry_dryrun_subprocess():
    """dryrun_multichip called from a process that sees fewer devices
    than requested falls back to a subprocess (scrubbed env + virtual
    CPU mesh). Exercise that path explicitly."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import __graft_entry__ as ge

    ge._dryrun_multichip_subprocess(8)


def test_slab_preserves_offsets():
    mesh, table = case(16, 4, 1)
    part = partition_mesh(mesh, 4, method="slab")
    assert part.local_mesh.neighbor_offsets == mesh.neighbor_offsets
    rcb = partition_mesh(mesh, 4, method="rcb")
    assert rcb.local_mesh.neighbor_offsets is None


def test_slab_ghost_layers_refresh():
    """After a refresh, every in-window ghost slot of the slab layout
    holds the owning device's value (= global cell id here)."""
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from orc_cfd.parallel.sharded import AXIS, ShardedComm

    mesh, table = case(16, 4, 1)
    n = 4
    part = partition_mesh(mesh, n, method="slab")
    st = initial_state(
        mesh,
        vel=np.tile(np.arange(mesh.n_cells, dtype=float)[:, None], (1, 3)),
        p=np.arange(mesh.n_cells, dtype=float),
    )
    local = scatter_state(part, st)
    device_mesh = Mesh(np.array(jax.devices()[:n]), (AXIS,))

    def f(send_idx, recv_idx, x):
        sq = lambda t: jax.tree.map(lambda a: a[0], t)
        comm = ShardedComm(part, sq(send_idx), sq(recv_idx))
        return comm.refresh(sq(x))[None]

    refreshed = np.asarray(
        jax.jit(
            shard_map(
                f,
                mesh=device_mesh,
                in_specs=(P(AXIS), P(AXIS), P(AXIS)),
                out_specs=P(AXIS),
                check_vma=False,
            )
        )(part.send_idx, part.recv_idx, local.p)
    )
    og = np.asarray(part.owned_global)
    om = np.asarray(part.owned_mask)
    C = mesh.n_cells
    checked = 0
    for p in range(n):
        sl = np.nonzero(om[p])[0]
        w0 = og[p, sl[0]] - sl[0]  # window origin (global id of slot 0)
        for i in range(part.local_size - 1):
            g = w0 + i
            if 0 <= g < C and not om[p, i]:  # in-window ghost slot
                assert refreshed[p, i] == g, (p, i, g, refreshed[p, i])
                checked += 1
    assert checked > 0


def _irregular_case(n=14, seed=5):
    """A randomly permuted (-> RCM-reordered at compile) cavity box:
    no structured offsets, slice plan present (tests/test_reorder.py)."""
    import sys

    sys.path.insert(0, "tests")
    from test_reorder import _random_irregular_mesh

    mesh, table = _random_irregular_mesh(n, seed=seed)
    assert mesh.neighbor_offsets is None and mesh.slice_plan is not None
    return mesh, table


def test_sharded_amg_matches_single_device_irregular():
    """Distributed ALGEBRAIC multigrid on an irregular mesh (fine level
    distributed, Galerkin/restriction psum-assembled from owned rows,
    coarse correction replicated — amg.multigrid_solve_sharded) must
    reproduce the single-device AMG trajectory."""
    mesh, table = _irregular_case()
    mg = NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.MULTIGRID,
            iterations=30,
            multigrid_levels=2,
            multigrid_smoother_iterations=4,
            preconditioner=PreconditionMethod.JACOBI,
        ),
    )
    ref_state, _ = solve_steady(
        mesh, table, mg, 1.0, 0.01,
        state=initial_state(mesh), iterations=15,
        reporting_interval=15, verbose=False,
    )
    sh_state, _ = solve_steady_sharded(
        mesh, table, mg, 1.0, 0.01,
        state=initial_state(mesh), iterations=15,
        reporting_interval=15, n_devices=4, verbose=False,
        partition_method="rcb", use_ck=False,
    )
    np.testing.assert_allclose(
        np.asarray(sh_state.vel), np.asarray(ref_state.vel),
        rtol=1e-8, atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(sh_state.p), np.asarray(ref_state.p),
        rtol=1e-8, atol=1e-12,
    )


def test_sharded_3x3_cube_matches_single_device(reference_mesh_dir):
    """The reference's own mixed-cell TGRID mesh (3x3_cube.msh),
    RCB-partitioned and solved sharded, must match the single-device
    run — the distributed tier on the reference's mesh class."""
    import os

    from orc_cfd.mesh import read_mesh

    mesh, table = read_mesh(os.path.join(reference_mesh_dir, "3x3_cube.msh"))
    table.set("INLET", FaceCondition.PRESSURE_INLET, scalar_value=1.0)
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("PERIODIC_-Z", FaceCondition.WALL)
    table.set("PERIODIC_+Z", FaceCondition.WALL)
    ref_state, _ = solve_steady(
        mesh, table, SETTINGS, 1.0, 0.01,
        state=initial_state(mesh), iterations=25,
        reporting_interval=25, verbose=False,
    )
    sh_state, _ = solve_steady_sharded(
        mesh, table, SETTINGS, 1.0, 0.01,
        state=initial_state(mesh), iterations=25,
        reporting_interval=25, n_devices=4, verbose=False,
        partition_method="rcb", use_ck=False,
    )
    np.testing.assert_allclose(
        np.asarray(sh_state.vel), np.asarray(ref_state.vel),
        rtol=1e-8, atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(sh_state.p), np.asarray(ref_state.p),
        rtol=1e-8, atol=1e-12,
    )
