"""Algebraic multigrid with a host-built, device-executed hierarchy.

The reference rebuilds its restriction matrix and Galerkin product
R A R^T from scratch on every solve call (linear_algebra.rs:80-84) —
wasted work, since the sparsity never changes. Here the expensive,
irregular part (greedy pairwise aggregation + coarse-sparsity
construction) runs ONCE on host per mesh, producing static index maps;
per solve, the device only:

- restricts residuals   (segment-sum over the aggregation map),
- computes coarse-level *values* via one precomputed scatter
  (`galerkin_values` — every fine ELL entry knows its flat coarse slot),
- smooths with BiCGSTAB (+ Jacobi row scaling) at each level,
- prolongs corrections  (a gather).

All shapes are static per level, so the whole V-cycle compiles into the
jitted SIMPLE step. Aggregation strategies mirror the reference's
RestrictionMethods (lib.rs:197-201): Injection pairs consecutive cells;
Strongest pairs each cell with its most negatively-coupled unmerged
neighbor (linear_algebra.rs:12-63) — done as a proper disjoint pairwise
aggregation here.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from orc_cfd.ops.spmv import EllMatrix
from orc_cfd.solver.krylov import SolveInfo, bicgstab_solve, _identity_sum, _norm
from orc_cfd.utils.settings import (
    MatrixSolverSettings,
    RestrictionMethod,
    SolutionMethod,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MgLevel:
    agg: jax.Array  # [n_fine] i32 fine -> coarse cell
    diag_target: jax.Array  # [n_fine] i32 flat coarse slot of fine diag
    off_target: jax.Array  # [n_fine*K_f] i32 flat coarse slot of fine offs
    coarse_neighbors: jax.Array  # [n_coarse, K_c] i32
    n_coarse: int = dataclasses.field(metadata=dict(static=True))
    k_coarse: int = dataclasses.field(metadata=dict(static=True))
    # Slice plan for the coarse matrix (mesh/reorder.py): pairwise
    # aggregation of RCM-ordered fine cells keeps the coarse adjacency
    # bandwidth ~half the fine one, so every coarse level's smoother
    # rides the gather-free slice SpMV too.
    plan: "object | None" = None


def _aggregate(
    diag: np.ndarray,
    off: np.ndarray,
    neighbors: np.ndarray,
    method: RestrictionMethod,
) -> np.ndarray:
    """Greedy pairwise aggregation -> agg[n] coarse ids (0..n_c-1)."""
    n, K = off.shape
    agg = np.full(n, -1, dtype=np.int64)
    nc = 0
    if method == RestrictionMethod.INJECTION:
        for i in range(n):
            if agg[i] >= 0:
                continue
            agg[i] = nc
            if i + 1 < n:
                agg[i + 1] = nc
            nc += 1
        return agg
    # Strongest: pair with the most negative off-diagonal neighbor.
    for i in range(n):
        if agg[i] >= 0:
            continue
        best = -1
        best_val = 0.0
        for k in range(K):
            j = neighbors[i, k]
            if j == i or agg[j] >= 0:
                continue
            v = off[i, k]
            if v < best_val:
                best_val = v
                best = j
        agg[i] = nc
        if best >= 0:
            agg[best] = nc
        nc += 1
    return agg


def _coarse_structure(
    agg: np.ndarray, neighbors: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Build the coarse ELL sparsity and flat scatter targets.

    Returns (coarse_neighbors [n_c,K_c], diag_target [n_f],
    off_target [n_f*K_f], K_c). Flat coarse layout: row I occupies
    slots [I*(K_c+1), (I+1)*(K_c+1)): slot 0 = diag, 1+k = off k.
    """
    n_f, K_f = neighbors.shape
    n_c = int(agg.max()) + 1
    # Coarse adjacency sets.
    adj = [set() for _ in range(n_c)]
    for i in range(n_f):
        I = agg[i]
        for k in range(K_f):
            J = agg[neighbors[i, k]]
            if J != I:
                adj[I].add(J)
    K_c = max(1, max(len(s) for s in adj))
    coarse_neighbors = np.tile(np.arange(n_c)[:, None], (1, K_c))
    slot_of = {}
    for I in range(n_c):
        for s, J in enumerate(sorted(adj[I])):
            coarse_neighbors[I, s] = J
            slot_of[(I, J)] = s

    stride = K_c + 1
    diag_target = agg * stride
    off_target = np.empty(n_f * K_f, dtype=np.int64)
    for i in range(n_f):
        I = agg[i]
        for k in range(K_f):
            j = neighbors[i, k]
            J = agg[j]
            if J == I:
                t = I * stride  # folds into the coarse diagonal
            else:
                t = I * stride + 1 + slot_of[(I, J)]
            off_target[i * K_f + k] = t
    return coarse_neighbors, diag_target, off_target, K_c


def build_hierarchy(
    mesh,
    diff,
    solver: MatrixSolverSettings,
) -> List[MgLevel]:
    """Build the static AMG hierarchy from the (fixed) diffusion-matrix
    values as the coupling-strength representative."""
    return build_hierarchy_from_matrix(
        np.asarray(diff.diag),
        np.asarray(diff.off),
        np.asarray(mesh.cell_neighbors),
        solver,
    )


def build_hierarchy_from_matrix(
    diag: np.ndarray,
    off: np.ndarray,
    neighbors: np.ndarray,
    solver: MatrixSolverSettings,
) -> List[MgLevel]:
    diag = np.asarray(diag, dtype=np.float64)
    off = np.asarray(off, dtype=np.float64)
    neighbors = np.asarray(neighbors, dtype=np.int64)
    levels: List[MgLevel] = []
    for _ in range(solver.multigrid_levels):
        n = diag.shape[0]
        if n <= solver.multigrid_coarsest_size:
            break
        agg = _aggregate(diag, off, neighbors, solver.multigrid_restriction)
        coarse_neighbors, diag_t, off_t, K_c = _coarse_structure(agg, neighbors)
        n_c = int(agg.max()) + 1
        from orc_cfd.mesh.reorder import build_slice_plan

        plan = build_slice_plan(
            coarse_neighbors,
            coarse_neighbors != np.arange(n_c)[:, None],
        )
        levels.append(
            MgLevel(
                agg=jnp.asarray(agg, jnp.int32),
                diag_target=jnp.asarray(diag_t, jnp.int32),
                off_target=jnp.asarray(off_t, jnp.int32),
                coarse_neighbors=jnp.asarray(coarse_neighbors, jnp.int32),
                n_coarse=n_c,
                k_coarse=K_c,
                plan=plan,
            )
        )
        # Host-side Galerkin of the representative matrix for the next
        # level's aggregation decisions.
        stride = K_c + 1
        flat = np.zeros(n_c * stride)
        np.add.at(flat, diag_t, diag)
        np.add.at(flat, off_t, off.reshape(-1))
        flat = flat.reshape(n_c, stride)
        diag, off, neighbors = flat[:, 0], flat[:, 1:], coarse_neighbors
    return levels


def galerkin_values(A: EllMatrix, level: MgLevel):
    """Coarse-level matrix values A_c = R A R^T via one static scatter."""
    stride = level.k_coarse + 1
    vals = jnp.concatenate([A.diag, A.off.reshape(-1)])
    tgt = jnp.concatenate([level.diag_target, level.off_target])
    flat = jax.ops.segment_sum(
        vals, tgt, num_segments=level.n_coarse * stride
    )
    flat = flat.reshape(level.n_coarse, stride)
    return EllMatrix(
        diag=flat[:, 0], off=flat[:, 1:], neighbors=level.coarse_neighbors,
        plan=level.plan,
    )


def _smooth(A, b, x0, settings: MatrixSolverSettings,
            axis_sum=_identity_sum, iterations=None, refresh=None,
            project=None):
    """Per-level smoother: Jacobi-preconditioned BiCGSTAB (the
    reference's MULTIGRID_SMOOTHER, linear_algebra.rs:9). `refresh` is
    the halo-refresh hook for distributed fine-level smoothing;
    `project` the constant-nullspace deflation hook for singular
    (unanchored) pressure systems (krylov.constant_deflation)."""
    from orc_cfd.solver.krylov import _no_project, _no_refresh

    if (refresh is None or refresh is _no_refresh) and A.plan is not None:
        A = A.prepare()  # gather-free slice SpMV for the whole smooth
    if A.offsets is not None:
        # Pre-slice the off-diagonal columns outside the smoother's
        # while loop (see EllMatrix.split_columns) — the multigrid
        # cycle keeps the array form for Galerkin coarse construction,
        # so the split happens per smooth rather than per solve.
        A = A.split_columns()
    Ap, inv_d = A.jacobi_preconditioned()
    x, info = bicgstab_solve(
        Ap,
        b * inv_d,
        x0,
        iterations
        if iterations is not None
        else (settings.multigrid_smoother_iterations or settings.iterations),
        axis_sum,
        convergence_threshold=settings.relative_convergence_threshold,
        refresh=refresh if refresh is not None else _no_refresh,
        compensated=settings.compensated_f32,
        project=project if project is not None else _no_project,
    )
    return x, info


def _coarse_project(null_scale):
    """Plain-mean constant deflation for the (replicated, all-active)
    coarse levels of a V-cycle; identity when no deflation was
    requested. The coarse null vector IS the constant: the Galerkin
    product with summing restriction / piecewise-constant prolongation
    gives A_c 1_c = R A P 1_c = R A 1_f = 0."""
    if null_scale is None:
        return None
    from orc_cfd.solver.krylov import constant_deflation

    return constant_deflation(null_scale)


def multigrid_solve(
    A: EllMatrix,
    b,
    x0,
    settings: MatrixSolverSettings,
    hierarchy: List[MgLevel],
    axis_sum=_identity_sum,
    project=None,
    null_scale=None,
):
    """V-ish cycle mirroring the reference's structure
    (linear_algebra.rs:65-141,270-296): smooth on the fine grid, then
    add the recursively-computed coarse-grid correction, post-smoothing
    on the way up."""
    x, info0 = _smooth(A, b, x0, settings, axis_sum, project=project)
    if hierarchy:
        r = b - A.matvec(x)
        x = x + _mg_correction(
            A, r, 0, settings, hierarchy, axis_sum,
            project=_coarse_project(null_scale),
        )
    rn = _norm(b - A.matvec(x), axis_sum)
    diverged = jnp.isnan(rn) | (jnp.max(jnp.abs(x)) > 1e10)
    return x, SolveInfo(
        iterations=info0.iterations, residual=rn, diverged=diverged
    )


def multigrid_solve_sharded(
    A: EllMatrix,
    b,
    x0,
    settings: MatrixSolverSettings,
    hierarchy: List[MgLevel],
    axis_sum,
    refresh,
    owned_mask,
    owned_global,
    project=None,
    null_scale=None,
):
    """Distributed AMG V-cycle (counterpart of gmg.gmg_solve_sharded):
    fine-level smoothing runs distributed through the halo-refresh /
    psum hooks; the level-0 Galerkin product and coarse residual are
    assembled from each device's OWNED rows and psum'ed, after which
    every device carries the identical (small) coarse problem and the
    correction is computed replicated — no collectives below level 0.

    The flat coarse slot of each local matrix entry is derived on
    device from the global aggregation map: local row i (global id g)
    scatters its diagonal to agg[g]*stride, and its k-th off-diagonal
    (local neighbor slot -> global id g_nb) to the coarse column slot
    of (agg[g], agg[g_nb]) found in `coarse_neighbors` — intra-
    aggregate entries fold into the coarse diagonal, exactly like the
    host-side _coarse_structure.
    """
    from orc_cfd.ops.layout import take
    from orc_cfd.solver.krylov import _mv

    x, info0 = _smooth(
        A, b, x0, settings, axis_sum, refresh=refresh, project=project
    )
    cproject = _coarse_project(null_scale)
    if hierarchy:
        level = hierarchy[0]
        if A.neighbors is None:
            raise ValueError("sharded AMG needs the local neighbor table")
        r = b - _mv(A, x, refresh)
        stride = level.k_coarse + 1
        n_c = level.n_coarse
        g = owned_global.astype(jnp.int32)
        I = take(level.agg, g)  # [L] coarse id of each local row
        g_nb = take(g, A.neighbors)  # [L,K] global id of local neighbors
        J = take(level.agg, g_nb)  # [L,K] coarse id across each entry
        # Column slot of J in coarse row I (K_c-way compare-select).
        crow = take(level.coarse_neighbors, I)  # [L,K_c]
        matches = crow[:, None, :] == J[:, :, None]  # [L,K,K_c]
        slot = jnp.argmax(matches, axis=-1).astype(jnp.int32)  # [L,K]
        tgt = jnp.where(
            J == I[:, None],
            (I * stride)[:, None],  # folds into the coarse diagonal
            I[:, None] * stride + 1 + slot,
        )
        zero = jnp.zeros((), A.diag.dtype)
        o = owned_mask
        flat = jnp.zeros((n_c * stride,), A.diag.dtype)
        flat = flat.at[I * stride].add(jnp.where(o, A.diag, zero))
        flat = flat.at[tgt.reshape(-1)].add(
            jnp.where(o[:, None], A.off, zero).reshape(-1)
        )
        r_c = jnp.zeros((n_c,), r.dtype).at[I].add(jnp.where(o, r, zero))
        flat = axis_sum(flat)
        r_c = axis_sum(r_c)
        flat = flat.reshape(n_c, stride)
        cdiag = jnp.where(flat[:, 0] == 0.0, 1.0, flat[:, 0])
        A_c = EllMatrix(
            diag=cdiag,
            off=flat[:, 1:],
            neighbors=level.coarse_neighbors,
            plan=level.plan,
        )
        # Replicated coarse correction (identical on every device).
        e_c, _ = _smooth(
            A_c,
            r_c,
            jnp.zeros_like(r_c),
            settings,
            iterations=settings.iterations
            if len(hierarchy) == 1
            else None,
            project=cproject,
        )
        if len(hierarchy) > 1:
            # Same cycle as the single-device _mg_correction: recurse on
            # the restricted residual, then post-smooth at this level.
            e_c = e_c + _mg_correction(
                A_c, r_c, 1, settings, hierarchy, _identity_sum,
                project=cproject,
            )
            e_c, _ = _smooth(A_c, r_c, e_c, settings, project=cproject)
        x = x + jnp.where(owned_mask, take(e_c, I), 0.0)
    rn = _norm(b - _mv(A, x, refresh), axis_sum)
    diverged = jnp.isnan(rn) | (jnp.max(jnp.abs(x)) > 1e10)
    return x, SolveInfo(
        iterations=info0.iterations, residual=rn, diverged=diverged
    )


def _mg_correction(A_f, r, level_idx, settings, hierarchy, axis_sum,
                   project=None):
    level = hierarchy[level_idx]
    r_c = jax.ops.segment_sum(r, level.agg, num_segments=level.n_coarse)
    A_c = galerkin_values(A_f, level)
    # Coarsest level: solve accurately (it's tiny); intermediate levels
    # take smoother sweeps only.
    coarsest = level_idx + 1 == len(hierarchy)
    e_c, _ = _smooth(
        A_c, r_c, jnp.zeros_like(r_c), settings, axis_sum,
        iterations=settings.iterations if coarsest else None,
        project=project,
    )
    if not coarsest:
        e_c = e_c + _mg_correction(
            A_c, r_c, level_idx + 1, settings, hierarchy, axis_sum,
            project=project,
        )
        e_c, _ = _smooth(A_c, r_c, e_c, settings, axis_sum, project=project)
    return e_c[level.agg]
