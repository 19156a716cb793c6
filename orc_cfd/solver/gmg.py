"""Structured geometric multigrid (GMG) — the shift-friendly multigrid.

The reference's multigrid rebuilds a CSR restriction matrix and the
Galerkin product R A R^T on every solve (linear_algebra.rs:65-141); the
round-1 AMG port kept that math but paid for it with `segment_sum`
scatters per solve and gather-SpMV smoothing on irregular coarse
levels. On a structured box
mesh none of that irregularity exists:

- coarsening is 2x per axis (block aggregation), so *every* level is
  itself a structured box: the smoother's SpMV stays on the circular-
  shift fast path at all levels;
- restriction/prolongation are reshape block-sums / broadcasts — pure
  data movement XLA fuses into the surrounding arithmetic;
- the Galerkin coarse matrix is computed per solve from the fine ELL
  coefficient arrays with static parity masks (in-block entries fold
  into the coarse diagonal, cross-block entries into the matching
  coarse offset column) — elementwise math + block-sums, no scatter.

The hierarchy is ALL-STATIC (a tuple of hashable dataclasses with no
array leaves): levels pass through `jit` as empty pytrees and the
whole V-cycle compiles into the SIMPLE step.

Supports periodic wrap offsets (x/y/z), odd extents (zero-padded
blocks), and non-coarsenable axes (block size 1). Falls back to the
algebraic hierarchy (`solver/amg.py`) for meshes whose offsets don't
match a structured box.

Smoothing follows the reference's choice of Jacobi-preconditioned
BiCGSTAB sweeps per level (linear_algebra.rs:9, MULTIGRID_SMOOTHER).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from orc_cfd.ops.spmv import EllMatrix
from orc_cfd.solver.krylov import SolveInfo, _identity_sum, _norm
from orc_cfd.utils.settings import MatrixSolverSettings


def infer_box_dims(
    offsets: Tuple[int, ...], n_cells: int
) -> Optional[Tuple[int, int, int]]:
    """Recover (nx, ny, nz) of a structured box from its neighbor
    offsets (cell id = ix + nx*(iy + ny*iz)).

    Interior steps contribute +/-{1, nx, nx*ny}; periodic wraps
    contribute -/+{nx-1, nx*(ny-1), nx*ny*(nz-1)}. Returns None when no
    consistent box exists (irregular mesh).
    """
    pos = sorted({abs(int(d)) for d in offsets if d != 0})
    if not pos:
        return None
    # Candidate nx values: every offset magnitude o could be nx (step)
    # or o+1 could be nx (wrap nx-1); nx=1 covers 1-cell-wide axes.
    cands_x = {1}
    for o in pos:
        cands_x.add(o)
        cands_x.add(o + 1)
    for nx in sorted(cands_x):
        if nx < 1 or n_cells % nx:
            continue
        rest = n_cells // nx
        cands_y = {1}
        for o in pos:
            if o % nx == 0:
                cands_y.add(o // nx)
                cands_y.add(o // nx + 1)
        for ny in sorted(cands_y):
            if ny < 1 or rest % ny:
                continue
            nz = rest // ny
            allowed = {1, nx, nx * ny} | {
                nx - 1,
                nx * (ny - 1),
                nx * ny * (nz - 1),
            }
            allowed.discard(0)
            if set(pos) <= allowed:
                return (nx, ny, nz)
    return None


def _classify_columns(offsets, dims):
    """Per ELL column: None (padding) or (axis, direction, wrap)."""
    nx, ny, nz = dims
    table = {}
    for axis, (step, n_ax) in enumerate(
        ((1, nx), (nx, ny), (nx * ny, nz))
    ):
        if n_ax <= 1:
            continue
        table[step] = (axis, +1, False)
        table[-step] = (axis, -1, False)
        wrap = step * (n_ax - 1)
        # +direction wrap: last cell -> first = NEGATIVE flat delta.
        table.setdefault(-wrap, (axis, +1, True))
        table.setdefault(wrap, (axis, -1, True))
    out = []
    for d in offsets:
        out.append(table.get(int(d)))
        if int(d) != 0 and table.get(int(d)) is None:
            return None  # unclassifiable offset: not a plain box
    return tuple(out)


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class GmgLevel:
    """Static description of one fine->coarse transfer. Hashable, no
    array members: registered static, so a hierarchy tuple flows
    through jit arguments as an empty pytree (a compile-time
    constant)."""

    dims: Tuple[int, int, int]  # fine (nx, ny, nz)
    cdims: Tuple[int, int, int]  # coarse
    block: Tuple[int, int, int]  # 1 or 2 per axis
    pdims: Tuple[int, int, int]  # fine padded to block*cdims
    fine_offsets: Tuple[int, ...]  # fine ELL column offsets
    col_info: Tuple  # per fine column: None | (axis, dir, wrap)
    coarse_offsets: Tuple[int, ...]  # coarse ELL column offsets
    # per fine column: index into coarse_offsets, -1 = coarse diagonal,
    # -2 = padding column (zero coefficients, skipped)
    coarse_col_of: Tuple[int, ...]

    @property
    def n_coarse(self) -> int:
        cx, cy, cz = self.cdims
        return cx * cy * cz


def _coarse_delta(axis, direction, wrap, cdims):
    nx, ny, _ = cdims
    stride = (1, nx, nx * ny)[axis]
    n_ax = cdims[axis]
    if wrap:
        if n_ax == 1:
            return 0  # folds into the coarse diagonal
        return -direction * stride * (n_ax - 1)
    if n_ax == 1:
        return 0
    return direction * stride


def build_level(dims, offsets) -> Optional[GmgLevel]:
    col_info = _classify_columns(offsets, dims)
    if col_info is None:
        return None
    wraps = [False, False, False]
    for info in col_info:
        if info is not None and info[2]:
            wraps[info[0]] = True
    block = []
    for axis, n_ax in enumerate(dims):
        if n_ax < 2:
            block.append(1)
        elif wraps[axis] and n_ax % 2:
            # Odd periodic axis: zero-padding would break the wrap
            # adjacency; leave the axis uncoarsened.
            block.append(1)
        else:
            block.append(2)
    if all(b == 1 for b in block):
        return None
    cdims = tuple(-(-n // b) for n, b in zip(dims, block))
    pdims = tuple(c * b for c, b in zip(cdims, block))

    coarse_offsets: List[int] = []
    coarse_col_of: List[int] = []
    for k, info in enumerate(col_info):
        if info is None:
            coarse_col_of.append(-2)
            continue
        delta = _coarse_delta(*info, cdims)
        if delta == 0:
            coarse_col_of.append(-1)
            continue
        if delta not in coarse_offsets:
            coarse_offsets.append(delta)
        coarse_col_of.append(coarse_offsets.index(delta))
        # A cross-block portion of a non-wrap column also exists when
        # block=2 (handled by masks); block=1 columns are all-cross.
    return GmgLevel(
        dims=tuple(dims),
        cdims=cdims,
        block=tuple(block),
        pdims=pdims,
        fine_offsets=tuple(int(d) for d in offsets),
        col_info=col_info,
        coarse_offsets=tuple(coarse_offsets),
        coarse_col_of=tuple(coarse_col_of),
    )


def build_gmg_hierarchy(
    dims: Tuple[int, int, int],
    offsets: Tuple[int, ...],
    solver: MatrixSolverSettings,
) -> Optional[Tuple[GmgLevel, ...]]:
    """Static level stack down to `multigrid_coarsest_size` cells (or
    `multigrid_levels`, whichever limit hits first)."""
    levels: List[GmgLevel] = []
    cur_dims, cur_offsets = tuple(dims), tuple(offsets)
    for _ in range(solver.multigrid_levels):
        n = cur_dims[0] * cur_dims[1] * cur_dims[2]
        if n <= solver.multigrid_coarsest_size:
            break
        lvl = build_level(cur_dims, cur_offsets)
        if lvl is None:
            break
        levels.append(lvl)
        cur_dims = lvl.cdims
        cur_offsets = lvl.coarse_offsets
    return tuple(levels) if levels else None


def build_mg_hierarchy(mesh, diff, settings):
    """Hierarchy auto-selection for `SolutionMethod.MULTIGRID`:
    geometric (this module) when the mesh's neighbor offsets describe a
    structured box, algebraic (`solver/amg.py`) otherwise."""
    if mesh.neighbor_offsets is not None:
        dims = infer_box_dims(mesh.neighbor_offsets, mesh.n_cells)
        if dims is not None:
            h = build_gmg_hierarchy(
                dims, mesh.neighbor_offsets, settings.matrix_solver
            )
            if h:
                return h
    from orc_cfd.solver.amg import build_hierarchy

    return build_hierarchy(mesh, diff, settings.matrix_solver)


# --- per-level transfer ops (pure reshapes; [C]-shaped vectors) -------


def _grid(x, dims):
    nx, ny, nz = dims
    return x.reshape(nz, ny, nx)


def _pad(a, dims, pdims):
    if dims == pdims:
        return a
    return jnp.pad(
        a,
        (
            (0, pdims[2] - dims[2]),
            (0, pdims[1] - dims[1]),
            (0, pdims[0] - dims[0]),
        ),
    )


def restrict(r, level: GmgLevel):
    """Aggregate fine cells into their 2x2x2 (or smaller) blocks."""
    bx, by, bz = level.block
    cx, cy, cz = level.cdims
    a = _pad(_grid(r, level.dims), level.dims, level.pdims)
    return a.reshape(cz, bz, cy, by, cx, bx).sum(axis=(1, 3, 5)).reshape(-1)


def prolong(e, level: GmgLevel):
    """Piecewise-constant interpolation back to the fine grid."""
    bx, by, bz = level.block
    cx, cy, cz = level.cdims
    nx, ny, nz = level.dims
    a = e.reshape(cz, cy, cx)
    a = jnp.broadcast_to(
        a[:, None, :, None, :, None], (cz, bz, cy, by, cx, bx)
    ).reshape(cz * bz, cy * by, cx * bx)
    return a[:nz, :ny, :nx].reshape(-1)


def _cross_mask(level: GmgLevel, axis: int, direction: int, dtype):
    """1.0 where a (non-wrap) step along `axis` leaves the cell's
    block: the high cell of each 2-block for +steps, the low cell for
    -steps. Computed from iota (static shapes), so it costs nothing."""
    nx, ny, nz = level.dims
    dim_idx = {0: 2, 1: 1, 2: 0}[axis]  # [nz, ny, nx] layout
    idx = lax.broadcasted_iota(jnp.int32, (nz, ny, nx), dim_idx)
    par = idx % 2
    cross = par == (1 if direction > 0 else 0)
    return cross.reshape(-1).astype(dtype)


def galerkin(A: EllMatrix, level: GmgLevel) -> EllMatrix:
    """Coarse matrix A_c = R A P for R = block sum, P = block copy:
    A_c[I,J] = sum over fine entries crossing (or staying inside)
    block boundaries — per-column masked block-sums, no scatter."""
    cdiag = restrict(A.diag, level)
    coff = [None] * len(level.coarse_offsets)

    def acc(slot, v):
        coff[slot] = v if coff[slot] is None else coff[slot] + v

    for k, info in enumerate(level.col_info):
        tgt = level.coarse_col_of[k]
        if tgt == -2:
            continue  # structurally-zero padding column
        coeff = A.off[..., k]
        axis, direction, wrap = info
        if tgt == -1:
            cdiag = cdiag + restrict(coeff, level)
            continue
        if wrap or level.block[axis] == 1:
            acc(tgt, restrict(coeff, level))
            continue
        cross = _cross_mask(level, axis, direction, coeff.dtype)
        acc(tgt, restrict(coeff * cross, level))
        cdiag = cdiag + restrict(coeff * (1.0 - cross), level)

    n_c = level.n_coarse
    cols = [
        c if c is not None else jnp.zeros((n_c,), A.diag.dtype)
        for c in coff
    ]
    # Blocks that are entirely padding get identity rows (their
    # restricted residual is 0, so the correction stays 0).
    cdiag = jnp.where(cdiag == 0.0, 1.0, cdiag)
    return EllMatrix(
        diag=cdiag,
        off=jnp.stack(cols, axis=-1)
        if cols
        else jnp.zeros((n_c, 0), A.diag.dtype),
        neighbors=None,  # shift path only — never gathered
        offsets=level.coarse_offsets,
    )


def gmg_solve(
    A: EllMatrix,
    b,
    x0,
    settings: MatrixSolverSettings,
    hierarchy: Tuple[GmgLevel, ...],
    axis_sum=_identity_sum,
    project=None,
    null_scale=None,
):
    """One V-cycle with BiCGSTAB smoothing, mirroring the reference's
    multigrid iteration structure (linear_algebra.rs:65-141): smooth,
    coarse-grid correction (recursive), post-smooth on the way up.
    Coarse matrices are re-Galerkined per call (coefficients change
    every outer iteration; the transfer structure does not).

    `project`/`null_scale`: constant-nullspace deflation for singular
    (unanchored) pressure systems — see krylov.constant_deflation."""
    from orc_cfd.solver.amg import _coarse_project, _smooth

    x, info0 = _smooth(A, b, x0, settings, axis_sum, project=project)
    if hierarchy:
        r = b - A.matvec(x)
        x = x + _gmg_correction(
            A, r, 0, settings, hierarchy, axis_sum,
            project=_coarse_project(null_scale),
        )
        x, _ = _smooth(A, b, x, settings, axis_sum, project=project)
    rn = _norm(b - A.matvec(x), axis_sum)
    diverged = jnp.isnan(rn) | (jnp.max(jnp.abs(x)) > 1e10)
    return x, SolveInfo(
        iterations=info0.iterations, residual=rn, diverged=diverged
    )


def _gmg_correction(A_f, r, idx, settings, hierarchy, axis_sum,
                    project=None):
    from orc_cfd.solver.amg import _smooth

    level = hierarchy[idx]
    r_c = restrict(r, level)
    A_c = galerkin(A_f, level)
    coarsest = idx + 1 == len(hierarchy)
    e_c, _ = _smooth(
        A_c,
        r_c,
        jnp.zeros_like(r_c),
        settings,
        axis_sum,
        iterations=settings.iterations if coarsest else None,
        project=project,
    )
    if not coarsest:
        rr = r_c - A_c.matvec(e_c)
        e_c = e_c + _gmg_correction(
            A_c, rr, idx + 1, settings, hierarchy, axis_sum,
            project=project,
        )
        e_c, _ = _smooth(A_c, r_c, e_c, settings, axis_sum, project=project)
    return prolong(e_c, level)


# --- distributed V-cycle (shard_map) ----------------------------------
#
# Fine-level smoothing runs distributed (ppermute halo refresh + psum
# dot products, exactly like the other sharded solvers). The coarse
# correction runs REPLICATED: each device scatter-adds its OWNED rows'
# contributions to the global coarse residual and the global coarse
# Galerkin matrix, one psum makes both replicated, and every device
# then computes the identical coarse correction with the single-device
# machinery — same math as the single-device V-cycle (equivalence is
# pinned by tests/test_gmg.py), with two [C_coarse]-sized collectives
# per V-cycle riding the ICI. Coarse work is C/4 (2D) or C/8 (3D) of
# the fine grid, so replicating it costs less than distributing it
# would save.


def _coarse_index_of(level: GmgLevel, g):
    """Coarse cell of global fine cell id g (flat block arithmetic)."""
    nx, ny, _ = level.dims
    bx, by, bz = level.block
    cx, cy, _ = level.cdims
    ix = g % nx
    iy = (g // nx) % ny
    iz = g // (nx * ny)
    return (ix // bx) + cx * ((iy // by) + cy * (iz // bz))


def _local_coarse_contrib(A, r, owned_mask, owned_global, level: GmgLevel):
    """(flat coarse-matrix values [n_c*(K_c+1)], coarse residual [n_c])
    from this device's owned fine rows. psum across devices completes
    R A P and R r."""
    nx, ny, _ = level.dims
    g = owned_global.astype(jnp.int32)
    I = _coarse_index_of(level, g)
    stride = len(level.coarse_offsets) + 1
    n_c = level.n_coarse
    zero = jnp.zeros((), A.diag.dtype)

    r_c = jnp.zeros((n_c,), r.dtype).at[I].add(
        jnp.where(owned_mask, r, zero)
    )
    flat = jnp.zeros((n_c * stride,), A.diag.dtype)
    flat = flat.at[I * stride].add(jnp.where(owned_mask, A.diag, zero))
    for k, info in enumerate(level.col_info):
        tgt = level.coarse_col_of[k]
        if tgt == -2:
            continue
        coeff = jnp.where(owned_mask, A.off[..., k], zero)
        if tgt == -1:
            flat = flat.at[I * stride].add(coeff)
            continue
        axis, direction, wrap = info
        if wrap or level.block[axis] == 1:
            flat = flat.at[I * stride + 1 + tgt].add(coeff)
            continue
        idx_ax = (g % nx, (g // nx) % ny, g // (nx * ny))[axis]
        cross = (idx_ax % 2) == (1 if direction > 0 else 0)
        target = jnp.where(cross, I * stride + 1 + tgt, I * stride)
        flat = flat.at[target].add(coeff)
    return flat, r_c


def gmg_solve_sharded(
    A,
    b,
    x0,
    settings: MatrixSolverSettings,
    hierarchy: Tuple[GmgLevel, ...],
    axis_sum,
    refresh,
    owned_mask,
    owned_global,
    project=None,
    null_scale=None,
):
    """Distributed V-cycle: smooth locally, correct globally-replicated
    (see module comment above)."""
    from orc_cfd.solver.amg import _coarse_project, _smooth
    from orc_cfd.solver.krylov import _mv

    x, info0 = _smooth(
        A, b, x0, settings, axis_sum, refresh=refresh, project=project
    )
    cproject = _coarse_project(null_scale)
    if hierarchy:
        level = hierarchy[0]
        r = b - _mv(A, x, refresh)
        flat, r_c = _local_coarse_contrib(
            A, r, owned_mask, owned_global, level
        )
        flat = axis_sum(flat)
        r_c = axis_sum(r_c)
        stride = len(level.coarse_offsets) + 1
        flat = flat.reshape(level.n_coarse, stride)
        cdiag = jnp.where(flat[:, 0] == 0.0, 1.0, flat[:, 0])
        A_c = EllMatrix(
            diag=cdiag,
            off=flat[:, 1:],
            neighbors=None,
            offsets=level.coarse_offsets,
        )
        # Replicated coarse correction (every device computes the same
        # thing; no collectives below this point).
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
            rr = r_c - A_c.matvec(e_c)
            e_c = e_c + _gmg_correction(
                A_c, rr, 1, settings, hierarchy, _identity_sum,
                project=cproject,
            )
            e_c, _ = _smooth(A_c, r_c, e_c, settings, project=cproject)
        e_f = prolong(e_c, level)  # [C] global, replicated
        from orc_cfd.ops.layout import take

        x = x + jnp.where(
            owned_mask, take(e_f, owned_global.astype(jnp.int32)), 0.0
        )
        x, _ = _smooth(
            A, b, x, settings, axis_sum, refresh=refresh, project=project
        )
    rn = _norm(b - _mv(A, x, refresh), axis_sum)
    diverged = jnp.isnan(rn) | (jnp.max(jnp.abs(x)) > 1e10)
    return x, SolveInfo(
        iterations=info0.iterations, residual=rn, diverged=diverged
    )
