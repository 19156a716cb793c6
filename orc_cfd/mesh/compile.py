"""Mesh compiler: RawMesh -> padded SoA device arrays.

This is the fixed-width replacement for the reference's pointer-based
`Mesh` (reference: mesh.rs:127-214): every variable-length adjacency list
becomes a fixed-width, padded, masked index array so that all downstream
assembly is vectorized gathers + elementwise math + masked reductions —
no HashMaps, no per-entry mutation, fully static shapes.

Layout:

- Face-major arrays ``[F]``/``[F,3]``: owner/neighbor cell ids, area,
  unit outward (w.r.t. owner) normal, centroid, BC-zone slot, and
  precomputed interpolation helpers.
- Cell-major ELL arrays ``[C,K]`` (K = max faces/cell): face ids,
  validity mask, owner-sign, and the neighbor cell across each face
  (self-index for boundary/padded slots so gathers stay in-bounds).

The ``[C,K]`` neighbor table doubles as the fixed sparsity pattern of
every linear system the solver assembles (diagonal + K off-diagonals),
i.e. the ELL sparse-matrix structure the SpMV kernels consume.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from orc_cfd.mesh.geometry import Geometry, derive_geometry
from orc_cfd.mesh.tgrid import RawMesh
from orc_cfd.mesh.zones import BoundaryTable


@dataclasses.dataclass
class _Geo:
    """Minimal geometry bundle for compile_from_arrays."""

    face_area: np.ndarray
    face_normal: np.ndarray
    face_centroid: np.ndarray
    cell_centroid: np.ndarray
    cell_volume: np.ndarray


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CompiledMesh:
    # --- face-major ---
    face_owner: jax.Array  # [F] i32
    face_neighbor: jax.Array  # [F] i32 (self-index at boundaries)
    face_interior: jax.Array  # [F] bool
    face_area: jax.Array  # [F]
    face_normal: jax.Array  # [F,3] unit, outward from owner
    face_centroid: jax.Array  # [F,3]
    face_zone_slot: jax.Array  # [F] i32 into BoundaryTable arrays
    face_lw: jax.Array  # [F] linear-weighted interp weight
    face_r_on: jax.Array  # [F,3] owner->neighbor (boundary: owner->face)
    face_dist_on: jax.Array  # [F] |face_r_on|
    face_dist_fo: jax.Array  # [F] |face centroid - owner centroid|
    # --- cell-major ---
    cell_centroid: jax.Array  # [C,3]
    cell_volume: jax.Array  # [C]
    cell_faces: jax.Array  # [C,K] i32 (0 at padded slots)
    cell_face_mask: jax.Array  # [C,K] bool
    cell_face_sign: jax.Array  # [C,K] +1 owner / -1 neighbor (0 padded)
    cell_neighbors: jax.Array  # [C,K] i32 (self at boundary/padded slots)
    # --- static metadata ---
    dim: int = dataclasses.field(metadata=dict(static=True))
    # Constant per-column neighbor index deltas when the adjacency is
    # structured (see EllMatrix.offsets); None for irregular meshes.
    neighbor_offsets: tuple | None = dataclasses.field(
        default=None, metadata=dict(static=True)
    )
    # Per-ELL-column geometry constants for UNIFORM structured boxes
    # (set by mesh.generate._structured_compile): a tuple of K entries
    # (area, n_out(3), dist_fo, dist_on_int, zone_slot_boundary), all
    # plain floats/ints (hashable -> static). When present, the
    # (c,k)-geometry expansion collapses to two boolean masks plus
    # these constants (ops/ck_ops.UniformCKGeometry) — ~20x less
    # static HBM than the expanded arrays.
    ck_constants: tuple | None = dataclasses.field(
        default=None, metadata=dict(static=True)
    )
    # Optional vertex-interpolation tables for node-based Green-Gauss
    # (mesh/nodes.py); built on request since they need the raw
    # face-node topology the compiled mesh otherwise discards.
    nodes: "object | None" = None
    # Irregular-mesh fast path (mesh/reorder.py): RCM cell permutation
    # (cell_order[new_id] = old_id; None when the input order was kept)
    # and the per-tile distinct-delta slice plan consumed by
    # EllMatrix.prepare()/slice_spmv.
    cell_order: jax.Array | None = None
    slice_plan: "object | None" = None

    @property
    def n_cells(self) -> int:
        return self.cell_volume.shape[0]

    @property
    def n_faces(self) -> int:
        return self.face_area.shape[0]

    @property
    def max_faces_per_cell(self) -> int:
        return self.cell_faces.shape[1]

    @property
    def dtype(self):
        return self.cell_volume.dtype


def trim_for_ck(mesh: CompiledMesh) -> CompiledMesh:
    """Copy of the mesh with every array the (c,k)-direct step never
    reads replaced by a 2-element dummy: the face-major tables and the
    [C,K] index/sign tables (the ck step works from CKGeometry + shift
    offsets + cell volume/centroid only). Passing the trimmed mesh to
    the jitted step keeps ~2.2 GB of face arrays (at 16.8M cells f32)
    out of the executable's arguments and lets them be freed.

    Dummies are length 2 — not 1 — so any op that accidentally touches
    a trimmed field fails loudly on a shape mismatch instead of
    broadcasting a [1,...] array against [C,...].
    """
    dt = mesh.dtype
    d1 = jnp.zeros((2,), dt)
    d3 = jnp.zeros((2, 3), dt)
    i1 = jnp.zeros((2,), jnp.int32)
    b1 = jnp.zeros((2,), bool)
    K = mesh.max_faces_per_cell
    return dataclasses.replace(
        mesh,
        face_owner=i1,
        face_neighbor=i1,
        face_interior=b1,
        face_area=d1,
        face_normal=d3,
        face_centroid=d3,
        face_zone_slot=i1,
        face_lw=d1,
        face_r_on=d3,
        face_dist_on=d1,
        face_dist_fo=d1,
        cell_faces=jnp.zeros((2, K), jnp.int32),
        cell_face_sign=jnp.zeros((2, K), dt),
        cell_neighbors=jnp.zeros((2, K), jnp.int32),
        nodes=None,
    )


def compile_mesh(raw: RawMesh, dtype=jnp.float64, nodes: bool = False):
    """Compile a parsed mesh into (CompiledMesh, BoundaryTable).

    `nodes=True` additionally builds the vertex-interpolation tables
    required by node-based Green-Gauss gradients (mesh/nodes.py).

    Translational-periodic pairs (RawMesh.periodic_pairs, TGRID `(18`
    sections) are merged here: each (face, shadow) pair becomes ONE
    interior face connecting the two owner cells, with the periodic
    translation folded into the face interpolation geometry
    (face_lw / face_r_on / face_dist_on). The reference parses and
    discards this data (io.rs:176-179) and has no periodic solver path;
    here periodic faces ride the ordinary interior path end to end.
    """
    geo = derive_geometry(raw)
    table = BoundaryTable(raw.face_zones)
    zone_slot = np.array(
        [table.slot_of_zone[z] for z in raw.face_zone_id], dtype=np.int64
    )
    fo = geo.face_owner
    fn = geo.face_neighbor
    fa, fnorm, fc = geo.face_area, geo.face_normal, geo.face_centroid
    face_shift = None
    if raw.periodic_pairs.size:
        fo, fn, fa, fnorm, fc, zone_slot, face_shift = _merge_periodic(
            raw.periodic_pairs, table, fo, fn, fa, fnorm, fc, zone_slot
        )
    mesh = compile_from_arrays(
        dim=raw.dim,
        face_owner=fo,
        face_neighbor=fn,
        face_area=fa,
        face_normal=fnorm,
        face_centroid=fc,
        face_zone_slot=zone_slot,
        cell_centroid=geo.cell_centroid,
        cell_volume=geo.cell_volume,
        dtype=dtype,
        face_shift=face_shift,
    )
    if nodes:
        from orc_cfd.mesh.nodes import build_node_interp

        ni = build_node_interp(raw, geo.cell_centroid, dtype=mesh.dtype)
        if mesh.cell_order is not None:
            # The node tables reference cell ids in the raw order; remap
            # through the RCM permutation (weights are value-identical).
            order = np.asarray(mesh.cell_order)
            inv = np.empty(order.shape[0], dtype=np.int64)
            inv[order] = np.arange(order.shape[0])
            ni = dataclasses.replace(
                ni,
                node_cells=jnp.asarray(
                    inv[np.asarray(ni.node_cells)], jnp.int32
                ),
            )
        mesh = dataclasses.replace(mesh, nodes=ni)
    return mesh, table


def to_raw_order(mesh: CompiledMesh, arr):
    """Map a compiled-order cell array back to the raw-mesh cell order
    (identity when no reordering was applied). For writers that pair
    compiled fields with raw-mesh topology (e.g. io/vtk.py)."""
    if mesh.cell_order is None:
        return arr
    import numpy as _np

    order = _np.asarray(mesh.cell_order)
    inv = _np.empty(order.shape[0], dtype=_np.int64)
    inv[order] = _np.arange(order.shape[0])
    return _np.asarray(arr)[inv]


def _merge_periodic(
    pairs, table, owner, neighbor, area, normal, centroid, zone_slot
):
    """Fold (periodic, shadow) face pairs into single interior faces.

    Keeps the periodic-side face of each pair with its owner/geometry,
    points its neighbor at the shadow face's owner cell, and records the
    translation `shift = x_f(periodic) - x_f(shadow)` so downstream
    interpolation geometry sees the neighbor cell's periodic *image*
    (centroid + shift). Shadow faces are dropped; merged faces take the
    interior zone slot so every BC select treats them as interior.
    """
    from orc_cfd.mesh.zones import FaceCondition

    f_idx = np.asarray(pairs[:, 0], dtype=np.int64)
    s_idx = np.asarray(pairs[:, 1], dtype=np.int64)
    owner = np.asarray(owner, dtype=np.int64).copy()
    neighbor = np.asarray(neighbor, dtype=np.int64).copy()
    zone_slot = np.asarray(zone_slot, dtype=np.int64).copy()
    if (neighbor[f_idx] >= 0).any() or (neighbor[s_idx] >= 0).any():
        raise ValueError("periodic pair references a non-boundary face")

    shift = np.zeros_like(centroid)
    shift[f_idx] = centroid[f_idx] - centroid[s_idx]
    # Translational periodicity only: within each pair zone the
    # translation must be a single constant vector.
    for slot in np.unique(zone_slot[f_idx]):
        sel = zone_slot[f_idx] == slot
        sh = shift[f_idx][sel]
        if np.abs(sh - sh[0]).max() > 1e-9 * max(1.0, np.abs(sh).max()):
            raise NotImplementedError(
                "rotationally-periodic zones are not supported (pair "
                "translations differ within one zone)"
            )
    neighbor[f_idx] = owner[s_idx]

    interior_slots = [
        table.slot_of_zone[zid]
        for zid, fz in table.zones.items()
        if fz.zone_type == FaceCondition.INTERIOR
    ]
    if not interior_slots:
        raise ValueError("periodic merge requires an interior face zone")
    zone_slot[f_idx] = interior_slots[0]

    keep = np.ones(owner.shape[0], dtype=bool)
    keep[s_idx] = False
    return (
        owner[keep],
        neighbor[keep],
        np.asarray(area)[keep],
        np.asarray(normal)[keep],
        np.asarray(centroid)[keep],
        zone_slot[keep],
        shift[keep],
    )


def compile_from_arrays(
    dim: int,
    face_owner: np.ndarray,
    face_neighbor: np.ndarray,  # -1 for boundary faces
    face_area: np.ndarray,
    face_normal: np.ndarray,  # unit, outward from owner
    face_centroid: np.ndarray,
    face_zone_slot: np.ndarray,
    cell_centroid: np.ndarray,
    cell_volume: np.ndarray,
    dtype=jnp.float64,
    face_shift: np.ndarray | None = None,  # [F,3] periodic translation
) -> CompiledMesh:
    """Build a CompiledMesh directly from face/cell arrays.

    Used both by the TGRID path (via geometry derivation) and by mesh
    generators that know their geometry analytically and can skip the
    parse + derive steps entirely (the scalable path for multi-million
    cell benchmark meshes).

    `face_shift` (zeros when None) translates each interior face's
    neighbor centroid to its periodic image before the interpolation
    helpers (lw, r_on, dist) are derived — nonzero only on merged
    periodic faces. The shift is baked into those per-face arrays, so
    no downstream op needs to know about periodicity as long as it
    derives neighbor-centroid geometry from `face_r_on` (they all do).
    """
    F = face_owner.shape[0]
    C = cell_volume.shape[0]

    owner = np.asarray(face_owner, dtype=np.int64)
    neighbor = np.asarray(face_neighbor, dtype=np.int64)
    interior = neighbor >= 0
    neighbor_safe = np.where(interior, neighbor, owner)
    geo = _Geo(
        face_area=face_area,
        face_normal=face_normal,
        face_centroid=face_centroid,
        cell_centroid=cell_centroid,
        cell_volume=cell_volume,
    )
    zone_slot = face_zone_slot

    # Interpolation helpers (reference: solver.rs:988-991, 1129-1132 use
    # w = dx0 / (dx0 + dx1) with dx measured centroid->face). Periodic
    # faces see the neighbor's translated image centroid.
    shift = (
        np.zeros_like(geo.face_normal)
        if face_shift is None
        else np.asarray(face_shift, dtype=np.float64)
    )
    nbr_centroid = geo.cell_centroid[neighbor_safe] + shift
    dx0 = np.linalg.norm(
        geo.cell_centroid[owner] - geo.face_centroid, axis=1
    )
    dx1 = np.linalg.norm(nbr_centroid - geo.face_centroid, axis=1)
    lw = np.where(interior, dx0 / np.maximum(dx0 + dx1, 1e-300), 0.0)

    r_on = np.where(
        interior[:, None],
        nbr_centroid - geo.cell_centroid[owner],
        geo.face_centroid - geo.cell_centroid[owner],
    )
    dist_on = np.linalg.norm(r_on, axis=1)

    # --- build the [C,K] ELL tables ---
    cell_faces, cell_face_mask, cell_face_sign, cell_neighbors = _build_ell(
        owner, neighbor, neighbor_safe, interior, C
    )

    entry_interior = interior[cell_faces] & cell_face_mask
    structured = _structure_ell(
        cell_faces, cell_face_mask, cell_face_sign, cell_neighbors,
        entry_interior,
    )
    cell_centroid = geo.cell_centroid
    cell_volume = geo.cell_volume
    cell_order = None
    slice_plan = None
    if structured is not None:
        offsets, cell_faces, cell_face_mask, cell_face_sign, cell_neighbors = (
            structured
        )
    else:
        offsets = None
        import os as _os

        if _os.environ.get("ORC_RCM", "1") == "1" and C > 2:
            # Irregular adjacency: RCM-reorder cells to bound the index
            # bandwidth, then build the slice plan (mesh/reorder.py) so
            # solvers run the gather-free slice SpMV.
            from orc_cfd.mesh.reorder import (
                build_best_slice_plan,
                rcm_permutation,
            )

            rcm = rcm_permutation(cell_neighbors, entry_interior)
            inv = np.empty(C, dtype=np.int64)
            inv[rcm] = np.arange(C)
            owner = inv[owner]
            neighbor = np.where(interior, inv[neighbor_safe], -1)
            neighbor_safe = np.where(interior, inv[neighbor_safe], owner)
            cell_centroid = np.asarray(cell_centroid)[rcm]
            cell_volume = np.asarray(cell_volume)[rcm]
            (
                cell_faces,
                cell_face_mask,
                cell_face_sign,
                cell_neighbors,
            ) = _build_ell(owner, neighbor, neighbor_safe, interior, C)
            entry_interior = interior[cell_faces] & cell_face_mask
            slice_plan = build_best_slice_plan(
                cell_neighbors, entry_interior
            )
            cell_order = rcm

    f = lambda x: jnp.asarray(x, dtype=dtype)
    i32 = lambda x: jnp.asarray(x, dtype=jnp.int32)

    return CompiledMesh(
        face_owner=i32(owner),
        face_neighbor=i32(neighbor_safe),
        face_interior=jnp.asarray(interior),
        face_area=f(geo.face_area),
        face_normal=f(geo.face_normal),
        face_centroid=f(geo.face_centroid),
        face_zone_slot=i32(zone_slot),
        face_lw=f(lw),
        face_r_on=f(r_on),
        face_dist_on=f(dist_on),
        face_dist_fo=f(dx0),
        cell_centroid=f(cell_centroid),
        cell_volume=f(cell_volume),
        cell_faces=i32(cell_faces),
        cell_face_mask=jnp.asarray(cell_face_mask),
        cell_face_sign=f(cell_face_sign),
        cell_neighbors=i32(cell_neighbors),
        dim=dim,
        neighbor_offsets=offsets,
        cell_order=None if cell_order is None else i32(cell_order),
        slice_plan=slice_plan,
    )


def _build_ell(owner, neighbor, neighbor_safe, interior, C):
    """Pack the face list into [C,K] ELL tables (faces, mask, owner-sign,
    neighbor-cell; self-index at boundary/padded slots)."""
    F = owner.shape[0]
    n_int = int(interior.sum())
    ell_face = np.concatenate([np.arange(F), np.arange(F)[interior]])
    ell_cell = np.concatenate([owner, neighbor[interior]])
    ell_sign = np.concatenate([np.ones(F), -np.ones(n_int)])
    ell_other = np.concatenate([neighbor_safe, owner[interior]])

    order = np.argsort(ell_cell, kind="stable")
    ell_face = ell_face[order]
    ell_cell = ell_cell[order]
    ell_sign = ell_sign[order]
    ell_other = ell_other[order]

    counts = np.zeros(C, dtype=np.int64)
    np.add.at(counts, owner, 1)
    np.add.at(counts, neighbor[interior], 1)
    K = int(counts.max())
    starts = np.zeros(C + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(len(ell_cell)) - starts[ell_cell]

    cell_faces = np.zeros((C, K), dtype=np.int64)
    cell_face_mask = np.zeros((C, K), dtype=bool)
    cell_face_sign = np.zeros((C, K), dtype=np.float64)
    cell_neighbors = np.tile(np.arange(C, dtype=np.int64)[:, None], (1, K))
    cell_faces[ell_cell, slot] = ell_face
    cell_face_mask[ell_cell, slot] = True
    cell_face_sign[ell_cell, slot] = ell_sign
    # Neighbor = the other cell for interior faces; self for boundary
    # faces (so a gather returns the cell's own value, which combined
    # with a zero matrix coefficient is a no-op).
    is_int_entry = interior[ell_face]
    cell_neighbors[ell_cell[is_int_entry], slot[is_int_entry]] = ell_other[
        is_int_entry
    ]
    return cell_faces, cell_face_mask, cell_face_sign, cell_neighbors


def _structure_ell(cell_faces, mask, sign, nbrs, entry_interior):
    """Detect a structured adjacency and reorder ELL columns so every
    interior entry in column k satisfies neighbor == cell + d_k.

    Returns (offsets, faces, mask, sign, neighbors) with per-row
    entries permuted, or None if the mesh is irregular. Entry order
    within a row is semantically irrelevant to assembly (all [C,K] ops
    reduce symmetrically over k); only the SpMV shift path cares.

    Periodic wrap faces contribute extra distinct deltas (e.g. -(nx-1)
    on an x-periodic box); the ELL is *widened* to one column per
    offset (up to 2K) so the shift path survives — a wrap entry's
    `jnp.roll` wraps the flat array exactly where the periodic
    neighbor lives, and every row without that offset carries a zero
    coefficient there.
    """
    C, K = nbrs.shape
    if C == 0 or not entry_interior.any():
        return None
    delta = nbrs - np.arange(C)[:, None]
    cand = np.unique(delta[entry_interior])
    if len(cand) > 2 * K:
        return None
    K_eff = max(K, len(cand))
    rows, cols = np.nonzero(entry_interior)
    tgt = np.searchsorted(cand, delta[rows, cols])
    key = rows * K_eff + tgt
    if len(np.unique(key)) != len(key):
        return None  # two same-offset neighbors in one row: irregular

    new_f = np.zeros((C, K_eff), dtype=cell_faces.dtype)
    new_m = np.zeros((C, K_eff), dtype=mask.dtype)
    new_s = np.zeros((C, K_eff), dtype=sign.dtype)
    new_n = np.tile(np.arange(C, dtype=nbrs.dtype)[:, None], (1, K_eff))
    used = np.zeros((C, K_eff), dtype=bool)
    new_f[rows, tgt] = cell_faces[rows, cols]
    new_m[rows, tgt] = True
    new_s[rows, tgt] = sign[rows, cols]
    new_n[rows, tgt] = nbrs[rows, cols]
    used[rows, tgt] = True

    # Boundary entries fill each row's free columns in order (their
    # matrix coefficients are structurally zero, so their column offset
    # is irrelevant to the shift SpMV).
    brows, bcols = np.nonzero(mask & ~entry_interior)
    if len(brows):
        free_rows, free_cols = np.nonzero(~used)
        ord_b = np.arange(len(brows)) - np.searchsorted(brows, brows)
        ord_f = np.arange(len(free_rows)) - np.searchsorted(free_rows, free_rows)
        slot_lookup = np.full((C, K_eff), -1, dtype=np.int64)
        slot_lookup[free_rows, ord_f] = free_cols
        j = slot_lookup[brows, ord_b]
        assert (j >= 0).all()
        new_f[brows, j] = cell_faces[brows, bcols]
        new_m[brows, j] = True
        new_s[brows, j] = sign[brows, bcols]
        new_n[brows, j] = nbrs[brows, bcols]

    offsets = tuple(int(d) for d in cand) + (0,) * (K_eff - len(cand))
    return offsets, new_f, new_m, new_s, new_n
