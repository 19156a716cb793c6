"""Structured hex-mesh generation.

The reference ships only pre-made example meshes; scaling its cases up
(e.g. the multi-million-cell lid-driven-cavity benchmark) requires
generating meshes. Two paths:

- `structured_box_mesh`: builds the CompiledMesh arrays analytically —
  no text parsing, scales to tens of millions of cells in seconds.
- `write_tgrid`: emits a TGRID .msh text file for a structured box, used
  to round-trip-test the parser and to produce reference-compatible
  fixtures (grammar per io.rs:78-284 of the reference's reader).

Zone naming follows the reference's couette fixtures
(couette_flow_*.msh): INLET (x-), OUTLET (x+), BOTTOM_WALL (y-),
TOP_WALL (y+), PERIODIC_-Z (z-), PERIODIC_+Z (z+), FLUID interior.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax.numpy as jnp
import numpy as np

from orc_cfd.mesh.compile import CompiledMesh, compile_from_arrays
from orc_cfd.mesh.zones import BoundaryTable, FaceCondition, FaceZone

DEFAULT_ZONE_NAMES = {
    "interior": "FLUID",
    "x-": "INLET",
    "x+": "OUTLET",
    "y-": "BOTTOM_WALL",
    "y+": "TOP_WALL",
    "z-": "PERIODIC_-Z",
    "z+": "PERIODIC_+Z",
}


def structured_box_mesh(
    nx: int,
    ny: int,
    nz: int = 1,
    lengths: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    zone_names: Dict[str, str] | None = None,
    dtype=jnp.float64,
    periodic: Tuple[str, ...] = (),
):
    """Uniform structured hex mesh of nx*ny*nz cells.

    Cell (i,j,k) has id ``i + nx*(j + ny*k)`` (x fastest). Returns
    (CompiledMesh, BoundaryTable); boundary zones default to
    Wall/Interior types — set the actual BCs on the table afterwards.

    `periodic` lists axes ("x", "y", "z") to close translationally:
    the two boundary planes of a periodic axis are replaced by wrap
    faces — interior faces at the high plane whose neighbor is the
    cell at the low plane, with the domain-length translation baked
    into the interpolation geometry (compile_from_arrays face_shift).
    Wrap faces add one +/- flat-index offset pair per periodic axis,
    so the mesh keeps its structured `neighbor_offsets` and the whole
    solve (assembly, SpMV, ck fast path) stays gather-free. The zone
    table keeps the axis's two zones, retyped PERIODIC/PERIODIC_SHADOW
    for bookkeeping (no faces reference them — wrap faces are
    interior).

    The ELL adjacency, offsets, and interpolation geometry of a
    uniform box are all analytic, so this builds the CompiledMesh
    arrays directly (_structured_compile) instead of routing through
    the generic `compile_from_arrays` sort/dedup machinery — ~10x
    faster at multi-million cells (the generic path remains for TGRID
    meshes and is the equivalence reference in tests/test_mesh.py).
    """
    per_axes = frozenset({"x": 0, "y": 1, "z": 2}[a] for a in periodic)
    # A 2-cell periodic axis gives two same-offset neighbors per row
    # (step and wrap both at +/-1): no structured column assignment
    # exists — take the generic (gather-path) construction.
    fast = all(
        (axis not in per_axes) or n >= 3
        for axis, n in zip((0, 1, 2), (nx, ny, nz))
    )
    if fast:
        return _structured_compile(
            nx, ny, nz, lengths, origin, zone_names, dtype, per_axes
        )
    return _structured_box_mesh_generic(
        nx, ny, nz, lengths, origin, zone_names, dtype, periodic
    )


def _structured_box_mesh_generic(
    nx, ny, nz, lengths, origin, zone_names, dtype, periodic
):
    """Generic-path construction (face lists -> compile_from_arrays).
    Kept as the equivalence reference for `_structured_compile` and as
    the fallback for configurations without a structured column
    assignment (2-cell periodic axes)."""
    names = dict(DEFAULT_ZONE_NAMES)
    if zone_names:
        names.update(zone_names)
    per_axes = frozenset(
        {"x": 0, "y": 1, "z": 2}[a] for a in periodic
    )
    for axis, n_axis in zip((0, 1, 2), (nx, ny, nz)):
        if axis in per_axes and n_axis < 2:
            raise ValueError(
                f"periodic axis {'xyz'[axis]} needs at least 2 cells "
                f"(got {n_axis}): a 1-cell wrap face would connect a "
                f"cell to itself"
            )
    lx, ly, lz = lengths
    ox, oy, oz = origin
    hx, hy, hz = lx / nx, ly / ny, lz / nz
    C = nx * ny * nz

    def cid(i, j, k):
        return i + nx * (j + ny * k)

    # Cell centroids / volumes.
    i, j, k = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    flat = cid(i, j, k).ravel()
    cc = np.zeros((C, 3))
    cc[flat, 0] = (ox + (i.ravel() + 0.5) * hx)
    cc[flat, 1] = (oy + (j.ravel() + 0.5) * hy)
    cc[flat, 2] = (oz + (k.ravel() + 0.5) * hz)
    vol = np.full(C, hx * hy * hz)

    # Zone table: 0 interior, 1..6 boundaries. Periodic axes follow the
    # TGRID-writer convention: high plane = PERIODIC (code 12), low
    # plane = PERIODIC_SHADOW (code 8) — matching write_tgrid so the
    # analytic and round-tripped tables agree.
    table = _box_zone_table(names, per_axes, (nx, ny, nz))

    owners, neighbors, areas, normals, cents, zslots, shifts = (
        [], [], [], [], [], [], []
    )

    def add_direction(axis, n_axis, h_axis, area, lo_zone, hi_zone):
        """Faces perpendicular to `axis` at planes 0..n_axis (periodic
        axes: planes 1..n_axis, the high plane wrapping to cell 0)."""
        is_per = axis in per_axes
        ax_counts = [nx, ny, nz]
        ax_counts[axis] = n_axis + 1
        pi, pj, pk = np.meshgrid(
            np.arange(ax_counts[0]),
            np.arange(ax_counts[1]),
            np.arange(ax_counts[2]),
            indexing="ij",
        )
        plane = (pi, pj, pk)[axis].ravel()
        others = [p.ravel() for p in (pi, pj, pk)]
        if is_per:
            sel = plane > 0  # drop the low plane (merged into the wrap)
            plane = plane[sel]
            others = [o[sel] for o in others]

        lo_idx = list(others)
        lo_idx[axis] = plane - 1  # cell below the plane
        hi_idx = list(others)
        hi_idx[axis] = np.where(plane < n_axis, plane, 0)  # wrap at top
        has_lo = plane > 0
        has_hi = (plane < n_axis) | is_per
        lo_cell = cid(*[np.clip(x, 0, None) for x in lo_idx])
        hi_cell = cid(*hi_idx)

        own = np.where(has_lo, lo_cell, hi_cell)
        nbr = np.where(has_lo & has_hi, hi_cell, -1)
        # Outward (from owner) normal: +e_axis for interior & high
        # boundary (owner below), -e_axis for the low boundary.
        sign = np.where(has_lo, 1.0, -1.0)
        nrm = np.zeros((own.shape[0], 3))
        nrm[:, axis] = sign

        cen = np.zeros((own.shape[0], 3))
        h = [hx, hy, hz]
        o = [ox, oy, oz]
        L = [lx, ly, lz]
        for a in range(3):
            if a == axis:
                cen[:, a] = o[a] + plane * h[a]
            else:
                cen[:, a] = o[a] + (others[a] + 0.5) * h[a]

        # Wrap faces: neighbor is the low-plane cell, whose periodic
        # image sits one domain length up the axis.
        shf = np.zeros((own.shape[0], 3))
        if is_per:
            shf[plane == n_axis, axis] = L[axis]

        zs = np.where(
            has_lo & has_hi,
            table.slot_of_zone[1],
            np.where(
                has_lo,
                table.slot_of_zone[hi_zone],
                table.slot_of_zone[lo_zone],
            ),
        )
        owners.append(own)
        neighbors.append(nbr)
        areas.append(np.full(own.shape[0], area))
        normals.append(nrm)
        cents.append(cen)
        zslots.append(zs)
        shifts.append(shf)

    add_direction(0, nx, hx, hy * hz, 2, 3)
    add_direction(1, ny, hy, hx * hz, 4, 5)
    add_direction(2, nz, hz, hx * hy, 6, 7)

    mesh = compile_from_arrays(
        dim=3,
        face_owner=np.concatenate(owners),
        face_neighbor=np.concatenate(neighbors),
        face_area=np.concatenate(areas),
        face_normal=np.concatenate(normals),
        face_centroid=np.concatenate(cents),
        face_zone_slot=np.concatenate(zslots),
        cell_centroid=cc,
        cell_volume=vol,
        dtype=dtype,
        face_shift=np.concatenate(shifts) if per_axes else None,
    )
    return mesh, table


def _box_zone_table(names, per_axes, dims):
    """Zone table shared by both structured constructions: 1 interior,
    2..7 the axis boundary pairs. Periodic axes follow the TGRID-writer
    convention (high plane = PERIODIC code 12, low = PERIODIC_SHADOW
    code 8) so analytic and round-tripped tables agree.

    A non-periodic axis with a SINGLE cell is a 2D reduction: its two
    planes default to SYMMETRY, not WALL. A wall default there silently
    adds a parasitic 2*mu*A/(V*h/2) drag on every cell (~4 nu/h^2 decay
    rate — measured 5x the physical rate on a Taylor-Green vortex
    before this default existed); every shipped model overrode it, but
    user-built 2D cases shouldn't have to know to."""
    zones = {1: FaceZone(1, FaceCondition.INTERIOR, names["interior"])}
    for axis, (lo_key, hi_key) in enumerate(
        (("x-", "x+"), ("y-", "y+"), ("z-", "z+"))
    ):
        if axis in per_axes:
            lo_t, hi_t = (
                FaceCondition.PERIODIC_SHADOW, FaceCondition.PERIODIC
            )
        elif dims[axis] == 1:
            lo_t = hi_t = FaceCondition.SYMMETRY
        else:
            lo_t = hi_t = FaceCondition.WALL
        zones[2 + 2 * axis] = FaceZone(2 + 2 * axis, lo_t, names[lo_key])
        zones[3 + 2 * axis] = FaceZone(3 + 2 * axis, hi_t, names[hi_key])
    return BoundaryTable(zones)


def _structured_compile(
    nx, ny, nz, lengths, origin, zone_names, dtype, per_axes
):
    """Direct analytic CompiledMesh construction for a uniform box.

    Everything the generic `compile_from_arrays` derives by sorting and
    deduplicating face lists is closed-form here: face ids are
    (axis, plane, transverse) triples, the ELL has one column per flat
    offset (ascending), boundary faces occupy their own direction's
    masked-off column (or the first free pad column on 1-cell axes),
    and the interpolation geometry of a uniform grid is constant per
    face class. Semantically equivalent to the generic path (pinned by
    tests/test_mesh.py::test_structured_fast_matches_generic)."""
    names = dict(DEFAULT_ZONE_NAMES)
    if zone_names:
        names.update(zone_names)
    dims = (nx, ny, nz)
    for axis in per_axes:
        if dims[axis] < 2:
            raise ValueError(
                f"periodic axis {'xyz'[axis]} needs at least 2 cells "
                f"(got {dims[axis]}): a 1-cell wrap face would connect "
                f"a cell to itself"
            )
    h = (lengths[0] / nx, lengths[1] / ny, lengths[2] / nz)
    o = origin
    C = nx * ny * nz
    table = _box_zone_table(names, per_axes, dims)
    slot = table.slot_of_zone
    int_slot = slot[1]

    idx = np.arange(C, dtype=np.int64)
    ia = (idx % nx, (idx // nx) % ny, idx // (nx * ny))  # i, j, k
    strides = (1, nx, nx * ny)

    # Transverse flat index (cell id with the axis digit removed) and
    # its inverse (cell id from transverse index + axis coordinate).
    def other_flat(axis):
        if axis == 0:
            return idx // nx
        if axis == 1:
            return ia[0] + nx * ia[2]
        return idx % (nx * ny)

    def cell_from(axis, of, q):
        if axis == 0:
            return q + nx * of
        if axis == 1:
            return of % nx + nx * q + nx * ny * (of // nx)
        return of + nx * ny * q

    # --- face arrays, direction-major -------------------------------
    P = {a: C // dims[a] for a in range(3)}
    n_planes = {
        a: dims[a] + (0 if a in per_axes else 1) for a in range(3)
    }
    base = {}
    acc = 0
    for a in range(3):
        base[a] = acc
        acc += n_planes[a] * P[a]
    F = acc

    f_owner = np.empty(F, dtype=np.int64)
    f_neighbor = np.empty(F, dtype=np.int64)
    f_interior = np.empty(F, dtype=bool)
    f_area = np.empty(F)
    f_normal = np.zeros((F, 3))
    f_centroid = np.empty((F, 3))
    f_zslot = np.empty(F, dtype=np.int64)
    f_lw = np.empty(F)
    f_r_on = np.zeros((F, 3))
    f_dist_on = np.empty(F)
    f_dist_fo = np.empty(F)

    for a in range(3):
        per = a in per_axes
        n_a, s_a, pa = dims[a], strides[a], P[a]
        sl = slice(base[a], base[a] + n_planes[a] * pa)
        fi = np.arange(n_planes[a] * pa, dtype=np.int64)
        p_idx = fi // pa
        of = fi % pa
        plane = p_idx + 1 if per else p_idx
        if per:
            own_q = p_idx  # cell below plane p_idx+1
            nbr_q = np.where(p_idx < n_a - 1, p_idx + 1, 0)
            f_owner[sl] = cell_from(a, of, own_q)
            f_neighbor[sl] = cell_from(a, of, nbr_q)
            f_interior[sl] = True
            f_normal[sl, a] = 1.0
            f_zslot[sl] = int_slot
            f_lw[sl] = 0.5
            f_r_on[sl, a] = h[a]
            f_dist_on[sl] = h[a]
        else:
            has_lo = p_idx > 0
            has_hi = p_idx < n_a
            own_q = np.where(has_lo, p_idx - 1, 0)
            f_owner[sl] = cell_from(a, of, own_q)
            inter = has_lo & has_hi
            nbr = np.where(
                inter, cell_from(a, of, np.minimum(p_idx, n_a - 1)), -1
            )
            f_neighbor[sl] = nbr
            f_interior[sl] = inter
            f_normal[sl, a] = np.where(has_lo, 1.0, -1.0)
            f_zslot[sl] = np.where(
                inter,
                int_slot,
                np.where(has_lo, slot[3 + 2 * a], slot[2 + 2 * a]),
            )
            f_lw[sl] = np.where(inter, 0.5, 0.0)
            # owner -> neighbor (interior: +h along a); boundary:
            # owner -> face centroid (half cell toward the face).
            f_r_on[sl, a] = np.where(
                inter, h[a], np.where(has_lo, 0.5 * h[a], -0.5 * h[a])
            )
            f_dist_on[sl] = np.where(inter, h[a], 0.5 * h[a])
        f_area[sl] = np.prod([h[b] for b in range(3) if b != a])
        f_dist_fo[sl] = 0.5 * h[a]
        # Centroid: axis coordinate on the plane, transverse centered.
        f_centroid[sl, a] = o[a] + plane * h[a]
        for b in range(3):
            if b == a:
                continue
            # Decode transverse coordinates per (a, b) pair.
            if a == 0:  # of = j + ny*k
                coord = of % ny if b == 1 else of // ny
            elif a == 1:  # of = i + nx*k
                coord = of % nx if b == 0 else of // nx
            else:  # of = i + nx*j
                coord = of % nx if b == 0 else of // nx
            f_centroid[sl, b] = o[b] + (coord + 0.5) * h[b]

    # --- ELL tables: one column per flat offset ---------------------
    col_specs = []  # (delta, builder)
    leftovers = []
    for a in range(3):
        per = a in per_axes
        n_a, s_a, pa = dims[a], strides[a], P[a]
        i_a = ia[a]
        of_c = other_flat(a)
        if n_a == 1:
            # Both faces are leftover boundary fills (plane 0 and 1).
            leftovers.append((base[a] + of_c, base[a] + pa + of_c))
            continue
        if per:
            fup = base[a] + i_a * pa + of_c  # plane i_a+1
            fdn = base[a] + ((i_a - 1) % n_a) * pa + of_c
            col_specs.append(
                (s_a, dict(face=fup, mask=i_a < n_a - 1, sign=1.0,
                           nbr=idx + s_a, axis=a, dir=1,
                           wrap_or_per=True))
            )
            col_specs.append(
                (-s_a, dict(face=fdn, mask=i_a > 0, sign=-1.0,
                            nbr=idx - s_a, axis=a, dir=-1,
                            wrap_or_per=True))
            )
            w = s_a * (n_a - 1)
            fw = base[a] + (n_a - 1) * pa + of_c
            col_specs.append(
                (-w, dict(face=fw, mask=i_a == n_a - 1, sign=1.0,
                          nbr=idx - w, axis=a, dir=1,
                          wrap_or_per=True))
            )
            col_specs.append(
                (w, dict(face=fw, mask=i_a == 0, sign=-1.0,
                         nbr=idx + w, axis=a, dir=-1,
                         wrap_or_per=True))
            )
        else:
            fup = base[a] + (i_a + 1) * pa + of_c
            fdn = base[a] + i_a * pa + of_c
            hi = i_a == n_a - 1
            lo = i_a == 0
            col_specs.append(
                (s_a, dict(face=fup, mask=None, sign=1.0,
                           nbr=np.where(hi, idx, idx + s_a),
                           interior=~hi, axis=a, dir=1,
                           wrap_or_per=False))
            )
            col_specs.append(
                (-s_a, dict(face=fdn, mask=None,
                            sign=np.where(lo, 1.0, -1.0),
                            nbr=np.where(lo, idx, idx - s_a),
                            interior=~lo, axis=a, dir=-1,
                            wrap_or_per=False))
            )

    col_specs.sort(key=lambda t: t[0])
    n_struct = len(col_specs)
    K = max(n_struct, 6)
    cell_faces = np.zeros((C, K), dtype=np.int64)
    cell_mask = np.zeros((C, K), dtype=bool)
    cell_sign = np.zeros((C, K))
    cell_nbrs = np.tile(idx[:, None], (1, K))
    for kcol, (delta, spec) in enumerate(col_specs):
        m = spec["mask"] if spec["mask"] is not None else np.ones(C, bool)
        cell_faces[:, kcol] = np.where(m, spec["face"], 0)
        cell_mask[:, kcol] = m
        cell_sign[:, kcol] = np.where(m, spec["sign"], 0.0)
        nbr_col = np.where(
            m & spec.get("interior", m), spec["nbr"], idx
        )
        cell_nbrs[:, kcol] = nbr_col
    # Per-column geometry constants (UniformCKGeometry): valid when
    # every column has a fixed axis/direction/boundary-zone across all
    # rows. Structural columns always do; leftover (1-cell-axis)
    # boundary columns do only when the free-column pattern is
    # row-independent — i.e. no periodic axes alongside leftovers.
    col_const = [None] * K
    for kcol, (delta, spec) in enumerate(col_specs):
        a = spec["axis"]
        d = spec["dir"]
        nvec = [0.0, 0.0, 0.0]
        nvec[a] = float(d)
        bnd_slot = (
            int_slot
            if spec["wrap_or_per"]
            else (slot[3 + 2 * a] if d > 0 else slot[2 + 2 * a])
        )
        col_const[kcol] = (
            float(np.prod([h[b] for b in range(3) if b != a])),
            tuple(nvec),
            0.5 * h[a],
            float(h[a]),
            int(bnd_slot),
        )
    used = cell_mask.copy()
    for a_left, (lo_face, hi_face) in zip(
        [a for a in range(3) if dims[a] == 1 and a not in per_axes],
        leftovers,
    ):
        for bface, d in ((lo_face, -1.0), (hi_face, 1.0)):
            kfree = np.argmax(~used, axis=1)
            rows = idx
            cell_faces[rows, kfree] = bface
            cell_mask[rows, kfree] = True
            cell_sign[rows, kfree] = 1.0
            used[rows, kfree] = True
            if not per_axes:
                kc = int(kfree[0])
                nvec = [0.0, 0.0, 0.0]
                nvec[a_left] = d
                col_const[kc] = (
                    float(
                        np.prod([h[b] for b in range(3) if b != a_left])
                    ),
                    tuple(nvec),
                    0.5 * h[a_left],
                    float(h[a_left]),
                    int(
                        slot[3 + 2 * a_left]
                        if d > 0
                        else slot[2 + 2 * a_left]
                    ),
                )
    ck_constants = None
    # Leftover boundary faces land in per-ROW free columns when
    # periodic wrap columns exist (row-dependent free pattern), which
    # breaks per-column constancy — no constants in that case.
    if not (leftovers and per_axes) and all(
        c is not None for c in col_const
    ):
        ck_constants = (int(int_slot), tuple(col_const))
    offsets = tuple(int(d) for d, _ in col_specs) + (0,) * (K - n_struct)

    # --- cell geometry ----------------------------------------------
    cc = np.empty((C, 3))
    for a in range(3):
        cc[:, a] = o[a] + (ia[a] + 0.5) * h[a]
    vol = np.full(C, h[0] * h[1] * h[2])

    f = lambda x: jnp.asarray(x, dtype=dtype)
    i32 = lambda x: jnp.asarray(x, dtype=jnp.int32)
    mesh = CompiledMesh(
        face_owner=i32(f_owner),
        face_neighbor=i32(
            np.where(f_interior, f_neighbor, f_owner)
        ),
        face_interior=jnp.asarray(f_interior),
        face_area=f(f_area),
        face_normal=f(f_normal),
        face_centroid=f(f_centroid),
        face_zone_slot=i32(f_zslot),
        face_lw=f(f_lw),
        face_r_on=f(f_r_on),
        face_dist_on=f(f_dist_on),
        face_dist_fo=f(f_dist_fo),
        cell_centroid=f(cc),
        cell_volume=f(vol),
        cell_faces=i32(cell_faces),
        cell_face_mask=jnp.asarray(cell_mask),
        cell_face_sign=f(cell_sign),
        cell_neighbors=i32(cell_nbrs),
        dim=3,
        neighbor_offsets=offsets,
        ck_constants=ck_constants,
    )
    return mesh, table


def write_tgrid(
    path: str,
    nx: int,
    ny: int,
    nz: int = 1,
    lengths: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    zone_names: Dict[str, str] | None = None,
    periodic: Tuple[str, ...] = (),
):
    """Write a structured box as a TGRID .msh text file.

    Periodic axes emit their high-plane faces as a PERIODIC zone (BC
    code 12), the low plane as PERIODIC_SHADOW (code 8), and an
    ``(18 ...)`` shadow-pair section mapping each periodic face to its
    shadow — the grammar the reference parses and discards
    (io.rs:176-179) and this framework's reader retains."""
    names = dict(DEFAULT_ZONE_NAMES)
    if zone_names:
        names.update(zone_names)
    per_axes = frozenset({"x": 0, "y": 1, "z": 2}[a] for a in periodic)
    lx, ly, lz = lengths
    ox, oy, oz = origin
    hx, hy, hz = lx / nx, ly / ny, lz / nz
    npx, npy, npz = nx + 1, ny + 1, nz + 1
    n_nodes = npx * npy * npz
    n_cells = nx * ny * nz

    def nid(i, j, k):  # 1-based node id
        return 1 + i + npx * (j + npy * k)

    def cid(i, j, k):  # 1-based cell id
        return 1 + i + nx * (j + ny * k)

    # Count faces per zone.
    n_int = (nx - 1) * ny * nz + nx * (ny - 1) * nz + nx * ny * (nz - 1)
    zone_faces = {
        "interior": [],
        "x-": [],
        "x+": [],
        "y-": [],
        "y+": [],
        "z-": [],
        "z+": [],
    }

    # Quad faces with nodes ordered counterclockwise seen from +axis.
    for i in range(npx):
        for j in range(ny):
            for k in range(nz):
                nodes = (
                    nid(i, j, k),
                    nid(i, j + 1, k),
                    nid(i, j + 1, k + 1),
                    nid(i, j, k + 1),
                )
                c_lo = cid(i - 1, j, k) if i > 0 else 0
                c_hi = cid(i, j, k) if i < nx else 0
                key = "interior" if (c_lo and c_hi) else ("x-" if i == 0 else "x+")
                zone_faces[key].append((nodes, c_hi, c_lo))
    for j in range(npy):
        for i in range(nx):
            for k in range(nz):
                nodes = (
                    nid(i, j, k),
                    nid(i + 1, j, k),
                    nid(i + 1, j, k + 1),
                    nid(i, j, k + 1),
                )
                c_lo = cid(i, j - 1, k) if j > 0 else 0
                c_hi = cid(i, j, k) if j < ny else 0
                key = "interior" if (c_lo and c_hi) else ("y-" if j == 0 else "y+")
                zone_faces[key].append((nodes, c_hi, c_lo))
    for k in range(npz):
        for i in range(nx):
            for j in range(ny):
                nodes = (
                    nid(i, j, k),
                    nid(i + 1, j, k),
                    nid(i + 1, j + 1, k),
                    nid(i, j + 1, k),
                )
                c_lo = cid(i, j, k - 1) if k > 0 else 0
                c_hi = cid(i, j, k) if k < nz else 0
                key = "interior" if (c_lo and c_hi) else ("z-" if k == 0 else "z+")
                zone_faces[key].append((nodes, c_hi, c_lo))

    n_faces = sum(len(v) for v in zone_faces.values())
    # Mirror _box_zone_table: walls (code 3) on real boundaries,
    # SYMMETRY (code 7) on the planes of a single-cell non-periodic
    # axis (a 2D reduction), periodic pair codes on periodic axes —
    # so a written+re-read box gets the same BoundaryTable as the
    # analytic construction.
    bc_code = {"interior": 2}
    for axis, (lo_key, hi_key) in enumerate(
        (("x-", "x+"), ("y-", "y+"), ("z-", "z+"))
    ):
        code = 7 if (nx, ny, nz)[axis] == 1 else 3
        bc_code[lo_key] = bc_code[hi_key] = code
    for axis in per_axes:
        lo_key, hi_key = (("x-", "x+"), ("y-", "y+"), ("z-", "z+"))[axis]
        bc_code[hi_key] = 12  # PERIODIC
        bc_code[lo_key] = 8  # PERIODIC_SHADOW

    with open(path, "w") as f:
        f.write('(0 "Generated by orc_cfd structured_box_mesh")\n')
        f.write('(0 "Units: Meters")\n')
        f.write("(2 3)\n")
        f.write(f"(10 (0 1 {n_nodes:x} 0 3))\n")
        f.write(f"(10 (1 1 {n_nodes:x} 1 3)\n(\n")
        # Emit nodes in id order (i fastest).
        for idx in range(n_nodes):
            i = idx % npx
            j = (idx // npx) % npy
            k = idx // (npx * npy)
            f.write(f"{ox + i * hx:.17g} {oy + j * hy:.17g} {oz + k * hz:.17g}\n")
        f.write("))\n")
        f.write(f"(12 (0 1 {n_cells:x} 0 0))\n")
        f.write(f"(12 (2 1 {n_cells:x} 1 4))\n")
        f.write(f"(13 (0 1 {n_faces:x} 0 0))\n")

        zone_id = 10
        first = 1
        zone_start: Dict[str, int] = {}
        zone_num: Dict[str, int] = {}
        for key in ("interior", "x-", "x+", "y-", "y+", "z-", "z+"):
            faces = zone_faces[key]
            if not faces:
                continue
            last = first + len(faces) - 1
            zone_start[key] = first
            zone_num[key] = zone_id
            f.write(f'(0 "Faces of zone {names[key]}")\n')
            f.write(
                f"(13 ({zone_id:x} {first:x} {last:x} {bc_code[key]:x} 4)(\n"
            )
            for nodes, c0, c1 in faces:
                f.write(
                    " ".join(f"{x:x}" for x in nodes)
                    + f" {c0:x} {c1:x}\n"
                )
            f.write(")\n)\n")
            first = last + 1
            zone_id += 1

        # Periodic shadow-pair sections: one (18 per periodic axis,
        # pairing the high-plane (PERIODIC) faces with the low-plane
        # (PERIODIC_SHADOW) faces in identical transverse order.
        for axis in sorted(per_axes):
            lo_key, hi_key = (("x-", "x+"), ("y-", "y+"), ("z-", "z+"))[
                axis
            ]
            n_pairs = len(zone_faces[hi_key])
            assert n_pairs == len(zone_faces[lo_key])
            f.write(f'(0 "Periodic pairs for axis {"xyz"[axis]}")\n')
            f.write(
                f"(18 (1 {n_pairs:x} {zone_num[hi_key]:x} "
                f"{zone_num[lo_key]:x})(\n"
            )
            for idx in range(n_pairs):
                f.write(
                    f"{zone_start[hi_key] + idx:x} "
                    f"{zone_start[lo_key] + idx:x}\n"
                )
            f.write("))\n")
