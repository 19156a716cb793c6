"""Mesh-domain decomposition: RCB partitioning + halo construction.

The CFD analogue of data parallelism (SURVEY.md 2, parallelism
inventory): cells are partitioned across devices by recursive
coordinate bisection; each device owns a contiguous block of cells plus
*halo* slots replicating remote face-neighbors. All per-part arrays are
padded to uniform sizes so the stacked [P, ...] arrays shard cleanly
over a `jax.sharding.Mesh` axis, and the per-offset exchange lists
drive `lax.ppermute` halo refreshes (the JAX-native NCCL replacement —
neighbor permutes ride the ICI).

Local index space of every part (size L = c_max + h_max + 1):
  [0, c_max)            owned cells (padded tail inactive)
  [c_max, c_max+h_max)  halo slots (remote cells, refreshed on demand)
  L-1                   trash slot (padded exchange targets land here)
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from orc_cfd.mesh.compile import CompiledMesh


def rcb_partition(points: np.ndarray, n_parts: int) -> np.ndarray:
    """Recursive coordinate bisection -> part id per point [N]."""
    points = np.asarray(points)
    out = np.zeros(points.shape[0], dtype=np.int64)

    def rec(idx: np.ndarray, parts: int, base: int):
        if parts == 1:
            out[idx] = base
            return
        p_lo = parts // 2
        pts = points[idx]
        axis = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
        order = np.argsort(pts[:, axis], kind="stable")
        n_lo = int(round(len(idx) * p_lo / parts))
        rec(idx[order[:n_lo]], p_lo, base)
        rec(idx[order[n_lo:]], parts - p_lo, base + p_lo)

    rec(np.arange(points.shape[0]), n_parts, 0)
    return out


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Partition:
    """Stacked per-part local mesh + exchange plan (leading axis = P)."""

    local_mesh: CompiledMesh  # all arrays stacked [P, ...]
    owned_global: jax.Array  # [P, L] i32 global id at each owned slot
    owned_mask: jax.Array  # [P, L] bool — true at owned, real slots
    # Exchange plan, one entry per active ring offset:
    send_idx: tuple  # of [P, s_d] i32 local indices to gather & send
    recv_idx: tuple  # of [P, s_d] i32 local halo slots (trash-padded)
    offsets: tuple = dataclasses.field(metadata=dict(static=True))
    n_parts: int = dataclasses.field(metadata=dict(static=True))
    c_max: int = dataclasses.field(metadata=dict(static=True))
    h_max: int = dataclasses.field(metadata=dict(static=True))

    @property
    def local_size(self) -> int:
        return self.c_max + self.h_max + 1


def partition_mesh(
    mesh: CompiledMesh, n_parts: int, dtype=None, method: str = "auto"
) -> Partition:
    """Partition a compiled mesh for `n_parts` devices.

    method: "slab" (contiguous index ranges with ghost layers —
    preserves structured neighbor offsets, so the distributed SpMV runs
    gather-free), "rcb" (recursive coordinate bisection — general
    meshes), or "auto" (slab when the mesh is structured).
    """
    if method == "auto":
        method = "slab" if mesh.neighbor_offsets is not None else "rcb"
    if method == "slab":
        if mesh.neighbor_offsets is None:
            raise ValueError("slab partitioning requires a structured mesh")
        return _partition_slab(mesh, n_parts, dtype)
    return _partition_rcb(mesh, n_parts, dtype)


def _partition_slab(
    mesh: CompiledMesh, n_parts: int, dtype=None
) -> Partition:
    """Ghost-layer slab decomposition of a structured mesh.

    Each part owns the contiguous global range [p*c_max, ...) and keeps
    H = max|offset| ghost cells on each side in *global index order*,
    so local neighbor deltas equal the global `neighbor_offsets` and
    every device-local SpMV stays on the shift path.

    Local layout (size L = c_max + 2H + 1):
      [0, H)              lower ghost layer
      [H, H + size_p)     owned cells
      [H + c_max, +H)     upper ghost layer
      L-1                 trash slot
    """
    dtype = dtype or mesh.dtype
    C, F, K = mesh.n_cells, mesh.n_faces, mesh.max_faces_per_cell
    offs = mesh.neighbor_offsets
    # Ghost depth = the largest neighbor offset. Periodic wrap offsets
    # transverse to the partition (slowest) axis are smaller than the
    # existing plane offset, so they ride along free; periodicity ALONG
    # the partition axis makes H approach C (each device replicates
    # most of the domain) — still correct, but use RCB there instead.
    H = max(1, max(abs(int(d)) for d in offs))
    c_max = -(-C // n_parts)
    L = c_max + 2 * H + 1
    trash = L - 1

    starts = [p * c_max for p in range(n_parts)]
    sizes = [max(0, min(c_max, C - s)) for s in starts]
    part_of = np.minimum(np.arange(C) // c_max, n_parts - 1)

    owner = np.asarray(mesh.face_owner, dtype=np.int64)
    neighbor = np.asarray(mesh.face_neighbor, dtype=np.int64)
    interior = np.asarray(mesh.face_interior)
    nbrs_g = np.asarray(mesh.cell_neighbors, dtype=np.int64)
    mask_g = np.asarray(mesh.cell_face_mask)
    faces_g = np.asarray(mesh.cell_faces, dtype=np.int64)
    sign_g = np.asarray(mesh.cell_face_sign)
    cc = np.asarray(mesh.cell_centroid)
    g_vol = np.asarray(mesh.cell_volume)

    local_of = np.full((n_parts, C), trash, dtype=np.int64)
    halos: List[np.ndarray] = []
    for p in range(n_parts):
        w0 = starts[p] - H
        lo = np.arange(max(0, w0), starts[p])
        hi = np.arange(
            min(C, starts[p] + sizes[p]),
            min(C, starts[p] + c_max + H),
        )
        # In-window cells (ghosts + owned) all map by g - w0.
        win = np.arange(max(0, w0), min(C, starts[p] + c_max + H))
        local_of[p, win] = win - w0
        halos.append(np.concatenate([lo, hi]))

    part_faces: List[np.ndarray] = []
    for p in range(n_parts):
        sel = (part_of[owner] == p) | (interior & (part_of[neighbor] == p))
        part_faces.append(np.nonzero(sel)[0])
    f_max = max(len(f) for f in part_faces)

    def zeros(shape, fill=0.0):
        return np.full(shape, fill, dtype=np.float64)

    l_owner = np.zeros((n_parts, f_max), dtype=np.int64)
    l_neighbor = np.zeros((n_parts, f_max), dtype=np.int64)
    l_interior = np.zeros((n_parts, f_max), dtype=bool)
    l_area = zeros((n_parts, f_max))
    l_normal = zeros((n_parts, f_max, 3))
    l_normal[:, :, 0] = 1.0
    l_fcent = zeros((n_parts, f_max, 3))
    l_zslot = np.zeros((n_parts, f_max), dtype=np.int64)
    l_lw = zeros((n_parts, f_max))
    l_ron = zeros((n_parts, f_max, 3))
    l_ron[:, :, 0] = 1.0
    l_dist_on = zeros((n_parts, f_max), 1.0)
    l_dist_fo = zeros((n_parts, f_max), 1.0)
    l_ccent = zeros((n_parts, L, 3))
    l_vol = zeros((n_parts, L), 1.0)
    l_cf = np.zeros((n_parts, L, K), dtype=np.int64)
    l_cmask = np.zeros((n_parts, L, K), dtype=bool)
    l_csign = zeros((n_parts, L, K))
    l_cnbr = np.tile(
        np.arange(L, dtype=np.int64)[None, :, None], (n_parts, 1, K)
    )
    owned_global = np.zeros((n_parts, L), dtype=np.int64)
    owned_mask = np.zeros((n_parts, L), dtype=bool)

    g_arrs = dict(
        area=np.asarray(mesh.face_area),
        normal=np.asarray(mesh.face_normal),
        fcent=np.asarray(mesh.face_centroid),
        zslot=np.asarray(mesh.face_zone_slot, dtype=np.int64),
        lw=np.asarray(mesh.face_lw),
        ron=np.asarray(mesh.face_r_on),
        dist_on=np.asarray(mesh.face_dist_on),
        dist_fo=np.asarray(mesh.face_dist_fo),
    )

    for p in range(n_parts):
        w0 = starts[p] - H
        o = np.arange(starts[p], starts[p] + sizes[p])
        sl = o - w0  # local slots of owned cells
        owned_global[p, sl] = o
        owned_mask[p, sl] = True
        # Halo (ghost-layer) slots also record their global ids —
        # consumers distinguish owned vs halo via owned_mask (the
        # sharded-AMG Galerkin derives coarse scatter targets from
        # global ids of NEIGHBOR slots, which may be halos).
        hg = halos[p]
        owned_global[p, local_of[p, hg]] = hg
        pf = part_faces[p]
        n_f = len(pf)
        face_local = np.full(F, -1, dtype=np.int64)
        face_local[pf] = np.arange(n_f)

        l_owner[p, :n_f] = owner[pf] - w0
        l_neighbor[p, :n_f] = neighbor[pf] - w0
        l_interior[p, :n_f] = interior[pf]
        l_area[p, :n_f] = g_arrs["area"][pf]
        l_normal[p, :n_f] = g_arrs["normal"][pf]
        l_fcent[p, :n_f] = g_arrs["fcent"][pf]
        l_zslot[p, :n_f] = g_arrs["zslot"][pf]
        l_lw[p, :n_f] = g_arrs["lw"][pf]
        l_ron[p, :n_f] = g_arrs["ron"][pf]
        l_dist_on[p, :n_f] = g_arrs["dist_on"][pf]
        l_dist_fo[p, :n_f] = g_arrs["dist_fo"][pf]

        win = np.arange(max(0, w0), min(C, starts[p] + c_max + H))
        l_ccent[p, win - w0] = cc[win]
        l_vol[p, win - w0] = g_vol[win]

        l_cf[p, sl] = np.where(mask_g[o], np.maximum(face_local[faces_g[o]], 0), 0)
        l_cmask[p, sl] = mask_g[o]
        l_csign[p, sl] = sign_g[o]
        l_cnbr[p, sl] = np.where(
            mask_g[o], nbrs_g[o] - w0, sl[:, None]
        )

    send_idx, recv_idx, ring_offsets = _exchange_plan(
        halos, local_of, part_of, n_parts, trash
    )

    f = lambda x: jnp.asarray(x, dtype=dtype)
    i32 = lambda x: jnp.asarray(x, dtype=jnp.int32)
    local_mesh = CompiledMesh(
        face_owner=i32(l_owner),
        face_neighbor=i32(l_neighbor),
        face_interior=jnp.asarray(l_interior),
        face_area=f(l_area),
        face_normal=f(l_normal),
        face_centroid=f(l_fcent),
        face_zone_slot=i32(l_zslot),
        face_lw=f(l_lw),
        face_r_on=f(l_ron),
        face_dist_on=f(l_dist_on),
        face_dist_fo=f(l_dist_fo),
        cell_centroid=f(l_ccent),
        cell_volume=f(l_vol),
        cell_faces=i32(l_cf),
        cell_face_mask=jnp.asarray(l_cmask),
        cell_face_sign=f(l_csign),
        cell_neighbors=i32(l_cnbr),
        dim=mesh.dim,
        neighbor_offsets=offs,
        # Uniform-box column constants hold for every owned local cell
        # (slab windows preserve global geometry and column order), so
        # the per-device ck path keeps the compact UniformCKGeometry —
        # and the fused Pallas assembly kernels stay eligible.
        ck_constants=mesh.ck_constants,
    )
    return Partition(
        local_mesh=local_mesh,
        owned_global=i32(owned_global),
        owned_mask=jnp.asarray(owned_mask),
        send_idx=tuple(i32(s) for s in send_idx),
        recv_idx=tuple(i32(r) for r in recv_idx),
        offsets=tuple(ring_offsets),
        n_parts=n_parts,
        c_max=c_max + 2 * H,  # owned+ghost extent (L = this + 1)
        h_max=0,
    )


def _exchange_plan(halos, local_of, part_of, n_parts, trash):
    """Per-ring-offset send/recv index lists (shared by both
    partitioners)."""
    send_idx: List[np.ndarray] = []
    recv_idx: List[np.ndarray] = []
    ring_offsets: List[int] = []
    for d in range(1, n_parts):
        sends = []
        any_traffic = False
        for src in range(n_parts):
            dst = (src + d) % n_parts
            need = halos[dst][part_of[halos[dst]] == src]
            if len(need):
                any_traffic = True
            sends.append(need)
        if not any_traffic:
            continue
        s_max = max(len(s) for s in sends)
        s_arr = np.zeros((n_parts, s_max), dtype=np.int64)
        r_arr = np.full((n_parts, s_max), trash, dtype=np.int64)
        for src in range(n_parts):
            dst = (src + d) % n_parts
            need = sends[src]
            s_arr[src, : len(need)] = local_of[src, need]
            r_arr[dst, : len(need)] = local_of[dst, need]
        send_idx.append(s_arr)
        recv_idx.append(r_arr)
        ring_offsets.append(d)
    return send_idx, recv_idx, ring_offsets


def _partition_rcb(
    mesh: CompiledMesh, n_parts: int, dtype=None
) -> Partition:
    """Partition a compiled mesh for `n_parts` devices (RCB + sorted
    halo blocks)."""
    dtype = dtype or mesh.dtype
    C, F, K = mesh.n_cells, mesh.n_faces, mesh.max_faces_per_cell
    cc = np.asarray(mesh.cell_centroid)
    part_of = rcb_partition(cc, n_parts)

    owner = np.asarray(mesh.face_owner, dtype=np.int64)
    neighbor = np.asarray(mesh.face_neighbor, dtype=np.int64)
    interior = np.asarray(mesh.face_interior)
    nbrs_g = np.asarray(mesh.cell_neighbors, dtype=np.int64)
    mask_g = np.asarray(mesh.cell_face_mask)
    faces_g = np.asarray(mesh.cell_faces, dtype=np.int64)
    sign_g = np.asarray(mesh.cell_face_sign)

    owned: List[np.ndarray] = [
        np.nonzero(part_of == p)[0] for p in range(n_parts)
    ]
    c_max = max(len(o) for o in owned)

    # Halo cells: remote neighbors of owned cells (via the [C,K] table).
    halos: List[np.ndarray] = []
    for p in range(n_parts):
        o = owned[p]
        nb = nbrs_g[o][mask_g[o]]
        remote = np.unique(nb[part_of[nb] != p])
        halos.append(remote)
    h_max = max((len(h) for h in halos), default=0)
    h_max = max(h_max, 1)
    L = c_max + h_max + 1
    trash = L - 1

    # Local index of a global cell within part p.
    local_of = np.full((n_parts, C), trash, dtype=np.int64)
    for p in range(n_parts):
        local_of[p, owned[p]] = np.arange(len(owned[p]))
        local_of[p, halos[p]] = c_max + np.arange(len(halos[p]))

    # Faces present in part p: any face adjacent to an owned cell (cut
    # faces are duplicated on both sides).
    part_faces: List[np.ndarray] = []
    for p in range(n_parts):
        sel = (part_of[owner] == p) | (interior & (part_of[neighbor] == p))
        part_faces.append(np.nonzero(sel)[0])
    f_max = max(len(f) for f in part_faces)

    # --- build stacked local arrays ---
    def zeros(shape, fill=0.0):
        return np.full(shape, fill, dtype=np.float64)

    l_owner = np.zeros((n_parts, f_max), dtype=np.int64)
    l_neighbor = np.zeros((n_parts, f_max), dtype=np.int64)
    l_interior = np.zeros((n_parts, f_max), dtype=bool)
    l_area = zeros((n_parts, f_max))
    l_normal = zeros((n_parts, f_max, 3))
    l_normal[:, :, 0] = 1.0
    l_fcent = zeros((n_parts, f_max, 3))
    l_zslot = np.zeros((n_parts, f_max), dtype=np.int64)
    l_lw = zeros((n_parts, f_max))
    l_ron = zeros((n_parts, f_max, 3))
    l_ron[:, :, 0] = 1.0
    l_dist_on = zeros((n_parts, f_max), 1.0)
    l_dist_fo = zeros((n_parts, f_max), 1.0)

    l_ccent = zeros((n_parts, L, 3))
    l_vol = zeros((n_parts, L), 1.0)
    l_cf = np.zeros((n_parts, L, K), dtype=np.int64)
    l_cmask = np.zeros((n_parts, L, K), dtype=bool)
    l_csign = zeros((n_parts, L, K))
    l_cnbr = np.tile(np.arange(L, dtype=np.int64)[None, :, None], (n_parts, 1, K))

    owned_global = np.zeros((n_parts, L), dtype=np.int64)
    owned_mask = np.zeros((n_parts, L), dtype=bool)

    g_area = np.asarray(mesh.face_area)
    g_normal = np.asarray(mesh.face_normal)
    g_fcent = np.asarray(mesh.face_centroid)
    g_zslot = np.asarray(mesh.face_zone_slot, dtype=np.int64)
    g_lw = np.asarray(mesh.face_lw)
    g_ron = np.asarray(mesh.face_r_on)
    g_dist_on = np.asarray(mesh.face_dist_on)
    g_dist_fo = np.asarray(mesh.face_dist_fo)
    g_vol = np.asarray(mesh.cell_volume)

    for p in range(n_parts):
        o = owned[p]
        n_o = len(o)
        owned_global[p, :n_o] = o
        owned_mask[p, :n_o] = True
        # Halo slots also record their global ids (see slab comment).
        owned_global[p, c_max : c_max + len(halos[p])] = halos[p]
        pf = part_faces[p]
        n_f = len(pf)
        face_local = np.full(F, -1, dtype=np.int64)
        face_local[pf] = np.arange(n_f)

        l_owner[p, :n_f] = local_of[p, owner[pf]]
        l_neighbor[p, :n_f] = local_of[p, neighbor[pf]]
        l_interior[p, :n_f] = interior[pf]
        l_area[p, :n_f] = g_area[pf]
        l_normal[p, :n_f] = g_normal[pf]
        l_fcent[p, :n_f] = g_fcent[pf]
        l_zslot[p, :n_f] = g_zslot[pf]
        l_lw[p, :n_f] = g_lw[pf]
        l_ron[p, :n_f] = g_ron[pf]
        l_dist_on[p, :n_f] = g_dist_on[pf]
        l_dist_fo[p, :n_f] = g_dist_fo[pf]

        # Cell geometry for owned + halo slots.
        l_ccent[p, :n_o] = cc[o]
        l_vol[p, :n_o] = g_vol[o]
        hs = halos[p]
        l_ccent[p, c_max : c_max + len(hs)] = cc[hs]
        l_vol[p, c_max : c_max + len(hs)] = g_vol[hs]

        # [L,K] adjacency rows for owned cells.
        lf = face_local[faces_g[o]]  # [n_o, K]; -1 never occurs for
        # valid slots (every face of an owned cell is in part_faces)
        l_cf[p, :n_o] = np.where(mask_g[o], np.maximum(lf, 0), 0)
        l_cmask[p, :n_o] = mask_g[o]
        l_csign[p, :n_o] = sign_g[o]
        l_cnbr[p, :n_o] = np.where(
            mask_g[o],
            local_of[p, nbrs_g[o]],
            np.arange(n_o)[:, None],
        )
        # Boundary slots keep the self-gather convention.
        self_rows = np.arange(n_o)[:, None]
        l_cnbr[p, :n_o] = np.where(
            l_cnbr[p, :n_o] == trash, self_rows, l_cnbr[p, :n_o]
        )

    # --- exchange plan (ring offsets) ---
    send_idx, recv_idx, offsets = _exchange_plan(
        halos, local_of, part_of, n_parts, trash
    )

    f = lambda x: jnp.asarray(x, dtype=dtype)
    i32 = lambda x: jnp.asarray(x, dtype=jnp.int32)
    local_mesh = CompiledMesh(
        face_owner=i32(l_owner),
        face_neighbor=i32(l_neighbor),
        face_interior=jnp.asarray(l_interior),
        face_area=f(l_area),
        face_normal=f(l_normal),
        face_centroid=f(l_fcent),
        face_zone_slot=i32(l_zslot),
        face_lw=f(l_lw),
        face_r_on=f(l_ron),
        face_dist_on=f(l_dist_on),
        face_dist_fo=f(l_dist_fo),
        cell_centroid=f(l_ccent),
        cell_volume=f(l_vol),
        cell_faces=i32(l_cf),
        cell_face_mask=jnp.asarray(l_cmask),
        cell_face_sign=f(l_csign),
        cell_neighbors=i32(l_cnbr),
        dim=mesh.dim,
    )
    return Partition(
        local_mesh=local_mesh,
        owned_global=i32(owned_global),
        owned_mask=jnp.asarray(owned_mask),
        send_idx=tuple(i32(s) for s in send_idx),
        recv_idx=tuple(i32(r) for r in recv_idx),
        offsets=tuple(offsets),
        n_parts=n_parts,
        c_max=c_max,
        h_max=h_max,
    )
