"""Mesh geometry derivation (host, vectorized NumPy).

Computes face normals/areas/centroids and cell centroids/volumes from a
parsed `RawMesh`, replicating the reference's geometric definitions
(reference: io.rs:289-438):

- face centroid  = arithmetic mean of its nodes
- face area      = edge length (2D) / triangle fan around the centroid,
                   including the wrap-around pair (3D)
- cell centroid  = arithmetic mean of its face centroids
- cell volume    = sum_f area_f * |(c_f - c_c) . n_f| / dim  (pyramid rule)

One deliberate improvement over the reference: face normals are oriented
*geometrically* so that `+normal` always points out of the owner cell
(checked against the owner-centroid direction), rather than relying on the
TGRID node-ordering convention (reference: io.rs:329-337). The reference's
2D normal construction loses orientation information (io.rs:304-321) and
its boundary flip only triggers when cell 0 is the missing one; the
centroid test is unambiguous for any valid mesh.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from orc_cfd.mesh.tgrid import RawMesh


@dataclasses.dataclass
class Geometry:
    """Derived geometric quantities (host, NumPy)."""

    face_owner: np.ndarray  # [F] int64 — always valid
    face_neighbor: np.ndarray  # [F] int64 — -1 for boundary faces
    face_area: np.ndarray  # [F]
    face_normal: np.ndarray  # [F, 3] unit, outward from owner
    face_centroid: np.ndarray  # [F, 3]
    cell_centroid: np.ndarray  # [C, 3]
    cell_volume: np.ndarray  # [C]
    cell_face_count: np.ndarray  # [C] int64


def derive_geometry(raw: RawMesh) -> Geometry:
    F = raw.n_faces
    C = raw.n_cells
    dim = raw.dim
    pts = raw.points

    counts = np.array([len(x) for x in raw.face_nodes], dtype=np.int64)
    M = int(counts.max())
    # Padded node-index array; padding repeats the first node so padded
    # edge pairs degenerate to zero-length (zero area contribution).
    nodes = np.empty((F, M), dtype=np.int64)
    for f, nl in enumerate(raw.face_nodes):
        nodes[f, : len(nl)] = nl
        nodes[f, len(nl) :] = nl[0]
    # Successor node (cyclic within the first `counts` entries).
    nxt = np.roll(nodes, -1, axis=1)
    ar = np.arange(M)[None, :]
    last = counts[:, None] - 1
    nxt = np.where(ar == last, nodes[:, :1], nxt)
    nxt = np.where(ar > last, nodes[:, :1], nxt)

    p = pts[nodes]  # [F, M, 3]
    face_centroid = p.sum(axis=1)
    # Padding repeats node 0; subtract the extra copies before averaging.
    extra = (M - counts)[:, None] * pts[nodes[:, 0]]
    face_centroid = (face_centroid - extra) / counts[:, None]

    # Raw (unoriented) normals.
    if dim == 2:
        t = pts[nodes[:, 1]] - pts[nodes[:, 0]]
        raw_normal = np.stack(
            [-t[:, 1], t[:, 0], np.zeros(F)], axis=1
        )
        face_area = np.linalg.norm(t, axis=1)
    else:
        v0 = pts[nodes[:, 0]]
        v1 = pts[nodes[:, 1]]
        v2 = pts[nodes[:, 2]]
        raw_normal = np.cross(v2 - v1, v1 - v0)
        # Triangle fan around the centroid over every cyclic edge pair.
        e1 = pts[nodes] - face_centroid[:, None, :]
        e2 = pts[nxt] - face_centroid[:, None, :]
        tri = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=2)
        face_area = tri.sum(axis=1)
    nrm = np.linalg.norm(raw_normal, axis=1, keepdims=True)
    if np.any(nrm == 0):
        bad = np.nonzero(nrm[:, 0] == 0)[0][:5]
        raise ValueError(f"degenerate face normals at faces {bad}")
    raw_normal = raw_normal / nrm

    # Owner/neighbor assignment: the owner is the first cell present.
    c0 = raw.face_cells[:, 0]
    c1 = raw.face_cells[:, 1]
    face_owner = np.where(c0 >= 0, c0, c1)
    face_neighbor = np.where(c0 >= 0, c1, -1)
    if np.any(face_owner < 0):
        raise ValueError("face with no adjacent cell")

    # Cell centroids = mean of adjacent face centroids.
    cell_face_count = np.zeros(C, dtype=np.int64)
    np.add.at(cell_face_count, face_owner, 1)
    interior = face_neighbor >= 0
    np.add.at(cell_face_count, face_neighbor[interior], 1)
    if np.any(cell_face_count < dim + 1):
        raise ValueError("cell has too few faces")
    csum = np.zeros((C, 3))
    np.add.at(csum, face_owner, face_centroid)
    np.add.at(csum, face_neighbor[interior], face_centroid[interior])
    cell_centroid = csum / cell_face_count[:, None]

    # Orient normals outward from the owner cell.
    to_face = face_centroid - cell_centroid[face_owner]
    sgn = np.sign(np.einsum("fi,fi->f", raw_normal, to_face))
    if np.any(sgn == 0):
        bad = np.nonzero(sgn == 0)[0][:5]
        raise ValueError(
            f"cannot orient face normals (owner centroid lies in the face "
            f"plane) at faces {bad}"
        )
    face_normal = raw_normal * sgn[:, None]

    # Cell volumes by the pyramid rule.
    h_owner = np.abs(
        np.einsum(
            "fi,fi->f", face_centroid - cell_centroid[face_owner], face_normal
        )
    )
    h_nbr = np.abs(
        np.einsum(
            "fi,fi->f",
            face_centroid - cell_centroid[np.maximum(face_neighbor, 0)],
            face_normal,
        )
    )
    cell_volume = np.zeros(C)
    np.add.at(cell_volume, face_owner, face_area * h_owner / dim)
    np.add.at(
        cell_volume,
        face_neighbor[interior],
        (face_area * h_nbr / dim)[interior],
    )

    return Geometry(
        face_owner=face_owner,
        face_neighbor=face_neighbor,
        face_area=face_area,
        face_normal=face_normal,
        face_centroid=face_centroid,
        cell_centroid=cell_centroid,
        cell_volume=cell_volume,
        cell_face_count=cell_face_count,
    )
