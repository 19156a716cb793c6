"""Node (vertex) interpolation tables for node-based Green-Gauss.

The reference enumerates a NodeBased Green-Gauss variant but panics on
it (solver.rs:901, lib.rs:148-162); this implements it. Cell values are
interpolated to mesh vertices by inverse-distance weighting, vertex
values are averaged to face values, and the standard Green-Gauss loop
runs on those face values — the classic remedy for the cell-based
scheme's skewness error on non-orthogonal meshes.

Static-shape discipline: both interpolation stages are padded fixed-width
gather-reduce tables ([N, Kn] cells-per-node, [F, Kf] nodes-per-face),
built once on the host from the parsed RawMesh. Gradients run once per
outer SIMPLE iteration (never inside Krylov inner loops), so the
gathers here are off the critical path.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from orc_cfd.ops.layout import take
import numpy as np

from orc_cfd.mesh.tgrid import RawMesh


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NodeInterp:
    node_cells: jax.Array  # [N,Kn] i32 (0 at padded slots)
    node_w: jax.Array  # [N,Kn] IDW weights, normalized, 0 padded
    face_nodes: jax.Array  # [F,Kf] i32 (0 at padded slots)
    face_node_w: jax.Array  # [F,Kf] 1/n_nodes(f), 0 padded

    @property
    def n_nodes(self) -> int:
        return self.node_cells.shape[0]


def build_node_interp(
    raw: RawMesh, cell_centroid: np.ndarray, dtype=jnp.float64
) -> NodeInterp:
    """Host-side build of the two padded interpolation tables."""
    N = raw.points.shape[0]
    F = raw.n_faces
    cc = np.asarray(cell_centroid, dtype=np.float64)

    # node -> adjacent cells (via the faces that carry each node).
    adj = [set() for _ in range(N)]
    for f in range(F):
        c0, c1 = raw.face_cells[f]
        for n in raw.face_nodes[f]:
            if c0 >= 0:
                adj[n].add(int(c0))
            if c1 >= 0:
                adj[n].add(int(c1))
    kn = max((len(s) for s in adj), default=1)
    node_cells = np.zeros((N, kn), dtype=np.int64)
    node_w = np.zeros((N, kn), dtype=np.float64)
    pts = np.asarray(raw.points, dtype=np.float64)
    for n, cells in enumerate(adj):
        if not cells:
            continue  # orphan node: zero weights, contributes nothing
        cs = np.fromiter(cells, dtype=np.int64)
        d = np.linalg.norm(cc[cs] - pts[n], axis=1)
        w = 1.0 / np.maximum(d, 1e-300)
        node_cells[n, : len(cs)] = cs
        node_w[n, : len(cs)] = w / w.sum()

    kf = max(len(fn) for fn in raw.face_nodes)
    face_nodes = np.zeros((F, kf), dtype=np.int64)
    face_node_w = np.zeros((F, kf), dtype=np.float64)
    for f, fn in enumerate(raw.face_nodes):
        face_nodes[f, : len(fn)] = fn
        face_node_w[f, : len(fn)] = 1.0 / len(fn)

    return NodeInterp(
        node_cells=jnp.asarray(node_cells, dtype=jnp.int32),
        node_w=jnp.asarray(node_w, dtype=dtype),
        face_nodes=jnp.asarray(face_nodes, dtype=jnp.int32),
        face_node_w=jnp.asarray(face_node_w, dtype=dtype),
    )


def node_face_values(ni: NodeInterp, phi):
    """Cell field -> face values via vertices.

    phi: [C] -> [F];  [C,3] -> [F,3].
    """
    if phi.ndim == 1:
        phi_n = (take(phi, ni.node_cells) * ni.node_w).sum(axis=1)  # [N]
        return (take(phi_n, ni.face_nodes) * ni.face_node_w).sum(axis=1)
    phi_n = (take(phi, ni.node_cells) * ni.node_w[..., None]).sum(axis=1)  # [N,3]
    return (take(phi_n, ni.face_nodes) * ni.face_node_w[..., None]).sum(axis=1)
