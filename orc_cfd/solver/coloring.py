"""Greedy graph coloring of the cell adjacency (host side).

Gauss-Seidel parallelizes on a device as a multi-color sweep: cells of one
color share no faces, so they update simultaneously with full
Gauss-Seidel semantics. The coloring is computed once per mesh on host
(a bounded-degree greedy pass; K+1 colors suffice).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def greedy_coloring(mesh):
    """Returns (colors [C] i32 device array, n_colors)."""
    nbrs = np.asarray(mesh.cell_neighbors)
    mask = np.asarray(mesh.cell_face_mask) & (
        nbrs != np.arange(nbrs.shape[0])[:, None]
    )
    C, K = nbrs.shape
    colors = np.full(C, -1, dtype=np.int32)
    for c in range(C):
        used = set(colors[nbrs[c][mask[c]]])
        col = 0
        while col in used:
            col += 1
        colors[c] = col
    return jnp.asarray(colors), int(colors.max()) + 1
