"""Cell reordering + slice-plan construction for irregular meshes.

The structured fast path (EllMatrix.offsets -> circular-shift SpMV)
requires every ELL column to have a constant neighbor index delta.
Genuinely irregular meshes (the reference's native mesh class,
io.rs:32-515 / mesh.rs:140-179) have no such structure, so their
SpMV is an element gather.

This module gives ANY mesh a locality-preserving layout:

1. **Reverse Cuthill-McKee ordering** bounds the adjacency bandwidth to
   ~O(sqrt(C)) for planar / O(C^(2/3)) for volumetric meshes: after
   reordering, every neighbor of cell c lies within a small index
   window of c.
2. **Slice plan**: cells are grouped into tiles of T consecutive rows.
   Within one tile the (neighbor - cell) deltas concentrate onto a few
   dozen distinct values (measured: ~33 distinct deltas per 128-row
   tile on a 100k-cell random-triangulated box, vs 786 globally). The
   SpMV then becomes, per tile, a sum over its distinct deltas d of

       y[tile] += coef_d[tile] * x[tile_start + d : tile_start + d + T]

   i.e. *contiguous dynamic slices* of x (gather-with-slice-size-T)
   times dense coefficient columns -- no element gather anywhere, and
   coverage of every matrix
   entry is exact by construction (out-of-range slice starts are
   absorbed by zero padding of x).

The reference has no counterpart (its CSR SpMV is cache-friendly on
CPU regardless of ordering). RCM ordering also keeps the plain gather
SpMV cache-local.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SlicePlan:
    """Static per-tile slice schedule for an ELL matrix.

    starts:  [ntiles, n_max] i32 -- start of each slice in the PADDED
             x vector (pad_lo zeros prepended); unused columns repeat
             the tile's first used start and carry zero coefficients.
    col_of:  [C, K] i32 -- slice column j of each ELL entry (tile-local);
             boundary/padded entries map to column 0, where their zero
             coefficients are harmlessly accumulated.
    """

    starts: jax.Array
    col_of: jax.Array
    tile: int = dataclasses.field(metadata=dict(static=True))
    n_max: int = dataclasses.field(metadata=dict(static=True))
    pad_lo: int = dataclasses.field(metadata=dict(static=True))
    pad_hi: int = dataclasses.field(metadata=dict(static=True))
    n_cells: int = dataclasses.field(metadata=dict(static=True))

    @property
    def ntiles(self) -> int:
        return self.starts.shape[0]


def rcm_permutation(
    cell_neighbors: np.ndarray, entry_interior: np.ndarray
) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of the cell adjacency graph.

    Returns `order` with order[new_id] = old_id. Starts each connected
    component from a minimum-degree vertex (the standard heuristic).
    """
    C, K = cell_neighbors.shape
    # CSR adjacency from the ELL table (interior entries only).
    # np.nonzero is row-major, so the entries are already grouped by
    # row in order — `nbr` IS the CSR data array.
    rows, cols = np.nonzero(entry_interior)
    nbr = cell_neighbors[rows, cols]
    deg = np.zeros(C, dtype=np.int64)
    np.add.at(deg, rows, 1)
    starts = np.zeros(C + 1, dtype=np.int64)
    np.cumsum(deg, out=starts[1:])
    adj = nbr

    try:
        # C-speed RCM; the pure-numpy BFS below is the fallback (and
        # the behavioral spec). Any valid RCM ordering works — callers
        # only rely on bandwidth reduction, not the exact permutation.
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        a = csr_matrix(
            (np.ones(len(adj), np.int8), adj, starts), shape=(C, C)
        )
        return np.asarray(
            reverse_cuthill_mckee(a, symmetric_mode=True), dtype=np.int64
        )
    except ImportError:  # pragma: no cover
        pass

    visited = np.zeros(C, dtype=bool)
    order = np.empty(C, dtype=np.int64)
    pos = 0
    for start in np.argsort(deg, kind="stable"):
        if visited[start]:
            continue
        visited[start] = True
        head = pos
        order[pos] = start
        pos += 1
        while head < pos:
            u = order[head]
            head += 1
            cand = adj[starts[u] : starts[u + 1]]
            cand = cand[~visited[cand]]
            if len(cand):
                cand = np.unique(cand)  # sorted, dedup
                cand = cand[np.argsort(deg[cand], kind="stable")]
                n = len(cand)
                order[pos : pos + n] = cand
                visited[cand] = True
                pos += n
    assert pos == C
    return order[::-1].copy()


def build_slice_plan(
    cell_neighbors: np.ndarray,
    entry_interior: np.ndarray,
    tile: int = 128,
) -> SlicePlan | None:
    """Build the per-tile distinct-delta slice schedule.

    Returns None when the plan would be degenerate (bandwidth so large
    that n_max slices per tile exceed the tile size -- then the plan
    has no advantage over a plain gather).
    """
    import jax.numpy as jnp

    C, K = cell_neighbors.shape
    ntiles = -(-C // tile)
    delta = cell_neighbors.astype(np.int64) - np.arange(C)[:, None]
    rows, cols = np.nonzero(entry_interior)
    if len(rows) == 0:
        return None
    t = rows // tile
    d = delta[rows, cols]
    # Unique (tile, delta) pairs; tile-local column = rank of delta
    # within its tile's sorted distinct set.
    pair = np.stack([t, d], axis=1)
    uniq, inverse = np.unique(pair, axis=0, return_inverse=True)
    ut, ud = uniq[:, 0], uniq[:, 1]
    tile_first = np.searchsorted(ut, np.arange(ntiles))
    j_of_pair = np.arange(len(uniq)) - tile_first[ut]
    counts = np.bincount(ut, minlength=ntiles)
    n_max = int(counts.max())
    if n_max > tile:
        return None

    col_of = np.zeros((C, K), dtype=np.int64)
    col_of[rows, cols] = j_of_pair[inverse]

    # Slice for (tile t, column j) covers padded indices
    # [pad_lo + t*tile + d, + tile); choose pads so every start and end
    # is in range. Unused columns -> start 0, coef 0.
    raw_start = ut * tile + ud
    pad_lo = int(max(0, -raw_start.min()))
    # Padded length pad_lo + C + pad_hi must cover the furthest slice
    # end pad_lo + raw_start.max() + tile.
    pad_hi = int(max(0, raw_start.max() + tile - C))
    # Unused columns repeat the tile's first used start (zero
    # coefficients make them no-ops); tiles with NO interior entries
    # get a placeholder inside their own row span.
    own_span = pad_lo + np.minimum(
        np.arange(ntiles, dtype=np.int64) * tile, max(0, C - tile)
    )
    first_start = own_span
    has = counts > 0
    first_start[has] = raw_start[tile_first[has]] + pad_lo
    starts = np.broadcast_to(
        first_start[:, None], (ntiles, n_max)
    ).copy()
    starts[ut, j_of_pair] = raw_start + pad_lo

    return SlicePlan(
        starts=jnp.asarray(starts, jnp.int32),
        col_of=jnp.asarray(col_of, jnp.int32),
        tile=tile,
        n_max=n_max,
        pad_lo=pad_lo,
        pad_hi=pad_hi,
        n_cells=C,
    )


def build_best_slice_plan(
    cell_neighbors: np.ndarray,
    entry_interior: np.ndarray,
    tiles=(128, 1024),
) -> SlicePlan | None:
    """Build slice plans at the candidate tile widths and keep the one
    with the lowest modeled cost per cell: n_max slices per tile, each
    costing a fixed issue overhead plus its share of the [n_max, tile]
    coefficient block. Wider tiles amortize the per-slice overhead at
    the price of a larger per-tile distinct-delta set."""
    C = cell_neighbors.shape[0]
    best, best_cost = None, None
    for tile in tiles:
        if tile != 128 and C < 4 * tile:
            continue
        plan = build_slice_plan(
            cell_neighbors, entry_interior, tile=tile
        )
        if plan is None:
            continue
        T = tile // 128
        n_eff = plan.n_max
        instr = n_eff * (2 + -(-(T + 1) // 8) + -(-T // 8))
        instr += n_eff * T * 16 // 8  # coef traffic
        cost = instr / tile  # per cell
        if best_cost is None or cost < best_cost:
            best, best_cost = plan, cost
    return best
