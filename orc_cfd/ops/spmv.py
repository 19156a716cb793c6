"""ELL sparse matrix-vector products.

The fixed mesh adjacency gives every assembled system the same sparsity:
one diagonal + up to K off-diagonals per row, aligned with
`mesh.cell_neighbors` (the fixed-width replacement for the reference's
CSR matrices with in-place value overwrite, discretization.rs:450-472).

`EllMatrix` supports leading batch dimensions — the three momentum
systems (shared sparsity, different coefficients) are solved as one
batched [3, C] solve.

The implementation is pure XLA (shift or gather + multiply + reduce,
which XLA fuses into the surrounding solver iteration).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """A = diag(diag) + scatter(off) over a shared neighbor table.

    diag: [..., C];  off: [..., C, K];  neighbors: [C, K] i32 with
    self-indices at padded/boundary slots (their `off` must be 0).

    `offsets`: static per-column index deltas when the adjacency is
    *structured* (neighbors[c, k] == c + offsets[k] wherever off != 0,
    detected at mesh-compile time). With offsets set, the SpMV gather
    degenerates to K circular shifts — pure elementwise work that XLA
    fuses into the surrounding Krylov iteration, eliminating the gather
    and (at small mesh sizes) most of the dispatch-latency floor.
    Wrap-around entries are safe by construction: any row whose
    neighbor is not exactly c + offsets[k] carries a zero coefficient.

    `plan` (irregular meshes, mesh/reorder.py): a per-tile distinct-
    delta slice schedule. `prepare()` converts `off` once per solve
    into the slice-column layout [..., ntiles, n_max, T]
    (`slice_layout=True`), after which matvec runs gather-free on
    contiguous dynamic slices — the path for meshes with no structured
    offsets.
    """

    diag: jax.Array
    off: "jax.Array | tuple"
    neighbors: jax.Array
    offsets: tuple | None = dataclasses.field(
        default=None, metadata=dict(static=True)
    )
    plan: "object | None" = None
    slice_layout: bool = dataclasses.field(
        default=False, metadata=dict(static=True)
    )

    @property
    def n(self) -> int:
        return self.diag.shape[-1]

    def matvec(self, x):
        """A @ x for x of shape [..., C] (batch dims broadcast)."""
        if self.slice_layout:
            return slice_spmv(self.diag, self.off, self.plan, x)
        return ell_spmv(self.diag, self.off, self.neighbors, x, self.offsets)

    def split_columns(self) -> "EllMatrix":
        """Pre-slice `off` into its K per-offset columns (a K-tuple of
        [..., C] arrays) BEFORE entering a solver loop.

        XLA does not hoist loop-invariant slices out of a
        `lax.while_loop` body, so `off[..., k]` would be re-sliced (a
        strided copy of the minor-dim-K array) on every iteration.
        Splitting once per solve moves those copies out of the loop;
        the shift SpMV then reads loop-invariant contiguous vectors.

        Zero-offset slots are DROPPED: a d == 0 entry marks a padded
        ELL column that is never active (a real self-neighbor lives on
        the diagonal, so mesh compilation assigns 0 only to slots with
        identically-zero coefficients — e.g. the two unused K=6 slots
        of a 2D mesh). Dropping them removes their dead coefficient
        reads from every SpMV of the solve.

        Only meaningful for structured-offsets matrices (the slice-plan
        path converts layouts in `prepare()` instead). No-op if already
        split."""
        if self.offsets is None or isinstance(self.off, tuple):
            return self
        keep = [k for k, d in enumerate(self.offsets) if int(d) != 0]
        return EllMatrix(
            diag=self.diag,
            off=tuple(self.off[..., k] for k in keep),
            neighbors=self.neighbors,
            offsets=tuple(self.offsets[k] for k in keep),
            plan=self.plan,
            slice_layout=self.slice_layout,
        )

    def prepare(self) -> "EllMatrix":
        """One-time (per solve) conversion to the slice-column layout
        when a slice plan exists; amortized over the solve's dozens of
        SpMVs. No-op otherwise.

        The [C,K] -> [C,n_max] routing is a K-way one-hot select
        accumulation whose SUM is exactly scatter-add-equivalent —
        including when two interior slots of a row share a delta (e.g.
        duplicated face pairs): their coefficients land in the same
        (c, j) and add, just as a scatter-add would merge them. No
        distinct-delta precondition is needed for correctness; delta
        distinctness only determines whether coefficients merge into
        one slice column. The elementwise form avoids an XLA
        scatter."""
        if self.plan is None or self.slice_layout:
            return self
        p = self.plan
        C, K = self.neighbors.shape
        batch = self.off.shape[:-2]
        iota_j = jnp.arange(p.n_max, dtype=p.col_of.dtype)[None, :]
        coef = jnp.zeros((*batch, C, p.n_max), self.off.dtype)
        for k in range(K):
            coef = coef + jnp.where(
                p.col_of[:, k : k + 1] == iota_j,
                self.off[..., :, k : k + 1],
                0.0,
            )
        cpad = p.ntiles * p.tile - C
        coef = jnp.pad(
            coef, [(0, 0)] * len(batch) + [(0, cpad), (0, 0)]
        ).reshape(*batch, p.ntiles, p.tile, p.n_max)
        coef = jnp.swapaxes(coef, -1, -2)  # [..., ntiles, n_max, T]
        return EllMatrix(
            diag=self.diag,
            off=coef,
            neighbors=self.neighbors,
            offsets=None,
            plan=p,
            slice_layout=True,
        )

    def with_values(self, diag, off) -> "EllMatrix":
        return EllMatrix(
            diag=diag,
            off=off,
            neighbors=self.neighbors,
            offsets=self.offsets,
            plan=self.plan,
            slice_layout=self.slice_layout,
        )

    def jacobi_preconditioned(self):
        """Return (D^-1 A, D^-1) applied form: scales rows by 1/diag
        (reference: linear_algebra.rs:157-168)."""
        inv_d = 1.0 / self.diag
        if self.slice_layout:
            p = self.plan
            batch = self.diag.shape[:-1]
            cpad = p.ntiles * p.tile - p.n_cells
            inv_d_t = jnp.pad(
                inv_d, [(0, 0)] * len(batch) + [(0, cpad)]
            ).reshape(*batch, p.ntiles, 1, p.tile)
            off_scaled = self.off * inv_d_t
        elif isinstance(self.off, tuple):
            off_scaled = tuple(o * inv_d for o in self.off)
        else:
            off_scaled = self.off * inv_d[..., None]
        return (
            EllMatrix(
                diag=jnp.ones_like(self.diag),
                off=off_scaled,
                neighbors=self.neighbors,
                offsets=self.offsets,
                plan=self.plan,
                slice_layout=self.slice_layout,
            ),
            inv_d,
        )


def ell_spmv(diag, off, neighbors, x, offsets=None):
    """y = diag * x + sum_k off[..., k] * x[..., neighbors[:, k]].

    With static `offsets`, neighbor gathers become circular shifts
    (see EllMatrix.offsets)."""
    if offsets is not None:
        y = diag * x
        for k, d in enumerate(offsets):
            xk = jnp.roll(x, -d, axis=-1) if d != 0 else x
            col = off[k] if isinstance(off, tuple) else off[..., k]
            y = y + col * xk
        return y
    xg = x[..., neighbors]  # [..., C, K]
    return diag * x + jnp.sum(off * xg, axis=-1)


def slice_spmv(diag, coef, plan, x):
    """Gather-free SpMV over a slice plan (mesh/reorder.py).

    coef: [..., ntiles, n_max, T] slice-column coefficients (from
    EllMatrix.prepare()); x: [..., C]. XLA lowers the vmapped
    dynamic_slice to a gather with slice_sizes=(T,).
    """
    from jax import lax

    T, C = plan.tile, plan.n_cells
    batch = x.shape[:-1]
    xp = jnp.pad(
        x, [(0, 0)] * len(batch) + [(plan.pad_lo, plan.pad_hi)]
    )

    def one(s):
        return lax.dynamic_slice_in_dim(xp, s, T, axis=-1)  # [..., T]

    g = jax.vmap(jax.vmap(one))(plan.starts)  # [ntiles, n_max, ..., T]
    if batch:
        g = jnp.moveaxis(g, tuple(range(2, 2 + len(batch))), tuple(range(len(batch))))
    # [..., ntiles, n_max, T] — matches coef's layout elementwise.
    y_off = jnp.sum(coef * g, axis=-2)  # [..., ntiles, T]
    y_off = y_off.reshape(*batch, plan.ntiles * T)[..., :C]
    return diag * x + y_off
