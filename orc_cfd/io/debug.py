"""Human-readable dumps of assembled systems (debug aid).

Counterpart of the reference's matrix/vector pretty-printers
(io.rs:666-820): small systems print densely with aligned columns;
large systems print per-row sparse entries with the diagonal starred.
Operates on ELL matrices (orc_cfd.ops.spmv.EllMatrix).
"""

from __future__ import annotations

import numpy as np


def vector_to_string(v) -> str:
    v = np.asarray(v)
    return "[" + ", ".join(f"{x: >9.2e}" for x in v) + "]"


def print_vec_scientific(v):
    print(vector_to_string(v))


def ell_to_string(A, max_dense_cols: int = 16) -> str:
    """Render an EllMatrix; dense layout below `max_dense_cols`.

    Structured-mesh matrices may omit `neighbors` (the shift-SpMV path
    never reads it); the column targets are reconstructed from the
    static offsets, clipped to in-range rows (out-of-range rolls carry
    zero coefficients by the EllMatrix.offsets contract)."""
    diag = np.asarray(A.diag)
    off = np.asarray(A.off)
    n = diag.shape[-1]
    if A.neighbors is not None:
        nbr = np.asarray(A.neighbors)
    else:
        idx = np.arange(n)[:, None]
        deltas = np.asarray(A.offsets, dtype=np.int64)[None, :]
        nbr = np.clip(idx + deltas, 0, n - 1)
    rows = []
    if n < max_dense_cols:
        dense = np.zeros((n, n))
        for i in range(n):
            dense[i, i] = diag[i]
            for k in range(off.shape[-1]):
                dense[i, nbr[i, k]] += off[i, k]
        for i in range(n):
            cells = [
                f"{dense[i, j]: <9.2e}" if dense[i, j] != 0 else " " * 9
                for j in range(n)
            ]
            rows.append(f"{i}: " + ", ".join(cells))
    else:
        for i in range(n):
            ent = [f"*{i}={diag[i]:.2e}"]
            for k in range(off.shape[-1]):
                if off[i, k] != 0.0:
                    ent.append(f"{nbr[i, k]}={off[i, k]:.2e}")
            rows.append(f"{i}: " + ", ".join(ent))
    return "\n".join(rows)


def linear_system_to_string(A, b, max_dense_cols: int = 16) -> str:
    """Matrix rows alongside the RHS."""
    b = np.asarray(b)
    lines = ell_to_string(A, max_dense_cols).split("\n")
    return "\n".join(
        f"{line} | {b[i]: >9.2e}" for i, line in enumerate(lines)
    )


def print_matrix(A):
    print(ell_to_string(A))


def print_linear_system(A, b):
    print(linear_system_to_string(A, b))
