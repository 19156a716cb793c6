"""Fixed-count damped Jacobi smoother (krylov.jacobi_smooth_solve).

Equivalence pins: the XLA sweep loop on structured-offset systems must
reproduce a dense NumPy Jacobi iteration — batched and unbatched, 2D
and 3D offset patterns, offsets wider than 128 cells, sweep
counts 1-6 — and split_columns' zero-offset pruning must not change
any SpMV result.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from orc_cfd.ops.spmv import EllMatrix
from orc_cfd.solver.krylov import jacobi_smooth_solve


def _structured_system(C, offsets, B=0, dtype=jnp.float32, seed=0):
    """Random diagonally-dominant system honoring the offsets contract
    (off == 0 wherever c + d strays outside [0, C))."""
    rng = np.random.default_rng(seed)
    K = len(offsets)
    off = rng.uniform(-1.0, 0.0, size=(C, K))
    c = np.arange(C)
    for k, d in enumerate(offsets):
        if d == 0:
            off[:, k] = 0.0
        else:
            off[((c + d) < 0) | ((c + d) >= C), k] = 0.0
    diag = 1.0 + np.abs(off).sum(axis=1) + rng.random(C)
    shape = (B, C) if B else (C,)
    b = rng.standard_normal(shape)
    x0 = rng.standard_normal(shape)
    return (
        jnp.asarray(diag, dtype),
        jnp.asarray(off, dtype),
        jnp.asarray(b, dtype),
        jnp.asarray(x0, dtype),
    )


def _dense_sweeps(diag, off, offsets, b, x0, sweeps, relaxation):
    """NumPy reference: `sweeps` damped-Jacobi steps
    x <- w D^-1 (b - (A - D) x) + (1 - w) x on the dense matrix."""
    diag = np.asarray(diag, np.float64)
    off = np.asarray(off, np.float64)
    C = diag.shape[0]
    A = np.diag(diag)
    c = np.arange(C)
    for k, d in enumerate(offsets):
        ok = (c + d >= 0) & (c + d < C) & (d != 0)
        A[c[ok], c[ok] + d] += off[ok, k]
    R = A - np.diag(diag)
    x = np.asarray(x0, np.float64)
    b = np.asarray(b, np.float64)
    for _ in range(sweeps):
        x = relaxation * (b - x @ R.T) / diag + (1.0 - relaxation) * x
    return x


def _smooth(diag, off, offsets, b, x0, sweeps, relaxation):
    A = EllMatrix(diag=diag, off=off, neighbors=None, offsets=offsets)
    return jacobi_smooth_solve(A, b, x0, sweeps, relaxation)[0]


@pytest.mark.parametrize(
    "offsets,sweeps",
    [
        ((-40, -1, 1, 40), 1),
        ((-40, -1, 1, 40), 6),
        ((-40, -1, 1, 40, 0, 0), 4),  # 2D mesh with padded K=6 slots
        ((-1600, -40, -1, 1, 40, 1600), 3),  # 3D-like pattern
        ((-130, -1, 1, 130), 5),  # |d| wider than 128 cells
    ],
)
def test_kernel_matches_xla_sweeps(offsets, sweeps):
    C = 2100
    diag, off, b, x0 = _structured_system(C, offsets, B=3, seed=1)
    y = jax.vmap(
        lambda bb, xx: _smooth(diag, off, offsets, bb, xx, sweeps, 0.8)
    )(b, x0)
    for i in range(3):
        y_ref = _dense_sweeps(diag, off, offsets, b[i], x0[i], sweeps, 0.8)
        np.testing.assert_allclose(
            np.asarray(y[i]), y_ref, rtol=2e-5, atol=2e-5
        )


def test_unbatched_and_dispatch():
    offsets = (-64, -1, 1, 64)
    C = 4096
    diag, off, b, x0 = _structured_system(C, offsets, seed=2)
    y = _smooth(diag, off, offsets, b, x0, 4, 0.7)
    y_ref = _dense_sweeps(diag, off, offsets, b, x0, 4, 0.7)
    np.testing.assert_allclose(np.asarray(y), y_ref, rtol=2e-5, atol=2e-5)


def test_split_columns_drops_zero_offsets():
    offsets = (-40, -1, 1, 40, 0, 0)
    C = 1000
    diag, off, b, x0 = _structured_system(C, offsets, seed=4)
    A = EllMatrix(
        diag=diag, off=off, neighbors=None, offsets=offsets
    )
    S = A.split_columns()
    assert isinstance(S.off, tuple)
    assert len(S.off) == 4 and S.offsets == (-40, -1, 1, 40)
    np.testing.assert_allclose(
        np.asarray(S.matvec(x0)), np.asarray(A.matvec(x0)), rtol=1e-6
    )
    # Preconditioning on the split form matches preconditioning then
    # splitting.
    P1, inv1 = S.jacobi_preconditioned()
    P2, inv2 = A.jacobi_preconditioned()
    np.testing.assert_allclose(
        np.asarray(P1.matvec(x0)),
        np.asarray(P2.matvec(x0)),
        rtol=1e-6,
    )


def test_vmap_shared_matrix_routes_batched():
    """jax.vmap over the smoother with a shared matrix (the momentum
    solve's shape in solver/simple.py) matches the dense reference
    per component."""
    offsets = (-48, -1, 1, 48)
    C = 2304
    diag, off, b3, x3 = _structured_system(C, offsets, B=3, seed=5)
    A = EllMatrix(diag=diag, off=off, neighbors=None, offsets=offsets)
    y = jax.vmap(
        lambda bb, xx: jacobi_smooth_solve(A, bb, xx, 5, 0.75)[0]
    )(b3, x3)
    for i in range(3):
        y_ref = _dense_sweeps(diag, off, offsets, b3[i], x3[i], 5, 0.75)
        np.testing.assert_allclose(
            np.asarray(y[i]), y_ref, rtol=2e-5, atol=2e-5
        )
