"""Irregular-mesh SpMV on the slice plan (mesh/reorder.py) and the
plain ELL gather, pinned against a dense NumPy product.

The slice-plan SpMV (ops/spmv.slice_spmv, the XLA formulation every
backend runs) must reproduce the dense matrix-vector product exactly
up to f32 rounding: unbatched, explicit [3,C] batch, jax.vmap (the
production momentum-solve shape), partial last tiles, wide (1024-row)
tiles, empty tiles and a heavily skewed per-tile slice distribution.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from orc_cfd.mesh.reorder import build_slice_plan
from orc_cfd.ops.spmv import EllMatrix, ell_spmv, slice_spmv


def _dense(diag, off, nbrs, x):
    """NumPy reference: dense A @ x for A = diag + scatter(off), over
    any leading batch dims of diag/off/x."""
    C = nbrs.shape[0]
    diag = np.asarray(diag, np.float64)
    off = np.asarray(off, np.float64)
    x = np.asarray(x, np.float64)
    batch = np.broadcast_shapes(diag.shape[:-1], off.shape[:-2], x.shape[:-1])
    A = np.zeros(batch + (C, C))
    A[..., np.arange(C), np.arange(C)] = np.broadcast_to(diag, batch + (C,))
    rows = np.repeat(np.arange(C), nbrs.shape[1])
    offb = np.broadcast_to(off, batch + off.shape[-2:]).reshape(
        batch + (-1,)
    )
    for idx in np.ndindex(*batch):
        np.add.at(A[idx], (rows, nbrs.reshape(-1)), offb[idx])
    return np.einsum("...ij,...j->...i", A, np.broadcast_to(x, batch + (C,)))


def _random_banded(C, K=4, bw=10, seed=0, empty_tiles=()):
    """A random banded ELL sparsity (what RCM produces) + a matching
    slice plan; `empty_tiles` rows get no interior entries at all."""
    rng = np.random.default_rng(seed)
    base = np.arange(C)[:, None]
    nbrs = base + rng.integers(-bw, bw + 1, (C, K))
    valid = (nbrs >= 0) & (nbrs < C) & (nbrs != base)
    t = np.arange(C) // 128
    for et in empty_tiles:
        valid[t == et] = False
    nbrs = np.where(valid, nbrs, base)
    plan = build_slice_plan(nbrs, valid, tile=128)
    assert plan is not None
    off = (rng.standard_normal((C, K)) * valid).astype(np.float32)
    diag = (rng.standard_normal(C) + 5.0).astype(np.float32)
    x = rng.standard_normal(C).astype(np.float32)
    return nbrs, off, diag, x, plan


def _prepared_coef(off, nbrs, plan):
    A = EllMatrix(
        diag=jnp.zeros(off.shape[:-1], off.dtype),
        off=jnp.asarray(off),
        neighbors=jnp.asarray(nbrs),
        plan=plan,
    ).prepare()
    return A.off  # [..., ntiles, n_max, T]


def _slice(diag, off, nbrs, plan, x):
    A = EllMatrix(
        diag=jnp.asarray(diag), off=jnp.asarray(off),
        neighbors=jnp.asarray(nbrs), plan=plan,
    ).prepare()
    return np.asarray(slice_spmv(A.diag, A.off, plan, jnp.asarray(x)))


# C values chosen so the last tile is partial.
@pytest.mark.parametrize("C", [300, 1410])
def test_kernel_matches_gather(C):
    nbrs, off, diag, x, plan = _random_banded(C, seed=C % 97)
    assert C % 128 != 0  # partial last tile exercised
    np.testing.assert_allclose(
        _slice(diag, off, nbrs, plan, x), _dense(diag, off, nbrs, x),
        rtol=2e-5, atol=2e-5,
    )


def test_kernel_batched_explicit():
    """Explicit [3,C] leading batch (the prepared momentum systems)."""
    C = 500
    nbrs, off1, diag1, _, plan = _random_banded(C, seed=2)
    rng = np.random.default_rng(5)
    valid = off1 != 0
    off = (rng.standard_normal((3, C, off1.shape[1])) * valid).astype(
        np.float32
    )
    diag = (rng.standard_normal((3, C)) + 5.0).astype(np.float32)
    x = rng.standard_normal((3, C)).astype(np.float32)
    np.testing.assert_allclose(
        _slice(diag, off, nbrs, plan, x), _dense(diag, off, nbrs, x),
        rtol=2e-5, atol=2e-5,
    )


def test_kernel_under_vmap():
    """jax.vmap over the slice SpMV (how solver/simple.py's batched
    momentum solve reaches it) matches the dense product."""
    C = 400
    nbrs, off1, _, _, plan = _random_banded(C, seed=3)
    rng = np.random.default_rng(7)
    valid = off1 != 0
    off = (rng.standard_normal((3, C, off1.shape[1])) * valid).astype(
        np.float32
    )
    diag = (rng.standard_normal((3, C)) + 5.0).astype(np.float32)
    x = rng.standard_normal((3, C)).astype(np.float32)
    coef = EllMatrix(
        diag=jnp.asarray(diag), off=jnp.asarray(off),
        neighbors=jnp.asarray(nbrs), plan=plan,
    ).prepare().off
    y = jax.vmap(lambda d, c, xi: slice_spmv(d, c, plan, xi))(
        jnp.asarray(diag), coef, jnp.asarray(x)
    )
    np.testing.assert_allclose(
        np.asarray(y), _dense(diag, off, nbrs, x), rtol=2e-5, atol=2e-5
    )


def test_empty_tile_placeholder_stays_local():
    """A tile with zero interior entries gets a placeholder start
    inside its OWN row span (mesh/reorder.py), and the SpMV still
    matches the dense product on such a plan."""
    C = 128 * 12
    empty = (2, 9)
    nbrs, off, diag, x, plan = _random_banded(
        C, bw=10, seed=11, empty_tiles=empty
    )
    starts = np.asarray(plan.starts)
    for et in empty:
        lo = plan.pad_lo + et * 128
        assert np.all(starts[et] >= lo) and np.all(starts[et] <= lo + 128)
    np.testing.assert_allclose(
        _slice(diag, off, nbrs, plan, x), _dense(diag, off, nbrs, x),
        rtol=2e-5, atol=2e-5,
    )


def test_nbr_kernel_matches_gather():
    """The plain ELL gather SpMV (ops/spmv.ell_spmv without offsets,
    what irregular meshes use outside a slice plan) matches the dense
    product — scalar and [3,C] batched, K=6, an empty tile, partial
    last tile."""
    C = 300
    nbrs, off, diag, x, plan = _random_banded(
        C, K=6, bw=6, seed=7, empty_tiles=(1,)
    )
    y = ell_spmv(
        jnp.asarray(diag), jnp.asarray(off), jnp.asarray(nbrs),
        jnp.asarray(x),
    )
    np.testing.assert_allclose(
        np.asarray(y), _dense(diag, off, nbrs, x), rtol=2e-5, atol=2e-5
    )
    x3 = np.random.default_rng(1).standard_normal((3, C)).astype(
        np.float32
    )
    y3 = ell_spmv(
        jnp.asarray(diag), jnp.asarray(off), jnp.asarray(nbrs),
        jnp.asarray(x3),
    )
    np.testing.assert_allclose(
        np.asarray(y3), _dense(diag, off, nbrs, x3), rtol=2e-5, atol=2e-5
    )


def test_wide_tile_kernels_match_gather():
    """tile=1024 plans (mesh/reorder.build_best_slice_plan's wide
    candidate) match the dense product, including a partial last
    tile."""
    C, K, bw = 4196, 4, 6  # 5 tiles, last partial
    rng = np.random.default_rng(21)
    base = np.arange(C)[:, None]
    nbrs = base + rng.integers(-bw, bw + 1, (C, K))
    valid = (nbrs >= 0) & (nbrs < C) & (nbrs != base)
    nbrs = np.where(valid, nbrs, base)
    plan = build_slice_plan(nbrs, valid, tile=1024)
    assert plan is not None and plan.tile == 1024
    off = (rng.standard_normal((C, K)) * valid).astype(np.float32)
    diag = (rng.standard_normal(C) + 5.0).astype(np.float32)
    x = rng.standard_normal(C).astype(np.float32)
    np.testing.assert_allclose(
        _slice(diag, off, nbrs, plan, x), _dense(diag, off, nbrs, x),
        rtol=2e-5, atol=2e-5,
    )


def test_best_plan_selector():
    """build_best_slice_plan picks a valid plan and small meshes stay
    on tile=128 (wide tiles need C >= 4*tile)."""
    from orc_cfd.mesh.reorder import build_best_slice_plan

    C, K = 700, 4
    rng = np.random.default_rng(5)
    base = np.arange(C)[:, None]
    nbrs = base + rng.integers(-8, 9, (C, K))
    valid = (nbrs >= 0) & (nbrs < C) & (nbrs != base)
    nbrs = np.where(valid, nbrs, base)
    plan = build_best_slice_plan(nbrs, valid)
    assert plan is not None and plan.tile == 128


def _skewed_mesh(C=6400, K=6, band=400, seed=3):
    """Adjacency with a heavily skewed per-tile slice-count
    distribution (most tiles few distinct deltas, a tail of many)."""
    rng = np.random.default_rng(seed)
    ntiles = -(-C // 128)
    n_d = np.minimum(2 + rng.geometric(0.2, ntiles), 30)
    max_d = int(n_d.max())
    tile_deltas = rng.integers(-band, band + 1, (ntiles, max_d))
    t_of = np.arange(C) // 128
    pick = rng.integers(0, 10_000, (C, K)) % n_d[t_of][:, None]
    nbrs = np.arange(C)[:, None] + tile_deltas[t_of[:, None], pick]
    valid = (nbrs >= 0) & (nbrs < C) & (rng.random((C, K)) < 0.9)
    nbrs = np.where(valid, np.clip(nbrs, 0, C - 1), np.arange(C)[:, None])
    plan = build_slice_plan(nbrs, valid, tile=128)
    assert plan is not None
    off = (rng.standard_normal((C, K)) * valid).astype(np.float32)
    diag = (rng.standard_normal(C) + 5.0).astype(np.float32)
    x = rng.standard_normal(C).astype(np.float32)
    return nbrs, off, diag, x, plan


def test_heavy_tail_split_exact():
    """A skewed plan (a tail of tiles with many distinct deltas; plain
    gather reference y = diag x + sum_k off x[nbr])."""
    nbrs, off, diag, x, plan = _skewed_mesh()
    assert plan.n_max > 12
    y_ref = diag * x + (off * x[nbrs]).sum(-1)
    np.testing.assert_allclose(
        _slice(diag, off, nbrs, plan, x), y_ref, rtol=2e-5, atol=2e-5
    )


def test_heavy_tail_split_batched():
    """vmapped [3,C] batched SpMV over a skewed plan (the momentum
    path) stays exact."""
    nbrs, off, diag, x, plan = _skewed_mesh(seed=11)
    C = len(diag)
    rng = np.random.default_rng(5)
    x3 = rng.standard_normal((3, C)).astype(np.float32)
    A = EllMatrix(
        diag=jnp.asarray(diag), off=jnp.asarray(off),
        neighbors=jnp.asarray(nbrs), plan=plan,
    ).prepare()
    f = lambda v: slice_spmv(A.diag, A.off, plan, v)
    y = np.asarray(jax.vmap(f)(jnp.asarray(x3)))
    y_ref = diag * x3 + (off[None] * x3[:, nbrs.astype(np.int64)]).sum(-1)
    np.testing.assert_allclose(y, y_ref, rtol=2e-5, atol=2e-5)
