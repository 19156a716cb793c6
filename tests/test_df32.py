"""Double-float (2xf32) primitives vs true f64 (ops/df32.py).

The claim to pin: df32 SpMV and dots reproduce f64 results to ~2^-45
relative — two orders tighter than plain f32's 2^-24 — using only f32
vector ops. Its speed on the GPU is not measured yet."""

import jax
import numpy as np

import jax.numpy as jnp

from orc_cfd.ops.df32 import (
    df_add,
    df_dot,
    df_from_f64,
    df_mul,
    df_spmv,
    df_sum,
    df_to_f64,
)
from orc_cfd.ops.spmv import ell_spmv


def _rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    # wide dynamic range to exercise the low words
    return jnp.asarray(
        rng.standard_normal(shape)
        * np.exp(rng.uniform(-8, 8, shape))
        * scale,
        jnp.float64,
    )


def test_df_mul_add_roundtrip():
    a = _rand((4096,), 0)
    b = _rand((4096,), 1)
    ah, al = df_from_f64(a)
    bh, bl = df_from_f64(b)
    assert float(jnp.max(jnp.abs(df_to_f64(ah, al) - a) / jnp.abs(a))) < 2e-15
    mh, ml = df_mul(ah, al, bh, bl)
    rel = np.asarray(jnp.abs(df_to_f64(mh, ml) - a * b) / jnp.abs(a * b))
    assert rel.max() < 1e-13, rel.max()
    sh, sl = df_add(ah, al, bh, bl)
    denom = jnp.maximum(jnp.abs(a + b), 1e-300)
    rel = np.asarray(jnp.abs(df_to_f64(sh, sl) - (a + b)) / denom)
    # cancellation rows only keep the f32-pair information of inputs
    assert np.median(rel) < 1e-14


def test_df_dot_vs_f64():
    x = _rand((10000,), 2)
    y = _rand((10000,), 3)
    want = float(jnp.sum(x * y))
    xh, xl = df_from_f64(x)
    yh, yl = df_from_f64(y)
    h, l = df_dot(xh, xl, yh, yl)
    got = float(df_to_f64(h, l))
    rel = abs(got - want) / abs(want)
    f32 = abs(float(jnp.sum(x.astype(jnp.float32) * y.astype(jnp.float32))) - want) / abs(want)
    assert rel < 1e-12, (rel, f32)
    assert rel < 1e-4 * max(f32, 1e-30) or f32 < 1e-12  # orders tighter than f32


def test_df_sum_exact_errors():
    # adversarial: large + tiny values whose f32 sum loses everything
    big = jnp.full((512,), 1.0, jnp.float32)
    tiny = jnp.full((512,), 1e-8, jnp.float32)
    p = jnp.concatenate([big, tiny])
    h, l = df_sum(p)
    want = 512.0 + 512e-8
    got = float(h) + float(l)
    assert abs(got - want) / want < 1e-12


def test_df_spmv_vs_f64_shift():
    C, K = 8192, 4
    offsets = (-64, -1, 1, 64)
    diag = _rand((C,), 4, 4.0)
    off = _rand((C, K), 5)
    x = _rand((C,), 6)
    want = np.asarray(ell_spmv(diag, off, None, x, offsets))
    dh, dl = df_from_f64(diag)
    oh, ol = df_from_f64(off)
    xh, xl = df_from_f64(x)
    yh, yl = df_spmv(dh, dl, oh, ol, offsets, xh, xl)
    got = np.asarray(df_to_f64(yh, yl))
    f32 = np.asarray(
        ell_spmv(
            diag.astype(jnp.float32),
            off.astype(jnp.float32),
            None,
            x.astype(jnp.float32),
            offsets,
        )
    ).astype(np.float64)
    scale = np.abs(want) + np.abs(diag) * np.abs(x) + 1e-300
    rel_df = np.abs(got - want) / scale
    rel_f32 = np.abs(f32 - want) / scale
    # worst rows (heavy cancellation under the e^16 dynamic range)
    # keep ~2^-34; typical rows keep ~2^-50
    assert rel_df.max() < 1e-9, rel_df.max()
    assert np.median(rel_df) < 1e-14, np.median(rel_df)
    # at least 1e4x tighter than plain f32 on this data
    assert np.median(rel_df) < 1e-4 * np.median(rel_f32)


# --- round 5: df32 iterative refinement (solver/refine.py) ---


def _banded_system(C=2000, K=4, seed=0, band=40):
    """Diagonally-dominant f64 system over a random banded adjacency
    with a slice plan (the irregular-mesh matrix shape)."""
    from orc_cfd.mesh.reorder import build_slice_plan
    from orc_cfd.ops.spmv import EllMatrix

    rng = np.random.default_rng(seed)
    nbrs = np.clip(
        np.arange(C)[:, None] + rng.integers(-band, band, (C, K)), 0, C - 1
    )
    valid = nbrs != np.arange(C)[:, None]
    plan = build_slice_plan(nbrs, valid, tile=128)
    assert plan is not None
    off = rng.standard_normal((C, K)) * valid * 0.2
    diag = np.abs(off).sum(1) + rng.uniform(1.0, 2.0, C)
    A = EllMatrix(
        diag=jnp.asarray(diag), off=jnp.asarray(off),
        neighbors=jnp.asarray(nbrs), offsets=None, plan=plan,
    )
    x_true = rng.standard_normal(C)
    return A, jnp.asarray(x_true), A.matvec(jnp.asarray(x_true))


def _ir_settings():
    from orc_cfd.utils.settings import (
        MatrixSolverSettings,
        PreconditionMethod,
        SolutionMethod,
        SolverPrecision,
    )

    return MatrixSolverSettings(
        solver_type=SolutionMethod.BICGSTAB,
        iterations=100,
        relative_convergence_threshold=1e-8,
        preconditioner=PreconditionMethod.JACOBI,
        precision=SolverPrecision.DF32_IR,
    )


def test_df32_ir_slice_plan_accuracy():
    """DF32_IR on an irregular (slice-plan) f64 system reaches f64-level
    accuracy with plain-f32 inner solves (solver/refine.py)."""
    from orc_cfd.solver.krylov import iterative_solve

    A, x_true, b = _banded_system()
    x, info = iterative_solve(A, b, jnp.zeros_like(b), _ir_settings())
    assert x.dtype == b.dtype
    err = np.abs(np.asarray(x) - np.asarray(x_true)).max()
    err /= np.abs(np.asarray(x_true)).max()
    assert err < 1e-11, err
    assert not bool(info.diverged)


def test_df32_ir_structured_accuracy():
    """DF32_IR on a structured (shift-offset) f64 system."""
    from orc_cfd.mesh import structured_box_mesh
    from orc_cfd.ops.spmv import EllMatrix
    from orc_cfd.solver.krylov import iterative_solve

    mesh, _ = structured_box_mesh(32, 32, 1)
    rng = np.random.default_rng(3)
    C = mesh.n_cells
    interior = np.asarray(
        mesh.face_interior[mesh.cell_faces] & mesh.cell_face_mask
    )
    off = rng.standard_normal(interior.shape) * interior * 0.2
    A = EllMatrix(
        diag=jnp.asarray(np.abs(off).sum(1) + 1.5),
        off=jnp.asarray(off),
        neighbors=None,
        offsets=mesh.neighbor_offsets,
    )
    x_true = rng.standard_normal(C)
    b = A.matvec(jnp.asarray(x_true))
    x, info = iterative_solve(A, b, jnp.zeros_like(b), _ir_settings())
    err = np.abs(np.asarray(x) - x_true).max() / np.abs(x_true).max()
    assert err < 1e-11, err


def test_df32_ir_batched_vmap():
    """DF32_IR under jax.vmap (the [3,C] batched momentum solve
    shape)."""
    from orc_cfd.solver.krylov import iterative_solve

    A, x_true, b = _banded_system(C=1000, seed=7)
    b3 = jnp.stack([b, 2.0 * b, -b])
    xs, info = jax.vmap(
        lambda bb: iterative_solve(
            A, bb, jnp.zeros_like(bb), _ir_settings()
        )
    )(b3)
    scale = jnp.asarray([1.0, 2.0, -1.0])[:, None]
    ref = scale * x_true[None, :]
    err = np.abs(np.asarray(xs) - np.asarray(ref)).max()
    err /= np.abs(np.asarray(ref)).max()
    assert err < 1e-11, err

