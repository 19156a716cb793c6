"""The backend decision (orc_cfd.backend), the compile-cache helper, and
the f32 precision contract of the solver graphs.

The hand-written kernels run compiled only on a `gpu` backend and in
interpret mode only on request; every f32 contraction in the SIMPLE
step asks for HIGHEST precision so a GPU cannot silently run it in
TF32.
"""

import os

import jax
import jax.numpy as jnp
import pytest

from orc_cfd import backend


@pytest.mark.parametrize(
    "platform,interpret,want",
    [
        ("gpu", False, "gpu"),
        ("gpu", True, "gpu"),
        ("cpu", False, None),
        ("cpu", True, "interpret"),
        ("rocm", False, None),
    ],
)
def test_kernel_mode(monkeypatch, platform, interpret, want):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert backend.kernel_mode(interpret=interpret) == want


@pytest.mark.parametrize(
    "platform,env,want",
    [
        ("gpu", "1", "compiled"),
        ("gpu", "0", None),
        ("cpu", "1", None),
        ("cpu", "force", "interpret"),
    ],
)
def test_fused_assembly_selection(monkeypatch, platform, env, want):
    """_pallas_asm_spec follows the one predicate: compiled kernels on
    a GPU, interpret mode only under ORC_PALLAS_ASM=force, the XLA ck
    path otherwise."""
    from orc_cfd.models.cavity import cavity_case
    from orc_cfd.ops.ck_ops import build_ck_geometry
    from orc_cfd.solver.simple import _pallas_asm_spec
    from orc_cfd.utils.settings import NumericalSettings, RelaxationMode

    mesh, table = cavity_case(n=8, dtype=jnp.float32)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    settings = NumericalSettings(relaxation_mode=RelaxationMode.IMPLICIT)
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    monkeypatch.setenv("ORC_PALLAS_ASM", env)
    spec = _pallas_asm_spec(mesh, table, settings, ck)
    if want is None:
        assert spec is None
    else:
        assert spec is not None and spec[2] == (want == "interpret")


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the helper configures no
    other directory."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch):
    """Without the variable the cache sits at one fixed, git-ignored
    path inside the checkout."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert backend.setup_compile_cache() == backend.CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == backend.CACHE_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(backend.CACHE_DIR) == root
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _step_hlo(settings, use_ck, fc=False):
    """StableHLO text of one jitted SIMPLE chunk on a small f32 box."""
    from orc_cfd.models.cavity import cavity_case
    from orc_cfd.ops.assembly import diffusion_system
    from orc_cfd.ops.ck_ops import build_ck_geometry, ck_bc, ck_diffusion
    from orc_cfd.ops.fields import device_bc, face_bc
    from orc_cfd.solver.simple import _make_chunk_runner, initial_state

    mesh, table = cavity_case(n=6, dtype=jnp.float32)
    zc, zs, zv = device_bc(table, dtype=mesh.dtype)
    mu = jnp.asarray(0.01, mesh.dtype)
    diff = diffusion_system(mesh, face_bc(mesh, zc, zs, zv), mu)
    ck = ck_diff = None
    if use_ck:
        ck = build_ck_geometry(mesh, len(table.zone_ids))
        ck_diff = ck_diffusion(mesh, ck, ck_bc(ck, zc, zs, zv), mu)
    state = initial_state(mesh)
    if fc:
        import dataclasses

        from orc_cfd.solver.fc import ck_initial_flux
        from orc_cfd.solver.simple import initial_flux

        flux = (
            ck_initial_flux(mesh, ck, ck_bc(ck, zc, zs, zv), settings, state)
            if use_ck
            else initial_flux(mesh, zc, zs, zv, settings, state)
        )
        state = dataclasses.replace(state, flux=flux)
    run = _make_chunk_runner(
        mesh, settings, diff, 1, {}, ck=ck, ck_diff=ck_diff, use_fc=fc
    )
    return jax.jit(run).lower(state, zc, zs, zv, 1.0, mu).as_text()


@pytest.mark.parametrize(
    "scheme,use_ck,fc",
    [
        ("rc_so", False, False),
        ("tvd_dc", False, False),
        ("tvd_dc", True, False),
        ("lsq", True, False),
        ("rc_so", False, True),
    ],
)
def test_f32_contractions_request_highest(scheme, use_ck, fc):
    """Every dot_general of the f32 SIMPLE step (the einsums of
    gradients, interpolation, assembly, ck_ops and fc) carries
    precision HIGHEST."""
    from orc_cfd.utils.settings import (
        GradientReconstruction,
        MatrixSolverSettings,
        MomentumScheme,
        NumericalSettings,
        PressureInterpolation,
        PressureVelocityCoupling,
        SolutionMethod,
        VelocityInterpolation,
        tvd_umist,
    )

    kw = dict(
        pressure_interpolation=PressureInterpolation.SECOND_ORDER,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB, iterations=5
        ),
    )
    if scheme == "tvd_dc":
        kw.update(momentum=MomentumScheme.TVD_DC, tvd_psi=tvd_umist)
    if scheme == "lsq":
        kw.update(
            gradient_reconstruction=GradientReconstruction.LEAST_SQUARES
        )
    if fc:
        kw.update(
            pressure_velocity_coupling=PressureVelocityCoupling.SIMPLE_FC
        )
    hlo = _step_hlo(NumericalSettings(**kw), use_ck, fc)
    dots = [ln for ln in hlo.splitlines() if "dot_general" in ln]
    assert dots, "expected f32 contractions in the step"
    for ln in dots:
        assert "HIGHEST" in ln, ln


def test_initialize_flow_contractions_highest():
    from orc_cfd.models.cavity import cavity_case
    from orc_cfd.solver.init_fields import initialize_flow

    mesh, table = cavity_case(n=6, dtype=jnp.float32)
    jaxpr = jax.make_jaxpr(
        lambda: initialize_flow(mesh, table, 0.01, 1.0, validate=False)
    )()
    dots = [
        e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"
    ]
    assert dots
    for e in dots:
        assert e.params["precision"] == (
            jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST
        ), e
