"""Flux-corrected SIMPLE (solver/fc.py, PressureVelocityCoupling.SIMPLE_FC).

The properties that define the scheme, each pinned here:
- conservative by construction: the stored face flux is divergence-free
  to solver tolerance EVERY iteration;
- converges to the SAME discrete solution as the parity loop when the
  Rhie-Chow flux closes both (the pressure-equation coefficient IS the
  Rhie-Chow damping coefficient);
- stable at pressure_relaxation 0.3 under implicit momentum relaxation
  (the parity loop needs 0.01-0.1);
- immune to the thin-z pathology: the 24^2 aspect-0.09 cavity that NaNs
  under the parity loop (its z-plane boundary terms swamp the p'
  diagonal ~1e2-1e3x) converges to machine zero.
"""

import numpy as np

import jax.numpy as jnp

from orc_cfd.mesh import structured_box_mesh
from orc_cfd.mesh.zones import FaceCondition
from orc_cfd.models.cavity import cavity_case
from orc_cfd.models.channel_flow import (
    ChannelFlowParameters,
    solve_channel_flow,
)
from orc_cfd.solver.simple import initial_state, solve_steady
from orc_cfd.utils.settings import (
    MatrixSolverSettings,
    MomentumScheme,
    NumericalSettings,
    PreconditionMethod,
    PressureInterpolation,
    PressureVelocityCoupling,
    RelaxationMode,
    SolutionMethod,
    VelocityInterpolation,
)

SOLVER = MatrixSolverSettings(
    solver_type=SolutionMethod.BICGSTAB,
    iterations=50,
    preconditioner=PreconditionMethod.JACOBI,
)


def _fc_settings(vi, pr=0.3, **kw):
    return NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_velocity_coupling=PressureVelocityCoupling.SIMPLE_FC,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=vi,
        relaxation_mode=RelaxationMode.IMPLICIT,
        momentum_relaxation=0.7,
        pressure_relaxation=pr,
        matrix_solver=SOLVER,
        **kw,
    )


def _flux_divergence(mesh, flux):
    """Per-cell divergence of the stored flux (numpy): [F] owner-outward
    on the face-major path, [C,K] outward-per-slot on the ck path."""
    flux = np.asarray(flux)
    if flux.ndim == 2:  # ck path: [C,K] outward normal velocity
        area = np.asarray(mesh.face_area)[np.asarray(mesh.cell_faces)]
        mask = np.asarray(mesh.cell_face_mask)
        fa = np.where(mask, flux * area, 0.0)
        return fa.sum(axis=1), np.abs(fa).max()
    own = np.asarray(mesh.face_owner)
    nbr = np.asarray(mesh.face_neighbor)
    interior = np.asarray(mesh.face_interior)
    fa = flux * np.asarray(mesh.face_area)
    div = np.zeros(mesh.n_cells)
    np.add.at(div, own, fa)
    np.add.at(div, nbr[interior], -fa[interior])
    return div, np.abs(fa).max()


def test_fc_poiseuille_analytics_high_alpha_p():
    """Pressure-driven channel at pressure_relaxation 0.3 (3-30x the
    parity loop's stable range): validates against the analytical
    profile AND reaches machine-zero pressure increments."""
    for vi in (
        VelocityInterpolation.LINEAR_WEIGHTED,
        VelocityInterpolation.RHIE_CHOW,
    ):
        r = solve_channel_flow(
            ChannelFlowParameters(top_wall_velocity=0.0, dp_dx=5.0),
            _fc_settings(vi),
            iterations=300,
            reporting_interval=300,
            validation_threshold=0.05,
            verbose=False,
        )
        assert r["passed"], (vi, r["u_mean"], r["u_mean_analytical"])
        h = r["history"][-1]
        assert not bool(np.any(np.asarray(h.diverged))), vi
        assert float(h.p_corr_norm[-1]) < 1e-12, (
            vi, float(h.p_corr_norm[-1]))


def test_fc_momentum_source_poiseuille():
    """SIMPLE_FC + momentum_source through solve_steady (the
    combination a round-3 guard blocked as untested): a uniform
    body force G in x replaces the driving pressure gradient of a
    plane-Poiseuille channel; the machine-converged bulk velocity must
    track the analytical G*h^2/(12 mu) (12% — the 12-cell discrete
    solution sits 9.4% below the parabola mean; the parity loop gives
    the same 0.3776, so it is discretization, not the coupling), the
    ck and face-major paths must agree tightly, and the stored flux
    must stay conservative."""
    G, mu, rho = 5.0, 0.01, 1.0
    h, L = 0.1, 0.4
    u_mean_exact = G * h**2 / (12 * mu)
    mesh, table = structured_box_mesh(
        24, 12, 1, lengths=(L, h, 0.01 * h)
    )
    table.set("TOP_WALL", FaceCondition.WALL)
    table.set("BOTTOM_WALL", FaceCondition.WALL)
    table.set("INLET", FaceCondition.PRESSURE_INLET, scalar_value=0.0)
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)

    def source(cc, vol):
        s = jnp.zeros_like(cc)
        return s.at[:, 0].set(G * vol)

    s = _fc_settings(
        VelocityInterpolation.RHIE_CHOW, momentum_source=source
    )
    u_means = {}
    for use_ck in (True, False):
        state, hist = solve_steady(
            mesh, table, s, rho, mu, state=initial_state(mesh),
            iterations=400, reporting_interval=400, verbose=False,
            use_ck=use_ck,
        )
        u_mean = float(np.asarray(state.vel[:, 0]).mean())
        u_means[use_ck] = u_mean
        assert abs(u_mean - u_mean_exact) / u_mean_exact < 0.12, (
            use_ck, u_mean, u_mean_exact,
        )
        assert float(hist[-1].p_corr_norm[-1]) < 1e-10, use_ck
        div, fa_scale = _flux_divergence(mesh, state.flux)
        assert np.abs(div).max() < 1e-8 * max(fa_scale, 1e-300), use_ck
    assert abs(u_means[True] - u_means[False]) < 1e-8 * abs(
        u_means[False]
    ), u_means


def test_fc_matches_parity_converged_field():
    """FC and the parity loop solve the SAME discrete equations when
    Rhie-Chow closes both (the FC pressure-equation coefficient equals
    the RC damping coefficient, solver/fc.py): converged cavity fields
    must agree to solver roundoff. FC also gets there faster — pinned
    loosely (2x) against trajectory noise."""
    mesh, table = cavity_case(n=16, lid_velocity=1.0)
    fields = {}
    speed = {}
    for coupling, pr in (
        (PressureVelocityCoupling.SIMPLE, 0.1),
        (PressureVelocityCoupling.SIMPLE_FC, 0.3),
    ):
        s = NumericalSettings(
            momentum=MomentumScheme.UD,
            pressure_velocity_coupling=coupling,
            pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
            velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
            relaxation_mode=RelaxationMode.IMPLICIT,
            momentum_relaxation=0.7,
            pressure_relaxation=pr,
            matrix_solver=MatrixSolverSettings(
                solver_type=SolutionMethod.BICGSTAB,
                iterations=60,
                preconditioner=PreconditionMethod.JACOBI,
            ),
        )
        st, hist = solve_steady(
            mesh, table, s, 1.0, 0.01, state=initial_state(mesh),
            iterations=2500, reporting_interval=2500, verbose=False,
        )
        vcs = np.asarray(hist[-1].vel_corr_norm)
        assert (vcs < 1e-12).any(), coupling  # machine-converged
        speed[coupling] = int(np.argmax(vcs < 1e-12))
        fields[coupling] = (np.asarray(st.vel), np.asarray(st.p))
    (v_s, p_s), (v_f, p_f) = fields.values()
    np.testing.assert_allclose(v_s, v_f, rtol=0, atol=1e-11)
    # p is pure gauge on the all-wall cavity: compare zero-mean fields.
    np.testing.assert_allclose(
        p_s - p_s.mean(), p_f - p_f.mean(), rtol=0, atol=1e-11
    )
    assert (
        speed[PressureVelocityCoupling.SIMPLE_FC]
        < speed[PressureVelocityCoupling.SIMPLE]
    ), speed


def test_fc_thin_z_cavity_converges_conservatively():
    """The 24^2 z/dx=0.09 Re=1000 cavity NaNs under the parity loop
    (reference-parity boundary terms swamp its p' diagonal; see
    assembly.pressure_correction_system). FC has no such terms — it
    must converge to machine-zero pressure increments with a stored
    flux that is divergence-free to solver tolerance."""
    n = 24
    dx = 1.0 / n
    mesh, table = structured_box_mesh(n, n, 1, lengths=(1.0, 1.0, 0.09 * dx))
    table.set("TOP_WALL", FaceCondition.WALL, vector_value=(1.0, 0.0, 0.0))
    for z in ("BOTTOM_WALL", "INLET", "OUTLET"):
        table.set(z, FaceCondition.WALL)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    st, hist = solve_steady(
        mesh, table,
        _fc_settings(VelocityInterpolation.LINEAR_WEIGHTED),
        1.0, 1e-3, state=initial_state(mesh),
        iterations=800, reporting_interval=800, verbose=False,
    )
    h = hist[-1]
    assert not bool(np.any(np.asarray(h.diverged)))
    assert float(h.p_corr_norm[-1]) < 1e-12
    u = np.asarray(st.vel[:, 0])
    assert np.isfinite(u).all() and 0.3 < u.max() <= 1.0
    div, scale = _flux_divergence(mesh, st.flux)
    assert np.abs(div).max() < 1e-12 * scale, (np.abs(div).max(), scale)


def test_fc_flux_conservation_every_iteration():
    """div(stored flux) == linear-solve residual EVERY iteration, not
    just at convergence — checked early in a transient-ish state."""
    mesh, table = cavity_case(n=12, lid_velocity=1.0)
    st, _ = solve_steady(
        mesh, table, _fc_settings(VelocityInterpolation.RHIE_CHOW),
        1.0, 0.01, state=initial_state(mesh),
        iterations=3, reporting_interval=3, verbose=False,
    )
    div, scale = _flux_divergence(mesh, st.flux)
    # 3 iterations in, the FIELDS are far from converged, but the flux
    # must already be conservative (rel tolerance of the inner solve).
    assert np.abs(div).max() < 1e-3 * max(scale, 1e-30), (
        np.abs(div).max(), scale)


def test_fc_ck_matches_face_major():
    """The (c,k)-direct FC step (ck_simple_step_fc) is the same physics
    as the face-major step: identical convergence trajectory and fields
    to roundoff."""
    mesh, table = cavity_case(n=12, lid_velocity=1.0)
    s = _fc_settings(VelocityInterpolation.RHIE_CHOW)
    out = {}
    for uck in (False, True):
        st, hist = solve_steady(
            mesh, table, s, 1.0, 0.01, state=initial_state(mesh),
            iterations=400, reporting_interval=400, verbose=False,
            use_ck=uck,
        )
        assert not bool(np.any(np.asarray(hist[-1].diverged))), uck
        out[uck] = (np.asarray(st.vel), np.asarray(st.p))
    np.testing.assert_allclose(
        out[False][0], out[True][0], rtol=0, atol=1e-12
    )
    np.testing.assert_allclose(
        out[False][1] - out[False][1].mean(),
        out[True][1] - out[True][1].mean(),
        rtol=0, atol=1e-12,
    )


def test_fc_sharded_matches_single_device():
    """SIMPLE_FC under shard_map (both the face-major and ck-direct
    local steps): all reductions/refreshes ride the comm hooks, so the
    sharded trajectory must reproduce the single-device one."""
    from orc_cfd.parallel.sharded import solve_steady_sharded

    mesh, table = structured_box_mesh(8, 8, 1, lengths=(0.002, 0.001, 0.0001))
    table.set("TOP_WALL", FaceCondition.WALL, vector_value=(5e-4, 0, 0))
    table.set("BOTTOM_WALL", FaceCondition.WALL)
    table.set("INLET", FaceCondition.PRESSURE_INLET, scalar_value=0.01)
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    s = _fc_settings(VelocityInterpolation.RHIE_CHOW)
    ref_state, _ = solve_steady(
        mesh, table, s, 1000.0, 0.001, state=initial_state(mesh),
        iterations=30, reporting_interval=30, verbose=False, use_ck=False,
    )
    for uck in (False, "auto"):
        sh_state, _ = solve_steady_sharded(
            mesh, table, s, 1000.0, 0.001, state=initial_state(mesh),
            iterations=30, reporting_interval=30, verbose=False,
            n_devices=4, use_ck=uck,
        )
        np.testing.assert_allclose(
            np.asarray(sh_state.vel), np.asarray(ref_state.vel),
            rtol=1e-8, atol=1e-14, err_msg=str(uck),
        )
        np.testing.assert_allclose(
            np.asarray(sh_state.p), np.asarray(ref_state.p),
            rtol=1e-8, atol=1e-12, err_msg=str(uck),
        )


def test_fc_transient_taylor_green():
    """SIMPLE_FC transient marching on the exact Taylor-Green decay —
    the fully periodic box exercises the deflated full-p solve inside
    implicit-Euler time steps. Same tolerances as the parity-loop TG
    test (tests/test_transient.py)."""
    import dataclasses

    from orc_cfd.solver.transient import solve_transient

    N = 32
    rho, mu = 1.0, 0.02
    nu = mu / rho
    mesh, table = structured_box_mesh(
        N, N, 1, lengths=(2 * np.pi, 2 * np.pi, 1.0),
        periodic=("x", "y"), dtype=jnp.float64,
    )
    cc = np.asarray(mesh.cell_centroid)
    x, y = cc[:, 0], cc[:, 1]
    u0 = np.sin(x) * np.cos(y)
    v0 = -np.cos(x) * np.sin(y)
    p0 = rho / 4.0 * (np.cos(2 * x) + np.cos(2 * y))
    st = initial_state(mesh)
    st = dataclasses.replace(
        st,
        vel=jnp.asarray(np.stack([u0, v0, np.zeros_like(u0)], -1)),
        p=jnp.asarray(p0),
    )
    s = NumericalSettings(
        momentum=MomentumScheme.CD1,
        pressure_velocity_coupling=PressureVelocityCoupling.SIMPLE_FC,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
        pressure_relaxation=0.3,
        momentum_relaxation=0.7,
        relaxation_mode=RelaxationMode.IMPLICIT,
        matrix_solver=SOLVER,
    )
    dt, nsteps = 0.05, 20  # t = 1.0
    st, _ = solve_transient(
        mesh, table, s, rho, mu, dt, nsteps,
        inner_iterations=10, state=st, verbose=False,
    )
    decay = np.exp(-2 * nu * dt * nsteps)
    u = np.asarray(st.vel[:, 0])
    v = np.asarray(st.vel[:, 1])
    err = max(np.abs(u - u0 * decay).max(), np.abs(v - v0 * decay).max())
    assert err < 5e-3, f"max pointwise error {err:.2e} vs exact decay"


def test_fc_rans_channel_smoke():
    """SIMPLE_FC + k-epsilon: the body-force Re_tau=590 channel rig
    (tests/test_turbulence.py) runs under the FC coupling with finite,
    physical fields. Quantitative DNS bands stay pinned by the parity
    test; this pins that the RANS outer loop composes with FC."""
    from orc_cfd.solver.turbulence import solve_steady_turbulent

    H = 2.0
    rho, mu = 1.0, 1.0 / 10975.0
    u_tau = 590.0 * mu / rho / (H / 2)
    G = rho * u_tau**2 / (H / 2)
    mesh, table = structured_box_mesh(
        4, 16, 1, lengths=(0.4, H, 0.1), periodic=("x",),
    )
    table.set("TOP_WALL", FaceCondition.WALL)
    table.set("BOTTOM_WALL", FaceCondition.WALL)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)

    def source(cc, vol):
        s = jnp.zeros_like(cc)
        return s.at[:, 0].set(G * vol)

    s = NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_velocity_coupling=PressureVelocityCoupling.SIMPLE_FC,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
        relaxation_mode=RelaxationMode.IMPLICIT,
        momentum_relaxation=0.6,
        pressure_relaxation=0.3,
        matrix_solver=SOLVER,
        momentum_source=source,
    )
    flow, turb, hist = solve_steady_turbulent(
        mesh, table, s, rho, mu, u_ref=18.0,
        iterations=1000, reporting_interval=1000,
        intensity=0.05, length_scale=0.2 * H, verbose=False,
    )
    u = np.asarray(flow.vel[:, 0])
    k = np.asarray(turb.k)
    assert np.isfinite(u).all() and np.isfinite(k).all()
    assert not bool(np.any(np.asarray(hist[-1].diverged)))
    # Spinning up toward the DNS bulk U_b+ ~ 17.5 (measured: 11.7 at
    # 1000 iterations, 15.6 at 2000 — the ramp is the body-force
    # channel's physical development, not the coupling).
    ub_plus = u.mean() / u_tau
    assert 8.0 < ub_plus < 25.0, ub_plus


def test_fc_irregular_mesh_matches_structured():
    """SIMPLE_FC on a genuinely irregular mesh (randomly permuted
    cells, no structured offsets — the RCM + slice-plan path): the
    converged cavity field matches the structured run's, mapped
    through the compiled cell ordering. This pins FC on the
    reference's own mesh class (unstructured, io.rs:32-515)."""
    import jax

    rng = np.random.default_rng(5)
    mesh_s, table = cavity_case(n=12, lid_velocity=1.0)
    from orc_cfd.mesh.compile import compile_from_arrays

    C = mesh_s.n_cells
    perm = rng.permutation(C)
    inv = np.empty(C, np.int64)
    inv[perm] = np.arange(C)
    interior = np.asarray(mesh_s.face_interior)
    mesh_i = compile_from_arrays(
        dim=2,
        face_owner=inv[np.asarray(mesh_s.face_owner)],
        face_neighbor=np.where(
            interior, inv[np.asarray(mesh_s.face_neighbor)], -1
        ),
        face_area=np.asarray(mesh_s.face_area),
        face_normal=np.asarray(mesh_s.face_normal),
        face_centroid=np.asarray(mesh_s.face_centroid),
        face_zone_slot=np.asarray(mesh_s.face_zone_slot),
        cell_centroid=np.asarray(mesh_s.cell_centroid)[perm],
        cell_volume=np.asarray(mesh_s.cell_volume)[perm],
        dtype=mesh_s.dtype,
    )
    assert mesh_i.neighbor_offsets is None  # genuinely irregular

    s = _fc_settings(VelocityInterpolation.RHIE_CHOW)
    kw = dict(iterations=400, reporting_interval=400, verbose=False)
    st_s, _ = solve_steady(
        mesh_s, table, s, 1.0, 0.01, state=initial_state(mesh_s), **kw
    )
    st_i, hist = solve_steady(
        mesh_i, table, s, 1.0, 0.01, state=initial_state(mesh_i), **kw
    )
    assert not bool(np.any(np.asarray(hist[-1].diverged)))
    # Map the irregular run's cells back to raw (= structured) order.
    u_i = np.asarray(st_i.vel)
    if mesh_i.cell_order is not None:
        raw = np.empty_like(u_i)
        raw[np.asarray(mesh_i.cell_order)] = u_i
        u_i = raw
    u_i = u_i[inv]  # undo the random permutation
    np.testing.assert_allclose(
        u_i, np.asarray(st_s.vel), rtol=0, atol=5e-8
    )


def test_fc_explicit_relaxation_envelope():
    """FC under EXPLICIT relaxation inside its measured stable envelope
    (scripts/probe_fc_explicit.py, round 5): the pressure-driven
    Poiseuille case converges — machine-deep, far beyond the parity
    loop at the same settings — with the alpha-consistent stored-flux
    blend (settings.resolved_fc_flux_relaxation) active by default.
    The graded pressure-BC channel and alpha_p >= 0.1 cavities remain
    OUTSIDE the envelope (NOTES.md round-5 table); AUTO therefore
    still gates FC on implicit relaxation."""
    from orc_cfd.models.channel_flow import (
        ChannelFlowParameters,
        couette_case,
    )

    params = ChannelFlowParameters(top_wall_velocity=0.0, dp_dx=5.0)
    mesh, table = couette_case(nx=8, ny=8, params=params)
    s = _fc_settings(
        VelocityInterpolation.RHIE_CHOW,
        pr=0.05,
    ).replace(
        relaxation_mode=RelaxationMode.EXPLICIT,
        momentum_relaxation=0.5,
    )
    assert s.resolved_fc_flux_relaxation() == 0.5  # auto = alpha_u
    state, hist = solve_steady(
        mesh, table, s, params.rho, params.mu,
        state=initial_state(mesh), iterations=300,
        reporting_interval=300, verbose=False,
    )
    last = hist[-1]
    assert not bool(np.any(np.asarray(last.diverged)))
    # Deep convergence: the velocity corrections collapse.
    assert float(np.asarray(last.vel_corr_norm)[-1]) < 1e-8
    u = np.asarray(state.vel[:, 0])
    h = 0.001
    u_mean_ana = h**2 / (12 * params.mu) * params.dp_dx
    assert abs(abs(u.mean()) - u_mean_ana) / u_mean_ana < 0.05
