"""Coefficient-level ground truth vs the reference's assembly math.

A hand transliteration of the reference's formulas into plain NumPy
per-cell/per-face loops (reference: discretization.rs:39-131 diffusion,
133-356 advection, 358-448 pressure correction; solver.rs:952-1150 face
interpolation, 774-950 gradients, 1169-1227 correction), asserted
ENTRY-FOR-ENTRY against orc_cfd's vectorized [C,K] ELL assembly. If any
assembled coefficient drifts from the reference's formulas, these tests
fail.

Frozen-coefficient semantics: the reference mutates a_u/a_v/a_w in place
while *reading* their diagonals for Rhie-Chow fluxes mid-sweep
(discretization.rs:184-197 + 312-351), so its literal assembled values
depend on cell iteration order — a sequential artifact, not a formula.
Both sides here receive the SAME frozen mom_diag input, which tests the
formulas themselves.

Deliberate deviations NOT tested here (documented in the op docstrings):
least-squares boundary rows (reference uses absolute values — a bug),
CD2 (the reference panics on it), TVD per-component zero-difference
guard (exercised with fields where no component difference is zero).
"""

from __future__ import annotations

import numpy as np
import pytest

from orc_cfd.mesh import structured_box_mesh
from orc_cfd.mesh.zones import FaceCondition
from orc_cfd.ops.assembly import (
    apply_pressure_correction,
    diffusion_system,
    momentum_system,
    pressure_correction_system,
)
from orc_cfd.ops.fields import device_bc, face_bc
from orc_cfd.ops.gradients import pressure_gradient, velocity_gradient
from orc_cfd.ops.interpolation import face_flux, face_pressure
from orc_cfd.utils.settings import (
    GradientReconstruction,
    MomentumScheme,
    NumericalSettings,
    PressureInterpolation,
    RelaxationMode,
    VelocityInterpolation,
    tvd_quick,
)

WALL = int(FaceCondition.WALL)
P_IN = int(FaceCondition.PRESSURE_INLET)
P_OUT = int(FaceCondition.PRESSURE_OUTLET)
SYM = int(FaceCondition.SYMMETRY)
V_IN = int(FaceCondition.VELOCITY_INLET)
INT = int(FaceCondition.INTERIOR)

RHO = 1.3
MU = 0.7


class RefAssembler:
    """Plain-NumPy transliteration of the reference assembly math.

    Operates per cell / per face exactly as the Rust loops do; produces
    dense matrices for comparison. All formulas cite the reference.
    """

    def __init__(self, mesh, fbc):
        g = lambda x: np.asarray(x, dtype=np.float64)
        self.owner = np.asarray(mesh.face_owner)
        self.neighbor = np.asarray(mesh.face_neighbor)
        self.interior = np.asarray(mesh.face_interior)
        self.area = g(mesh.face_area)
        self.normal = g(mesh.face_normal)
        self.fcent = g(mesh.face_centroid)
        self.ccent = g(mesh.cell_centroid)
        self.vol = g(mesh.cell_volume)
        self.code = np.asarray(fbc.code)
        self.bc_s = g(fbc.scalar)
        self.bc_v = g(fbc.vector)
        self.C = self.vol.shape[0]
        self.F = self.area.shape[0]
        self.cell_faces = [[] for _ in range(self.C)]
        for f in range(self.F):
            self.cell_faces[self.owner[f]].append(f)
            if self.interior[f]:
                self.cell_faces[self.neighbor[f]].append(f)

    # -- helpers ---------------------------------------------------------
    def n_out(self, f, c):
        """Outward normal w.r.t. cell c (mesh.rs:216-226: stored normal
        points away from cell 0 = owner in this SoA layout)."""
        return self.normal[f] if self.owner[f] == c else -self.normal[f]

    def other(self, f, c):
        return self.neighbor[f] if self.owner[f] == c else self.owner[f]

    # -- solver.rs:952-1003 -----------------------------------------------
    def face_velocity(self, f, vel, scheme):
        code = self.code[f]
        if code in (WALL, V_IN):
            return self.bc_v[f]
        if code in (P_IN, P_OUT, SYM):
            return vel[self.owner[f]]
        assert code == INT
        c0, c1 = self.owner[f], self.neighbor[f]
        v0, v1 = vel[c0], vel[c1]
        if scheme == "linear":
            return 0.5 * (v0 + v1)
        dx0 = np.linalg.norm(self.ccent[c0] - self.fcent[f])
        dx1 = np.linalg.norm(self.ccent[c1] - self.fcent[f])
        return v0 + (v1 - v0) * dx0 / (dx0 + dx1)

    # -- solver.rs:874-901 (Green-Gauss cell, Linear face pressures) ------
    def pressure_gradient(self, c, p):
        acc = np.zeros(3)
        for f in self.cell_faces[c]:
            pf = self.face_pressure(f, p, "linear")
            acc += pf * (self.area[f] / self.vol[c]) * self.n_out(f, c)
        return acc

    # -- solver.rs:784-802 (Green-Gauss cell, Linear face velocities) -----
    def velocity_gradient(self, c, vel):
        acc = np.zeros((3, 3))
        for f in self.cell_faces[c]:
            vf = self.face_velocity(f, vel, "linear")
            acc += np.outer(
                vf, self.n_out(f, c) * (self.area[f] / self.vol[c])
            )
        return acc

    # -- solver.rs:1104-1150 ----------------------------------------------
    def face_pressure(self, f, p, scheme):
        code = self.code[f]
        if code in (SYM, WALL, V_IN):
            return p[self.owner[f]]
        if code in (P_IN, P_OUT):
            return self.bc_s[f]
        assert code == INT
        c0, c1 = self.owner[f], self.neighbor[f]
        if scheme == "linear":
            return 0.5 * (p[c0] + p[c1])
        if scheme == "linear_weighted":
            x0 = np.linalg.norm(self.ccent[c0] - self.fcent[f])
            x1 = np.linalg.norm(self.ccent[c1] - self.fcent[f])
            return p[c0] + (p[c1] - p[c0]) * x0 / (x0 + x1)
        assert scheme == "second_order"
        g0 = self.pressure_gradient(c0, p)
        g1 = self.pressure_gradient(c1, p)
        r0 = self.fcent[f] - self.ccent[c0]
        r1 = self.fcent[f] - self.ccent[c1]
        return 0.5 * ((p[c0] + p[c1]) + (g0 @ r0 + g1 @ r1))

    # -- solver.rs:1007-1102 ----------------------------------------------
    def face_flux(self, f, c, vel, scheme, p=None, mom_diag=None):
        code = self.code[f]
        n = self.n_out(f, c)
        if code in (WALL, SYM):
            return 0.0
        if code == V_IN:
            return n @ self.bc_v[f]
        if code in (P_IN, P_OUT):
            return n @ vel[self.owner[f]]
        assert code == INT
        if scheme in ("linear", "linear_weighted"):
            return n @ self.face_velocity(f, vel, scheme)
        assert scheme == "rhie_chow"
        j = self.other(f, c)
        # Normal momentum coefficient (discretization.rs:14-23).
        a_i = np.linalg.norm(mom_diag[c] * n)
        a_j = np.linalg.norm(mom_diag[j] * n)
        r = self.ccent[j] - self.ccent[c]
        voa_i = self.vol[c] / a_i
        voa_j = self.vol[j] / a_j
        t1 = (vel[c] + vel[j]) @ n
        t2 = (voa_i + voa_j) * (p[c] - p[j]) / np.linalg.norm(r)
        t3 = (
            voa_i * self.pressure_gradient(c, p)
            + voa_j * self.pressure_gradient(j, p)
        ) @ (r / np.linalg.norm(r))
        # DELIBERATE DEVIATION: solver.rs:1095 computes t1 + t2 - t3,
        # which does NOT vanish for a linear pressure field (with
        # (p_i - p_j) in t2 the gradient part must ADD) — the
        # reference's sign injects a spurious -d_f*grad_p.n flux.
        # orc_cfd uses the consistent +t3 form; the oracle pins it.
        return 0.5 * (t1 + t2 + t3)

    # -- discretization.rs:39-131 ------------------------------------------
    def diffusion(self, mu):
        A = np.zeros((self.C, self.C))
        b = np.zeros((self.C, 3))
        for c in range(self.C):
            a_p = 0.0
            for f in self.cell_faces[c]:
                code = self.code[f]
                if code in (WALL, V_IN):
                    d = mu * self.area[f] / np.linalg.norm(
                        self.fcent[f] - self.ccent[c]
                    )
                    b[c] += self.bc_v[f] * d
                    nbr = None
                elif code in (P_IN, P_OUT, SYM):
                    d, nbr = 0.0, None
                else:
                    nbr = self.other(f, c)
                    d = mu * self.area[f] / np.linalg.norm(
                        self.ccent[nbr] - self.ccent[c]
                    )
                a_p += d
                if nbr is not None:
                    A[c, nbr] += -d
            A[c, c] = a_p
        return A, b

    # -- discretization.rs:133-356 ------------------------------------------
    def momentum(
        self,
        vel,
        p,
        mom_diag,
        a_di,
        b_di,
        rho,
        scheme,
        vel_interp,
        p_interp,
        psi=None,
    ):
        """Returns dense A [3,C,C], b [3,C] (incl. diffusion b), pe [C,3]."""
        A = np.zeros((3, self.C, self.C))
        b = np.zeros((self.C, 3))
        pe = np.zeros((self.C, 3))
        for c in range(self.C):
            s_u = np.zeros(3)
            a_p = np.zeros(3)
            a_ii_di = a_di[c, c]
            for f in self.cell_faces[c]:
                flux = self.face_flux(f, c, vel, vel_interp, p, mom_diag)
                n = self.n_out(f, c)
                F = flux * self.area[f] * rho
                pf = self.face_pressure(f, p, p_interp)
                nbr = self.other(f, c) if self.interior[f] else None
                if scheme == "ud":
                    a_nb = min(F, 0.0) * np.ones(3)
                elif scheme == "cd1":
                    a_nb = F / 2.0 * np.ones(3)
                else:
                    assert scheme == "tvd"
                    if nbr is None:
                        a_nb = min(F, 0.0) * np.ones(3)
                    else:
                        dcell = nbr if F > 0 else c
                        dv = vel[dcell] - vel[c]
                        if np.linalg.norm(dv) == 0.0:
                            a_nb = F / 2.0 * np.ones(3)
                        else:
                            grad = self.velocity_gradient(c, vel)
                            r_pa = self.ccent[nbr] - self.ccent[c]
                            r = 2.0 * (grad @ r_pa) / dv - 1.0
                            a_nb = F * psi(r) / 2.0
                a_p += -a_nb + F
                s_u += -n * pf * self.area[f]
                if nbr is None:
                    if self.code[f] in (WALL, V_IN):
                        s_u += (a_nb - F) * self.bc_v[f]
                else:
                    a_ij_di = a_di[c, nbr]
                    for comp in range(3):
                        A[comp, c, nbr] = a_nb[comp] + a_ij_di
            b[c] = s_u
            pe[c] = a_p / a_ii_di
            for comp in range(3):
                A[comp, c, c] = a_p[comp] + a_ii_di
        return A, (b + b_di).T, pe

    # -- discretization.rs:358-448 ------------------------------------------
    def pressure_correction(self, vel, p, mom_diag, rho, vel_interp):
        A = np.zeros((self.C, self.C))
        b = np.zeros(self.C)
        for c in range(self.C):
            a_p = 0.0
            for f in self.cell_faces[c]:
                flux = self.face_flux(f, c, vel, vel_interp, p, mom_diag)
                b[c] += rho * (-flux) * self.area[f]
                n_in = -self.n_out(f, c)
                if self.interior[f]:
                    j = self.other(f, c)
                    a_face = 0.5 * np.linalg.norm(
                        (mom_diag[c] + mom_diag[j]) * n_in
                    )
                    a_nb = rho * self.area[f] ** 2 / a_face
                    A[c, j] = -a_nb
                    a_p += a_nb
                else:
                    # Reference rule retained (discretization.rs:434-436,
                    # its own TODO at :426 notwithstanding): every
                    # boundary face adds rho A^2/a/2 — the screened-
                    # Poisson damping the stateless-flux loop needs
                    # (see assembly.pressure_correction_system).
                    a_ii = np.linalg.norm(mom_diag[c] * n_in)
                    a_p += rho * self.area[f] ** 2 / a_ii / 2.0
            A[c, c] = a_p
        return A, b

    # -- solver.rs:1169-1227 -------------------------------------------------
    def apply_correction(self, p_prime, mom_diag, vel, p, alpha_u, alpha_p):
        new_vel = vel.copy()
        new_p = p + alpha_p * p_prime
        v_sq = 0.0
        for c in range(self.C):
            corr = np.zeros(3)
            for f in self.cell_faces[c]:
                code = self.code[f]
                # Reference cell-difference form (solver.rs:1214-1223)
                # — the PressureCorrectionForm.CELL_DIFFERENCE default.
                # The consistent FACE_VALUE option (p'_f linear) is a
                # documented deviation selectable in settings; its
                # equivalence at convergence is pinned by
                # tests/test_cavity.py::test_correction_forms_agree.
                if code in (WALL, SYM, V_IN):
                    ppf = p_prime[c]
                elif code in (P_IN, P_OUT):
                    ppf = 0.0
                else:
                    ppf = p_prime[self.other(f, c)]
                n = self.n_out(f, c)
                corr += (
                    (n / mom_diag[c]) * (p_prime[c] - ppf) * self.area[f]
                )
            new_vel[c] += alpha_u * corr
            v_sq += corr @ corr
        return new_vel, new_p, v_sq


# --------------------------------------------------------------------------


def dense_from_ell(A):
    """Densify an EllMatrix (diag [*,C], off [*,C,K], neighbors [C,K])."""
    diag = np.asarray(A.diag)
    off = np.asarray(A.off)
    nbr = np.asarray(A.neighbors)
    batched = diag.ndim == 2
    if not batched:
        diag, off = diag[None], off[None]
    B, C = diag.shape
    K = off.shape[-1]
    out = np.zeros((B, C, C))
    rows = np.tile(np.arange(C)[:, None], (1, K))
    for i in range(B):
        out[i, np.arange(C), np.arange(C)] = diag[i]
        np.add.at(out[i], (rows.ravel(), nbr.ravel()), off[i].ravel())
    return out if batched else out[0]


def make_box():
    mesh, table = structured_box_mesh(3, 4, 2, lengths=(1.5, 1.0, 0.8))
    table.set("INLET", FaceCondition.VELOCITY_INLET, vector_value=(0.7, 0.1, -0.2))
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.3)
    table.set("TOP_WALL", FaceCondition.WALL, vector_value=(0.5, 0.0, 0.0))
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.PRESSURE_INLET, scalar_value=1.2)
    return mesh, table


def make_cube(reference_mesh_dir):
    """Mixed-cell 3x3 cube from the reference examples (hex+prism).

    Its INLET/OUTLET zones are declared as INTERFACE (code 24), which
    neither implementation supports (the reference panics,
    discretization.rs:114-117) — retype them to supported conditions.
    """
    from orc_cfd.mesh import read_mesh

    mesh, table = read_mesh(f"{reference_mesh_dir}/3x3_cube.msh")
    table.set("INLET", FaceCondition.VELOCITY_INLET, vector_value=(0.7, 0.1, -0.2))
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.3)
    table.set("WALL", FaceCondition.WALL, vector_value=(0.4, 0.0, 0.1))
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.PRESSURE_INLET, scalar_value=1.2)
    return mesh, table


@pytest.fixture(params=["box", "cube"])
def case(request, reference_mesh_dir):
    if request.param == "box":
        mesh, table = make_box()
    else:
        mesh, table = make_cube(reference_mesh_dir)
    zc, zs, zv = device_bc(table, dtype=mesh.dtype)
    fbc = face_bc(mesh, zc, zs, zv)
    ref = RefAssembler(mesh, fbc)
    rng = np.random.default_rng(42)
    fields = dict(
        vel=rng.normal(size=(ref.C, 3)),
        p=rng.normal(size=ref.C),
        mom_diag=1.0 + rng.uniform(size=(ref.C, 3)),
        p_prime=rng.normal(size=ref.C),
    )
    return mesh, fbc, ref, fields


def test_diffusion_parity(case):
    mesh, fbc, ref, fl = case
    diff = diffusion_system(mesh, fbc, MU)
    A_ref, b_ref = ref.diffusion(MU)
    got = dense_from_ell(
        type("E", (), dict(diag=diff.diag, off=diff.off, neighbors=mesh.cell_neighbors))
    )
    np.testing.assert_allclose(got, A_ref, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.asarray(diff.b), b_ref, rtol=1e-12, atol=1e-14)


def test_gradient_parity(case):
    mesh, fbc, ref, fl = case
    gp = np.asarray(pressure_gradient(mesh, fbc, fl["p"]))
    gv = np.asarray(velocity_gradient(mesh, fbc, fl["vel"]))
    gp_ref = np.stack([ref.pressure_gradient(c, fl["p"]) for c in range(ref.C)])
    gv_ref = np.stack([ref.velocity_gradient(c, fl["vel"]) for c in range(ref.C)])
    np.testing.assert_allclose(gp, gp_ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(gv, gv_ref, rtol=1e-10, atol=1e-12)


MOMENTUM_CONFIGS = [
    # (scheme, vel interp, p interp)
    (MomentumScheme.UD, VelocityInterpolation.LINEAR, PressureInterpolation.LINEAR),
    (
        MomentumScheme.CD1,
        VelocityInterpolation.LINEAR_WEIGHTED,
        PressureInterpolation.LINEAR_WEIGHTED,
    ),
    (MomentumScheme.TVD, VelocityInterpolation.LINEAR, PressureInterpolation.LINEAR),
    # The reference's default config (lib.rs:58-74).
    (
        MomentumScheme.CD1,
        VelocityInterpolation.RHIE_CHOW,
        PressureInterpolation.SECOND_ORDER,
    ),
]


@pytest.mark.parametrize("scheme,vi,pi", MOMENTUM_CONFIGS)
def test_momentum_parity(case, scheme, vi, pi):
    mesh, fbc, ref, fl = case
    settings = NumericalSettings(
        momentum=scheme,
        tvd_psi=tvd_quick if scheme == MomentumScheme.TVD else None,
        velocity_interpolation=vi,
        pressure_interpolation=pi,
        relaxation_mode=RelaxationMode.EXPLICIT,
    )
    vel, p, mom_diag = fl["vel"], fl["p"], fl["mom_diag"]
    diff = diffusion_system(mesh, fbc, MU)
    grad_p = pressure_gradient(mesh, fbc, p)
    grad_v = velocity_gradient(mesh, fbc, vel)
    flux = face_flux(mesh, fbc, vel, vi, p=p, grad_p=grad_p, mom_diag=mom_diag)
    p_face = face_pressure(mesh, fbc, p, pi, grad_p=grad_p)
    A, b, pe = momentum_system(
        mesh, fbc, settings, RHO, vel, flux, p_face, diff, grad_vel=grad_v
    )

    A_di, b_di = ref.diffusion(MU)
    psi = (lambda r: (3.0 + r) / 4.0) if scheme == MomentumScheme.TVD else None
    names = {
        MomentumScheme.UD: "ud",
        MomentumScheme.CD1: "cd1",
        MomentumScheme.TVD: "tvd",
    }
    vi_name = {
        VelocityInterpolation.LINEAR: "linear",
        VelocityInterpolation.LINEAR_WEIGHTED: "linear_weighted",
        VelocityInterpolation.RHIE_CHOW: "rhie_chow",
    }[vi]
    pi_name = {
        PressureInterpolation.LINEAR: "linear",
        PressureInterpolation.LINEAR_WEIGHTED: "linear_weighted",
        PressureInterpolation.SECOND_ORDER: "second_order",
    }[pi]
    A_ref, b_ref, pe_ref = ref.momentum(
        vel, p, mom_diag, A_di, b_di, RHO, names[scheme], vi_name, pi_name, psi
    )
    A_dense = dense_from_ell(A)
    if A_dense.ndim == 2:
        # Shared-matrix form (UD/CD1 coefficients are component-
        # independent; see assembly.momentum_system): one [C,C] matrix
        # stands for all three identical reference matrices.
        A_dense = np.broadcast_to(A_dense, A_ref.shape)
    np.testing.assert_allclose(A_dense, A_ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(b), b_ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(pe), pe_ref, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize(
    "vi",
    [VelocityInterpolation.LINEAR_WEIGHTED, VelocityInterpolation.RHIE_CHOW],
)
def test_pressure_correction_parity(case, vi):
    mesh, fbc, ref, fl = case
    vel, p, mom_diag = fl["vel"], fl["p"], fl["mom_diag"]
    grad_p = pressure_gradient(mesh, fbc, p)
    flux = face_flux(mesh, fbc, vel, vi, p=p, grad_p=grad_p, mom_diag=mom_diag)
    A, b = pressure_correction_system(mesh, fbc, RHO, flux, mom_diag)
    vi_name = (
        "linear_weighted" if vi == VelocityInterpolation.LINEAR_WEIGHTED
        else "rhie_chow"
    )
    A_ref, b_ref = ref.pressure_correction(vel, p, mom_diag, RHO, vi_name)
    np.testing.assert_allclose(dense_from_ell(A), A_ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(b), b_ref, rtol=1e-10, atol=1e-12)


def test_apply_correction_parity(case):
    mesh, fbc, ref, fl = case
    settings = NumericalSettings(
        relaxation_mode=RelaxationMode.EXPLICIT,
        momentum_relaxation=0.5,
        pressure_relaxation=0.01,
    )
    new_vel, new_p, (p_sq, v_sq) = apply_pressure_correction(
        mesh, fbc, settings, fl["p_prime"], fl["mom_diag"], fl["vel"], fl["p"]
    )
    ref_vel, ref_p, ref_vsq = ref.apply_correction(
        fl["p_prime"], fl["mom_diag"], fl["vel"], fl["p"], 0.5, 0.01
    )
    np.testing.assert_allclose(np.asarray(new_vel), ref_vel, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(new_p), ref_p, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(float(p_sq), fl["p_prime"] @ fl["p_prime"], rtol=1e-12)
    np.testing.assert_allclose(float(v_sq), ref_vsq, rtol=1e-10)
