"""Gather-free (c,k)-direct physics ops.

Motivation: dynamic gathers inside solver loops cost far more than
circular shifts on the backend this was first tuned for. The same
applies to the assembly pipeline: the face-major formulation gathers
[C,K] slices of face arrays (flux[cell_faces], area[cell_faces], ...)
~25 times per SIMPLE step. Whether the ck step still wins on the GPU
is an open measurement (ROADMAP design item 4).

This module removes *all* runtime gathers for structured meshes:

- static face geometry is pre-expanded once on host into [C,K]-resident
  arrays (`CKGeometry`), orientation folded in (outward normals, signed
  owner->neighbor vectors), so no face-array gathers remain;
- neighbor cell values are fetched with circular shifts
  (mesh.neighbor_offsets) — or a single gather on irregular meshes;
- BC data is selected from the tiny zone tables with a static
  Z-way `where` chain instead of a gather.

Interior faces are processed twice (once per side) instead of once —
redundant elementwise FLOPs, which are nearly free, in exchange for
eliminating the gathers, which are not.

The face-major ops (orc_cfd.ops.interpolation / assembly) remain the
reference implementation and the path used by the sharded runtime;
equivalence is pinned by tests/test_ck.py.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from orc_cfd.mesh.compile import CompiledMesh
from orc_cfd.ops.fields import (
    INTERIOR,
    PRESSURE_INLET,
    PRESSURE_OUTLET,
    SYMMETRY,
    VELOCITY_INLET,
    WALL,
)
from orc_cfd.ops.layout import take
from orc_cfd.ops.spmv import EllMatrix
from orc_cfd.utils.settings import (
    GradientReconstruction,
    MomentumScheme,
    NumericalSettings,
    PressureInterpolation,
    VelocityInterpolation,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CKGeometry:
    """Static per-(cell, slot) geometry, orientation folded in."""

    area: jax.Array  # [C,K] (0 at padded slots)
    n_out: jax.Array  # [C,K,3] outward from c
    w: jax.Array  # [C,K] lin-weighted coeff: phi_f = phi_c + (phi_n-phi_c) w
    r_cf: jax.Array  # [C,K,3] x_face - x_c
    r_on: jax.Array  # [C,K,3] x_nbr - x_c (boundary: x_face - x_c)
    dist_on: jax.Array  # [C,K] |r_on|
    dist_fo: jax.Array  # [C,K] |x_face - x_c|
    interior: jax.Array  # [C,K] bool
    mask: jax.Array  # [C,K] bool
    zone_slot: jax.Array  # [C,K] i32
    n_zones: int = dataclasses.field(metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class UniformCKGeometry:
    """CKGeometry for UNIFORM structured boxes, where every float
    geometry quantity is constant per ELL column (mesh.ck_constants):
    the [C,K(,3)] arrays collapse to two boolean masks plus [K]-sized
    constants, cutting the static working set ~20x (e.g. 2.9 GB ->
    ~120 MB at 9.4M cells f32) and, more importantly, the HBM traffic
    of every assembly pass that streams them. The per-(c,k) arrays are
    exposed as properties computing broadcastable select expressions —
    XLA folds them into the consuming fusions, so they cost no memory
    at all. Drop-in duck-type for CKGeometry consumers."""

    interior: jax.Array  # [C,K] bool
    mask: jax.Array  # [C,K] bool
    c_area: jax.Array  # [K]
    c_n_out: jax.Array  # [K,3] outward from c (column-constant)
    c_dist_fo: jax.Array  # [K] |x_face - x_c|
    c_dist_on: jax.Array  # [K] interior |x_nbr - x_c|
    c_zone: jax.Array  # [K] i32 boundary zone slot of the column
    int_slot: int = dataclasses.field(metadata=dict(static=True))
    n_zones: int = dataclasses.field(metadata=dict(static=True))

    @property
    def area(self):
        return jnp.where(self.mask, self.c_area, 0.0)

    @property
    def n_out(self):
        return jnp.where(self.mask[..., None], self.c_n_out, 0.0)

    @property
    def w(self):
        return jnp.where(
            self.interior, jnp.asarray(0.5, self.c_area.dtype), 0.0
        )

    @property
    def r_cf(self):
        return jnp.where(
            self.mask[..., None],
            self.c_dist_fo[:, None] * self.c_n_out,
            0.0,
        )

    @property
    def r_on(self):
        return jnp.where(
            self.interior[..., None],
            self.c_dist_on[:, None] * self.c_n_out,
            self.r_cf,
        )

    @property
    def dist_on(self):
        return jnp.where(
            self.interior,
            self.c_dist_on,
            jnp.where(self.mask, self.c_dist_fo, 1.0),
        )

    @property
    def dist_fo(self):
        return jnp.where(self.mask, self.c_dist_fo, 1.0)

    @property
    def zone_slot(self):
        return jnp.where(
            self.interior | ~self.mask,
            jnp.int32(self.int_slot),
            self.c_zone,
        )


@jax.jit
def _expand_geometry(mesh: CompiledMesh):
    """Traced body of build_ck_geometry (module-level so memory probes
    can lower it without executing)."""
    cf = mesh.cell_faces
    m = mesh.cell_face_mask
    sgn = mesh.cell_face_sign
    area = take(mesh.face_area, cf) * m
    n_out = sgn[..., None] * take(mesh.face_normal, cf)
    cc = mesh.cell_centroid
    interior = take(mesh.face_interior, cf) & m
    # Per-(c,k) geometry in each cell's LOCAL frame, derived from the
    # stored face vectors so periodic wraps see translated images:
    #   owner rows:    x_f - x_c = (x_f - x_own);      c->nbr = +r_on
    #   neighbor rows: x_f - x_c = (x_f - x_own) - r_on; c->nbr = -r_on
    r_on_face = take(mesh.face_r_on, cf)
    r_f_own = take(
        mesh.face_centroid - take(cc, mesh.face_owner), cf
    )
    r_cf = jnp.where(
        (sgn > 0)[..., None], r_f_own, r_f_own - r_on_face
    ) * m[..., None]
    r_on = jnp.where(
        interior[..., None], sgn[..., None] * r_on_face, r_cf
    )
    dist_on = jnp.sqrt(jnp.sum(r_on * r_on, axis=-1))
    dist_fo = jnp.sqrt(jnp.sum(r_cf * r_cf, axis=-1))
    d_nf = r_cf - r_on
    dist_nf = jnp.sqrt(jnp.sum(d_nf * d_nf, axis=-1))
    w = jnp.where(
        interior,
        dist_fo / jnp.maximum(dist_fo + dist_nf, 1e-300),
        0.0,
    )
    return (
        area,
        n_out,
        w,
        r_cf,
        r_on,
        jnp.where(m, dist_on, 1.0),
        jnp.where(m, dist_fo, 1.0),
        interior,
        m,
        cf,
    )

@jax.jit
def _expand_masks(mesh: CompiledMesh):
    m = mesh.cell_face_mask
    return take(mesh.face_interior, mesh.cell_faces) & m, m


def build_ck_geometry(mesh: CompiledMesh, n_zones: int):
    """One-time expansion of face geometry to [C,K].

    Uniform structured boxes (mesh.ck_constants set by the analytic
    generator) skip the expansion entirely: only the interior/mask
    booleans are materialized, everything else is per-column constants
    (UniformCKGeometry).

    Otherwise runs ON DEVICE from the (already-resident) compact mesh
    arrays via layout-safe gathers (ops/layout.py): these happen
    exactly once, instead of expanding on host and uploading ~10
    [C,K(,3)] arrays."""
    if mesh.ck_constants is not None:
        int_slot, cols = mesh.ck_constants
        dt = mesh.dtype
        interior, m = _expand_masks(mesh)
        return UniformCKGeometry(
            interior=interior,
            mask=m,
            c_area=jnp.asarray([c[0] for c in cols], dt),
            c_n_out=jnp.asarray([c[1] for c in cols], dt),
            c_dist_fo=jnp.asarray([c[2] for c in cols], dt),
            c_dist_on=jnp.asarray([c[3] for c in cols], dt),
            c_zone=jnp.asarray([c[4] for c in cols], jnp.int32),
            int_slot=int_slot,
            n_zones=n_zones,
        )
    area, n_out, w, r_cf, r_on, dist_on, dist_fo, interior, m, cf = (
        _expand_geometry(mesh)
    )
    return CKGeometry(
        area=area,
        n_out=n_out,
        w=w,
        r_cf=r_cf,
        r_on=r_on,
        dist_on=dist_on,
        dist_fo=dist_fo,
        interior=interior,
        mask=m,
        zone_slot=take(mesh.face_zone_slot, mesh.cell_faces).astype(jnp.int32),
        n_zones=n_zones,
    )


def nbr_values(mesh: CompiledMesh, x, interior=None):
    """Neighbor-cell values [C,K(,d)] — shifts when structured, one
    gather otherwise. Boundary/padded slots return the cell's own value
    (consistent with the self-index convention).

    Pass the precomputed `interior` mask (CKGeometry.interior) when
    available: it keeps `mesh.cell_faces` out of the traced graph, so
    the [C,K] table is pruned from the executable's arguments (less
    per-dispatch layout normalization of big buffers)."""
    if mesh.neighbor_offsets is not None:
        cols = []
        for d in mesh.neighbor_offsets:
            cols.append(jnp.roll(x, -d, axis=0) if d != 0 else x)
        out = jnp.stack(cols, axis=1)  # [C,K,...]
        # Rows whose slot is not a real interior neighbor must fall back
        # to the cell's own value (rolled values there are arbitrary).
        if interior is None:
            interior = (
                take(mesh.face_interior, mesh.cell_faces)
                & mesh.cell_face_mask
            )
        own = jnp.expand_dims(x, 1)
        cond = interior.reshape(interior.shape + (1,) * (x.ndim - 1))
        return jnp.where(cond, out, own)
    return take(x, mesh.cell_neighbors)


def zone_sel(zone_vals, zone_slot, n_zones: int):
    """Static Z-way select (gather-free) of per-zone values onto [C,K].

    zone_vals: [Z] or [Z,3]; returns [C,K] or [C,K,3]."""
    if zone_vals.ndim == 1:
        out = jnp.full(zone_slot.shape, zone_vals[0], zone_vals.dtype)
        for z in range(1, n_zones):
            out = jnp.where(zone_slot == z, zone_vals[z], out)
        return out
    out = jnp.broadcast_to(
        zone_vals[0], zone_slot.shape + (zone_vals.shape[-1],)
    )
    for z in range(1, n_zones):
        out = jnp.where((zone_slot == z)[..., None], zone_vals[z], out)
    return out


class CKBC(NamedTuple):
    """Per-(c,k) BC data + frequently used masks."""

    code: jnp.ndarray  # [C,K] i32
    scalar: jnp.ndarray  # [C,K]
    vector: jnp.ndarray  # [C,K,3]
    is_wall_like: jnp.ndarray  # wall | symmetry
    is_dirichlet_vel: jnp.ndarray  # wall | velocity inlet
    is_pressure: jnp.ndarray  # pressure inlet | outlet
    is_vel_inlet: jnp.ndarray


def ck_bc(ck: CKGeometry, zone_codes, zone_scalar, zone_vector) -> CKBC:
    code = zone_sel(zone_codes, ck.zone_slot, ck.n_zones)
    scalar = zone_sel(zone_scalar, ck.zone_slot, ck.n_zones)
    vector = zone_sel(zone_vector, ck.zone_slot, ck.n_zones)
    m = ck.mask
    return CKBC(
        code=code,
        scalar=scalar,
        vector=vector,
        is_wall_like=((code == WALL) | (code == SYMMETRY)) & m,
        is_dirichlet_vel=((code == WALL) | (code == VELOCITY_INLET)) & m,
        is_pressure=((code == PRESSURE_INLET) | (code == PRESSURE_OUTLET)) & m,
        is_vel_inlet=(code == VELOCITY_INLET) & m,
    )


def ck_face_pressure(
    mesh, ck: CKGeometry, bc: CKBC, p, scheme: PressureInterpolation,
    grad_p=None, grad_p_nbr=None,
):
    """Face pressure per (c,k) [C,K] (face-major version:
    interpolation.face_pressure)."""
    p_c = p[:, None]
    p_n = nbr_values(mesh, p, ck.interior)
    if scheme == PressureInterpolation.LINEAR:
        interior = 0.5 * (p_c + p_n)
    elif scheme == PressureInterpolation.LINEAR_WEIGHTED:
        interior = p_c + (p_n - p_c) * ck.w
    elif scheme == PressureInterpolation.SECOND_ORDER:
        r_nf = ck.r_cf - ck.r_on  # x_face - x_nbr
        g_c = jnp.sum(grad_p[:, None, :] * ck.r_cf, axis=-1)
        g_n = jnp.sum(grad_p_nbr * r_nf, axis=-1)
        interior = 0.5 * ((p_c + p_n) + (g_c + g_n))
    else:
        raise NotImplementedError(f"pressure interpolation {scheme}")
    return jnp.where(
        bc.is_pressure,
        bc.scalar,
        jnp.where(ck.interior, interior, p_c),
    )


def ck_flux(
    mesh, ck: CKGeometry, bc: CKBC, vel, scheme: VelocityInterpolation,
    p=None, grad_p=None, grad_p_nbr=None, mom_diag=None, mom_diag_nbr=None,
    vel_nbr=None,
):
    """Outward normal velocity per (c,k) [C,K] (face-major version:
    interpolation.face_flux; Rhie-Chow per solver.rs:1051-1095, with
    the +term3 sign fix — see interpolation.face_flux's DELIBERATE
    DEVIATION note)."""
    v_c = vel[:, None, :]
    v_n = vel_nbr if vel_nbr is not None else nbr_values(mesh, vel, ck.interior)
    if scheme in (
        VelocityInterpolation.LINEAR,
        VelocityInterpolation.LINEAR_WEIGHTED,
    ):
        if scheme == VelocityInterpolation.LINEAR:
            vf = 0.5 * (v_c + v_n)
        else:
            vf = v_c + (v_n - v_c) * ck.w[..., None]
        interior = jnp.sum(vf * ck.n_out, axis=-1)
    elif scheme == VelocityInterpolation.RHIE_CHOW:
        md_n = (
            mom_diag_nbr if mom_diag_nbr is not None
            else nbr_values(mesh, mom_diag, ck.interior)
        )
        a_c = jnp.sqrt(
            jnp.sum((mom_diag[:, None, :] * ck.n_out) ** 2, axis=-1)
        )
        a_n = jnp.sqrt(jnp.sum((md_n * ck.n_out) ** 2, axis=-1))
        vol = mesh.cell_volume
        voa_c = vol[:, None] / a_c
        voa_n = nbr_values(mesh, vol, ck.interior) / a_n
        p_n = nbr_values(mesh, p, ck.interior)
        gp_n = grad_p_nbr if grad_p_nbr is not None else nbr_values(mesh, grad_p, ck.interior)
        term1 = jnp.sum((v_c + v_n) * ck.n_out, axis=-1)
        term2 = (voa_c + voa_n) * (p[:, None] - p_n) / ck.dist_on
        gsum = voa_c[..., None] * grad_p[:, None, :] + voa_n[..., None] * gp_n
        term3 = jnp.sum(gsum * ck.r_on, axis=-1) / ck.dist_on
        interior = 0.5 * (term1 + term2 + term3)
    else:
        raise NotImplementedError(f"velocity interpolation {scheme}")

    bnd = jnp.where(
        bc.is_vel_inlet,
        jnp.sum(bc.vector * ck.n_out, axis=-1),
        jnp.sum(v_c * ck.n_out, axis=-1),  # pressure BCs
    )
    return jnp.where(
        bc.is_wall_like,
        0.0,
        jnp.where(ck.interior, interior, jnp.where(ck.mask, bnd, 0.0)),
    )


def ck_pressure_gradient(mesh, ck: CKGeometry, bc: CKBC, p):
    """Green-Gauss cell gradient with Linear face pressures [C,3]."""
    pf = ck_face_pressure(mesh, ck, bc, p, PressureInterpolation.LINEAR)
    wgt = ck.area / mesh.cell_volume[:, None]
    return jnp.sum((wgt * pf)[..., None] * ck.n_out, axis=1)


def ck_lsq_pressure_gradient(mesh, ck: CKGeometry, bc: CKBC, p):
    """Least-squares cell pressure gradient, gather-free (face-major
    version: gradients.pressure_gradient LEAST_SQUARES — same rows:
    interior neighbor deltas, boundary face deltas with the zone value
    at pressure BCs). `ck.r_on` already IS the displacement-row table
    (interior: c->nbr incl. periodic translation; boundary: c->face;
    padded: 0)."""
    from orc_cfd.ops.gradients import _least_squares

    p_c = p[:, None]
    p_n = nbr_values(mesh, p, ck.interior)
    b = jnp.where(
        ck.interior,
        p_n - p_c,
        jnp.where(bc.is_pressure, bc.scalar - p_c, 0.0),
    )
    b = jnp.where(ck.mask, b, 0.0)
    return _least_squares(mesh, ck.r_on, b)


def ck_lsq_velocity_gradient(
    mesh, ck: CKGeometry, bc: CKBC, vel, vel_nbr=None
):
    """Least-squares velocity gradient [C,3,3], gather-free (face-major
    version: gradients.velocity_gradient LEAST_SQUARES)."""
    from orc_cfd.ops.gradients import _least_squares

    v_c = vel[:, None, :]
    v_n = vel_nbr if vel_nbr is not None else nbr_values(mesh, vel, ck.interior)
    b = jnp.where(
        ck.interior[..., None],
        v_n - v_c,
        jnp.where(bc.is_dirichlet_vel[..., None], bc.vector - v_c, 0.0),
    )
    b = jnp.where(ck.mask[..., None], b, 0.0)
    return _least_squares(mesh, ck.r_on, b)


def ck_velocity_gradient(mesh, ck: CKGeometry, bc: CKBC, vel, vel_nbr=None):
    """Green-Gauss velocity gradient [C,3,3] (row i = grad comp i)."""
    v_c = vel[:, None, :]
    v_n = vel_nbr if vel_nbr is not None else nbr_values(mesh, vel, ck.interior)
    vf = jnp.where(
        bc.is_dirichlet_vel[..., None],
        bc.vector,
        jnp.where(ck.interior[..., None], 0.5 * (v_c + v_n), v_c),
    )
    wgt = (ck.area / mesh.cell_volume[:, None])[..., None, None]
    return jnp.sum(wgt * vf[..., :, None] * ck.n_out[..., None, :], axis=1)


def ck_diffusion(mesh, ck: CKGeometry, bc: CKBC, mu):
    """Diffusion contributions (face-major version:
    assembly.diffusion_system)."""
    d_bnd = mu * ck.area / ck.dist_fo
    d_int = mu * ck.area / ck.dist_on
    dirichlet = bc.is_dirichlet_vel & ~ck.interior
    d = jnp.where(ck.interior, d_int, jnp.where(dirichlet, d_bnd, 0.0))
    diag = jnp.sum(d, axis=1)
    off = jnp.where(ck.interior, -d, 0.0)
    b = jnp.sum(
        jnp.where(dirichlet[..., None], d[..., None] * bc.vector, 0.0), axis=1
    )
    return diag, off, b


def ck_momentum(
    mesh, ck: CKGeometry, bc: CKBC, settings: NumericalSettings, rho,
    vel, F, p_f, diff_diag, diff_off, diff_b, grad_vel=None, vel_nbr=None,
    inertia=None,
):
    """Momentum assembly from per-(c,k) mass flows F = flux*area*rho
    (face-major version: assembly.momentum_system)."""
    Fv = F[..., None]
    scheme = settings.momentum
    s_dc = 0.0
    # UD/CD1/TVD_DC coefficients are component-independent: one shared
    # [C]/[C,K] matrix for all three components (see
    # assembly.momentum_system).
    if scheme == MomentumScheme.UD:
        a_nb = jnp.minimum(F, 0.0)  # [C,K], shared
    elif scheme == MomentumScheme.CD1:
        a_nb = F / 2.0  # [C,K], shared
    elif scheme == MomentumScheme.CD2:
        if grad_vel is None:
            raise ValueError("CD2 momentum requires grad_vel")
        gv_n = nbr_values(mesh, grad_vel, ck.interior)
        r_nf = ck.r_cf - ck.r_on
        g_c = jnp.einsum("cij,ckj->cki", grad_vel, ck.r_cf, precision="highest")
        g_d = jnp.sum(gv_n * r_nf[..., None, :], axis=-1)
        delta = 0.5 * (g_c + g_d)
        a_nb = Fv / 2.0 * jnp.ones((1, 1, 3), F.dtype)
        s_dc = -jnp.sum(jnp.where(ck.interior[..., None], Fv * delta, 0.0), axis=1)
    elif scheme == MomentumScheme.TVD:
        if settings.tvd_psi is None or grad_vel is None:
            raise ValueError("TVD momentum requires tvd_psi and grad_vel")
        psi = settings.tvd_psi
        v_c = vel[:, None, :]
        v_n = vel_nbr if vel_nbr is not None else nbr_values(mesh, vel, ck.interior)
        downstream = jnp.where(Fv > 0, v_n, v_c)
        diffv = downstream - v_c
        same = jnp.sqrt(jnp.sum(diffv * diffv, axis=-1)) == 0.0
        gdotr = jnp.einsum("cij,ckj->cki", grad_vel, ck.r_on, precision="highest")
        safe = jnp.where(diffv == 0.0, 1.0, diffv)
        r = jnp.where(diffv == 0.0, 1.0, 2.0 * gdotr / safe - 1.0)
        a_tvd = Fv * psi(r) / 2.0
        a_cd = Fv / 2.0 * jnp.ones_like(a_tvd)
        a_ud = jnp.minimum(Fv, 0.0) * jnp.ones_like(a_tvd)
        a_nb = jnp.where(
            ck.interior[..., None], jnp.where(same[..., None], a_cd, a_tvd), a_ud
        )
    elif scheme == MomentumScheme.TVD_DC:
        # Deferred-correction TVD (assembly.momentum_system TVD_DC, the
        # gather-free version): implicit UD matrix + explicit limited
        # increment from the upwind side (conservative by construction).
        if settings.tvd_psi is None or grad_vel is None:
            raise ValueError("TVD_DC momentum requires tvd_psi and grad_vel")
        psi = settings.tvd_psi
        a_nb = jnp.minimum(F, 0.0)  # [C,K]: the UD matrix, shared
        v_c = vel[:, None, :]
        v_n = vel_nbr if vel_nbr is not None else nbr_values(mesh, vel, ck.interior)
        g_n = nbr_values(mesh, grad_vel, ck.interior)
        d_cd = v_n - v_c
        up_is_c = (Fv > 0)
        delta = jnp.where(up_is_c, d_cd, -d_cd)  # phi_D - phi_U
        g_c = jnp.einsum("cij,ckj->cki", grad_vel, ck.r_on, precision="highest")
        g_nb = -jnp.sum(g_n * ck.r_on[..., None, :], axis=-1)
        gdotr = jnp.where(up_is_c, g_c, g_nb)  # grad_U . r_UD
        safe = jnp.where(delta == 0.0, 1.0, delta)
        r = 2.0 * gdotr / safe - 1.0
        corr = jnp.where(delta == 0.0, 0.0, psi(r) / 2.0 * delta)
        s_dc = -jnp.sum(
            jnp.where(ck.interior[..., None], Fv * corr, 0.0), axis=1
        )
    else:
        raise NotImplementedError(f"momentum scheme {scheme}")
    shared = a_nb.ndim == 2  # component-independent matrix
    if shared:
        a_nb = jnp.where(ck.mask, a_nb, 0.0)
        a_p = jnp.sum(jnp.where(ck.mask, -a_nb + F, 0.0), axis=1)  # [C]
        a_nb_src = a_nb[..., None]
    else:
        a_nb = jnp.where(ck.mask[..., None], a_nb, 0.0)
        a_p = jnp.sum(jnp.where(ck.mask[..., None], -a_nb + Fv, 0.0), axis=1)
        a_nb_src = a_nb
    s_u = -jnp.sum(
        jnp.where(
            ck.mask[..., None], ck.n_out * (p_f * ck.area)[..., None], 0.0
        ),
        axis=1,
    )
    dirichlet = bc.is_dirichlet_vel & ~ck.interior
    s_u = s_u + jnp.sum(
        jnp.where(dirichlet[..., None], (a_nb_src - Fv) * bc.vector, 0.0), axis=1
    )
    s_u = s_u + s_dc
    if settings.momentum_source is not None:
        from orc_cfd.ops.fields import momentum_source_term

        s_u = s_u + momentum_source_term(
            settings.momentum_source, mesh.cell_centroid, mesh.cell_volume
        )

    active = ck.mask.any(axis=1)
    a_t = 0.0
    s_t = 0.0
    if inertia is not None:
        rv_dt, vel_n = inertia
        a_t = rv_dt if shared else rv_dt[:, None]
        s_t = rv_dt[:, None] * vel_n
    from orc_cfd.utils.settings import RelaxationMode

    nbrs = (
        None if mesh.neighbor_offsets is not None else mesh.cell_neighbors
    )  # omitted on the shift path (see ck_pressure_correction)
    if shared:
        off = jnp.where(ck.interior, a_nb + diff_off, 0.0)  # [C,K]
        diag = a_p + diff_diag + a_t  # [C]
        b = s_u + diff_b + s_t  # [C,3]
        if settings.relaxation_mode == RelaxationMode.IMPLICIT:
            alpha = settings.momentum_relaxation
            b = b + (1.0 - alpha) / alpha * diag[:, None] * vel
            diag = diag / alpha
        diag = jnp.where(active, diag, 1.0)
        b = jnp.where(active[:, None], b, 0.0)
        pe = jnp.where(
            active[:, None],
            (a_p / jnp.where(active, diff_diag, 1.0))[:, None]
            * jnp.ones((1, 3), a_p.dtype),
            0.0,
        )
        A = EllMatrix(
            diag=diag,  # [C], shared by u/v/w
            off=off,  # [C,K]
            neighbors=nbrs,
            offsets=mesh.neighbor_offsets,
            plan=mesh.slice_plan,
        )
        return A, jnp.moveaxis(b, -1, 0), pe

    off = jnp.where(ck.interior[..., None], a_nb + diff_off[..., None], 0.0)
    diag = a_p + diff_diag[:, None] + a_t
    b = s_u + diff_b + s_t
    if settings.relaxation_mode == RelaxationMode.IMPLICIT:
        alpha = settings.momentum_relaxation
        b = b + (1.0 - alpha) / alpha * diag * vel
        diag = diag / alpha
    diag = jnp.where(active[:, None], diag, 1.0)
    b = jnp.where(active[:, None], b, 0.0)
    pe = jnp.where(
        active[:, None],
        a_p / jnp.where(active, diff_diag, 1.0)[:, None],
        0.0,
    )
    A = EllMatrix(
        diag=jnp.moveaxis(diag, -1, 0),
        off=jnp.moveaxis(off, -1, 0),
        neighbors=nbrs,
        offsets=mesh.neighbor_offsets,
        plan=mesh.slice_plan,
    )
    return A, jnp.moveaxis(b, -1, 0), pe


def ck_pressure_correction(
    mesh, ck: CKGeometry, bc: CKBC, rho, F2, mom_diag, mom_diag_nbr=None
):
    """SIMPLE continuity system from per-(c,k) mass flows
    (face-major version: assembly.pressure_correction_system)."""
    b = jnp.sum(jnp.where(ck.mask, -F2, 0.0), axis=1)
    md_n = (
        mom_diag_nbr if mom_diag_nbr is not None
        else nbr_values(mesh, mom_diag, ck.interior)
    )
    a_c = jnp.sqrt(jnp.sum((mom_diag[:, None, :] * ck.n_out) ** 2, axis=-1))
    a_face = 0.5 * jnp.sqrt(
        jnp.sum(((mom_diag[:, None, :] + md_n) * ck.n_out) ** 2, axis=-1)
    )
    a_nb = rho * ck.area**2 / a_face
    # All boundary faces contribute rho A^2/a/2, following the
    # reference INCLUDING its spurious prescribed-flux terms — they act
    # as the screened-Poisson damping the stateless-flux outer loop
    # needs (full rationale: assembly.pressure_correction_system).
    a_bnd = rho * ck.area**2 / a_c / 2.0
    active = ck.mask.any(axis=1)
    diag = jnp.sum(
        jnp.where(ck.interior, a_nb, jnp.where(ck.mask, a_bnd, 0.0)), axis=1
    )
    diag = jnp.where(active, diag, 1.0)
    b = jnp.where(active, b, 0.0)
    off = jnp.where(ck.interior, -a_nb, 0.0)
    return (
        EllMatrix(
            diag=diag,
            off=off,
            # The shift path never reads `neighbors`; omitting it for
            # structured meshes prunes the [C,K] table from the jitted
            # executable's arguments (less per-dispatch layout work).
            neighbors=(
                None
                if mesh.neighbor_offsets is not None
                else mesh.cell_neighbors
            ),
            offsets=mesh.neighbor_offsets,
            plan=mesh.slice_plan,
        ),
        b,
    )


def ck_apply_correction(
    mesh, ck: CKGeometry, bc: CKBC, settings, p_prime, mom_diag, vel, p
):
    """SIMPLE update (face-major version:
    assembly.apply_pressure_correction — the interior face value is
    selected by settings.pressure_correction_form)."""
    from orc_cfd.utils.settings import PressureCorrectionForm

    pp_nb = nbr_values(mesh, p_prime, ck.interior)
    if settings.pressure_correction_form == PressureCorrectionForm.FACE_VALUE:
        pp_int = 0.5 * (p_prime[:, None] + pp_nb)
    else:  # CELL_DIFFERENCE (reference parity, the default)
        pp_int = pp_nb
    pp_f = jnp.where(
        ck.interior,
        pp_int,
        jnp.where(bc.is_pressure, 0.0, p_prime[:, None]),
    )
    scaled_n = ck.n_out / mom_diag[:, None, :]
    dpp = (p_prime[:, None] - pp_f) * ck.area
    corr = jnp.sum(
        jnp.where(ck.mask[..., None], scaled_n * dpp[..., None], 0.0), axis=1
    )
    from orc_cfd.utils.settings import RelaxationMode

    corr_factor = (
        1.0
        if settings.relaxation_mode == RelaxationMode.IMPLICIT
        else settings.momentum_relaxation
    )
    new_vel = vel + corr_factor * corr
    new_p = p + settings.pressure_relaxation * p_prime
    active = ck.mask.any(axis=1)
    p_sq = jnp.sum(jnp.where(active, p_prime * p_prime, 0.0))
    v_sq = jnp.sum(jnp.where(active[:, None], corr * corr, 0.0))
    return new_vel, new_p, (p_sq, v_sq)
