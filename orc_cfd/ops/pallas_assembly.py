"""Fused momentum/pressure-correction assembly kernels (Pallas, Triton
route).

Each kernel computes an ENTIRE assembly pass for one block of cells:
it reads the cell fields once (u, v, w, p and — scheme-dependent —
grad p, the shared momentum diagonal, grad vel), writes only what the
solver consumes (matrix diag/off + RHS), and keeps every per-(c,k)
intermediate (face fluxes, face pressures, coefficients) in registers.
The XLA ck path (ops/ck_ops.py: ck_momentum / ck_pressure_correction)
is the plain reference these kernels are pinned against.

Scope (gated by callers via solver/simple._pallas_asm_spec):
- UNIFORM structured box meshes (UniformCKGeometry: per-column
  constant geometry, so every column is a static ColumnSpec);
- momentum schemes UD / CD1 / TVD_DC (the shared-matrix set — see
  assembly.momentum_system; reference advection menu:
  discretization.rs:133-356);
- Linear / LinearWeighted face velocities AND Rhie-Chow
  (solver.rs:1051-1095); Linear / LinearWeighted / SecondOrder face
  pressures (solver.rs:1124-1147);
- implicit (Patankar) relaxation; the transient inertia term
  rho V/dt (phi - phi^n) as optional inputs;
- WALL / SYMMETRY / VELOCITY_INLET / pressure-BC columns specialized
  statically per column from the zone constants.

The momentum matrix comes out in the SHARED form (diag [C], off [C,K]
— see assembly.momentum_system): UD/CD1/TVD_DC coefficients are
component-independent. Math is pinned against ck_momentum /
ck_pressure_correction / solver.fc by tests/test_pallas_assembly.py.

Layout: one program per BLOCK consecutive cells (a power of two, as
Triton requires). Every input stays in its natural cell-major layout
in device memory ([C], [C,3], [C,3,3], [C,K]); a neighbor value at
flat offset d is a load at index clip(c + d, 0, C-1), served by L1/L2
for the halo reuse between neighboring blocks. Clipped positions only
ever feed lanes that the per-cell interior flags select away. Outputs
are stored masked to the C real cells, so no operand or result is
padded or copied around the call.

f32 only: the kernels are the single-precision fast path (f64 runs
take the XLA ck path).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

#: Cells per program (power of two) and warps per program. Each thread
#: holds BLOCK / (32 * NUM_WARPS) cells' worth of ~30 live values.
BLOCK = 512
NUM_WARPS = 4


class ColumnSpec(NamedTuple):
    """Static per-ELL-column description of a uniform box mesh."""

    offset: int  # flat neighbor index delta (0 for z columns of a 2D box)
    area: float
    n_out: tuple  # (nx, ny, nz) outward unit normal, column-constant
    dist_fo: float  # |x_face - x_c|
    dist_on: float  # interior |x_nbr - x_c|
    kind: str  # "wall" | "symmetry" | "pressure" | "vinlet"
    zone: int  # zone slot (row of the traced bc-values array)


class AsmSpec(NamedTuple):
    """Static scheme selection for the fused kernels (one compilation
    per distinct spec)."""

    scheme: str = "ud"  # "ud" | "cd1" | "tvd_dc"
    rc: bool = False  # Rhie-Chow face fluxes (else Linear[Weighted])
    p_so: bool = False  # SecondOrder face pressures (else Linear[W])
    psi: object = None  # static TVD limiter callable (tvd_dc only)
    vol: float = 0.0  # uniform cell volume (rc / FC d-coefficients)
    # Compute the Green-Gauss cell pressure gradient IN-KERNEL from p
    # and the neighbor cells' flags instead of reading an XLA-computed
    # grad-p array — removes the separate gradient pass. Single-device
    # only: the sharded slab partition keeps a 1-deep ghost layer, but
    # the in-kernel NEIGHBOR gradient needs p (and interior flags) 2
    # layers deep — sharded runs read ppermute-refreshed grad p instead
    # (solver/simple._pallas_asm_spec).
    gg: bool = False


ACTIVE_BIT = 6  # flag bit marking real (non-padded) cells


def pack_flags(interior, mask):
    """[C] int8 per-cell flags: bit k = column k interior, bit 6 =
    active row (one byte per cell of boundary structure)."""
    C, K = interior.shape
    assert K <= ACTIVE_BIT
    f = jnp.zeros((C,), jnp.int32)
    for k in range(K):
        f = f | (interior[:, k].astype(jnp.int32) << k)
    f = f | (mask.any(axis=1).astype(jnp.int32) << ACTIVE_BIT)
    return f.astype(jnp.int8)


def _axis(col: ColumnSpec) -> int:
    """Static axis index of the column's unit normal."""
    return max(range(3), key=lambda i: abs(col.n_out[i]))


def _gp_axes(cols, spec: AsmSpec):
    """Axes whose grad-p component the kernels read (interior columns
    only — boundary faces never use gradient terms)."""
    if not (spec.rc or spec.p_so):
        return ()
    return tuple(sorted({_axis(c) for c in cols if c.offset != 0}))


def _dot_n(u, v, w, n):
    """u*nx + v*ny + w*nz skipping statically-zero components."""
    nx, ny, nz = n
    acc = None
    for val, comp in ((u, nx), (v, ny), (w, nz)):
        if comp:
            t = val * comp if comp != 1.0 else val
            acc = t if acc is None else acc + t
    return acc


def _block(n_cells):
    """This program's cell indices, their store mask, and a memoized
    loader `at(ref, d=0, stride=1, comp=0)` returning
    ref[stride * clip(c + d) + comp] for the block's cells c."""
    start = pl.program_id(0) * BLOCK
    cell = start + jnp.arange(BLOCK, dtype=jnp.int32)
    ok = cell < n_cells
    cache = {}

    def at(ref, d=0, stride=1, comp=0):
        key = (id(ref), d, stride, comp)
        if key not in cache:
            idx = jnp.clip(cell + d, 0, n_cells - 1)
            if stride != 1 or comp:
                idx = idx * stride + comp
            cache[key] = ref[idx]
        return cache[key]

    return start, ok, at


def _store(ref, val, start, ok, row=None):
    """Masked store of one block (row `row` of a [R, C] output)."""
    dst = pl.ds(start, BLOCK)
    if row is not None:
        dst = (jnp.int32(row), dst)
    plt.store(ref.at[dst], val, mask=ok)


def _flags_at(at, flags_ref, d=0):
    return at(flags_ref, d).astype(jnp.int32)


def _gg_eval(cols, spec, at, p_ref, flags_ref, bc_ref, zero):
    """Lazy in-kernel Green-Gauss CELL pressure gradient (Linear face
    pressures — exactly ck_ops.ck_pressure_gradient) evaluated at
    (axis, cell-offset d0); memoized per (axis, d0) so gp_c at d0=0 is
    computed once for all columns. Values at cells whose flags mark
    them past the domain are finite garbage selected away by the
    caller's `interior` selects."""
    cache = {}

    def gp(ax, d0):
        key = (ax, d0)
        if key in cache:
            return cache[key]
        fl = _flags_at(at, flags_ref, d0)
        p_c = at(p_ref, d0)
        acc = zero
        for k2, col2 in enumerate(cols):
            na2 = col2.n_out[ax]
            if not na2:
                continue  # statically zero contribution to this axis
            p_n = at(p_ref, d0 + col2.offset)
            i2 = ((fl >> k2) & 1) == 1
            if col2.kind == "pressure":
                p_b = jnp.zeros_like(p_c) + bc_ref[4 * col2.zone + 3]
            else:
                p_b = p_c
            p_f = jnp.where(i2, 0.5 * (p_c + p_n), p_b)
            acc = acc + (na2 * col2.area / spec.vol) * p_f
        cache[key] = acc
        return acc

    return gp


def _vn_boundary(col, u_c, v_c, w_c, bc_ref, zero):
    """Boundary-face normal velocity of column `col`."""
    if col.kind == "pressure":
        return _dot_n(u_c, v_c, w_c, col.n_out)
    if col.kind == "vinlet":
        z = 4 * col.zone
        return zero + _dot_n(
            bc_ref[z], bc_ref[z + 1], bc_ref[z + 2], col.n_out
        )
    return zero  # wall / symmetry: no flux through the face


def _momentum_kernel(
    cols, fc, spec, gp_axes, tvd, transient, n_cells,
    params_ref, bc_ref, flags_ref, vel_ref, p_ref, *refs,
):
    """Shared body for the parity and SIMPLE_FC momentum assemblies.

    `fc` (static): advect with the STORED [C,K] flux instead of
    interpolating face velocities — the only difference between the two
    couplings' momentum systems (solver/fc.py: ck_momentum is called
    with F = state.flux * A * rho).

    `spec` (static) selects the advection scheme (UD/CD1/TVD_DC), the
    face-velocity model (Linear vs Rhie-Chow) and the face-pressure
    model (Linear vs SecondOrder); `transient` adds the implicit-Euler
    inertia term from rv_dt / vel^n inputs.
    """
    refs = list(refs)
    gp_ref = refs.pop(0) if gp_axes and not spec.gg else None
    md_ref = refs.pop(0) if spec.rc and not fc else None
    gv_ref = refs.pop(0) if tvd else None
    flux_ref = refs.pop(0) if fc else None
    if transient:
        rvdt_ref, veln_ref = refs.pop(0), refs.pop(0)
    diag_ref, off_ref, b_ref = refs
    K = len(cols)

    start, ok, at = _block(n_cells)
    flags = _flags_at(at, flags_ref)
    active = ((flags >> ACTIVE_BIT) & 1) == 1
    rho = params_ref[0]
    mu = params_ref[1]
    alpha = params_ref[2]

    def vel(i, d=0):
        return at(vel_ref, d, 3, i)

    u_c, v_c, w_c, p_c = vel(0), vel(1), vel(2), at(p_ref)
    zero = jnp.zeros_like(u_c)
    one = jnp.ones_like(u_c)
    gp_eval = (
        _gg_eval(cols, spec, at, p_ref, flags_ref, bc_ref, zero)
        if spec.gg
        else None
    )
    if md_ref is not None:
        voa_c = spec.vol / at(md_ref)

    diag = zero
    bu = zero
    bv = zero
    bw = zero
    for k, col in enumerate(cols):
        d = col.offset
        interior = ((flags >> k) & 1) == 1
        ax = _axis(col) if d != 0 else None
        na = col.n_out[ax] if ax is not None else 0.0

        p_n = at(p_ref, d)
        if not fc or tvd:
            u_n, v_n, w_n = vel(0, d), vel(1, d), vel(2, d)
        if ax is not None and ax in gp_axes:
            if spec.gg:
                gp_c = gp_eval(ax, 0)
                gp_n = gp_eval(ax, d)
            else:
                gp_c = at(gp_ref, 0, 3, ax)
                gp_n = at(gp_ref, d, 3, ax)
        # --- face mass flow F ---
        if fc:
            # SIMPLE_FC: the conservative stored flux IS the face flux
            # (corrected through the p-matrix coefficients at the end
            # of the previous iteration).
            F = at(flux_ref, 0, K, k) * (col.area * rho)
        else:
            if spec.rc:
                # Rhie-Chow (interpolation.face_flux / ck_flux):
                # 0.5 [ (v_c+v_n).n + (V/a_c+V/a_n)(p_c-p_n)/d_on
                #       + (V/a_c gp_c + V/a_n gp_n).n ]
                voa_n = spec.vol / at(md_ref, d)
                term1 = _dot_n(u_c + u_n, v_c + v_n, w_c + w_n, col.n_out)
                term2 = (voa_c + voa_n) * (p_c - p_n) * (1.0 / col.dist_on)
                term3 = (voa_c * gp_c + voa_n * gp_n) * na
                vn_int = 0.5 * (term1 + term2 + term3)
            else:
                # LinearWeighted == Linear on a uniform box.
                vn_int = 0.5 * _dot_n(
                    u_c + u_n, v_c + v_n, w_c + w_n, col.n_out
                )
            vn_bnd = _vn_boundary(col, u_c, v_c, w_c, bc_ref, zero)
            F = jnp.where(interior, vn_int, vn_bnd) * (col.area * rho)
        # --- advection coefficient (shared-matrix schemes) ---
        if spec.scheme == "cd1":
            a_nb = F * 0.5
        else:  # UD matrix (also the TVD_DC implicit matrix)
            a_nb = jnp.minimum(F, 0.0)
        d_int = mu * col.area / col.dist_on
        d_bnd = mu * col.area / col.dist_fo
        _store(
            off_ref, jnp.where(active & interior, a_nb - d_int, 0.0),
            start, ok, row=k,
        )
        # diag: -a_nb + F on every face + diffusion on interior /
        # Dirichlet-velocity faces (wall & symmetry boundary terms are
        # identically 0 since F == 0 there).
        dirichlet = col.kind in ("wall", "vinlet")
        d_b = d_bnd if dirichlet else 0.0
        diag = diag + jnp.where(interior, -a_nb + F + d_int, -a_nb + F + d_b)
        if dirichlet:
            # Dirichlet sources: (a_nb - F) * v_bc + d_bnd * v_bc (the
            # diffusion part rides DiffusionSystem.b in the reference
            # formulation). BC velocities come from the TRACED zone
            # table (no recompile on value changes).
            s_w = jnp.where(interior, 0.0, (a_nb - F) + d_bnd)
            z = 4 * col.zone
            bu = bu + s_w * bc_ref[z]
            bv = bv + s_w * bc_ref[z + 1]
            bw = bw + s_w * bc_ref[z + 2]
        # --- TVD deferred correction (ck_momentum TVD_DC) ---
        if tvd and d != 0:
            up_c = F > 0
            e_on = na * col.dist_on  # grad.r_on = gv[.,ax]*na*d_on
            comps = ((u_c, u_n), (v_c, v_n), (w_c, w_n))
            accs = []
            for i, (x_c, x_n) in enumerate(comps):
                gv_c = at(gv_ref, 0, 9, 3 * i + ax)
                gv_n = at(gv_ref, d, 9, 3 * i + ax)
                d_cd = x_n - x_c
                delta = jnp.where(up_c, d_cd, -d_cd)
                gdotr = jnp.where(up_c, gv_c * e_on, gv_n * (-e_on))
                safe = jnp.where(delta == 0.0, one, delta)
                rr = 2.0 * gdotr / safe - 1.0
                corr = jnp.where(
                    delta == 0.0, zero, spec.psi(rr) * 0.5 * delta
                )
                accs.append(jnp.where(interior, F * corr, 0.0))
            bu = bu - accs[0]
            bv = bv - accs[1]
            bw = bw - accs[2]
        # --- pressure force: -n_out * p_f * area ---
        if col.kind == "pressure":
            p_bnd = zero + bc_ref[4 * col.zone + 3]
        else:
            p_bnd = p_c
        if spec.p_so and d != 0:
            # SecondOrder (ck_face_pressure): p_f = 0.5[(p_c+p_n)
            # + gp_c.r_cf + gp_n.(r_cf - r_on)].
            e_c = na * col.dist_fo
            e_n = na * (col.dist_fo - col.dist_on)
            p_int = 0.5 * ((p_c + p_n) + gp_c * e_c + gp_n * e_n)
        else:
            p_int = 0.5 * (p_c + p_n)
        pfA = jnp.where(interior, p_int, p_bnd) * col.area
        nxk, nyk, nzk = col.n_out
        if nxk:
            bu = bu - nxk * pfA
        if nyk:
            bv = bv - nyk * pfA
        if nzk:
            bw = bw - nzk * pfA

    if transient:
        # Implicit-Euler inertia: rho V/dt on the diagonal, rho V/dt *
        # vel^n on the RHS (ck_momentum `inertia`).
        rvdt = at(rvdt_ref)
        diag = diag + rvdt
        bu = bu + rvdt * at(veln_ref, 0, 3, 0)
        bv = bv + rvdt * at(veln_ref, 0, 3, 1)
        bw = bw + rvdt * at(veln_ref, 0, 3, 2)
    # Implicit (Patankar) relaxation + inactive padding rows.
    relax = (1.0 - alpha) / alpha
    bu = bu + relax * diag * u_c
    bv = bv + relax * diag * v_c
    bw = bw + relax * diag * w_c
    diag = diag / alpha
    _store(diag_ref, jnp.where(active, diag, one), start, ok)
    for i, bi in enumerate((bu, bv, bw)):
        _store(b_ref, jnp.where(active, bi, 0.0), start, ok, row=i)


def _call(kernel, name, operands, out_shapes, interpret):
    """pallas_call over one program per BLOCK cells (Triton route).
    Every operand and result is a whole array in device memory."""
    C = out_shapes[0][-1]
    return pl.pallas_call(
        kernel,
        out_shape=tuple(
            jax.ShapeDtypeStruct(s, jnp.float32) for s in out_shapes
        ),
        grid=(pl.cdiv(C, BLOCK),),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * len(operands),
        out_specs=tuple(
            pl.BlockSpec(memory_space=pl.ANY) for _ in out_shapes
        ),
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        interpret=interpret,
        name=name,
    )(*operands)


def _flat(x):
    """Cell-major flat view (a bitcast of the row-major array)."""
    return jnp.asarray(x, jnp.float32).reshape(-1)


def _params(*vals):
    return jnp.stack([jnp.asarray(v, jnp.float32) for v in vals])


@functools.partial(
    jax.jit,
    static_argnames=("cols", "spec", "interpret"),
)
def momentum_assembly(
    vel, p, bc_values, flags, cols: tuple, rho, mu,
    alpha, grad_p=None, mom_diag=None, grad_vel=None, inertia=None,
    spec: AsmSpec = AsmSpec(), interpret: bool = False,
):
    """Fused momentum assembly on a uniform box.

    vel [C,3], p [C] -> (diag [C], off [C,K], b [3,C]) in the shared-
    matrix form of assembly.momentum_system. `cols` is a tuple of
    ColumnSpec; `flags` [C] int8 from pack_flags; `bc_values` [Z,4]
    stacks the traced zone tables (vx, vy, vz, pressure); rho / mu /
    alpha are traced scalars. Scheme-dependent traced extras:
    `grad_p` [C,3] (rc / p_so), `mom_diag` [C] shared diagonal (rc),
    `grad_vel` [C,3,3] (tvd_dc), `inertia` = (rv_dt [C], vel_n [C,3]).
    """
    return _momentum_asm(
        vel, p, None, bc_values, flags, cols, rho, mu, alpha,
        grad_p, mom_diag, grad_vel, inertia, spec, interpret
    )


@functools.partial(
    jax.jit,
    static_argnames=("cols", "spec", "interpret"),
)
def fc_momentum_assembly(
    vel, p, flux, bc_values, flags, cols: tuple, rho, mu,
    alpha, grad_p=None, grad_vel=None, inertia=None,
    spec: AsmSpec = AsmSpec(), interpret: bool = False,
):
    """SIMPLE_FC fused momentum assembly: identical to
    momentum_assembly except advection uses the stored conservative
    [C,K] flux (solver/fc.py) instead of interpolated face
    velocities (so `mom_diag` is never needed)."""
    return _momentum_asm(
        vel, p, flux, bc_values, flags, cols, rho, mu, alpha,
        grad_p, None, grad_vel, inertia, spec, interpret
    )


def _momentum_asm(
    vel, p, flux, bc_values, flags, cols, rho, mu, alpha,
    grad_p, mom_diag, grad_vel, inertia, spec, interpret
):
    fc = flux is not None
    if fc:
        # The FC flux predictor reads iteration-START grad p computed
        # in fc.py; FC kernels always read the grad-p array.
        spec = spec._replace(gg=False)
    transient = inertia is not None
    tvd = spec.scheme == "tvd_dc"
    C = p.shape[0]
    K = len(cols)
    gp_axes = _gp_axes(cols, spec)
    if gp_axes and fc and not spec.p_so:
        gp_axes = ()  # FC momentum with Linear p never reads grad p

    operands = [
        _params(rho, mu, alpha), _flat(bc_values), flags, _flat(vel),
        _flat(p),
    ]
    if gp_axes and not spec.gg:
        operands.append(_flat(grad_p))
    if spec.rc and not fc:
        operands.append(_flat(mom_diag))
    if tvd:
        operands.append(_flat(grad_vel))
    if fc:
        operands.append(_flat(flux))
    if transient:
        rv_dt, vel_n = inertia
        operands += [_flat(rv_dt), _flat(vel_n)]

    kern = functools.partial(
        _momentum_kernel, tuple(cols), fc, spec, gp_axes, tvd, transient, C
    )
    diag, off, b3 = _call(
        kern,
        "fc_momentum_assembly" if fc else "momentum_assembly",
        operands,
        ((C,), (K, C), (3, C)),
        interpret,
    )
    return diag, jnp.moveaxis(off, 0, -1), b3


def _pc_kernel(
    cols, spec, gp_axes, n_cells,
    params_ref, bc_ref, flags_ref, vel_ref, md_ref, *refs,
):
    """Parity pressure-correction assembly (ck_flux + ck_pressure_
    correction in one pass)."""
    refs = list(refs)
    p_ref = refs.pop(0) if spec.rc else None
    gp_ref = refs.pop(0) if spec.rc and not spec.gg else None
    diag_ref, off_ref, b_ref = refs

    start, ok, at = _block(n_cells)
    flags = _flags_at(at, flags_ref)
    active = ((flags >> ACTIVE_BIT) & 1) == 1
    rho = params_ref[0]

    def vel(i, d=0):
        return at(vel_ref, d, 3, i)

    u_c, v_c, w_c, md_c = vel(0), vel(1), vel(2), at(md_ref)
    zero = jnp.zeros_like(u_c)
    gp_eval = (
        _gg_eval(cols, spec, at, p_ref, flags_ref, bc_ref, zero)
        if spec.gg
        else None
    )
    if spec.rc:
        p_c = at(p_ref)
        voa_c = spec.vol / md_c
    diag = zero
    b = zero
    for k, col in enumerate(cols):
        d = col.offset
        interior = ((flags >> k) & 1) == 1
        ax = _axis(col) if d != 0 else None
        na = col.n_out[ax] if ax is not None else 0.0

        u_n, v_n, w_n, md_n = vel(0, d), vel(1, d), vel(2, d), at(md_ref, d)
        term1 = _dot_n(u_c + u_n, v_c + v_n, w_c + w_n, col.n_out)
        if spec.rc and ax is not None:
            p_n = at(p_ref, d)
            if spec.gg:
                gp_c = gp_eval(ax, 0)
                gp_n = gp_eval(ax, d)
            else:
                gp_c = at(gp_ref, 0, 3, ax)
                gp_n = at(gp_ref, d, 3, ax)
            voa_n = spec.vol / md_n
            term2 = (voa_c + voa_n) * (p_c - p_n) * (1.0 / col.dist_on)
            term3 = (voa_c * gp_c + voa_n * gp_n) * na
            vn_int = 0.5 * (term1 + term2 + term3)
        else:
            vn_int = 0.5 * term1
        vn_bnd = _vn_boundary(col, u_c, v_c, w_c, bc_ref, zero)
        F2 = jnp.where(interior, vn_int, vn_bnd) * (col.area * rho)
        b = b - F2
        # Shared momentum diag: |md * n| == md for unit normals.
        a_face = 0.5 * (md_c + md_n)
        a_nb = (rho * col.area * col.area) / a_face
        a_bnd = (rho * col.area * col.area) / md_c * 0.5
        _store(
            off_ref, jnp.where(active & interior, -a_nb, 0.0),
            start, ok, row=k,
        )
        diag = diag + jnp.where(interior, a_nb, a_bnd)
    _store(diag_ref, jnp.where(active, diag, jnp.ones_like(diag)), start, ok)
    _store(b_ref, jnp.where(active, b, 0.0), start, ok)


@functools.partial(
    jax.jit, static_argnames=("cols", "spec", "interpret")
)
def pc_assembly(
    vel, mom_diag, bc_values, flags, cols: tuple, rho,
    p=None, grad_p=None,
    spec: AsmSpec = AsmSpec(), interpret: bool = False,
):
    """Fused pressure-correction assembly on a uniform box.

    vel [C,3] (post-momentum), mom_diag [C] (SHARED momentum diagonal)
    -> (diag [C], off [C,K], b [C]) matching ck_pressure_correction.
    The RHS flux matches ck_flux with the configured face-velocity
    model: LinearWeighted (spec.rc False) or Rhie-Chow (spec.rc True,
    requiring `p` and `grad_p` from the ITERATION START — exactly what
    ck_simple_step feeds its flux2)."""
    # The non-RC pc kernel never reads p, so gg is meaningful only
    # under Rhie-Chow (schemes like UD+SecondOrder set spec.gg for the
    # momentum kernel alone).
    spec = spec._replace(gg=spec.gg and spec.rc)
    C = mom_diag.shape[0]
    K = len(cols)
    gp_axes = _gp_axes(cols, spec) if spec.rc else ()
    operands = [
        _params(rho), _flat(bc_values), flags, _flat(vel),
        _flat(mom_diag),
    ]
    if spec.rc:
        operands.append(_flat(p))
        if not spec.gg:
            operands.append(_flat(grad_p))
    kern = functools.partial(_pc_kernel, tuple(cols), spec, gp_axes, C)
    diag, off, b = _call(
        kern, "pc_assembly", operands, ((C,), (K, C), (C,)), interpret
    )
    return diag, jnp.moveaxis(off, 0, -1), b


def _fc_pc_kernel(
    cols, spec, n_cells,
    params_ref, bc_ref, flags_ref, vel_ref, md_ref, *refs,
):
    """Fused SIMPLE_FC full-p continuity assembly (solver/fc.py:
    ck_flux_h + ck_d_coeffs + ck_fc_pressure_system in one pass).

    Differences from the parity _pc_kernel: the matrix coefficient is
    the Rhie-Chow damping d_f = 0.5 rho A (V/a_c + V/a_n)/dist (NOT the
    reference's rho A^2/a form), pressure columns close with a
    one-sided Dirichlet d_b and add d_b * p_BC to the RHS,
    prescribed-flux boundaries contribute NOTHING to the matrix, and
    the flux predictor flux_h is emitted ([K,C] output) for the
    conservative correction after the p-solve. With spec.rc the
    predictor is the Rhie-Chow flux WITHOUT its compact term2 (the
    pressure equation re-adds it — fc.face_flux_h)."""
    gp_ref = refs[0] if spec.rc else None
    diag_ref, off_ref, b_ref, fh_ref = refs[-4:]

    start, ok, at = _block(n_cells)
    flags = _flags_at(at, flags_ref)
    active = ((flags >> ACTIVE_BIT) & 1) == 1
    rho = params_ref[0]
    vol = params_ref[1]

    def vel(i, d=0):
        return at(vel_ref, d, 3, i)

    u_c, v_c, w_c, md_c = vel(0), vel(1), vel(2), at(md_ref)
    zero = jnp.zeros_like(u_c)
    diag = zero
    b = zero
    for k, col in enumerate(cols):
        d = col.offset
        interior = ((flags >> k) & 1) == 1
        ax = _axis(col) if d != 0 else None
        na = col.n_out[ax] if ax is not None else 0.0

        u_n, v_n, w_n, md_n = vel(0, d), vel(1, d), vel(2, d), at(md_ref, d)
        # Flux predictor (fc.ck_flux_h): plain interpolated normal
        # velocity, plus — under Rhie-Chow — term3 only (term2 is what
        # the pressure equation replaces).
        term1 = _dot_n(u_c + u_n, v_c + v_n, w_c + w_n, col.n_out)
        if spec.rc and ax is not None:
            gp_c = at(gp_ref, 0, 3, ax)
            gp_n = at(gp_ref, d, 3, ax)
            term3 = (vol / md_c * gp_c + vol / md_n * gp_n) * na
            vn_int = 0.5 * (term1 + term3)
        else:
            vn_int = 0.5 * term1
        vn_bnd = _vn_boundary(col, u_c, v_c, w_c, bc_ref, zero)
        fh = jnp.where(interior, vn_int, vn_bnd)
        _store(fh_ref, jnp.where(active, fh, 0.0), start, ok, row=k)
        b = b - fh * (col.area * rho)
        # d coefficients (fc.ck_d_coeffs): |md n| == md for unit
        # normals; V/a == vol/md on the uniform box.
        d_int = (
            (0.5 * rho * col.area / col.dist_on)
            * (vol / md_c + vol / md_n)
        )
        _store(
            off_ref, jnp.where(active & interior, -d_int, 0.0),
            start, ok, row=k,
        )
        if col.kind == "pressure":
            d_bnd = (rho * col.area / col.dist_fo) * (vol / md_c)
            diag = diag + jnp.where(interior, d_int, d_bnd)
            p_bc = bc_ref[4 * col.zone + 3]
            b = b + jnp.where(interior, 0.0, d_bnd * p_bc)
        else:
            # Prescribed-flux boundaries: no matrix contribution.
            diag = diag + jnp.where(interior, d_int, 0.0)
    _store(diag_ref, jnp.where(active, diag, jnp.ones_like(diag)), start, ok)
    _store(b_ref, jnp.where(active, b, 0.0), start, ok)


@functools.partial(
    jax.jit, static_argnames=("cols", "spec", "interpret")
)
def fc_pc_assembly(
    vel, mom_diag, bc_values, flags, cols: tuple, rho,
    grad_p=None, spec: AsmSpec = AsmSpec(), interpret: bool = False,
):
    """Fused SIMPLE_FC full-p continuity assembly on a uniform box.

    vel [C,3] (post-momentum), mom_diag [C] (shared momentum diagonal)
    -> (diag [C], off [C,K], b [C], flux_h [C,K]) matching
    fc.ck_flux_h / fc.ck_fc_pressure_system; the cell volume comes from
    spec.vol (uniform box). With spec.rc, `grad_p` is the iteration-
    start pressure gradient (fc.ck_flux_h's term3 input)."""
    C = mom_diag.shape[0]
    K = len(cols)
    operands = [
        _params(rho, spec.vol), _flat(bc_values), flags, _flat(vel),
        _flat(mom_diag),
    ]
    if spec.rc:
        operands.append(_flat(grad_p))
    kern = functools.partial(_fc_pc_kernel, tuple(cols), spec, C)
    diag, off, b, fh = _call(
        kern, "fc_pc_assembly", operands,
        ((C,), (K, C), (C,), (K, C)), interpret,
    )
    return (
        diag,
        jnp.moveaxis(off, 0, -1),
        b,
        jnp.moveaxis(fh, 0, -1),
    )


def column_specs(mesh, table) -> "tuple | None":
    """Build the static ColumnSpec tuple from a uniform mesh's
    ck_constants + zone table, or None when ineligible (non-uniform
    mesh, unsupported BC kinds, or periodic wrap columns)."""
    from orc_cfd.mesh.zones import FaceCondition

    if mesh.ck_constants is None or mesh.neighbor_offsets is None:
        return None
    int_slot, colc = mesh.ck_constants
    offsets = mesh.neighbor_offsets
    if len(colc) != len(offsets):
        return None
    # Box dims from the offsets: columns come in +/- pairs along axes.
    from orc_cfd.solver.gmg import infer_box_dims

    dims = infer_box_dims(offsets, mesh.n_cells)
    if dims is None:
        return None
    nx, ny, nz = dims
    strides = {1: 0, nx: 1, nx * ny: 2}
    slot_types = {}
    for zid, fz in table.zones.items():
        slot_types[table.slot_of_zone[zid]] = fz.zone_type
    cols = []
    for k, (off, (area, n_out, dist_fo, dist_on, zslot)) in enumerate(
        zip(offsets, colc)
    ):
        if abs(off) not in strides and off != 0:
            return None  # periodic wrap column: unsupported here
        zt = slot_types.get(int(zslot))
        if zt == FaceCondition.WALL:
            kind = "wall"
        elif zt == FaceCondition.SYMMETRY:
            kind = "symmetry"
        elif zt in (
            FaceCondition.PRESSURE_INLET,
            FaceCondition.PRESSURE_OUTLET,
        ):
            kind = "pressure"
        elif zt == FaceCondition.VELOCITY_INLET:
            kind = "vinlet"
        else:
            return None
        cols.append(
            ColumnSpec(
                offset=int(off),
                area=float(area),
                n_out=tuple(float(c) for c in n_out),
                dist_fo=float(dist_fo),
                dist_on=float(dist_on),
                kind=kind,
                zone=int(zslot),
            )
        )
    return tuple(cols)


def bc_value_table(zone_scalar, zone_vector):
    """[Z,4] traced (vx, vy, vz, pressure) rows from the device zone
    tables — the kernels read per-column rows with static indices."""
    return jnp.concatenate(
        [zone_vector, zone_scalar[:, None]], axis=1
    )
