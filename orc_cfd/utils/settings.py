"""Numerical settings for the solver stack.

Mirrors the capability surface of the reference's settings module
(reference: lib.rs:8-202) as hashable frozen dataclasses so a settings
object can be passed as a static argument to jitted functions: each
distinct scheme combination traces to its own XLA executable, and all
scheme dispatch happens at trace time (no data-dependent branching on
device).

Defaults follow the reference (lib.rs:58-86): CD1 momentum, CD diffusion,
second-order pressure interpolation, Rhie-Chow face velocities, cell-based
Green-Gauss gradients, momentum relaxation 0.5, pressure relaxation 0.01,
multigrid solver with 50 iterations/level, relaxation 0.5, relative
convergence threshold 1e-3, Jacobi preconditioning.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional


class PressureVelocityCoupling(enum.Enum):
    """Outer pressure-velocity coupling loop.

    SIMPLE (reference parity): stateless p'-increment SIMPLE — fluxes
    re-interpolated from cell fields every iteration, p' correction
    relaxed into p. Robust with the reference's tiny pressure
    relaxation (its stability story is the spurious boundary
    p'-diagonal — see assembly.pressure_correction_system).

    SIMPLE_FC: flux-corrected SIMPLE (solver/fc.py) — face fluxes are
    state, corrected conservatively through the pressure-equation
    coefficients every iteration (div(flux) == solver residual by
    construction), and the pressure equation solves the FULL p field.
    Measurably superior to the parity loop (tests/test_fc.py:
    machine-zero convergence in 87 vs >400 Poiseuille iterations,
    2.4x fewer on the cavity, stable where the parity loop NaNs) and
    stable at pressure_relaxation ~0.3 under implicit relaxation (vs
    0.01-0.1). Under RHIE_CHOW face velocities it converges to the
    SAME discrete solution as the parity loop (fields agree to 5e-15
    — the FC pressure-equation coefficient IS the RC damping
    coefficient). Under LINEAR/LINEAR_WEIGHTED it is a *different*
    (RC-stabilized) discretization: the converged flux keeps the full
    compact (p_i - p_j) correction term, so where a mean pressure
    gradient exists the cell-velocity bulk under-reports the (exactly
    conserved) face mass flux — measured 7.5% on an 8x8
    velocity-inlet channel.

    AUTO (the default since round 4): SIMPLE_FC whenever
    velocity_interpolation is RHIE_CHOW (equivalence pinned) AND
    relaxation_mode is IMPLICIT (FC's stored-flux update needs the
    Patankar diagonal margin — under explicit relaxation it diverges
    where the parity loop converges, measured on channel_flow.msh);
    the parity SIMPLE loop otherwise — the better coupling wherever
    it is semantics-preserving AND stable. Resolved by
    NumericalSettings.resolved_coupling().
    """

    SIMPLE = "simple"
    SIMPLE_FC = "simple_fc"
    AUTO = "auto"


class RelaxationMode(enum.Enum):
    """How momentum under-relaxation is applied.

    EXPLICIT: the reference's scheme — solve the unrelaxed momentum
    system, then scale the SIMPLE velocity correction by the relaxation
    factor (solver.rs:1221-1223). Diverges on strongly-coupled enclosed
    flows (e.g. lid-driven cavity).
    IMPLICIT: standard Patankar under-relaxation — divide the momentum
    diagonal by alpha and compensate the RHS with
    (1-alpha)/alpha * a_p * u_prev; the correction is applied in full.
    """

    EXPLICIT = "explicit"
    IMPLICIT = "implicit"


class MomentumScheme(enum.Enum):
    """Momentum advection discretization (reference: lib.rs:95-105)."""

    UD = "ud"  # first-order upwind
    CD1 = "cd1"  # central differencing (arithmetic mean)
    CD2 = "cd2"  # gradient-corrected CD (second order on arbitrary grids)
    TVD = "tvd"  # flux-limited; psi(r) supplied via NumericalSettings.tvd_psi
    # Deferred-correction TVD (orc_cfd extension): implicit part is pure
    # UD; the limited higher-order increment psi(r)/2 * (phi_D - phi_U)
    # moves to the RHS, evaluated ONCE per face from the upwind side so
    # both adjacent cells see the same face value. The reference's
    # in-matrix TVD (discretization.rs:233-287) silently uses a CD face
    # value on every inflow face (its r formula evaluates
    # (phi_downstream - phi_cell) with downstream == cell when f_i < 0,
    # which is identically zero and falls into the velocities-equal CD
    # branch) — non-conservative and first-order in recirculating flow.
    # TVD_DC is the production second-order scheme.
    TVD_DC = "tvd_dc"


class DiffusionScheme(enum.Enum):
    CD = "cd"


class PressureInterpolation(enum.Enum):
    """Face-pressure interpolation (reference: lib.rs:125-133).

    STANDARD exists for enum-surface parity and raises on use exactly
    like the reference (solver.rs:1134-1137 panics "not supported").
    NONE mirrors the reference's internal-only sentinel ("no
    interpolation will be needed", lib.rs:131-132); passing it to a
    solve raises — this framework's ops never dispatch on it."""

    LINEAR = "linear"
    LINEAR_WEIGHTED = "linear_weighted"
    STANDARD = "standard"
    SECOND_ORDER = "second_order"
    NONE = "none"


class VelocityInterpolation(enum.Enum):
    """Face-velocity / face-flux interpolation (reference: lib.rs:135-146).

    NONE mirrors the reference's internal-only sentinel (lib.rs:144-145);
    raises if a solve is attempted with it."""

    LINEAR = "linear"
    LINEAR_WEIGHTED = "linear_weighted"
    RHIE_CHOW = "rhie_chow"
    NONE = "none"


class PressureCorrectionForm(enum.Enum):
    """Form of the SIMPLE velocity correction from p'.

    CELL_DIFFERENCE (reference parity, solver.rs:1214-1223, the
    default): u += (alpha_u/a) sum_f (p'_c - p'_nb) A n_out. On a
    uniform grid this equals -2 (V/a) grad p' — exactly TWICE the
    consistent SIMPLE update — and its compact differences SEE
    grid-scale p' modes, damping the collocated checkerboard. That
    extra damping is what keeps the robust LinearWeighted default
    stable on coarse high-cell-Re grids (measured: the 16^2 Re=1000
    cavity at pressure_relaxation 0.1 diverges exponentially under the
    FACE_VALUE form, converges under CELL_DIFFERENCE), at the cost of
    overscaled smooth-mode corrections — the reason the reference
    needs pressure relaxation ~0.01 (README.md:17-19).

    FACE_VALUE (consistent): u += (alpha_u/a) sum_f (p'_c - p'_f) A
    n_out = -(alpha_u V/a) grad p' with interior p'_f linear, pressure
    BCs p'_f = 0, prescribed-flux BCs p'_f = p'_c. The textbook
    correction: exact magnitude on smooth fields (measured: reaches
    the converged channel profile in ~1/4 the iterations), but its
    wide gradient filter is BLIND to grid-scale p', so it relies on
    Rhie-Chow fluxes (or fine grids) for checkerboard control — pair
    it with VelocityInterpolation.RHIE_CHOW."""

    CELL_DIFFERENCE = "cell_difference"
    FACE_VALUE = "face_value"


class GradientReconstruction(enum.Enum):
    """Cell-gradient reconstruction (reference: lib.rs:148-162).

    GREEN_GAUSS_NODE (vertex-interpolated face values; the reference's
    NodeBased variant panics, solver.rs:901) needs a mesh loaded with
    read_mesh(..., nodes=True). NONE mirrors the reference's
    internal-only sentinel (lib.rs:159-161); raises on use."""

    GREEN_GAUSS_CELL = "green_gauss_cell"
    GREEN_GAUSS_NODE = "green_gauss_node"
    LEAST_SQUARES = "least_squares"
    NONE = "none"


class TurbulenceModel(enum.Enum):
    NONE = "none"
    STANDARD_K_EPSILON = "k_epsilon"


class SolutionMethod(enum.Enum):
    """Sparse linear solver (reference: lib.rs:171-179).

    Unlike the reference, Gauss-Seidel here is a working multi-color sweep
    (the reference's is disabled, linear_algebra.rs:245), and Multigrid
    passes the known-solution solver test (the reference's does not,
    linear_algebra.rs:344-345).
    """

    JACOBI = "jacobi"
    GAUSS_SEIDEL = "gauss_seidel"
    BICGSTAB = "bicgstab"
    MULTIGRID = "multigrid"
    # Internal (not part of the reference's menu): fixed-count damped
    # Jacobi sweeps with NO adaptive exit and NO per-sweep reductions —
    # the deterministic smoother used for warm-started transport solves
    # (MatrixSolverSettings.momentum_solver). Selectable directly too.
    JACOBI_SMOOTH = "jacobi_smooth"


class PreconditionMethod(enum.Enum):
    NONE = "none"
    JACOBI = "jacobi"


class SolverPrecision(enum.Enum):
    """Arithmetic mode for the linear solves (no reference counterpart:
    the reference is CPU f64 throughout, lib.rs:213).

    NATIVE: solve in the system's dtype.

    DF32_IR: f64-accuracy via double-float (2xf32) iterative
    refinement — plain f32 inner solves plus one f64 residual per
    refinement step (solver/refine.py). Requires an f64 system; ignored for f32
    systems and sharded runs."""

    NATIVE = "native"
    DF32_IR = "df32_ir"


class RestrictionMethod(enum.Enum):
    """AMG coarsening strategy (reference: lib.rs:197-201)."""

    INJECTION = "injection"
    STRONGEST = "strongest"


# --- TVD limiter functions psi(r) (reference: lib.rs:107-118). ---
# These operate on JAX arrays; they are closed over at trace time, so each
# limiter compiles to its own executable (the JAX answer to the reference's
# function-valued enum variant MomentumDiscretization::TVD(fn)).

def tvd_lud(r):
    return r


def tvd_quick(r):
    return (3.0 + r) / 4.0


def tvd_umist(r):
    import jax.numpy as jnp

    m = jnp.minimum(
        jnp.minimum(2.0 * r, (1.0 + 3.0 * r) / 4.0),
        jnp.minimum((3.0 + r) / 4.0, jnp.full_like(r, 2.0)),
    )
    return jnp.maximum(0.0, m)


@dataclasses.dataclass(frozen=True)
class MatrixSolverSettings:
    """Reference: lib.rs:39-56 (defaults lib.rs:76-86)."""

    solver_type: SolutionMethod = SolutionMethod.MULTIGRID
    # Iterations per solve (per level for multigrid). The reference notes
    # stability issues below ~50 (lib.rs:43-44).
    iterations: int = 50
    relaxation: float = 0.5
    # Terminate when the residual norm falls to this fraction of its value
    # after one iteration.
    relative_convergence_threshold: float = 1e-3
    # Sweep count for the WARM-STARTED transport solves inside the
    # SIMPLE loop (momentum u/v/w and RANS scalar transport), which run
    # as fixed-count damped-Jacobi smoothing (JACOBI_SMOOTH) instead of
    # the configured Krylov solver. Why a stationary smoother:
    # (1) DETERMINISM — Krylov scalars (rho/alpha/omega) and adaptive
    #     exits compare roundoff-ordered reductions, so single-device
    #     and sharded runs (different summation orders) can exit at
    #     different iterations or amplify roundoff through
    #     near-breakdown denominators. A stationary sweep has NO
    #     data-dependent scalars: sharded == single to the halo-exchange
    #     roundoff. (Measured: an adaptive k-transport exit sitting
    #     within 1e-15 of its bar left one path at ||r||=0.59 and
    #     carried the other to 1e-10 — a 78% field difference after one
    #     outer step.)
    # (2) ROBUSTNESS — a fixed-count Krylov solve can stop on a
    #     stagnation hump with a residual WORSE than entry (measured:
    #     4-iteration BiCGSTAB on a periodic-channel momentum system
    #     returned 6x-grown residuals and the outer loop amplified to
    #     1e147). Damped Jacobi on the diagonally-dominant transport
    #     systems contracts monotonically.
    # (3) COST — one SpMV per sweep and no global dot products (psum
    #     latency) at all; the outer iteration provides the
    #     low-frequency coupling through the pressure solve, which
    #     keeps its adaptive Krylov/multigrid treatment.
    # The momentum equation still converges to the exact discrete
    # solution: the outer fixed point is unchanged (a sweep is a no-op
    # only at zero residual). None = solve momentum with the full
    # configured solver settings instead.
    momentum_iterations: Optional[int] = 6
    # Relative exit (vs the entry residual) for warm-started transport
    # solves when the fixed-count smoother is NOT applicable (explicit
    # relaxation — see NumericalSettings.momentum_matrix_solver):
    # momentum/RANS inner solves only need to contract their residual
    # ~10x per outer iteration; the outer loop drives global
    # convergence, and tighter inner solves burn Krylov iterations for
    # nothing (the full 1e-3 rel-to-r0 exit slowed the couette
    # benchmark by about a quarter). None = use
    # relative_convergence_threshold unchanged.
    momentum_relative_threshold: Optional[float] = 0.1
    preconditioner: PreconditionMethod = PreconditionMethod.JACOBI
    # AMG controls (reference: linear_algebra.rs:9-10; smoother fixed to
    # BiCGSTAB with 3 coarsening levels there).
    multigrid_smoother: SolutionMethod = SolutionMethod.BICGSTAB
    multigrid_levels: int = 3
    multigrid_restriction: RestrictionMethod = RestrictionMethod.STRONGEST
    multigrid_coarsest_size: int = 16
    # Smoother iterations per level. None = `iterations` (the
    # reference's behavior — its smoother runs the full count at every
    # level, linear_algebra.rs:87-127, which makes a V-cycle ~5x the
    # cost of one plain smoother solve). A small count (3-8) with an
    # accurate coarsest-level solve is the standard, much cheaper
    # configuration.
    multigrid_smoother_iterations: Optional[int] = None
    # Compensated f32 reductions: accumulate Krylov dot products and
    # residual norms of float32 systems in double width (f32 products
    # are exact in f64). Recovers reduction accuracy lost to f32
    # cancellation at large cell counts for a small cost (the reduction
    # stream only — fields, SpMV and updates stay f32). No effect on
    # f64 runs. (SURVEY §7 design stance: compensated-f32 reductions.)
    compensated_f32: bool = False
    # f64-accuracy solves from f32 kernels via iterative refinement
    # (solver/refine.py) — see SolverPrecision. Only consulted for f64
    # systems on a single device.
    precision: SolverPrecision = SolverPrecision.NATIVE
    # Refinement steps for DF32_IR (each runs one full inner solve +
    # one df32 residual; 3 reaches the ~2^-45*kappa accuracy floor).
    refine_steps: int = 3

    def replace_precision(self, p: SolverPrecision) -> "MatrixSolverSettings":
        return dataclasses.replace(self, precision=p)

    def momentum_solver(self) -> "MatrixSolverSettings":
        """The settings used for warm-started transport solves
        (momentum, RANS k/eps): fixed-count damped-Jacobi smoothing —
        see the momentum_iterations note. relaxation=0.8 is a safe
        smoothing weight for the Jacobi-preconditioned (unit-diagonal)
        momentum rows."""
        if self.momentum_iterations is None:
            return self
        return dataclasses.replace(
            self,
            solver_type=SolutionMethod.JACOBI_SMOOTH,
            iterations=self.momentum_iterations,
            relaxation=0.8,
        )


@dataclasses.dataclass(frozen=True)
class NumericalSettings:
    """Reference: lib.rs:14-35 (defaults lib.rs:58-74)."""

    # Default flipped to AUTO in round 4: the
    # flux-corrected loop wherever Rhie-Chow makes it
    # semantics-preserving (better-measured convergence and stability
    # at identical converged fields), the parity loop otherwise. The
    # one knob whose default deviates from lib.rs:58-74 — the
    # reference has no FC loop.
    pressure_velocity_coupling: PressureVelocityCoupling = (
        PressureVelocityCoupling.AUTO
    )
    momentum: MomentumScheme = MomentumScheme.CD1
    # psi(r) for MomentumScheme.TVD. Identity of the callable is the hash
    # key, so reuse module-level functions (tvd_lud/tvd_quick/tvd_umist).
    tvd_psi: Optional[Callable] = None
    diffusion: DiffusionScheme = DiffusionScheme.CD
    pressure_interpolation: PressureInterpolation = PressureInterpolation.SECOND_ORDER
    velocity_interpolation: VelocityInterpolation = VelocityInterpolation.RHIE_CHOW
    pressure_correction_form: PressureCorrectionForm = (
        PressureCorrectionForm.CELL_DIFFERENCE
    )
    gradient_reconstruction: GradientReconstruction = (
        GradientReconstruction.GREEN_GAUSS_CELL
    )
    momentum_relaxation: float = 0.5
    relaxation_mode: "RelaxationMode" = None  # default set in __post_init__
    # Must be very small (<<0.1) for stable SIMPLE convergence
    # (reference: lib.rs:31-32, README.md:17-19).
    pressure_relaxation: float = 0.01
    # Optional per-cell momentum source (the reference's
    # get_momentum_source_term hook, solver.rs:698-701, which returns
    # zero). Two contracts, dispatched on REQUIRED positional-arg count
    # (ops/fields.momentum_source_term):
    #   f(cell_centroids [C,3]) -> [C,3]            already integrated
    #   f(cell_centroids, cell_volumes) -> [C,3]    integrates a
    #     per-unit-volume force from LOCAL arrays — the only form that
    #     works under shard_map (a closure over global volumes would
    #     shape-mismatch the per-device blocks).
    momentum_source: Optional[Callable] = None
    matrix_solver: MatrixSolverSettings = dataclasses.field(
        default_factory=MatrixSolverSettings
    )
    turbulence: TurbulenceModel = TurbulenceModel.NONE
    # Kahan-compensated accumulation of the outer-loop state (vel, p)
    # for FLOAT32 runs (f64 runs are unaffected regardless). Near
    # steady state the per-iteration increments shrink below f32
    # epsilon of the fields and round away entirely, freezing the run
    # short of the converged solution (measured: cold-started Re=1000
    # f32 cavities freeze at grid-INCREASING Ghia error — 0.091/0.113/
    # 0.185 at 64^2/128^2/256^2 — with p_corr stuck ~1e-5, while the
    # f64 run converges on; scripts/cavity_grid_study.py). The
    # compensation arrays extend the effective state precision to
    # ~2^-48 at the cost of two extra f32 fields and a few axpys per
    # iteration.
    compensated_state: bool = True
    # SIMPLE_FC stored-flux under-relaxation (None = auto): the
    # conservative flux update blends
    #   flux <- flux_old + beta * (flux_corrected - flux_old).
    # Both operands are (discretely) divergence-free, so any blend
    # stays conservative. Auto resolves to 1.0 under IMPLICIT
    # relaxation (the solved velocity already IS the relaxed one, so
    # the full correction is consistent) and to momentum_relaxation
    # under EXPLICIT (the velocity receives only alpha_u of the
    # correction — storing the FULL flux correction builds an
    # O((1-alpha_u)*corr) field/flux inconsistency each iteration,
    # the measured FC+explicit divergence mechanism; see NOTES.md
    # round 5).
    fc_flux_relaxation: Optional[float] = None

    def resolved_fc_flux_relaxation(self) -> float:
        if self.fc_flux_relaxation is not None:
            return self.fc_flux_relaxation
        if self.relaxation_mode is RelaxationMode.IMPLICIT:
            return 1.0
        return self.momentum_relaxation

    def __post_init__(self):
        if self.relaxation_mode is None:
            object.__setattr__(
                self, "relaxation_mode", RelaxationMode.EXPLICIT
            )

    def resolved_coupling(self) -> PressureVelocityCoupling:
        """AUTO -> SIMPLE_FC iff RHIE_CHOW closes the face fluxes
        (loop equivalence pinned at 1e-11, tests/test_fc.py) AND the
        relaxation is IMPLICIT (Patankar); the parity SIMPLE loop
        otherwise. Under LINEAR interpolations FC is a different,
        RC-stabilized discretization (see the PressureVelocityCoupling
        docstring); under EXPLICIT relaxation the FC loop's momentum
        rows lack the 1/alpha diagonal margin its stored-flux update
        assumes and it diverges where the parity loop converges
        (measured: channel_flow.msh, UD + Rhie-Chow, alpha_p 0.005-0.02
        all NaN under FC+explicit, fine under FC+implicit and under
        parity+explicit — round 4). Explicit members pass through."""
        if self.pressure_velocity_coupling is not PressureVelocityCoupling.AUTO:
            return self.pressure_velocity_coupling
        if (
            self.velocity_interpolation is VelocityInterpolation.RHIE_CHOW
            and self.relaxation_mode is RelaxationMode.IMPLICIT
        ):
            return PressureVelocityCoupling.SIMPLE_FC
        return PressureVelocityCoupling.SIMPLE

    def momentum_matrix_solver(self) -> MatrixSolverSettings:
        """Solver settings for the warm-started transport solves inside
        the outer loop (momentum u/v/w, RANS k/eps). The fixed-count
        damped-Jacobi smoother (MatrixSolverSettings.momentum_solver)
        needs the Patankar-boosted diagonal of IMPLICIT relaxation for
        guaranteed contraction: with explicit relaxation the momentum
        rows have no 1/alpha dominance margin and the sweep can amplify
        (measured: a convection-dominated developing RANS channel NaNs
        by outer iter 800 with 6 sweeps — and FASTER with 20, i.e.
        rho(M) > 1 — while the same case under implicit relaxation
        matches the full-solver trajectory). Explicit-relaxation runs
        keep the configured Krylov solver for every transport solve,
        loosened to momentum_relative_threshold (a ~10x contraction
        per call — the standard loose-inner-solve SIMPLE practice; the
        outer loop drives global convergence)."""
        ms = self.matrix_solver
        if self.relaxation_mode != RelaxationMode.IMPLICIT:
            if ms.solver_type == SolutionMethod.MULTIGRID:
                # MULTIGRID is for the elliptic pressure system only:
                # on the advection-dominated nonsymmetric transport
                # matrices the Galerkin coarse correction AMPLIFIES
                # (measured: a high-Pe RANS channel under explicit
                # relaxation blows up by outer iteration ~6, u_avg
                # 1e39). Transport solves fall back to the hierarchy's
                # own Krylov smoother.
                ms = dataclasses.replace(
                    ms, solver_type=ms.multigrid_smoother
                )
            if ms.momentum_relative_threshold is None:
                return ms
            return dataclasses.replace(
                ms,
                relative_convergence_threshold=(
                    ms.momentum_relative_threshold
                ),
            )
        return ms.momentum_solver()

    def replace(self, **kw) -> "NumericalSettings":
        return dataclasses.replace(self, **kw)


# Convenience preset settings mirroring the reference's named limiters.
TVD_LUD = NumericalSettings(momentum=MomentumScheme.TVD, tvd_psi=tvd_lud)
TVD_QUICK = NumericalSettings(momentum=MomentumScheme.TVD, tvd_psi=tvd_quick)
TVD_UMIST = NumericalSettings(momentum=MomentumScheme.TVD, tvd_psi=tvd_umist)
