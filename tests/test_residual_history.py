"""Residual-history regression against the pinned fixtures.

The project's correctness target is a residual-history match at 1e-6
relative tolerance on couette_flow_128x64x1. The Rust reference cannot
be built here, so the pinned trajectories are this framework's own f64
runs (scripts/gen_residual_fixture.py). Two pins since the round-4
default-coupling flip:

- the PARITY loop (explicit PressureVelocityCoupling.SIMPLE) against
  the round-1 fixture — unchanged by the flip, still the
  reference-trajectory stand-in (the package DEFAULTS also resolve
  here: AUTO -> SIMPLE under the default EXPLICIT relaxation, pinned
  below);
- the FC loop in its recommended envelope (AUTO + IMPLICIT
  relaxation, where AUTO resolves to SIMPLE_FC) against the round-4
  fixture.

Any change to solver semantics must reproduce these or consciously
regenerate them: `python scripts/gen_residual_fixture.py`.
"""

import os

import numpy as np
import pytest

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
FIXTURE = os.path.join(FIXDIR, "residual_history_couette_r1.npz")
FIXTURE_FC = os.path.join(FIXDIR, "residual_history_couette_fc_r4.npz")

FIELDS = (
    "vel_avg",
    "p_corr_norm",
    "vel_corr_norm",
    "mom_residual",
    "pc_residual",
    "peclet_avg",
)


def _check(history, fixture, label):
    from orc_cfd.solver.simple import stack_history

    hs = stack_history(history)
    with np.load(fixture) as z:
        for field in FIELDS:
            got = np.asarray(getattr(hs, field))
            want = z[field]
            np.testing.assert_allclose(
                got, want, rtol=1e-6, atol=1e-300,
                err_msg=f"{label} history field {field} drifted from the "
                "pinned trajectory (regenerate the fixtures if the change "
                "is intentional: scripts/gen_residual_fixture.py)",
            )
        assert not z["diverged"].any()


def test_history_matches_fixture(reference_mesh_dir):
    """Parity loop (explicit SIMPLE) vs the round-1 fixture; the
    package DEFAULTS (AUTO + explicit relaxation) must produce the
    SAME trajectory — AUTO resolves to SIMPLE outside the FC
    envelope."""
    if not os.path.exists(FIXTURE):
        pytest.skip("fixture not generated")
    import scripts.gen_residual_fixture as gen
    from orc_cfd.utils.settings import (
        NumericalSettings,
        PressureVelocityCoupling,
    )

    assert (
        NumericalSettings().resolved_coupling()
        is PressureVelocityCoupling.SIMPLE
    )
    _check(
        gen.build(PressureVelocityCoupling.SIMPLE), FIXTURE, "parity-loop"
    )
    _check(gen.build(), FIXTURE, "default (AUTO->SIMPLE)")


def test_history_matches_fc_fixture(reference_mesh_dir):
    """FC loop in its recommended envelope (AUTO + implicit
    relaxation -> SIMPLE_FC) vs the round-4 fixture."""
    if not os.path.exists(FIXTURE_FC):
        pytest.skip("fixture not generated")
    import scripts.gen_residual_fixture as gen

    _check(
        gen.build(fc_envelope=True), FIXTURE_FC, "FC envelope (SIMPLE_FC)"
    )
