#!/usr/bin/env python3
"""Batched test-suite runner — THE way to run the orc_cfd tests.

Why this exists: the XLA CPU JIT segfaults nondeterministically after
hundreds of in-process compilations (observed repeatedly in rounds 4-5,
always late in a monolithic `pytest tests/` run, different tests each
time; every crashed file passes standalone — see tests/conftest.py).
The persistent compile cache reduces but does not eliminate the crash.
This runner bounds per-process compile count by splitting the suite into
several sequential pytest processes, and localizes any crash by retrying
the crashed batch file-by-file. A file that fails in its own process is
a REAL failure; a batch crash that disappears under isolation is the
known infra bug and is reported as such (suite still green).

Usage:
    python scripts/run_suite.py            # full suite, batched
    python scripts/run_suite.py -k expr    # forwarded to pytest
Exit code 0 iff every test passes (possibly after isolation retry).
"""

from __future__ import annotations

import glob
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")

# Batches are explicit so compile-heavy files (solvers, pallas, fc,
# distributed) spread across processes. Anything not listed lands in the
# final catch-all batch — new test files are picked up automatically.
BATCHES: list[list[str]] = [
    # mesh/io/cli/aux: light compiles
    ["test_mesh.py", "test_native.py", "test_io.py", "test_cli.py",
     "test_aux.py", "test_reorder.py", "test_sequencing.py"],
    # assembly + parity: numpy-heavy, moderate compiles
    ["test_assembly.py", "test_gradients.py", "test_reference_parity.py",
     "test_ck.py", "test_tvd_dc.py"],
    # solvers + multigrid (the round-4 crash site) get their own process
    ["test_solvers.py", "test_gmg.py", "test_pallas_smooth.py",
     "test_pallas_slice.py", "test_df32.py"],
    # pallas assembly + distributed
    ["test_pallas_assembly.py", "test_distributed.py", "test_periodic.py",
     "test_backend.py", "test_chip_smoke.py"],
    # physics end-to-end
    ["test_channel_flow.py", "test_cavity.py", "test_cases_2d.py",
     "test_residual_history.py", "test_reference_configs.py"],
    # coupling variants
    ["test_fc.py", "test_transient.py", "test_turbulence.py"],
]


def _run(files: list[str], extra: list[str]) -> int:
    cmd = [sys.executable, "-m", "pytest", "-q", *extra,
           *[os.path.join("tests", f) for f in files]]
    proc = subprocess.run(cmd, cwd=REPO)
    return proc.returncode


def main() -> int:
    extra = sys.argv[1:]
    all_files = sorted(
        os.path.basename(p) for p in glob.glob(os.path.join(TESTS, "test_*.py"))
    )
    listed = {f for batch in BATCHES for f in batch}
    batches = [[f for f in batch if f in all_files] for batch in BATCHES]
    leftovers = [f for f in all_files if f not in listed]
    if leftovers:
        batches.append(leftovers)

    t0 = time.time()
    failures: list[str] = []
    infra_crashes: list[str] = []
    for i, batch in enumerate(batches):
        if not batch:
            continue
        print(f"\n=== batch {i + 1}/{len(batches)}: {' '.join(batch)} ===",
              flush=True)
        rc = _run(batch, extra)
        if rc == 0:
            continue
        if rc == 5:  # no tests collected (e.g. -k filtered everything out)
            continue
        # Batch failed or crashed: localize file-by-file in fresh processes.
        print(f"--- batch {i + 1} exited rc={rc}; isolating per file ---",
              flush=True)
        crashed = rc < 0 or rc == 139
        for f in batch:
            frc = _run([f], extra)
            if frc in (0, 5):
                continue
            if frc < 0 or frc == 139:
                # Crashed even standalone — retry once (the XLA crash is
                # nondeterministic); twice-in-a-row is a real failure.
                frc = _run([f], extra)
                if frc in (0, 5):
                    infra_crashes.append(f)
                    continue
            failures.append(f)
        if crashed and not failures:
            infra_crashes.append(f"batch-{i + 1}")

    dt = time.time() - t0
    print(f"\n=== suite done in {dt:.0f}s ===")
    if infra_crashes:
        print(f"known XLA-CPU-JIT crash localized and cleared in: "
              f"{', '.join(infra_crashes)} (all tests green)")
    if failures:
        print(f"FAILED files: {', '.join(failures)}")
        return 1
    print("ALL GREEN")
    return 0


if __name__ == "__main__":
    sys.exit(main())
