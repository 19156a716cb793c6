"""Flagship-validation cadence.

Runs the heavy ORC_SLOW-gated physics validations — the Ghia
Re=1000 mesh-sequenced cavity flagship (tests/test_cavity.py) — on the
requested backend and APPENDS a dated record to FLAGSHIP.md, so the
headline physics claim is re-verified every round instead of resting
on a one-time result.

Usage:
    python scripts/run_flagship.py            # on the GPU (minutes)
    python scripts/run_flagship.py --cpu      # CPU (much slower)

Run once per round; commit the FLAGSHIP.md line it appends.
"""

import datetime
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOG = os.path.join(REPO, "FLAGSHIP.md")

HEADER = """# Flagship validation log

One dated record per round (scripts/run_flagship.py): the
ORC_SLOW-gated Ghia Re=1000 cavity flagship (mesh-sequenced 256^2,
TVD_DC + Rhie-Chow, tests/test_cavity.py::test_cavity_re1000_ghia_flagship)
must pass on real hardware every round.

| date | git | backend | result | wall |
|---|---|---|---|---|
"""


def main():
    cpu = "--cpu" in sys.argv
    env = dict(os.environ)
    env["ORC_SLOW"] = "1"
    if not cpu:
        env["ORC_TEST_PLATFORM"] = "gpu"
    rev = subprocess.run(
        ["git", "rev-parse", "--short", "HEAD"],
        cwd=REPO, capture_output=True, text=True,
    ).stdout.strip()
    t0 = time.time()
    proc = subprocess.run(
        [
            sys.executable, "-m", "pytest",
            "tests/test_cavity.py::test_cavity_re1000_ghia_flagship",
            "-q", "--no-header",
        ],
        cwd=REPO, env=env, capture_output=True, text=True,
    )
    wall = time.time() - t0
    tail = (proc.stdout + proc.stderr).strip().splitlines()
    result = "PASS" if proc.returncode == 0 else "FAIL"
    print("\n".join(tail[-12:]), file=sys.stderr)

    if not os.path.exists(LOG):
        with open(LOG, "w") as f:
            f.write(HEADER)
    stamp = datetime.datetime.now(datetime.UTC).strftime("%Y-%m-%d")
    if cpu:
        backend = "cpu"
    else:
        sys.path.insert(0, REPO)
        from orc_cfd.backend import card

        backend = card()
    with open(LOG, "a") as f:
        f.write(
            f"| {stamp} | {rev} | {backend} | {result} "
            f"| {wall/60:.1f} min |\n"
        )
    print(f"{result} in {wall/60:.1f} min -> appended to FLAGSHIP.md")
    sys.exit(proc.returncode)


if __name__ == "__main__":
    main()
