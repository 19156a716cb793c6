"""chip_smoke.py on the CPU: it refuses to run without a GPU (and when
the rest of the repository is missing), and each phase function passes
at toy size — the same code the card runs at full size."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_refuses_cpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_refuses_alone(tmp_path):
    """In a directory holding only chip_smoke.py, the script fails and
    prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_phase_cli_toy(monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "OUT_DIR", str(tmp_path))
    res, failed = chip_smoke.phase_cli(
        n=16, iterations=50, channel=(32, 16, 300)
    )
    assert not failed, failed
    assert res["channel_passed"]
    assert res["vel_corr_last"] < res["vel_corr_first"]


def test_phase_fused_toy():
    res, failed = chip_smoke.phase_fused(n=16, iterations=3, interpret=True)
    assert not failed, failed
    assert "ref_gradp_asm_mom_b" in res
    assert "ref_fc_asm_pc_b" in res


def test_phase_irregular_toy():
    res, failed = chip_smoke.phase_irregular(n=12, iterations=5)
    assert not failed, failed


def test_phase_sharded_toy():
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs the multi-device CPU mesh")
    res, failed = chip_smoke.phase_sharded(
        n=16, iterations=5, n_devices=4, interpret=True
    )
    assert not failed, failed
    assert res["float64_devices"] == [0, 1, 2, 3]
    json.dumps(res)
