"""chip_smoke.py's phases at tiny sizes on the CPU: control flow, checks
and reporting. The numbers that matter come from the run on the card."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


@pytest.fixture(autouse=True)
def _no_repo_compile_cache(monkeypatch, tmp_path):
    # with the variable set the cache helper changes nothing
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))


def test_device_phase_refuses_cpu(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.phase_device()
    assert cs.phase_device(require_gpu=False)["platform"] == "cpu"
    assert cs.main([]) == 2
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_headline_phase_tiny():
    out = cs.phase_headline(num_walkers=2048, num_dims=4, num_warmup=100,
                            num_samples=100)
    assert out["kernel_used"] == "xla"
    assert out["max_abs_mean"] < 0.1 and out["max_abs_var_minus_1"] < 0.2
    assert 0.5 < out["accept_rate"] <= 1.0
    assert out["sampling_scan_memory"]["temp_size_in_bytes"] >= 0
    assert set(out["tolerance"]) == {"mean", "var"}


def test_cli_phase_tiny():
    out = cs.phase_cli(num_walkers=128, extra_args=(
        "--num-warmup", "100", "--num-samples", "100"))
    assert out["rc"] == 0 and out["kernel_used"] == "xla"
    assert out["ok"], out
    assert abs(out["constrained_means"]["mu"] - 4.4) < 1.0


def test_chees_logreg_phase_tiny():
    out = cs.phase_chees_logreg(num_walkers=256, num_warmup=100,
                                num_samples=50)
    assert out["ok"], out
    # the CPU has no TF32: both precisions take the same path
    assert out["default_vs_highest_max_mean_gap_sd"] == 0.0
    assert out["highest"]["kernel_used"] == "xla"


def test_four_phase_on_virtual_devices():
    out = cs.phase_four(walkers_per_device=512, num_dims=4, num_warmup=100,
                        num_samples=100)
    assert out["walkers"] == 2048 and out["mesh_devices"] == 4
    for path in ("one_device", "gspmd", "shard_map"):
        row = out[path]
        assert row["max_abs_mean"] < 0.1, (path, row)
        assert 0.5 < row["accept_rate"] <= 1.0
    assert out["gspmd"]["max_gap_to_one_device_mean"] < 0.1
    assert out["shard_map"]["max_gap_to_one_device_var"] < 0.3


def test_main_writes_record_and_last_line(monkeypatch, capsys, tmp_path):
    """With the device check passed (the CPU standing in), main runs the
    chosen phases, writes the record under chiprun_out/ and prints the
    device line last."""
    monkeypatch.setattr(cs, "phase_device",
                        lambda require_gpu=True: cs.device_record())
    monkeypatch.setattr(cs, "REPO", str(tmp_path))
    monkeypatch.setattr(cs, "phase_four", lambda: {"ok": True})
    assert cs.main(["--four"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": cs.device_record()}
    with open(tmp_path / "chiprun_out" / "chip_smoke.json") as f:
        assert json.load(f)["phases"]["four"]["ok"] is True

    monkeypatch.setattr(cs, "phase_four", lambda: {"ok": False})
    assert cs.main(["--four"]) == 1
    assert '"ok": true' not in capsys.readouterr().out
