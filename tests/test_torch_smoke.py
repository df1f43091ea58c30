"""``chip_smoke.py`` off the card: it prints the versions first and then
exits non-zero with no result, in a checkout without CUDA and in a
directory that holds the script and nothing else of the repository."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def run_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def assert_no_result(out):
    assert out.returncode != 0
    lines = out.stdout.splitlines()
    assert lines and lines[0].startswith(f"torch {torch.__version__} cuda ")
    for line in lines:
        if line.startswith("{"):
            assert "ok" not in json.loads(line), line


def test_chip_smoke_refuses_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    out = run_smoke(tmp_path)
    assert_no_result(out)
    assert "is not a checkout of the repository" in out.stderr


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = run_smoke(ROOT)
    assert_no_result(out)
    assert "CUDA is not available" in out.stderr
