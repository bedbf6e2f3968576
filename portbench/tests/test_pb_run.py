"""A run without a card, or without the port, prints no result."""

import shutil
import subprocess
import sys

import pytest

from portbench import spec


def _run(cwd):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "sdp_n100_m100.b256",
         "--seed", "3000000017", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_a_run_without_a_card_fails_and_prints_nothing():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(spec.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_a_run_with_only_the_benchmark_fails(tmp_path):
    shutil.copy(spec.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
