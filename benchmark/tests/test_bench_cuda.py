"""On the card: each cell runs a short window and comes out correct, its
result line in the contract's shape. Skips without a card (decided inside
the test). On the card: python -m pytest --noconftest -m cuda
benchmark/tests/test_bench_cuda.py"""
import json
import subprocess
import sys

import pytest
import torch

from benchmark import spec


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.benchmark()["workloads"]])
def test_cell_runs_correct(card, cell):
    got = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell,
         "--seed", str(2 ** 31 + 77), "--seconds", "15", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
    assert got.returncode == 0, got.stderr[-4000:]
    line = json.loads(got.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"] and list(line)[-1] == "checks"
    assert line["correct"], line
    assert line["device"]["platform"] == "gpu"
    assert "setup_s" in line["metrics"]
