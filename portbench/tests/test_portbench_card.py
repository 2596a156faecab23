"""Each cell through the CLI on the card: a short window and a traced
run, both correct. Skips without a CUDA device."""

import json
import subprocess
import sys

import pytest
import torch

from portbench.tests.conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(card, cell, trace):
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell, "--seed", "4294967311",
                           "--seconds", "2", "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
                          timeout=1500)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert result["breakdown"]["device_ops"]
