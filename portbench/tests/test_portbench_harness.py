"""The harness on the CPU: small cells through the port's plain versions,
the control and the planted faults, and the finding of configurations,
mixes, metrics and kernel families by name."""

import json
import shutil

import pytest

from portbench.tests.conftest import run_module, run_small, small_copy

CELLS = ["reverb_small.offline", "rfft_small.b16"]
SEED = 2_147_483_659  # past 32 signed bits


@pytest.mark.parametrize("cell", CELLS)
def test_small_cell_is_correct(small, cell):
    result = run_small(small, cell, SEED)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    for check in result["checks"].values():
        assert check["value"] < check["limit"] / 10


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(small, cell):
    """The reference fed TF32 inputs, in the program's place, fails."""
    result = run_small(small, cell, SEED, "--control")
    assert result["correct"] is False and result["failed"] > 0


@pytest.mark.parametrize("cell,fault", [
    *[(cell, "half_batch") for cell in CELLS],
    *[(cell, "altered_answer") for cell in CELLS],
])
def test_planted_fault_is_not_correct(small, cell, fault):
    """Half of the rows or channels left out, one answer altered where it
    is produced: each makes ``correct`` false. (Neither entry carries
    state from call to call, so none can return it unchanged; no cell
    runs on more than one chip, so no exchange between chips can be left
    out.)"""
    result = run_small(small, cell, SEED, "--fault", fault)
    assert result["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_on_the_cpu(small, cell):
    """The traced path end to end (without a card the windows record the
    host's ops, so the device metrics find nothing and are left out)."""
    result = run_small(small, cell, SEED, "--trace")
    assert result["correct"] is True and result["attempted"] > 0
    assert list(result)[-2:] == ["breakdown", "checks"]
    assert result["device"]["busy_s"] == 0 and result["device"]["window_s"] > 0
    assert set(result["metrics"]) <= {m["name"] for m in json.loads((small / "BENCHMARK.json").read_text())["per_layer"]}
    if "rfft" in cell:
        assert result["metrics"]["enqueue_ms.fft"]["value"] > 0


def _draw(config_name: str, mix_name: str, seed: int):
    """The inputs one seed makes, the ring's order and the calls kept of 40."""
    import torch

    from portbench import harness, traffic
    from portbench.tests.conftest import SMALL_CONFIGS, SMALL_MIXES

    base, changes = SMALL_CONFIGS[config_name]
    config = harness.load_json("configs", base) | changes
    base, changes = SMALL_MIXES[mix_name]
    mix = harness.load_json("traffic", base) | changes
    plan = traffic.Plan(mix, seed)
    entry = harness.system_entry(config, mix)(config, plan, seed, "cpu")
    for call in range(40):
        plan.offer(call, call)
    inputs = entry.clips if hasattr(entry, "clips") else entry.x
    return plan.order, sorted(plan.kept), torch.cat([inputs.flatten(), getattr(entry, "ir", inputs).flatten()])


@pytest.mark.parametrize("config,mix", [("reverb_small", "offline_small"), ("rfft_small", "roundtrip_small")])
def test_same_seed_same_numbers(config, mix):
    """A seed makes the same inputs, ring order and sample every time;
    another seed makes other inputs."""
    import torch

    a, b, c = (_draw(config, mix, seed) for seed in (SEED, SEED, SEED + 1))
    assert a[0] == b[0] and a[1] == b[1] and torch.equal(a[2], b[2])
    assert not torch.equal(a[2], c[2])


@pytest.mark.parametrize("cell,rate", [("reverb_small.offline", "samples_per_s.convolve"),
                                       ("rfft_small.b16", "samples_per_s.fft")])
def test_end_to_end_metrics_by_cell(small, cell, rate):
    result = run_small(small, cell, 1)
    assert set(result["metrics"]) == {rate, "setup_s"}
    assert set(result) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(m["value"] > 0 for m in result["metrics"].values())


def test_dropped_in_files_are_found_by_name(tmp_path):
    """A configuration, a mix, a per-layer metric and a kernel family
    added as new files and entries, with no file of the harness edited."""
    copy = small_copy(tmp_path)
    pb = copy / "portbench"
    (pb / "configs" / "rfft_new.json").write_text(
        json.dumps(json.loads((pb / "configs" / "rfft_small.json").read_text()) | {"n": 1024}))
    (pb / "traffic" / "roundtrip_new.json").write_text(
        json.dumps(json.loads((pb / "traffic" / "roundtrip_small.json").read_text()) | {"batch": 5}))
    (pb / "metrics" / "calls_seen.py").write_text("def read(r):\n    return float(r.calls)\n")
    (pb / "kernels" / "new_family.txt").write_text("brand_new_kernel\n")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "rfft_new", "source": "test", "file": "portbench/configs/rfft_new.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "rfft_new.b5", "config": "rfft_new", "traffic": "roundtrip_new",
                               "chips": 1, "why": "test"})
    next(m for m in bench["end_to_end"] if m["name"] == "samples_per_s.fft")["workloads"].append("rfft_new.b5")
    bench["per_layer"].append({"name": "calls_seen.throughput", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "test", "moves": "samples_per_s.fft",
                               "workloads": ["rfft_new.b5"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    result = run_small(copy, "rfft_new.b5", 3)
    assert result["correct"] is True and result["metrics"]["samples_per_s.fft"]["value"] > 0
    probe = run_module(copy, "portbench.tests.find_probe", "calls_seen.throughput")
    assert probe.returncode == 0, probe.stderr[-3000:]
    found = json.loads(probe.stdout.strip().splitlines()[-1])
    assert found["reader"] == 12.0 and "brand_new_kernel" in found["kernels"]
    assert "rfft_packed_kernel" in found["kernels"]


@pytest.mark.parametrize("cell", ["reverb64.offline", "rfft16384.b4096"])
def test_no_card_exits_nonzero_without_a_result(cell):
    """The CLI on a machine with no CUDA device: no CPU fallback."""
    from portbench.tests.conftest import ROOT
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = run_module(ROOT, "portbench.run", "--workload", cell, "--seed", "1", "--seconds", "1", "--trace", "0")
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_benchmark_files_alone_exit_nonzero(tmp_path):
    """A directory with only BENCHMARK.json and portbench/: the port is
    missing, so the run fails and prints no result."""
    from portbench.tests.conftest import PORTBENCH, ROOT
    shutil.copytree(PORTBENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    import os
    import subprocess
    import sys
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "rfft16384.b4096", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
