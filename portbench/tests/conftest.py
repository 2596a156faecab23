"""Fixtures of the benchmark's own tests: a copy of ``portbench/`` with
small configurations, mixes and cells, which the CPU runs drive through
the harness (the port's plain versions)."""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
PORTBENCH = HERE.parent
ROOT = PORTBENCH.parent

# Small stand-ins for the cells: the same systems and entries.
SMALL_CONFIGS = {
    "reverb_small": ("reverb64", {"channels": 2, "ir_taps": 1000, "block": 256}),
    "rfft_small": ("rfft16384", {"n": 512}),
}
SMALL_MIXES = {
    "offline_small": ("offline_loop", {"clip_seconds": 0.05, "warmup_calls": 2, "kept": 2}),
    "roundtrip_small": ("batch_roundtrip_b4096", {"batch": 16, "ring": 3, "warmup_calls": 2, "kept": 3}),
}
# small cell: (configuration, mix, the cell of BENCHMARK.json whose metrics it reports)
SMALL_CELLS = {
    "reverb_small.offline": ("reverb_small", "offline_small", "reverb64.offline"),
    "rfft_small.b16": ("rfft_small", "roundtrip_small", "rfft16384.b4096"),
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one "
                                       "(on the card: python -m pytest -m cuda portbench/tests -q)")


def small_copy(dest: pathlib.Path) -> pathlib.Path:
    """A copy of ``portbench/`` under ``dest`` whose BENCHMARK.json holds
    the small cells, with their configurations and mixes as files."""
    shutil.copytree(PORTBENCH, dest / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    for name, (base, changes) in SMALL_CONFIGS.items():
        cfg = json.loads((PORTBENCH / "configs" / f"{base}.json").read_text()) | changes
        (dest / "portbench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, (base, changes) in SMALL_MIXES.items():
        mix = json.loads((PORTBENCH / "traffic" / f"{base}.json").read_text()) | changes
        (dest / "portbench" / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": n, "source": "test", "file": f"portbench/configs/{n}.json", "reduced": [],
                         "why": "test"} for n in SMALL_CONFIGS]
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "test"}
                          for n, (c, t, _) in SMALL_CELLS.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [n for n, (_, _, cell) in SMALL_CELLS.items() if cell in m["workloads"]]
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture(scope="session")
def small(tmp_path_factory) -> pathlib.Path:
    return small_copy(tmp_path_factory.mktemp("small"))


def run_module(cwd: pathlib.Path, module: str, *args: str, timeout: float = 300) -> subprocess.CompletedProcess:
    """``python -m module args`` from ``cwd``, with the repository's port
    importable behind the copy."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(cwd), str(ROOT)]))
    return subprocess.run([sys.executable, "-m", module, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def run_small(copy: pathlib.Path, cell: str, seed: int, *opts: str) -> dict:
    """The result object of one small cell run on the CPU."""
    proc = run_module(copy, "portbench.tests.cpu_cell", cell, str(seed), "0.2", *opts)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])
