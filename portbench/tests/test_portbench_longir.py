"""The long-IR reverb's stand-in on the CPU: ``longir64.offline`` at 2
channels of 1 s through 40,000-tap IRs (N = 2^18, still the real
composite), through the harness and the port's plain versions; the
control and the planted faults fail. And the cell's work, against
numbers worked out by hand."""

import json

import pytest

from portbench.tests.conftest import ROOT, run_module, small_copy

SEED = 2_147_483_659  # past 32 signed bits
CELL = "longir_small.offline"
CHANNELS, TAPS, SECONDS = 2, 40_000, 1.0


@pytest.fixture(scope="module")
def longir_small(tmp_path_factory):
    """``small_copy`` plus the long-IR stand-in: its configuration, mix and
    cell, which reports what ``longir64.offline`` reports."""
    copy = small_copy(tmp_path_factory.mktemp("longir_small"))
    pb = copy / "portbench"
    config = json.loads((pb / "configs" / "longir64.json").read_text())
    config |= {"channels": CHANNELS, "ir_taps": TAPS}
    (pb / "configs" / "longir_small.json").write_text(json.dumps(config))
    mix = json.loads((pb / "traffic" / "offline_loop.json").read_text())
    mix |= {"clip_seconds": SECONDS, "warmup_calls": 2, "trace_calls": 2, "kept": 2}
    (pb / "traffic" / "offline_longir_small.json").write_text(json.dumps(mix))
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    listing = {m["name"] for m in real["end_to_end"] + real["per_layer"] if "longir64.offline" in m.get("workloads", [])}
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "longir_small", "source": "test", "file": "portbench/configs/longir_small.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "longir_small", "traffic": "offline_longir_small",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in listing:
            m["workloads"].append(CELL)
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    return copy


def _run(copy, *opts):
    proc = run_module(copy, "portbench.tests.longir_cpu_cell", CELL, str(SEED), "0.2", *opts)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_stand_in_is_correct(longir_small):
    result = _run(longir_small)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"samples_per_s.convolve", "setup_s"}
    check = result["checks"]["output_gap"]
    assert check["value"] < check["limit"] / 20


@pytest.mark.parametrize("opts", [("--control",), ("--fault", "half_channels"), ("--fault", "unflipped_hermitian")],
                         ids=["control", "half_channels", "unflipped_hermitian"])
def test_the_stand_in_fails(longir_small, opts):
    """The reference computed on TF32 inputs in the program's place, half
    of the channels zeroed where ``fir_filter_ols`` produces them, and the
    Hermitian assembly without its flips: each fails."""
    result = _run(longir_small, *opts)
    assert result["correct"] is False and result["failed"] > 0


def test_the_stand_in_traced(longir_small):
    """The traced path end to end: without a card the device metrics find
    nothing and are left out, and nothing raises."""
    result = _run(longir_small, "--trace")
    assert result["correct"] is True and result["metrics"] == {}
    assert result["device"]["busy_s"] == 0 and result["device"]["window_s"] > 0


def test_the_calls_work():
    """At 64 channels of 480,000 samples and 96,000 taps: N = 2^19 and 2
    frames a channel (the stand-in: 2^18, 1 frame), so 192 forward and
    128 inverse rows. The call: x,
    the IRs and y once (270.3 MB) and 8.238 GFLOP, 0.1229 ms, set by the
    operations. The composite's column kernels: 16 N bytes a row (2.684
    GB) and 7.969 GFLOP, 0.8013 ms, set by the bytes."""
    from portbench import longir_work, roofline

    assert longir_work.ols_geometry(480_000, 96_000) == (1 << 19, 2)
    assert longir_work.ols_geometry(480_000, 96_000, block=262_144) == (1 << 19, 2)
    assert longir_work.ols_geometry(int(SECONDS * 48_000), TAPS) == (1 << 18, 1)  # the stand-in's
    n, rows = 1 << 19, 64 + 128 + 128
    bytes_moved, flops = longir_work.call_work(64, 480_000, 96_000)
    assert bytes_moved == 4 * 64 * 480_000 * 2 + 4 * 64 * 96_000 == 270_336_000
    assert flops == rows * 2.5 * n * 19 + 8 * 128 * n // 2 == 8_237_613_056
    assert roofline.least_seconds(bytes_moved, flops) == pytest.approx(1.22949e-4, rel=1e-5)
    assert flops / roofline.FP32_FLOPS > bytes_moved / roofline.HBM_BYTES_PER_S
    bytes_moved, flops = longir_work.composite_work(64, 480_000, 96_000)
    assert bytes_moved == rows * 16 * n == 2_684_354_560
    assert flops == rows * 2.5 * n * 19 == 7_969_177_600
    assert roofline.least_seconds(bytes_moved, flops) == pytest.approx(8.0130e-4, rel=1e-4)
    assert bytes_moved / roofline.HBM_BYTES_PER_S > flops / roofline.FP32_FLOPS
