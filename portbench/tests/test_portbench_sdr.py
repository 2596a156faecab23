"""The SDR cell's stand-in on the CPU: ``sdr256.wideband`` at C = 32 on
2^15-sample captures, through the harness and the port's plain versions;
the control and a planted fault fail. And the cell's files: the
configuration's channel set and the chain's work."""

import json

import pytest

from portbench.tests.conftest import ROOT, run_module, small_copy

SEED = 2_147_483_659  # past 32 signed bits
CELL = "sdr_small.wideband"
CHANNELS = 32


def _occupied(channels: int) -> list[int]:
    from portbench.reference.sdr import lowpass
    from portbench.systems import sdr

    return sdr.occupied_channels(lowpass(64, 0.5), channels, 2)


@pytest.fixture(scope="module")
def sdr_small(tmp_path_factory):
    """``small_copy`` plus the SDR stand-in: its configuration, mix and
    cell, which reports what ``sdr256.wideband`` reports."""
    copy = small_copy(tmp_path_factory.mktemp("sdr_small"))
    pb = copy / "portbench"
    config = json.loads((pb / "configs" / "sdr256.json").read_text())
    config |= {"channels": CHANNELS, "occupied": _occupied(CHANNELS)}
    (pb / "configs" / "sdr_small.json").write_text(json.dumps(config))
    mix = json.loads((pb / "traffic" / "fm_capture_loop.json").read_text())
    mix |= {"capture_samples": 1 << 15, "ring": 2, "warmup_calls": 2, "trace_calls": 2, "kept": 2}
    (pb / "traffic" / "fm_capture_small.json").write_text(json.dumps(mix))
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    listing = {m["name"] for m in real["end_to_end"] + real["per_layer"] if "sdr256.wideband" in m.get("workloads", [])}
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sdr_small", "source": "test", "file": "portbench/configs/sdr_small.json",
                             "reduced": config["reduced"], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "sdr_small", "traffic": "fm_capture_small", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in listing:
            m["workloads"].append(CELL)
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    return copy


def _run(copy, *opts):
    proc = run_module(copy, "portbench.tests.sdr_cpu_cell", CELL, str(SEED), "0.2", *opts)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_stand_in_is_correct(sdr_small):
    result = _run(sdr_small)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"samples_per_s.fft", "setup_s"}
    check = result["checks"]["audio_gap"]
    assert check["value"] < check["limit"] / 20


@pytest.mark.parametrize("opts", [("--control",), ("--fault", "half_channels"), ("--fault", "unflipped_branches")],
                         ids=["control", "half_channels", "unflipped_branches"])
def test_the_stand_in_fails(sdr_small, opts):
    """The reference computed in TF32 in the program's place, half of the
    channels zeroed where the chain produces them, and the channelizer's
    branches stored oldest-first by its constructor: each fails."""
    result = _run(sdr_small, *opts)
    assert result["correct"] is False and result["failed"] > 0


def test_the_stand_in_traced(sdr_small):
    """The traced path end to end: without a card the device metrics find
    nothing and are left out, and nothing raises."""
    result = _run(sdr_small, "--trace")
    assert result["correct"] is True
    assert result["device"]["busy_s"] == 0 and result["device"]["window_s"] > 0


def test_the_configuration_lists_the_occupied_channels():
    """``occupied`` is what the front end's response gives, and the widths
    are ``SDRChainConfig()``'s."""
    import dataclasses

    from chowdsp_fft_tpu_torch.models import SDRChainConfig

    config = json.loads((ROOT / "portbench" / "configs" / "sdr256.json").read_text())
    assert config["occupied"] == _occupied(config["channels"])
    assert len(config["occupied"]) == 241
    for f in dataclasses.fields(SDRChainConfig):
        assert config[f.name] == getattr(SDRChainConfig(), f.name)


def test_the_chains_work():
    """At 2^24 samples: 142.6 MB and 3.087 GFLOP, a least time of 0.0461
    ms set by the operations."""
    from portbench import roofline, sdr_work

    bytes_moved, flops = sdr_work.chain_work(1 << 24, 256, 2, 64, 8, 4, 64)
    assert bytes_moved == 8 * 2 ** 24 + 4 * 256 * 8192 == 142_606_336
    assert flops == 2 * 2 ** 23 * 128 + 2 * 256 * 32768 * 16 + 32768 * 5 * 256 * 8 + 8 * 256 * 32768 + 256 * 8192 * 128
    assert flops == 3_087_007_744
    assert roofline.least_seconds(bytes_moved, flops) == pytest.approx(4.60747e-5, rel=1e-5)
    assert flops / roofline.FP32_FLOPS > bytes_moved / roofline.HBM_BYTES_PER_S
