"""The complex round trip's stand-in on the CPU: ``cfft1048576.b64`` at
2 rows of 2^15 (256 x 128, still the complex two-level composite),
through the harness and the port's plain versions; the control and the
planted faults fail. Its three readers on a made-up host-ops window, and
the cell's entries in ``BENCHMARK.json``."""

import json

import pytest

from portbench import cfft_work, harness, spans
from portbench.tests.conftest import ROOT, run_module, small_copy
from portbench.tests.test_portbench_spans import _readings, _write, _x, trace_dir  # noqa: F401

SEED = 2_147_483_693  # past 32 signed bits
CELL = "cfft_small.b2"
REAL = "cfft1048576.b64"
N, ROWS = 1 << 15, 2
READERS = ("cfft_roofline", "cfft_level1_device_ms", "cfft_level2_device_ms")


@pytest.fixture(scope="module")
def cfft_small(tmp_path_factory):
    """``small_copy`` plus the complex stand-in: its configuration, mix and
    cell, which reports what ``cfft1048576.b64`` reports."""
    copy = small_copy(tmp_path_factory.mktemp("cfft_small"))
    pb = copy / "portbench"
    config = json.loads((pb / "configs" / "cfft1048576.json").read_text()) | {"n": N}
    (pb / "configs" / "cfft_small.json").write_text(json.dumps(config))
    mix = json.loads((pb / "traffic" / "complex_roundtrip_b64.json").read_text())
    mix |= {"batch": ROWS, "ring": 3, "warmup_calls": 2, "trace_calls": 2, "enqueue_calls": 2, "kept": 2}
    (pb / "traffic" / "complex_roundtrip_small.json").write_text(json.dumps(mix))
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    listing = {m["name"] for m in real["end_to_end"] + real["per_layer"] if REAL in m.get("workloads", [])}
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "cfft_small", "source": "test", "file": "portbench/configs/cfft_small.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "cfft_small", "traffic": "complex_roundtrip_small",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in listing:
            m["workloads"].append(CELL)
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    return copy


def _run(copy, *opts):
    proc = run_module(copy, "portbench.tests.cfft_cpu_cell", CELL, str(SEED), "0.2", *opts)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_stand_in_is_correct(cfft_small):
    result = _run(cfft_small)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"samples_per_s.fft", "setup_s"}
    assert set(result["checks"]) == {"spectrum_gap", "roundtrip_gap"}
    for check in result["checks"].values():
        assert check["value"] < check["limit"] / 20


@pytest.mark.parametrize("opts", [("--control",), ("--fault", "conjugated_twiddle"), ("--fault", "zeroed_row")],
                         ids=["control", "conjugated_twiddle", "zeroed_row"])
def test_the_stand_in_fails(cfft_small, opts):
    """The reference computed on TF32 inputs in the program's place, level
    2 on the conjugate twiddle, and a zeroed row of the spectrum: each
    fails."""
    result = _run(cfft_small, *opts)
    assert result["correct"] is False and result["failed"] > 0
    assert result["checks"]["spectrum_gap"]["value"] > result["checks"]["spectrum_gap"]["limit"]


def test_the_stand_in_traced(cfft_small):
    """The traced path end to end: without a card the device metrics find
    nothing and are left out, and nothing raises."""
    result = _run(cfft_small, "--trace")
    assert result["correct"] is True and result["metrics"] == {}
    assert result["device"]["busy_s"] == 0 and result["device"]["window_s"] > 0


def _roundtrip_events(calls=1):
    """Calls of a complex round trip: l1, l2 forward, l2_rev, l1_rev, each
    launched in its own launch span (microseconds)."""
    ann, events = "user_annotation", []
    for i in range(calls):
        t = 10_000 * i
        events += [_x("portbench.call", ann, t, 5000), _x("api.fft", ann, t + 10, 400),
                   _x("ops.hopper_composite.cfft_composite", ann, t + 20, 300),
                   _x("api.ifft", ann, t + 500, 400), _x("ops.hopper_composite.cfft_composite", ann, t + 510, 300)]
        for j, (kernel, dur) in enumerate([("composite_l1_kernel", 540), ("composite_l2_kernel", 800),
                                           ("composite_l2_rev_kernel", 730), ("composite_l1_rev_kernel", 460)]):
            launch = t + (30 if j < 2 else 520) + 100 * (j % 2)
            corr = 10 * i + j + 1
            events += [_x(spans.LAUNCH + kernel, ann, launch, 50),
                       _x("cudaLaunchKernel", "cuda_runtime", launch + 10, 20, corr=corr),
                       _x("void (anonymous namespace)::column_passes_kernel<1, true>(float const*)", "kernel",
                          t + 1000 + 1000 * j, dur, tid=7, corr=corr)]
    return events


PORT = frozenset({"column_passes_kernel"})


def test_readers_on_a_made_up_window(trace_dir):  # noqa: F811
    _write(trace_dir / "trace_cell.host.json", _roundtrip_events(calls=2))
    r = harness.Readings(calls=2, window_s=0.02, busy_s=2 * 2.53e-3, device=[], port_kernels=PORT, enqueue_s=[],
                         work={"cfft": cfft_work.roundtrip_work(1 << 20, 64)})
    assert harness.metric_reader("cfft_level1_device_ms")(r) == pytest.approx(0.540 + 0.460)
    assert harness.metric_reader("cfft_level2_device_ms")(r) == pytest.approx(0.800 + 0.730)
    assert harness.metric_reader("cfft_roofline")(r) == pytest.approx(100 * 6.41043e-4 / 2.53e-3, rel=1e-5)


@pytest.mark.parametrize("case", ["no launch span", "no window", "no work"])
def test_readers_read_nothing(trace_dir, case):  # noqa: F811
    """A program without the launch spans, no host-ops window, or a run
    without the cell's work: the readers return None."""
    events = _roundtrip_events()
    if case == "no launch span":
        events = [e for e in events if not e["name"].startswith(spans.LAUNCH)]
    if case != "no window":
        _write(trace_dir / "trace_cell.host.json", events)
    if case == "no work":
        r = harness.Readings(calls=1, window_s=1e-3, busy_s=1e-3, device=[], port_kernels=PORT, enqueue_s=[],
                             work={})
        assert harness.metric_reader("cfft_roofline")(r) is None
    else:
        r = _readings()
        assert harness.metric_reader("cfft_level1_device_ms")(r) is None
        assert harness.metric_reader("cfft_level2_device_ms")(r) is None


def test_the_benchmark_lists_the_cell():
    """One configuration, one one-chip cell, ``samples_per_s.fft`` and the
    three readers listing it, each of those moving ``samples_per_s.fft``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.find(bench["workloads"], REAL, "workload")
    assert cell == {"name": REAL, "config": "cfft1048576", "traffic": "complex_roundtrip_b64", "chips": 1,
                    "why": cell["why"]}
    assert harness.find(bench["configs"], "cfft1048576", "config")["reduced"] == []
    listing = {m["name"] for m in bench["end_to_end"] + bench["per_layer"] if REAL in m.get("workloads", [])}
    assert listing == {"samples_per_s.fft", *READERS}
    for name in READERS:
        m = harness.find(bench["per_layer"], name, "metric")
        assert m["moves"] == "samples_per_s.fft" and m["workloads"] == [REAL]

