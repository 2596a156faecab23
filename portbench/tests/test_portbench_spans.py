"""The program's spans in a made-up host-ops window: the attribution of
device ops to the innermost span that launched them, and the readers
that sum them (``portbench/spans.py``)."""

import json
import os

import pytest

from portbench import harness, spans

PORT = frozenset({"rfft_packed_kernel", "irfft_packed_kernel"})


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _window_events():
    """One call of a reverb-like apply, in microseconds."""
    ann = "user_annotation"
    return [
        _x("portbench.call", ann, 0, 1000),
        _x("stream.ols.apply_offline", ann, 5, 595),
        _x("stream.ols.frame", ann, 10, 20),
        _x("api.rfft_packed_unordered", ann, 35, 65),
        _x("ops._cuda.launch.rfft_packed_kernel", ann, 40, 20),  # its runtime call is missing
        _x("stream.ols.fdl_shift", ann, 110, 40),
        _x("cudaLaunchKernel", "cuda_runtime", 120, 5, corr=2),
        _x("ops.convolve.accumulate_packed", ann, 200, 200),
        _x("aten::mul", "cpu_op", 205, 20),
        _x("cudaLaunchKernel", "cuda_runtime", 210, 5, corr=3),
        _x("cudaLaunchKernel", "cuda_runtime", 220, 5, tid=2, corr=8),  # another thread
        _x("cudaLaunchKernel", "cuda_runtime", 300, 5, corr=4),
        _x("api.irfft_packed_unordered", ann, 410, 70),
        _x("ops._cuda.launch.irfft_packed_kernel", ann, 420, 20),
        _x("cudaLaunchKernel", "cuda_runtime", 425, 5, corr=5),
        _x("stream.ols.trim", ann, 500, 50),
        _x("cudaLaunchKernel", "cuda_runtime", 510, 2, corr=6),
        _x("cudaLaunchKernel", "cuda_runtime", 700, 5, corr=7),  # outside every span
        _x("(anonymous namespace)::rfft_packed_kernel(float const*)", "kernel", 100, 10, tid=7, corr=1),
        _x("void at::native::elementwise_kernel<pad>()", "kernel", 130, 10, tid=7, corr=2),
        _x("void at::native::vectorized_elementwise_kernel<mul>()", "kernel", 220, 40, tid=7, corr=3),
        _x("void at::native::vectorized_elementwise_kernel<add>()", "kernel", 310, 20, tid=7, corr=4),
        _x("void (anonymous namespace)::irfft_packed_kernel<false>(float const*)", "kernel", 440, 10, tid=7, corr=5),
        _x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 520, 10, tid=7, corr=6),
        _x("void other_kernel()", "kernel", 710, 10, tid=7, corr=7),
        _x("void from_another_thread()", "kernel", 730, 5, tid=7, corr=8),
        _x("stream.ols.fdl_shift", "gpu_user_annotation", 130, 10, tid=7),  # the device's copy: not an op
    ]


def _write(path, events):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def _readings(calls=1):
    return harness.Readings(calls=calls, window_s=1e-3, busy_s=0.0, device=[], port_kernels=PORT, enqueue_s=[],
                            work={})


def test_attribution(tmp_path):
    device, host = spans.read_events(_write(tmp_path / "t.host.json", _window_events()))
    owner, placed = spans.attribute(device, host, PORT)
    assert [s.name if s else None for s in owner] == [
        "ops._cuda.launch.rfft_packed_kernel",  # a port kernel without its runtime call: paired by order
        "stream.ols.fdl_shift",
        "ops.convolve.accumulate_packed",  # the innermost of apply_offline and the accumulate
        "ops.convolve.accumulate_packed",
        "ops._cuda.launch.irfft_packed_kernel",  # by correlation
        "stream.ols.trim",
        None,  # launched outside every span
        None,  # its runtime call ran on another thread
    ]
    assert placed == {"port_kernels": 2, "by_correlation": 1, "by_order": 1}


def test_port_kernels_are_not_paired_when_the_counts_differ(tmp_path):
    events = [e for e in _window_events() if e["name"] != "ops._cuda.launch.irfft_packed_kernel"]
    device, host = spans.read_events(_write(tmp_path / "t.host.json", events))
    owner, placed = spans.attribute(device, host, PORT)
    assert owner[0] is None and placed["by_order"] == 0


@pytest.fixture
def trace_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "TRACE_DIR", tmp_path / "portbench")
    spans._window.cache_clear()
    return tmp_path / "portbench"


@pytest.mark.parametrize("name, value", [
    ("accumulate_device_ms", 1e-3 * 60),
    ("fdl_shift_device_ms", 1e-3 * 10),
    ("framing_device_ms", 1e-3 * 10),
    # gaps 110-130, 140-220, 260-310, 330-440, 450-520 fall in spans; 530-710, 720-730 do not
    ("program_idle_ms.convolve", 1e-3 * (20 + 80 + 50 + 110 + 70)),
    ("dispatch_host_ms.fft", 1e-3 * (65 + 70 - 20 - 20)),
    ("launch_host_ms.fft", 1e-3 * 40),
])
def test_readers(trace_dir, name, value, capsys):
    _write(trace_dir / "trace_cell.host.json", _window_events())
    assert harness.metric_reader(name)(_readings()) == pytest.approx(value)
    err = capsys.readouterr().err
    assert "spans: 2 port-kernel events, 1 placed by correlation, 1 by order; 2 in the launch span" in err
    assert "spans: glue 0.080000 ms a call" in err


def test_host_times_are_medians_over_the_calls(trace_dir):
    ann = "user_annotation"
    events = []
    for i, (api_us, launch_us) in enumerate([(50, 10), (80, 30), (60, 20)]):
        t = 1000 * i
        events += [_x("portbench.call", ann, t, 500), _x("api.rfft_packed", ann, t + 10, api_us),
                   _x("ops._cuda.launch.rfft_packed_kernel", ann, t + 20, launch_us)]
    _write(trace_dir / "trace_cell.host.json", events)
    r = _readings(calls=3)
    assert harness.metric_reader("launch_host_ms.fft")(r) == pytest.approx(0.020)
    assert harness.metric_reader("dispatch_host_ms.fft")(r) == pytest.approx(0.040)  # 40, 50, 40
    assert harness.metric_reader("accumulate_device_ms")(r) is None  # no device ops


NEW = ("accumulate_device_ms", "fdl_shift_device_ms", "framing_device_ms", "program_idle_ms.convolve",
       "dispatch_host_ms.fft", "launch_host_ms.fft")


@pytest.mark.parametrize("case", ["no program span", "no window", "another run's window"])
def test_readers_read_nothing(trace_dir, case):
    """A program without spans, no host-ops window, or a window with
    another count of calls: every new reader returns None."""
    events = _window_events()
    if case == "no program span":
        events = [e for e in events if not spans.is_program(e["name"]) or e["cat"] != "user_annotation"]
    if case != "no window":
        _write(trace_dir / "trace_cell.host.json", events)
    r = _readings(calls=2 if case == "another run's window" else 1)
    assert all(harness.metric_reader(name)(r) is None for name in NEW)


def test_the_newest_window_is_read(trace_dir):
    old = _write(trace_dir / "trace_a.host.json", _window_events())
    os.utime(old, ns=(1, 1))
    new = [e for e in _window_events() if e["name"] != "stream.ols.trim"]
    _write(trace_dir / "trace_b.host.json", new)
    assert harness.metric_reader("framing_device_ms")(_readings()) == 0.0
