"""The reduction from a Chrome trace to busy time, op totals, idle gaps
and the per-layer metrics, on a made-up trace."""

import json

import pytest

from portbench import harness, trace

PORT = frozenset({"rfft_packed_kernel", "irfft_packed_kernel"})


def _trace(tmp_path):
    ev = [
        {"ph": "X", "cat": "kernel", "name": "(anonymous namespace)::rfft_packed_kernel(float const*)", "ts": 100, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::irfft_packed_kernel<false>(float const*)",
         "ts": 105, "dur": 10},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "ts": 130, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "void at::native::vectorized_elementwise_kernel<4>()", "ts": 150, "dur": 20},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 114, "dur": 20},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.call", "ts": 90, "dur": 100},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 140, "dur": 5},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.read_chrome_trace(path)


def test_busy_is_the_union(tmp_path):
    device, host = _trace(tmp_path)
    assert len(device) == 4 and len(host) == 3
    busy = trace.busy_intervals(device)
    assert [(round(a * 1e6), round(b * 1e6)) for a, b in busy] == [(100, 115), (130, 135), (150, 170)]


def test_port_kernels_by_identifier():
    assert trace.is_port_kernel("void (anonymous namespace)::irfft_packed_kernel<false>(float)", PORT)
    assert trace.is_port_kernel("(anonymous namespace)::rfft_packed_kernel(float const*)", PORT)
    assert not trace.is_port_kernel("void my_rfft_packed_kernel_v2<1>(float)", PORT)
    assert not trace.is_port_kernel("void at::native::vectorized_elementwise_kernel<4>()", PORT)


def test_idle_gaps_by_innermost_host_op(tmp_path):
    device, host = _trace(tmp_path)
    gaps = dict(trace.idle_gaps_by_host_op(device, host))
    # 115-130 (middle 122.5: aten::mul inside portbench.call), 135-150 (middle 142.5: cudaLaunchKernel)
    assert gaps == {"aten::mul": pytest.approx(15e-6), "cudaLaunchKernel": pytest.approx(15e-6)}
    totals = dict(trace.device_ops_by_name(device))
    assert totals["Memset (Device)"] == pytest.approx(5e-6)


def test_readers(tmp_path):
    device, _ = _trace(tmp_path)
    busy = sum(b - a for a, b in trace.busy_intervals(device))
    r = harness.Readings(calls=2, window_s=100e-6, busy_s=busy, device=device, port_kernels=PORT,
                         enqueue_s=[1e-3, 3e-3, 2e-3], work={"fft": (3.35e12 * 20e-6, 0.0)})
    read = lambda name: harness.metric_reader(name)(r)  # noqa: E731
    assert read("idle_pct.fft") == pytest.approx(100 * (1 - 40e-6 / 100e-6))
    assert read("launches_per_call.convolve") == 2.0
    assert read("glue_device_ms") == pytest.approx(1e3 * 25e-6 / 2)
    assert read("enqueue_ms.fft") == pytest.approx(2.0)
    assert read("fft_roofline") == pytest.approx(100 * 20e-6 / 20e-6)
    assert read("call_roofline") is None  # nothing to read: no "call" work in this cell
    empty = harness.Readings(calls=1, window_s=1.0, busy_s=0.0, device=[], port_kernels=PORT, enqueue_s=[], work={})
    assert all(harness.metric_reader(n)(empty) is None for n in
               ("idle_pct.convolve", "glue_device_ms", "enqueue_ms.fft", "launches_per_call.fft",
                "fft_roofline"))


def test_a_device_window_that_lost_events_is_profiled_anew(monkeypatch):
    """The profiler's lost events cost a window profiled anew, not the run."""
    lost, profiled = iter([2, 1, 0]), []
    monkeypatch.setattr(harness, "_lost", lambda w, launched, names, log: next(lost))
    monkeypatch.setattr(harness, "_profile", lambda calls, name, n, host_ops: profiled.append((n, host_ops))
                        or (f"w{len(profiled) + 1}", 0.5, 4))
    got = harness._device_window(None, "cell", 7, ("w1", 0.4, 4), PORT, lambda line: None)
    assert got == ("w3", 0.5) and profiled == [(7, False), (7, False)]


def test_a_run_whose_device_windows_all_lost_events_fails(monkeypatch):
    profiled = []
    monkeypatch.setattr(harness, "_lost", lambda w, launched, names, log: 1)
    monkeypatch.setattr(harness, "_profile", lambda calls, name, n, host_ops: profiled.append(n) or ("w", 0.5, 4))
    with pytest.raises(RuntimeError, match="lost port-kernel events"):
        harness._device_window(None, "cell", 7, ("w1", 0.4, 4), PORT, lambda line: None)
    assert len(profiled) == harness.PROFILE_TRIES - 1
