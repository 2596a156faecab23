"""The readers of the port's own record (``portbench/records.py``) on a
made-up device-only window: two long-IR-like calls, each with the real
composite's two drivers around three kernel launches, on a trace clock
250 µs off the wall clock's."""

import json
import re

import pytest

from chowdsp_fft_tpu_torch.utils import tracing
from portbench import harness, records
from portbench.metrics import composite_host_ms, program_host_ms, span_idle_ms

THREAD, DEVICE_TID = 7, 99
PORT = frozenset({"rfft_packed_kernel", "irfft_packed_kernel"})
CALL_US = (0.0, 1200.0)


def _record(name, start_us, end_us, index, parent, call, t0):
    return tracing.Record(name, t0 + round(start_us * 1e3), t0 + round(end_us * 1e3), parent, call, THREAD, index)


def _x(name, cat, ts, dur, tid=THREAD, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _window(t0: int, offset_ns: int, base_ns: int):
    """The records of the two calls and the device-only trace's events.
    In a call (µs from its start): ``stream.ols.fir_filter_ols`` [0, 1000];
    ``rfft_composite`` [100, 400] with launches [150, 170] and [200, 220];
    ``irfft_composite`` [600, 900] with a launch [700, 720]; each launch's
    runtime call 5 µs in; the kernels at [160, 300], [350, 500], [720,
    1100]. After the second call an aten launch outside every record and
    its kernel at [2400, 2450]."""
    recs, events = [], []
    us = lambda perf_us: (t0 + round(perf_us * 1e3) + offset_ns - base_ns) / 1e3  # noqa: E731
    for o in CALL_US:
        i = len(recs)
        recs += [_record("stream.ols.fir_filter_ols", o, o + 1000, i, None, i, t0),
                 _record("ops.hopper_composite.rfft_composite", o + 100, o + 400, i + 1, i, i, t0),
                 _record("ops._cuda.launch.rfft_packed_kernel", o + 150, o + 170, i + 2, i + 1, i, t0),
                 _record("ops._cuda.launch.rfft_packed_kernel", o + 200, o + 220, i + 3, i + 1, i, t0),
                 _record("ops.hopper_composite.irfft_composite", o + 600, o + 900, i + 4, i, i, t0),
                 _record("ops._cuda.launch.irfft_packed_kernel", o + 700, o + 720, i + 5, i + 4, i, t0)]
        for corr, (call, kernel, start, end) in enumerate(
                [(150, "rfft_packed_kernel", 160, 300), (200, "rfft_packed_kernel", 350, 500),
                 (700, "irfft_packed_kernel", 720, 1100)], start=int(o)):
            events += [_x("cudaLaunchKernel", "cuda_runtime", us(o + call + 5), 5.0, corr=corr),
                       _x(f"void {kernel}(float const*)", "kernel", us(o + start), end - start, DEVICE_TID, corr)]
    events += [_x("cudaLaunchKernel", "cuda_runtime", us(2210), 5.0, corr=5000),
               _x("void at::native::fill_kernel()", "kernel", us(2400), 50.0, DEVICE_TID, 5000)]
    return recs, events


@pytest.fixture
def window(tmp_path, monkeypatch):
    """Writes the device-only trace where the harness puts it, serves the
    records from the port's ring, and returns the Readings of the run."""
    t0 = tracing._clock()
    offset = tracing._wall_offset_ns() + 250_000
    base = (t0 + offset) // 10**9 * 10**9
    recs, events = _window(t0, offset, base)
    monkeypatch.setattr(harness, "TRACE_DIR", tmp_path)
    (tmp_path / "trace_cell.json").write_text(json.dumps({"baseTimeNanoseconds": base, "traceEvents": events}))
    monkeypatch.setattr(tracing, "records", lambda: list(recs))
    monkeypatch.setattr(tracing, "dropped", lambda: 0)
    return harness.Readings(calls=2, window_s=2.6e-3, busy_s=1.08e-3, device=[], port_kernels=PORT, enqueue_s=[],
                            work={})


def test_the_readers_read_the_window(window, capsys):
    # gaps: [300, 350] in rfft_composite, [500, 720] in irfft_composite,
    # [1100, 1360] in the second call's entry, [1500, 1550] and
    # [1700, 1920] as the first call's; [2300, 2400] outside every record
    assert span_idle_ms.read(window) == pytest.approx((50 + 220 + 260 + 50 + 220) / 2 / 1e3, rel=1e-9)
    assert program_host_ms.read(window) == pytest.approx(1.0, rel=1e-9)
    # rfft_composite 300 - 2 x 20 µs, irfft_composite 300 - 20, a call
    assert composite_host_ms.read(window) == pytest.approx((260 + 280) / 1e3, rel=1e-9)
    log = capsys.readouterr().err
    assert "record ops.hopper_composite.irfft_composite: host self 0.280000 ms a call; idle 0.220000 ms a call" in log
    # the wait [0, 160] before the first kernel, at its middle in the entry's record: the fit's offset
    # moves it by up to half the slack, 15 µs wide here
    [entry] = re.findall(r"record stream.ols.fir_filter_ols: host self (\S+) ms a call; idle (\S+) ms a call", log)
    [summary] = re.findall(r"idle (\S+) ms a call in records \((\S+) of it from the first record to the first busy "
                           r"interval\), (\S+) between busy intervals outside any record, (\S+) before the first "
                           r"record or after the last busy interval \(host clock\); the window's idle "
                           r"\(window_s - busy_s\) (\S+)$", log, re.M)
    inside, head, outside, rest, total = map(float, summary)
    assert head == pytest.approx(0.080, abs=0.004)
    assert list(map(float, entry)) == pytest.approx([0.400, 0.130 + head], abs=2e-6)
    assert [inside, outside, total] == pytest.approx([0.400 + head, 0.050, 0.760], abs=2e-6)
    assert inside + outside + rest == pytest.approx(total, abs=3e-6)
    assert "clock map by launches" in log and "6 of 6 launch records hold a kernel's runtime call" in log
    assert "6 of 6 port-kernel runtime calls inside a launch record" in log and "0 device ops start before" in log


def test_the_readers_read_nothing_without_the_record(window, monkeypatch):
    """A port that keeps no record (a commit before it): every reader
    reads ``None`` and none raises."""
    monkeypatch.delattr(tracing, "clock_map")
    assert [m.read(window) for m in (span_idle_ms, program_host_ms, composite_host_ms)] == [None] * 3


def test_the_readers_read_nothing_where_the_ring_dropped_the_window(window, monkeypatch):
    monkeypatch.setattr(tracing, "dropped", lambda: 3)
    assert [m.read(window) for m in (span_idle_ms, program_host_ms, composite_host_ms)] == [None] * 3


def test_the_readers_read_nothing_where_calls_and_records_differ(window):
    window.calls = 3
    assert [m.read(window) for m in (span_idle_ms, program_host_ms, composite_host_ms)] == [None] * 3


def test_the_composite_reader_reads_nothing_without_its_drivers(window, monkeypatch):
    recs = [r._replace(parent=r.call if r.parent is not None else None)
            for r in tracing.records() if "composite" not in r.name]
    monkeypatch.setattr(tracing, "records", lambda: recs)
    assert composite_host_ms.read(window) is None
    assert program_host_ms.read(window) == pytest.approx(1.0, rel=1e-9)
