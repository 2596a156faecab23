"""The port's profiling helpers on the CPU, structurally: the slope of
``op_seconds`` against an injected clock, and ``trace`` writing a Chrome
trace. No timing thresholds: the times themselves come from the card
(chip_smoke.py's phase 22: ``op_seconds`` against phase 5's graph time of
K1)."""

import json

import pytest
import torch

import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu_torch.utils import profiling


class FakeClock:
    """Advances ``per_call`` a body call, plus ``fixed`` a loop."""

    def __init__(self, per_call: float, fixed: float):
        self.now, self.per_call, self.fixed = 0.0, per_call, fixed
        self.calls = 0

    def __call__(self) -> float:
        self.now += self.fixed / 2  # half the fixed cost at each end of a loop
        return self.now

    def body(self, c):
        self.calls += 1
        self.now += self.per_call
        return c + 1


def test_op_seconds_is_the_slope_between_loop_lengths(monkeypatch):
    clock = FakeClock(per_call=2.5e-3, fixed=0.7)
    monkeypatch.setattr(profiling, "_clock", clock)
    got = profiling.op_seconds(clock.body, torch.zeros(3), iters_pair=(4, 20), repeats=2)
    assert got == pytest.approx(2.5e-3, rel=1e-9)  # the fixed cost drops out
    assert clock.calls == (1 + 2) * 4 + (1 + 2) * 20  # a warm loop and the repeats, at each length
    rate = profiling.measure_samples_per_s(clock.body, torch.zeros(3), 1000, iters_pair=(4, 20), repeats=2)
    assert rate == pytest.approx(1000 / 2.5e-3, rel=1e-9)


def test_op_seconds_carries_tuples_and_takes_the_minimum(monkeypatch):
    """A tuple carry goes through the loop whole; each length's time is
    the fastest of its repeats."""
    clock = FakeClock(per_call=1e-3, fixed=0.0)
    monkeypatch.setattr(profiling, "_clock", clock)
    seen = []

    def body(c):
        a, b = c
        seen.append(int(a))
        slow = len(seen) in (5, 6, 7, 8)  # the first timed repeat of the short loop runs slow
        clock.now += 0.5 if slow else 0.0
        return clock.body(a), b

    got = profiling.op_seconds(body, (torch.tensor(0), torch.ones(2)), iters_pair=(4, 8), repeats=2)
    assert got == pytest.approx(1e-3, rel=1e-9)
    assert seen[:4] == [0, 1, 2, 3]


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(2, 1024)
    with profiling.trace(tmp_path / "tr") as log_dir:
        ct.rfft_packed(x)
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert log_dir == str(tmp_path / "tr") and len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
