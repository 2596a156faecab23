"""Profiling helpers: ``torch.profiler`` traces and slope timing.

PyTorch counterpart of ``chowdsp_fft_tpu/utils/profiling.py``. An op's
cost is the slope between two loop lengths, so the fixed cost of starting
a loop drops out. On a CUDA card each loop is captured in one CUDA graph
and replayed, so no host work runs between the launches (the method of
``chip_smoke.graph_time_ms``); on the CPU it is a loop on the host clock.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import time
from typing import Callable

import torch

__all__ = ["trace", "op_seconds", "measure_samples_per_s"]

DEFAULT_TRACE_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "trace"

_clock = time.perf_counter  # the host clock of the CPU loop


@contextlib.contextmanager
def trace(log_dir: str | os.PathLike = DEFAULT_TRACE_DIR):
    """Context manager recording a ``torch.profiler`` trace, with the
    card's kernels where a CUDA device is present, and writing it as a
    Chrome trace (``trace_<pid>_<ns>.json``) into ``log_dir`` on exit.

    Example::

        with profiling.trace("build/tr"):
            ct.rfft_packed(x)
    """
    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield str(log_dir)
    finally:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(str(log_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _host_seconds(body: Callable, init, iters: int, repeats: int) -> float:
    def loop():
        c = init
        for _ in range(iters):
            c = body(c)
        return c

    loop()  # warm: plans, tables
    best = float("inf")
    for _ in range(repeats):
        t0 = _clock()
        loop()
        best = min(best, _clock() - t0)
    return best


def _graph_seconds(body: Callable, init, iters: int, repeats: int) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm: plans, device tables, library plans
        body(init)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        c = init
        for _ in range(iters):
            c = body(c)
    del c
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    del graph
    torch.cuda.empty_cache()
    return best


def op_seconds(
    body: Callable,
    init,
    iters_pair: tuple[int, int] = (16, 272),
    repeats: int = 3,
) -> float:
    """Seconds per application of ``body`` (carry -> carry, a tensor or a
    tuple, list or dict of them), measured as the slope between
    ``iters_pair`` loop lengths, each the min of ``repeats`` runs.

    Where ``init`` holds a CUDA tensor, each loop is captured in one CUDA
    graph and replayed, timed with CUDA events: device time, no host in
    the loop (a body that syncs with the host cannot be captured, and
    raises). Otherwise the loop runs on the host clock.

    Rotate a carry of several inputs whose total exceeds the card's 50 MB
    L2, or a body re-reads a cached input and times fast."""
    timer = _graph_seconds if any(t.is_cuda for t in _tensors(init)) else _host_seconds
    lo, hi = iters_pair
    t_lo, t_hi = (timer(body, init, iters, repeats) for iters in iters_pair)
    return (t_hi - t_lo) / (hi - lo)


def measure_samples_per_s(body: Callable, init, samples_per_iter: int, **kw) -> float:
    """Throughput wrapper over :func:`op_seconds`."""
    return samples_per_iter / op_seconds(body, init, **kw)
