"""Spans at the port's layer boundaries, and the port's own record of them.

A span is named ``<layer module>.<what>``. It fires while a profiler runs
or inside :func:`recording`; otherwise :func:`span` returns one shared
null context, and a span costs one check. Nothing else turns spans on.

When a span fires it appends a :class:`Record` to a ring of
:data:`CAPACITY` entries kept in this module: its name, its start and end
on ``time.perf_counter_ns``, the index of the enclosing record on the same
thread (``parent``), the index of the outermost one (``call``: the records
of one call share it) and the thread's native id. The ring overwrites its
oldest entries and counts them (:func:`dropped`). Under a profiler the
span also enters ``torch.profiler.record_function(name)``, so it lands in
the profiler's trace beside the card's kernels. :func:`recording` records
with no profiler, which costs no aten-op recording: each layer's host time
is :func:`self_ns` of its records. :func:`clock_map` puts the record on a
Chrome trace's clock, so that a device trace recorded without host ops
can be read against the program's spans.

:data:`SPANS` lists every span name in the port; each ``_cuda.Kernel``
adds its launch span (:func:`launch_span`).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import functools
import re
import threading
import time
from typing import NamedTuple

import torch

__all__ = ["SPANS", "LAUNCH_SPAN", "CAPACITY", "Record", "ClockMap", "span", "spanned", "launch_span", "recording",
           "records", "dropped", "self_ns", "clock_map"]

# The prefix of a kernel launch's span; ``_cuda.Kernel`` appends the
# kernel's name.
LAUNCH_SPAN = "ops._cuda.launch."

SPANS = (
    "models.convolver.apply",
    "models.convolver.step",
    "models.sdr.forward",
    "models.sdr.front_end",
    "models.sdr.back_end",
    "models.sdr.sharded_step",
    "stream.polyphase.decimate",
    "stream.polyphase.interpolate",
    "stream.channelizer.forward",
    "stream.channelizer.commutate",
    "stream.channelizer.branch_fir",
    "stream.demod.fm",
    "stream.ols.apply_offline",
    "stream.ols.step",
    "stream.ols.step_k",
    "stream.ols.fir_filter_ols",
    "stream.ols.frame",
    "stream.ols.fdl_shift",
    "stream.ols.trim",
    "ops.convolve.accumulate_packed",
    "ops.convolve.accumulate_partitioned",
    "ops.hopper_composite.cfft_composite",
    "ops.hopper_composite.rfft_composite",
    "ops.hopper_composite.irfft_composite",
    "api.fft",
    "api.ifft",
    "api.fft_unordered",
    "api.ifft_unordered",
    "api.fft_planes",
    "api.ifft_planes",
    "api.fft_planes_unordered",
    "api.ifft_planes_unordered",
    "api.rfft",
    "api.irfft",
    "api.rfft_unordered",
    "api.irfft_unordered",
    "api.rfft_packed",
    "api.irfft_packed",
    "api.rfft_packed_unordered",
    "api.irfft_packed_unordered",
    "api.convolve_irfft_packed",
)

# Entries the ring holds: the largest traced window (300 round trips of 4
# spans, or 20 SDR chain calls) many times over.
CAPACITY = 1 << 15

_NULL = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled
record_function = torch.profiler.record_function
_clock = time.perf_counter_ns
_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")

# A process's first record_function pays a one-time lookup of its ops
# (~1.5 ms of host time). Pay it at import, not in the first profiled call:
# a profiler that records CUDA alone runs the spans too (torch does not say
# cheaply which activities it records), and would read that as idle.
with record_function("utils.tracing.import"):
    pass

_lock = threading.Lock()
# The ring: one list a field, one slot a record. A record is no object of
# its own, so the ring leaves nothing for the garbage collector to walk.
_name: list = [None] * CAPACITY
_start: list = [0] * CAPACITY
_end: list = [None] * CAPACITY  # None while the span is open
_parent: list = [None] * CAPACITY
_call: list = [0] * CAPACITY
_thread: list = [0] * CAPACITY
_appended = 0  # records ever appended; a record's index is its place in that sequence
_recording = 0  # open recording() contexts
# What span() checks: whether a profiler runs, or, while a recording() is
# open, always true. One call either way, as cheap as the profiler's check.
_fires = _profiler_enabled
_local = threading.local()  # a thread's open spans and its native id


def launch_span(kernel: str) -> str:
    """The launch span of kernel ``kernel``, added to :data:`SPANS`."""
    global SPANS
    name = LAUNCH_SPAN + kernel
    if name not in SPANS:
        SPANS += (name,)
    return name


class Record(NamedTuple):
    """One span's entry in the ring, as :func:`records` reads it.

    Under a profiler, ``start_ns`` and ``end_ns`` are the middles of the
    calls that open and close the span's ``record_function`` range, where
    the range takes its own times (opening one costs 2-100 µs of host
    time)."""

    name: str
    start_ns: int
    end_ns: int
    parent: int | None  # the index of the enclosing record on the thread
    call: int  # the index of the outermost one
    thread: int  # the thread's native id
    index: int


class _Span:
    """A firing span's context: it writes its record into the ring."""

    __slots__ = ("name", "index", "call", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        # The ring's bookkeeping lies outside the profiler's range, which
        # then holds what it held before the record, and two clock reads.
        stack = getattr(_local, "stack", None)
        if stack is None:  # the thread's first span (its native id is a system call)
            stack = _local.stack = []
            _local.thread = threading.get_native_id()
        outer = stack[-1] if stack else None
        global _appended
        with _lock:
            i = self.index = _appended
            _appended = i + 1
            slot = i % CAPACITY
            _name[slot], _end[slot], _thread[slot] = self.name, None, _local.thread
            _parent[slot] = outer.index if outer is not None else None
            self.call = _call[slot] = outer.call if outer is not None else i
        stack.append(self)
        if _profiler_enabled():
            t = _clock()
            self._range = record_function(self.name)
            self._range.__enter__()
            _start[slot] = (t + _clock()) // 2
        else:
            self._range = None
            _start[slot] = _clock()
        return self

    def __exit__(self, *exc):
        if self._range is None:
            end = _clock()
        else:
            t = _clock()
            self._range.__exit__(*exc)
            end = (t + _clock()) // 2
            self._range = None
        stack = _local.stack
        if stack[-1] is self:
            stack.pop()
        else:
            stack.remove(self)
        if _appended - self.index <= CAPACITY:  # not yet overwritten; one store, atomic
            _end[self.index % CAPACITY] = end
        return False


def span(name: str):
    """A context that records ``name`` while a profiler runs or inside
    :func:`recording`, else a shared null context."""
    return _Span(name) if _fires() else _NULL


def spanned(name: str):
    """Decorator: each call of the function inside :func:`span` ``(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not _fires():
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)

        return run

    return wrap


def _always() -> bool:
    return True


@contextlib.contextmanager
def recording():
    """Spans fire and are recorded inside the context, with no profiler.
    Yields a list that holds, on exit, the records appended inside it (of
    every thread)."""
    global _recording, _fires
    with _lock:
        _recording += 1
        _fires = _always
        first = _appended
    out: list[Record] = []
    try:
        yield out
    finally:
        with _lock:
            _recording -= 1
            if not _recording:
                _fires = _profiler_enabled
        out.extend(_held(first))


def _held(first: int) -> list[Record]:
    """The closed records from index ``first`` on that the ring holds."""
    with _lock:
        return [Record(_name[s], _start[s], _end[s], _parent[s], _call[s], _thread[s], i)
                for i in range(max(first, _appended - CAPACITY), _appended)
                if _end[s := i % CAPACITY] is not None]


def records() -> list[Record]:
    """The closed records the ring holds, oldest first."""
    return _held(0)


def dropped() -> int:
    """Records the ring has overwritten: every record whose index is
    below this is gone."""
    return max(0, _appended - CAPACITY)


def self_ns(recs) -> dict[int, int]:
    """Each record's self time by index: its duration less the part its
    children among ``recs`` cover (the children of one thread follow one
    another inside their parent)."""
    covered = collections.Counter()
    for r in recs:
        if r.parent is not None:
            covered[r.parent] += r.end_ns - r.start_ns
    return {r.index: r.end_ns - r.start_ns - covered[r.index] for r in recs}


def _wall_offset_ns() -> int:
    """``time.time_ns()`` less ``perf_counter_ns()``, from the tightest of
    a few bracketed reads."""
    best = None
    for _ in range(5):
        a = _clock()
        wall = time.time_ns()
        b = _clock()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


@dataclasses.dataclass(frozen=True)
class ClockMap:
    """A Chrome trace's clock (``ts`` in µs from ``baseTimeNanoseconds``)
    as ``perf_counter_ns`` plus ``offset_ns``.

    ``method`` is ``"launches"`` where the offset was fitted so that the
    most launch records hold the runtime launch call of a kernel the trace
    shows (``fitted`` of the ``launch_records`` near the trace do, at every
    offset in a range ``slack_ns`` wide), else ``"wall clock"``:
    ``time.time_ns()`` read beside ``perf_counter_ns``, the trace's clock
    being Unix time. ``wall_ns`` is that wall-clock offset; a fitted
    offset is it where it lies in the range, else the range's middle.
    ``threads`` pairs a record's thread with the trace's ``tid``."""

    offset_ns: int
    base_ns: int
    method: str
    launch_records: int = 0
    fitted: int = 0
    slack_ns: int = 0
    wall_ns: int = 0
    threads: tuple = ()

    def tid(self, thread: int):
        """The trace's ``tid`` of a record's thread."""
        return dict(self.threads).get(thread, thread)

    def us(self, perf_ns: int) -> float:
        """``perf_ns`` on the trace's ``ts`` scale (µs)."""
        return (perf_ns + self.offset_ns - self.base_ns) / 1e3

    def seconds(self, perf_ns: int) -> float:
        """``perf_ns`` on the trace's ``ts`` scale, in seconds."""
        return (perf_ns + self.offset_ns - self.base_ns) / 1e9


# How far from the wall clock's offset the fit looks: the trace's clock is
# Unix time, read on another clock than time.time_ns().
_REACH_NS = 1_000_000


@functools.lru_cache(maxsize=1024)
def _identifiers(name: str) -> frozenset:
    return frozenset(_IDENT.findall(name))


def _union(ranges) -> list[list[int]]:
    merged = []
    for a, b in sorted(ranges):
        if a > b:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def clock_map(trace: dict, recs) -> ClockMap:
    """Map the records ``recs`` onto the clock of ``trace`` (a Chrome
    trace as ``torch.profiler`` exports it, parsed).

    Each launch record (:data:`LAUNCH_SPAN`) holds one runtime call that
    launches a kernel, on its thread; the trace shows those calls (its
    ``cuda_runtime`` or ``cuda_driver`` events whose ``correlation`` a
    ``kernel`` event shares). The offset, within :data:`_REACH_NS` of the
    wall-clock offset, is the one at which the most launch records hold
    the call of a kernel that carries their kernel's name (a kernel whose
    ``__global__`` name is its record's), then the most hold any such
    call, then the nearest the wall clock's. A trace with no such call,
    or no launch record near one, is mapped by the wall clock."""
    base = int(trace.get("baseTimeNanoseconds", 0))
    wall = _wall_offset_ns()
    events = [e for e in trace.get("traceEvents", ()) if e.get("ph") == "X" and "dur" in e]
    kernels = {(e.get("args") or {}).get("correlation"): e.get("name", "") for e in events if e.get("cat") == "kernel"}
    kernels.pop(None, None)
    calls = collections.defaultdict(list)  # thread -> [(start, end, kernel)] in trace ns
    for e in events:
        kernel = kernels.get((e.get("args") or {}).get("correlation"))
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and kernel is not None:
            start = base + round(float(e["ts"]) * 1e3)
            calls[e.get("tid")].append((start, start + round(float(e["dur"]) * 1e3), kernel))
    for c in calls.values():
        c.sort()
    first = min((c[0][0] for c in calls.values()), default=0) - _REACH_NS
    last = max((end for c in calls.values() for _, end, _ in c), default=0) + _REACH_NS
    launches = [r for r in recs if r.name.startswith(LAUNCH_SPAN) and r.end_ns is not None
                and first <= r.start_ns + wall <= last]
    threads = {t: t for t in {r.thread for r in launches} if t in calls}
    if not threads and len({r.thread for r in launches}) == 1 and len(calls) == 1:
        # A trace that records CUDA alone may number the launching thread
        # otherwise than the host does: one thread on each side is paired.
        threads = {launches[0].thread: next(iter(calls))}
    launches = [r for r in launches if r.thread in threads]
    # A record holds a call at offsets [call end - record end, call start -
    # record start]. Each record's ranges, merged and clipped to the reach,
    # open and close once a piece: (offset, 0 opens / 1 closes, by name).
    edges = []
    for r in launches:
        own, name = calls[threads[r.thread]], r.name[len(LAUNCH_SPAN):]
        i = bisect.bisect_left(own, (r.start_ns + wall - _REACH_NS,))
        j = bisect.bisect_right(own, (r.end_ns + wall + _REACH_NS,))
        held = [(max(e - r.end_ns, wall - _REACH_NS), min(s - r.start_ns, wall + _REACH_NS), name in _identifiers(k))
                for s, e, k in own[i:j]]
        for by_name in (False, True):
            for a, b in _union((a, b) for a, b, named in held if named or not by_name):
                edges += [(a, 0, by_name), (b, 1, by_name)]
    # The best range starts at an open and runs to the next edge.
    edges.sort()
    best, held, named = ((0, 0, 0), wall, wall), 0, 0
    for k, (at, closes, by_name) in enumerate(edges):
        step = -1 if closes else 1
        named, held = (named + step, held) if by_name else (named, held + step)
        if not closes:
            end = edges[k + 1][0]
            score = (named, held, -abs(at + end - 2 * wall))
            if score > best[0]:
                best = (score, at, end)
    (named, held, _), lo, hi = best
    if not held:
        return ClockMap(wall, base, "wall clock", len(launches), wall_ns=wall)
    return ClockMap(wall if lo <= wall <= hi else (lo + hi) // 2, base, "launches", len(launches), held, hi - lo, wall,
                    tuple(threads.items()))
