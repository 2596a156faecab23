"""The program's spans in the traced run's host-ops window.

The port wraps its layer boundaries in ``record_function`` ranges named
``<layer module>.<what>`` (``api.rfft_packed``, ``stream.ols.fdl_shift``,
``ops._cuda.launch.<kernel>``, ...), which the profiler records only with
host activity, so everything here reads the window that records both
(``trace_<cell>.host.json``, written just before the readers run). There
the device ops' durations are the device's own; the host's times run
slow under the profiler, so host times and idle read high.

Attribution: a device op belongs to the innermost program span that
encloses, on the same host thread, the runtime call sharing its
``correlation``. A port kernel whose runtime call the trace lacks is
paired, in order, with the ``ops._cuda.launch.*`` spans, when their
counts are equal. A call is one ``portbench.call`` span.

A window with no program span (a program without them) reads ``None``.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import functools
import json
import pathlib
import statistics
import sys

from . import trace

CALL = "portbench.call"
PROGRAM = ("api.", "models.", "ops.", "stream.")  # the port's layer modules
LAUNCH = "ops._cuda.launch."
API = "api."
RUNTIME_CATS = tuple(c for c in trace.HOST_CATS if c.startswith("cuda_"))  # the CUDA API calls

# The spans that hold the reverb's glue: the convolve-accumulate, the FDL
# shift, the framing and the trim.
GLUE = ("ops.convolve.accumulate_packed", "stream.ols.fdl_shift", "stream.ols.frame", "stream.ols.trim")


@dataclasses.dataclass
class Event(trace.Op):
    tid: object = None
    correlation: int | None = None

    @property
    def end(self) -> float:
        return self.start + self.dur


def is_program(name: str) -> bool:
    return name.startswith(PROGRAM)


def read_events(path: pathlib.Path) -> tuple[list[Event], list[Event]]:
    """(device ops, host ops) of a Chrome trace, with each event's host
    thread and ``correlation``, sorted by start."""
    device, host = [], []
    for e in json.loads(pathlib.Path(path).read_text())["traceEvents"]:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        corr = (e.get("args") or {}).get("correlation")
        ev = Event(e.get("name", ""), e.get("cat", ""), float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6,
                   e.get("tid"), int(corr) if corr is not None else None)
        if ev.cat in trace.DEVICE_CATS:
            device.append(ev)
        elif ev.cat in trace.HOST_CATS:
            host.append(ev)
    device.sort(key=lambda o: o.start)
    host.sort(key=lambda o: o.start)
    return device, host


class _Nest:
    """The program spans of one thread; the innermost one around an
    interval is the latest started that still holds it (spans of one
    thread nest)."""

    def __init__(self, spans: list[Event]):
        self.spans = sorted(spans, key=lambda s: (s.start, -s.dur))
        self.starts = [s.start for s in self.spans]

    def around(self, start: float, end: float) -> Event | None:
        for i in range(bisect.bisect_right(self.starts, start) - 1, -1, -1):
            if self.spans[i].end >= end:
                return self.spans[i]
        return None


def attribute(device: list[Event], host: list[Event], port_names: frozenset) -> tuple[list, dict]:
    """The innermost program span of each device op (``None`` where no
    span launched it), and how many port kernels were placed by
    ``correlation`` and by order."""
    spans = [h for h in host if h.cat == "user_annotation" and is_program(h.name)]
    nests = {tid: _Nest([s for s in spans if s.tid == tid]) for tid in {s.tid for s in spans}}
    runtime = {h.correlation: h for h in host if h.cat in RUNTIME_CATS and h.correlation is not None}
    owner = []
    for op in device:
        call = runtime.get(op.correlation) if op.correlation is not None else None
        nest = nests.get(call.tid) if call is not None else None
        owner.append(nest.around(call.start, call.end) if nest is not None else None)
    port = [i for i, op in enumerate(device) if op.cat == "kernel" and trace.is_port_kernel(op.name, port_names)]
    launches = sorted((s for s in spans if s.name.startswith(LAUNCH)), key=lambda s: s.start)
    by_order = 0
    if len(port) == len(launches):
        for i, span in zip(port, launches):
            if device[i].correlation not in runtime:
                owner[i], by_order = span, by_order + 1
    return owner, {"port_kernels": len(port), "by_correlation": sum(device[i].correlation in runtime for i in port),
                   "by_order": by_order}


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def _clip(spans: list[Event], a: float, b: float) -> list[tuple[float, float]]:
    """The union of the spans' intervals within [a, b]."""
    inside = [trace.Op("", "", max(s.start, a), min(s.end, b) - max(s.start, a))
              for s in spans if s.end > a and s.start < b]
    return trace.busy_intervals(sorted(inside, key=lambda o: o.start))


def _intersect(xs, ys) -> list[tuple[float, float]]:
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


class HostWindow:
    """The program's spans, the device ops each launched, and the idle
    gaps each held, in one host-ops window."""

    def __init__(self, device: list[Event], host: list[Event], port_names: frozenset):
        self.device = device
        self.calls = [h for h in host if h.cat == "user_annotation" and h.name == CALL]
        self.spans = [h for h in host if h.cat == "user_annotation" and is_program(h.name)]
        self.owner, self.placed = attribute(device, host, port_names)
        self.port_names = port_names

    def device_ms(self, names) -> float | None:
        """Device ms a call of the ops whose innermost span is one of
        ``names``."""
        if not self.device or not self.calls:
            return None
        names = set(names)
        return 1e3 * sum(op.dur for op, s in zip(self.device, self.owner) if s is not None and s.name in names) \
            / len(self.calls)

    def idle_by_span(self) -> dict[str | None, float]:
        """Seconds of the idle gaps between the device's busy intervals,
        by the innermost program span at each gap's middle (``None``:
        none)."""
        busy = trace.busy_intervals(self.device)
        nest, out = _Nest(self.spans), collections.Counter()
        for (_, a), (b, _) in zip(busy, busy[1:]):
            mid = 0.5 * (a + b)
            span = nest.around(mid, mid)
            out[span.name if span is not None else None] += b - a
        return out

    def idle_ms(self) -> float | None:
        if not self.device or not self.calls:
            return None
        return 1e3 * sum(s for name, s in self.idle_by_span().items() if name is not None) / len(self.calls)

    def host_ms(self, inside: str, outside: str | None = None) -> float | None:
        """Median over the calls of the host ms inside spans whose names
        start with ``inside`` and outside those that start with
        ``outside``; ``None`` where no span starts with ``inside``."""
        ins = [s for s in self.spans if s.name.startswith(inside)]
        outs = [s for s in self.spans if outside and s.name.startswith(outside)]
        if not ins or not self.calls:
            return None
        per_call = []
        for c in self.calls:
            a = _clip(ins, c.start, c.end)
            per_call.append(_length(a) - _length(_intersect(a, _clip(outs, c.start, c.end))))
        return 1e3 * statistics.median(per_call)

    def log_lines(self) -> list[str]:
        """Each program span's device ms and idle ms a call, and the
        checks of coverage."""
        n = len(self.calls)
        device, ops = collections.Counter(), collections.Counter()
        for op, s in zip(self.device, self.owner):
            device[s.name if s is not None else None] += op.dur
            ops[s.name if s is not None else None] += 1
        idle = self.idle_by_span()
        lines = [f"span {name or '(no program span)'}: device {1e3 * device[name] / n:.6f} ms a call, "
                 f"{ops[name] / n:g} ops a call; idle {1e3 * idle.get(name, 0.0) / n:.6f} ms a call"
                 for name in sorted(set(device) | set(idle), key=lambda k: -device[k])]
        glue = sum(op.dur for op in self.device if not trace.is_port_kernel(op.name, self.port_names))
        split = sum(device[k] for k in GLUE)
        if glue > 0:
            lines.append(f"spans: glue {1e3 * split / n:.6f} ms a call in {', '.join(GLUE)}, of "
                         f"{1e3 * glue / n:.6f} ms of non-port device ops a call ({100 * split / glue:.3f}%)")
        same = sum(1 for op, s in zip(self.device, self.owner)
                   if s is not None and s.name.startswith(LAUNCH) and s.name[len(LAUNCH):] in trace.IDENT.findall(op.name))
        lines.append(f"spans: {self.placed['port_kernels']} port-kernel events, {self.placed['by_correlation']} "
                     f"placed by correlation, {self.placed['by_order']} by order; {same} in the launch span of "
                     f"their own kernel")
        return lines


@functools.lru_cache(maxsize=1)
def _window(path: str, mtime_ns: int, size: int, calls: int, port_names: frozenset) -> HostWindow | None:
    """One host-ops window, read once for all its readers (the file's
    time and size in the key), with its spans logged to standard error."""
    device, host = read_events(pathlib.Path(path))
    w = HostWindow(device, host, port_names)
    if not w.spans or len(w.calls) != calls:
        return None
    for line in w.log_lines():
        print(line, file=sys.stderr, flush=True)
    return w


def host_window(r) -> HostWindow | None:
    """The traced run's host-ops window (the newest ``trace_*.host.json``
    under the harness's trace directory, holding ``r.calls`` calls), or
    ``None`` where there is none or it holds no program span."""
    from . import harness

    paths = sorted(pathlib.Path(harness.TRACE_DIR).glob("trace_*.host.json"), key=lambda p: p.stat().st_mtime_ns)
    if not paths:
        return None
    stat = paths[-1].stat()
    return _window(str(paths[-1]), stat.st_mtime_ns, stat.st_size, r.calls, r.port_kernels)
