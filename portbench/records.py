"""The port's own record of its spans (``utils/tracing.py``), read on the
traced run's device-only window.

The port appends a record of every span that fires in either profiled
window. Here the records are put on the clock of the device-only
window's trace (the newest ``trace_*.json`` that is not a ``.host.json``)
by ``tracing.clock_map``, and the records of that window's calls are read
against the device's busy intervals there. That window records no host
op, so the records' times are the program's own, with the record's cost.

A call is one outermost record (``call`` is its own index). A window
reads ``None`` where the port keeps no record (a commit before it), where
the ring dropped a record of the window, where the window's outermost
records are not one a call, or where the trace holds no device op (a
rehearsal on the CPU).
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

from . import spans, trace


def _tracing():
    """The port's tracing module where it keeps the record, else ``None``."""
    from chowdsp_fft_tpu_torch.utils import tracing

    return tracing if hasattr(tracing, "clock_map") else None


@dataclasses.dataclass
class Placed:
    """A record on the trace's clock (seconds, as ``trace.Op.start``)."""

    record: object  # tracing.Record
    start: float
    end: float

    @property
    def name(self) -> str:
        return self.record.name


def _extent(path: pathlib.Path) -> tuple[dict, float, float]:
    """A trace, parsed, and the first start and last end (seconds) of its
    host and device events."""
    raw = json.loads(pathlib.Path(path).read_text())
    times = [(float(e["ts"]) * 1e-6, (float(e["ts"]) + float(e["dur"])) * 1e-6) for e in raw["traceEvents"]
             if e.get("ph") == "X" and "dur" in e and e.get("cat") in trace.HOST_CATS + trace.DEVICE_CATS]
    return raw, min((a for a, _ in times), default=0.0), max((b for _, b in times), default=0.0)


def place(recs, cmap, lo: float, hi: float) -> list[Placed]:
    """The records of the calls whose outermost record meets [lo, hi] on
    the trace's clock, mapped by ``cmap``, by start."""
    placed = [Placed(r, cmap.seconds(r.start_ns), cmap.seconds(r.end_ns)) for r in recs]
    calls = {p.record.index for p in placed if p.record.call == p.record.index and p.end >= lo and p.start <= hi}
    return sorted((p for p in placed if p.record.call in calls), key=lambda p: (p.start, p.record.index))


class RecordWindow:
    """The records of the device-only window's calls, with the device's
    busy intervals and idle gaps there."""

    def __init__(self, placed: list[Placed], device: list, cmap):
        self.records = placed
        self.calls = [p for p in placed if p.record.call == p.record.index]
        self.cmap = cmap
        self.busy = trace.busy_intervals(device)
        self.gaps = [(a, b) for (_, a), (b, _) in zip(self.busy, self.busy[1:])]
        self._of_call = collections.defaultdict(list)
        for p in placed:
            self._of_call[p.record.call].append(p)
        self._starts = [c.start for c in self.calls]
        tracing = _tracing()
        self._self_ns = tracing.self_ns([p.record for p in placed])

    def innermost(self, t: float) -> Placed | None:
        """The innermost record around ``t`` (the records of one call nest)."""
        i = bisect.bisect_right(self._starts, t) - 1
        if i < 0 or self.calls[i].end < t:
            return None
        around = [p for p in self._of_call[self.calls[i].record.index] if p.start <= t <= p.end]
        return max(around, key=lambda p: (p.start, p.record.index))

    def idle_by_record(self) -> collections.Counter:
        """Seconds of the gaps between busy intervals, by the innermost
        record at each gap's middle (``None``: none)."""
        out = collections.Counter()
        for a, b in self.gaps:
            p = self.innermost(0.5 * (a + b))
            out[p.name if p is not None else None] += b - a
        return out

    def idle_ms(self) -> float:
        """Idle ms a call of the gaps whose middle lies in a record."""
        return 1e3 * sum(s for name, s in self.idle_by_record().items() if name is not None) / len(self.calls)

    def host_ms(self) -> float:
        """The median over the calls of the outermost record's ms."""
        return 1e3 * statistics.median(c.end - c.start for c in self.calls)

    def self_ms(self, names) -> float | None:
        """Self ms a call of the records named in ``names`` (``None``
        where there is none)."""
        mine = [p for p in self.records if p.name in names]
        if not mine:
            return None
        return 1e-6 * sum(self._self_ns[p.record.index] for p in mine) / len(self.calls)

    def log_lines(self, window_s: float, busy_s: float) -> list[str]:
        """Each record name's host self ms and idle ms a call, and where
        the window's idle went."""
        n, host = len(self.calls), collections.Counter()
        for p in self.records:
            host[p.name] += self._self_ns[p.record.index] * 1e-9
        idle = self.idle_by_record()
        # The wait from the first record to the window's first busy interval
        # is no gap between busy intervals, so no span_idle_ms; the log puts
        # it down to the record at its middle, so that the records and what
        # lies outside them account for the window's whole idle.
        head = max(0.0, self.busy[0][0] - self.calls[0].start) if self.busy else 0.0
        if head:
            p = self.innermost(self.calls[0].start + 0.5 * head)
            idle[p.name if p is not None else None] += head
        lines = [f"record {name}: host self {1e3 * host[name] / n:.6f} ms a call; "
                 f"idle {1e3 * idle.get(name, 0.0) / n:.6f} ms a call" for name in sorted(host, key=lambda k: -host[k])]
        inside, outside = sum(s for k, s in idle.items() if k is not None), idle.get(None, 0.0)
        total = window_s - busy_s
        lines.append(f"records: idle {1e3 * inside / n:.6f} ms a call in records ({1e3 * head / n:.6f} of it from the "
                     f"first record to the first busy interval), {1e3 * outside / n:.6f} between busy intervals outside "
                     f"any record, {1e3 * (total - inside - outside) / n:.6f} before the first record or after the last "
                     f"busy interval (host clock); the window's idle (window_s - busy_s) {1e3 * total / n:.6f}")
        c = self.cmap
        lines.append(f"records: clock map by {c.method}: offset {c.offset_ns - c.wall_ns} ns from the wall clock's, "
                     f"{c.fitted} of {c.launch_records} launch records hold a kernel's runtime call, slack "
                     f"{c.slack_ns} ns; {n} calls, {len(self.records)} records")
        return lines


def launch_checks(w: RecordWindow, device: list, host: list, port_names: frozenset) -> str:
    """How many of the device-only trace's port-kernel runtime calls lie
    inside a mapped launch record of their thread, and how many device ops
    start before the launch record around their runtime call."""
    runtime = {h.correlation: h for h in host if h.cat in spans.RUNTIME_CATS and h.correlation is not None}
    launches = [p for p in w.records if p.name.startswith(spans.LAUNCH)]
    port = {id(op) for op in device if op.cat == "kernel" and trace.is_port_kernel(op.name, port_names)}
    inside = early = 0
    for op in device:
        call = runtime.get(op.correlation)
        if call is None:
            continue
        owner = [p for p in launches
                 if w.cmap.tid(p.record.thread) == call.tid and p.start <= call.start and call.end <= p.end]
        inside += bool(owner) and id(op) in port
        early += any(op.start < p.start for p in owner)
    return (f"records: {inside} of {len(port)} port-kernel runtime calls inside a launch record, "
            f"{len(launches)} launch records; {early} device ops start before their launch record")


def host_residual(recs, path: pathlib.Path) -> str | None:
    """|mapped record start - ``user_annotation`` start| in the host-ops
    window, each span's records and annotations paired in order."""
    tracing = _tracing()
    raw, lo, hi = _extent(path)
    cmap = tracing.clock_map(raw, recs)
    placed = place(recs, cmap, lo, hi)
    ann = collections.defaultdict(list)
    for e in raw["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and spans.is_program(e.get("name", "")):
            ann[e["name"]].append(float(e["ts"]) * 1e-6)
    mine = collections.defaultdict(list)
    for p in placed:
        mine[p.name].append(p.start)
    diffs = [abs(a - b) for name in ann if len(ann[name]) == len(mine[name])
             for a, b in zip(sorted(ann[name]), mine[name])]
    if not diffs:
        return None
    return (f"records: host-ops window, clock map by {cmap.method}: |record start - annotation start| median "
            f"{1e6 * statistics.median(diffs):.3f} us, max {1e6 * max(diffs):.3f} us over {len(diffs)} spans "
            f"({sum(map(len, ann.values()))} annotations, {len(placed)} records)")


@functools.lru_cache(maxsize=1)
def _window(path: str, mtime_ns: int, size: int, calls: int, window_s: float, busy_s: float,
            port_names: frozenset) -> RecordWindow | None:
    """One device-only window's records, read once for all its readers
    (the file's time and size in the key), logged to standard error."""
    tracing = _tracing()
    if tracing is None:
        return None
    recs = tracing.records()
    raw, lo, hi = _extent(pathlib.Path(path))
    cmap = tracing.clock_map(raw, recs)
    placed = place(recs, cmap, lo, hi)
    gone = tracing.dropped()
    calls_seen = sum(p.record.call == p.record.index for p in placed)
    if any(p.record.call < gone for p in placed) or (gone and recs and cmap.seconds(recs[0].start_ns) >= lo):
        print(f"records: the ring dropped records of the window ({gone} dropped)", file=sys.stderr, flush=True)
        return None
    if calls_seen != calls:
        print(f"records: {calls_seen} outermost records in the window, against {calls} calls", file=sys.stderr,
              flush=True)
        return None
    device, host = spans.read_events(pathlib.Path(path))
    if not device:
        return None
    w = RecordWindow(placed, device, cmap)
    lines = w.log_lines(window_s, busy_s) + [launch_checks(w, device, host, port_names)]
    hosts = sorted(pathlib.Path(path).parent.glob("trace_*.host.json"), key=lambda p: p.stat().st_mtime_ns)
    if hosts:
        lines.append(host_residual(recs, hosts[-1]) or "records: no span pairs in the host-ops window")
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    return w


def window(r) -> RecordWindow | None:
    """The records of the traced run's device-only window (the newest
    ``trace_*.json`` under the harness's trace directory that is not a
    ``.host.json``), or ``None``."""
    from . import harness

    paths = sorted((p for p in pathlib.Path(harness.TRACE_DIR).glob("trace_*.json")
                    if not p.name.endswith(".host.json")), key=lambda p: p.stat().st_mtime_ns)
    if not paths:
        return None
    stat = paths[-1].stat()
    return _window(str(paths[-1]), stat.st_mtime_ns, stat.st_size, r.calls, r.window_s, r.busy_s, r.port_kernels)
