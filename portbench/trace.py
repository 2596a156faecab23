"""A traced window: ``torch.profiler`` over a few calls, read back from
its Chrome trace.

The trace gives the device's operations (kernels, copies, fills) as
intervals, and the host's operations (aten ops, CUDA runtime calls, the
benchmark's own ``portbench.call`` spans) beside them. From these come
the device's busy time (the union of its intervals), each operation's
time by name, and the idle gaps with what the host did in each.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import pathlib
import re

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
NAME_CHARS = 96


@dataclasses.dataclass
class Op:
    name: str
    cat: str
    start: float  # seconds, the trace's clock
    dur: float


def read_chrome_trace(path: pathlib.Path) -> tuple[list[Op], list[Op]]:
    """(device ops, host ops) of a Chrome trace, sorted by start."""
    events = json.loads(path.read_text())["traceEvents"]
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        op = Op(e.get("name", ""), e.get("cat", ""), float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6)
        if op.cat in DEVICE_CATS:
            device.append(op)
        elif op.cat in HOST_CATS:
            host.append(op)
    device.sort(key=lambda o: o.start)
    host.sort(key=lambda o: o.start)
    return device, host


def busy_intervals(device: list[Op]) -> list[tuple[float, float]]:
    """The union of the device ops' intervals."""
    merged: list[list[float]] = []
    for op in device:
        end = op.start + op.dur
        if merged and op.start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([op.start, end])
    return [(a, b) for a, b in merged]


def is_port_kernel(name: str, port_names: frozenset[str]) -> bool:
    """Whether a device op is one of the port's own kernels: one of the
    identifiers of its (demangled) name is a ``__global__`` name listed
    under ``portbench/kernels/``."""
    return any(tok in port_names for tok in IDENT.findall(name))


def short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[: NAME_CHARS - 3] + "..."


def device_ops_by_name(device: list[Op], top: int = 10) -> list[list]:
    totals = collections.Counter()
    for op in device:
        totals[short(op.name)] += op.dur
    return [[name, secs] for name, secs in totals.most_common(top)]


def idle_gaps_by_host_op(device: list[Op], host: list[Op], top: int = 10) -> list[list]:
    """The idle gaps between the device's busy intervals, summed by the
    innermost host op that was running at each gap's middle."""
    busy = busy_intervals(device)
    totals = collections.Counter()
    active: list[Op] = []
    j = 0
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = 0.5 * (a + b)
        while j < len(host) and host[j].start <= mid:
            active.append(host[j])
            j += 1
        active = [op for op in active if op.start + op.dur >= mid]
        inner = min(active, key=lambda op: op.dur) if active else None
        totals[short(inner.name) if inner else "(no host op)"] += b - a
    return [[name, secs] for name, secs in totals.most_common(top)]


class Window:
    """``with Window(path, host_ops) as w: ...`` profiles the body (CUDA
    activity, and the host's ops with ``host_ops``), synchronises, and
    writes the Chrome trace to ``path``; after ``w.read()``, ``w.device``
    and ``w.host`` hold the ops."""

    def __init__(self, path: pathlib.Path, host_ops: bool):
        self.path = pathlib.Path(path)
        self.host_ops = host_ops
        self.device: list[Op] = []
        self.host: list[Op] = []

    def __enter__(self):
        # Without a card (a rehearsal on the CPU) there is no CUDA activity
        # to record, and the window records the host's ops alone.
        acts = [torch.profiler.ProfilerActivity.CUDA] if torch.cuda.is_available() else []
        if self.host_ops or not acts:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        if exc[0] is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.prof.export_chrome_trace(str(self.path))
        self.prof = None
        return False

    def read(self) -> None:
        self.device, self.host = read_chrome_trace(self.path)
