"""The generic runner of one cell: set-up, warm-up, the measured or the
traced window, the comparison that decides ``correct``, and the result.

Nothing here is particular to a cell. The cell's entry in
``BENCHMARK.json`` names its configuration (``configs/<config>.json``)
and its traffic mix (``traffic/<mix>.json``); the configuration names its
system (``systems/<system>.py``), the mix the entry the calls drive; each
per-layer metric is read by ``metrics/<name>.py``, or else by the file
named by the part of its name before the first dot; the port's kernel
names are the lines of ``kernels/*.txt``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import pathlib
import subprocess
import time
from contextlib import nullcontext

import torch
from chowdsp_fft_tpu_torch.ops import hopper_fft

from . import roofline, trace, traffic

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
TRACE_DIR = ROOT / "build" / "portbench"
clock = time.perf_counter


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(entries: list[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}")


def load_json(kind: str, name: str) -> dict:
    """``portbench/<kind>/<name>.json``."""
    return json.loads((HERE / kind / f"{name}.json").read_text())


def system_entry(config: dict, mix: dict):
    module = importlib.import_module(f"{__package__}.systems.{config['system']}")
    return module.ENTRIES[mix["entry"]]


def metric_reader(name: str):
    """``read(readings)`` of ``metrics/<name>.py``, else of the file named
    by the part of ``name`` before its first dot."""
    for stem in (name, name.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"{__package__}.metrics.{stem.replace('.', '_')}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module.read
    raise FileNotFoundError(f"no reader for metric {name!r} under {HERE / 'metrics'}")


def port_kernel_names() -> frozenset[str]:
    """The ``__global__`` names of the port's kernels, one family a file."""
    names = set()
    for path in sorted((HERE / "kernels").glob("*.txt")):
        names.update(line.strip() for line in path.read_text().splitlines() if line.strip())
    return frozenset(names)


def for_cell(metrics: list[dict], cell: str) -> list[dict]:
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


@dataclasses.dataclass
class Readings:
    """What a traced run measured, for the per-layer metric readers."""

    calls: int  # calls in the profiled window
    window_s: float  # the profiled window, host clock, ending in a synchronise
    busy_s: float  # union of the device's op intervals in the window
    device: list  # trace.Op of every device op (kernels, copies, fills)
    port_kernels: frozenset
    enqueue_s: list  # host seconds of calls made just after a synchronise
    work: dict  # roofline name -> (bytes, operations) of one call

    def is_port(self, name: str) -> bool:
        return trace.is_port_kernel(name, self.port_kernels)


def launch_counts() -> dict[str, int]:
    """The port's kernel launch counters (``ops/hopper_fft.KERNELS``)."""
    return {k.name: k.launches for k in hopper_fft.KERNELS}


def _sync(device):
    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


class Calls:
    """Numbers the calls of one run in order and offers each call's
    outputs to the plan's sample. ``enqueue_s`` is the host time of the
    last call's entry, from entering it to its return."""

    def __init__(self, call, plan: traffic.Plan, sync):
        self.call, self.plan, self.sync = call, plan, sync
        self.next, self.enqueue_s = 0, 0.0

    def __call__(self, offer: bool = True):
        a = clock()
        out = self.call(self.next)
        self.enqueue_s = clock() - a
        if offer:
            self.plan.offer(self.next, out)
        self.next += 1
        return out


def _warm_up(calls: Calls, mix: dict) -> dict[str, int]:
    """Every shape the window uses, holding as many outputs as the window
    does (the kept sample and the last call's), so that the window
    allocates nothing new. Returns the port's launches in it."""
    before, held, keep = launch_counts(), [], int(mix["kept"]) + 1
    for _ in range(max(int(mix["warmup_calls"]), keep + 1)):
        held = (held + [calls(offer=False)])[-keep:]
    calls.sync()
    return {k: n - before[k] for k, n in launch_counts().items()}


def _measure(calls: Calls, seconds: float, samples_per_call: int, log) -> dict:
    """The measured window: calls back to back until ``seconds`` have
    passed, then a synchronise. Returns the end-to-end values it
    measures."""
    count, marks = 0, []
    t0 = clock()
    while True:
        calls()
        count += 1
        elapsed = clock() - t0
        if elapsed >= len(marks) + 1:
            marks.append(count)
        if elapsed >= seconds:
            break
    calls.sync()
    window = clock() - t0
    log(f"window {window:.4f} s, {count} calls; calls in each second: "
        f"{[b - a for a, b in zip([0] + marks, marks)]}")
    return {"samples_per_s": count * samples_per_call / window}


def _profile(calls: Calls, name: str, n: int, host_ops: bool):
    """One profiled window of ``n`` calls: the window, its host-clock
    length and the counters' launches in it."""
    before = launch_counts()
    w = trace.Window(TRACE_DIR / f"trace_{name}{'.host' if host_ops else ''}.json", host_ops)
    with w:
        t0 = clock()
        for _ in range(n):
            with torch.profiler.record_function("portbench.call") if host_ops else nullcontext():
                calls()
        calls.sync()
        seconds = clock() - t0
    return w, seconds, sum(launch_counts().values()) - sum(before.values())


def _lost(w: trace.Window, launched: int, port_names: frozenset, log) -> int:
    """Port-kernel launches the window's trace lacks."""
    w.read()
    seen = sum(trace.is_port_kernel(op.name, port_names) for op in w.device if op.cat == "kernel")
    log(f"port kernels in {w.path.name}: {launched} launched by the counters, {seen} in the trace")
    return launched - seen


PROFILE_TRIES = 3


def _device_window(calls: Calls, name: str, n: int, first, port_names: frozenset, log):
    """The first device-only window whose port-kernel events equal the
    counters' launches (the profiler has been seen to drop events), out
    of ``first`` and up to ``PROFILE_TRIES - 1`` windows profiled anew;
    with none, the run fails. Returns the window and its seconds."""
    w, window, launched = first
    for attempt in range(1, PROFILE_TRIES + 1):
        lost = _lost(w, launched, port_names, log)
        if not lost:
            return w, window
        log(f"the profiler lost {lost} port-kernel events in device window {attempt} of {PROFILE_TRIES}")
        if attempt < PROFILE_TRIES:
            w, window, launched = _profile(calls, name, n, False)
    raise RuntimeError(f"the profiler lost port-kernel events in {PROFILE_TRIES} device windows running")


def _traced(calls: Calls, name: str, mix: dict, entry, per_layer: list[dict], log):
    """Two profiled windows of the same calls, then the enqueue probe; the
    per-layer values, the device's busy and window seconds, the
    breakdown. The device's ops come from a window that records CUDA
    activity alone: the CPU-side profiler slows the host and would
    inflate the idle share. The host op that each idle gap fell in comes
    from a window that records both."""
    n, port_names = int(mix["trace_calls"]), port_kernel_names()
    device_window, host_window = _profile(calls, name, n, False), _profile(calls, name, n, True)
    gc.collect()
    # The enqueue probe runs before the traces are parsed: the parsed ops
    # would slow the host's allocator and collector.
    enqueue = []
    for _ in range(int(mix["enqueue_calls"])):
        calls.sync()
        calls()
        enqueue.append(calls.enqueue_s)
    calls.sync()
    w, window = _device_window(calls, name, n, device_window, port_names, log)
    host_w, host_seconds, host_launched = host_window
    if _lost(host_w, host_launched, port_names, log):
        log("the host-ops window lost port-kernel events: its idle gaps are read as they are")
    log(f"profiled windows: {window:.6f} s device only, {host_seconds:.6f} s with host ops, {n} calls each")
    busy = sum(b - a for a, b in trace.busy_intervals(w.device))
    readings = Readings(n, window, busy, w.device, port_names, enqueue, entry.work())
    values = {m["name"]: metric_reader(m["name"])(readings) for m in per_layer}
    breakdown = {"device_ops": trace.device_ops_by_name(w.device),
                 "idle_gaps": trace.idle_gaps_by_host_op(host_w.device, host_w.host)}
    for key, rows in breakdown.items():
        for row_name, secs in rows:
            log(f"{key}: {secs:.6e} s  {row_name}")
    return values, {"busy_s": busy, "window_s": window}, breakdown


def run_cell(name: str, *, seed: int, seconds: float, trace_on: bool, device="cuda", control: bool = False,
             t_start: float | None = None, log=print) -> tuple[dict, list[str]]:
    """Run cell ``name`` once. Returns the result object and the lines
    that give each compared number beside its limit. ``control`` puts the
    float64 reference fed TF32 inputs in the program's place."""
    t_start = clock() if t_start is None else t_start
    bench = load_benchmark()
    cell = find(bench["workloads"], name, "workload")
    config, mix = load_json("configs", cell["config"]), load_json("traffic", cell["traffic"])
    on_card = torch.device(device).type == "cuda"
    plan = traffic.Plan(mix, seed)
    log(f"set-up: {clock() - t_start:.3f} s to the harness")
    entry = system_entry(config, mix)(config, plan, seed, device)
    log(f"set-up: {clock() - t_start:.3f} s to the inputs and the program")
    for label, secs in getattr(entry, "setup_marks", []):
        log(f"set-up: {secs:.3f} s for {label}")
    calls = Calls(entry.control if control else entry.call, plan, _sync(device))
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    rose = _warm_up(calls, mix)
    if on_card and not control:
        idle = [k for k in config["kernels"] if rose.get(k, 0) <= 0]
        if idle:
            raise RuntimeError(f"the port's kernels {idle} did not launch in the warm-up: {rose}")
    probe = clock()
    sum(range(1_000_000))
    probe = clock() - probe
    log(f"set-up: {clock() - t_start:.3f} s to the end of the warm-up; its launches of the port's kernels: "
        f"{ {k: n for k, n in rose.items() if n} }; a fixed Python loop took {1e3 * probe:.3f} ms")

    setup_s = clock() - t_start
    first = calls.next
    extra, breakdown = {}, None
    if trace_on:
        values, extra, breakdown = _traced(calls, name, mix, entry, for_cell(bench["per_layer"], name), log)
        if on_card and hasattr(entry, "yardstick"):
            log(entry.yardstick())
    else:
        values = _measure(calls, seconds, entry.samples_per_call, log)
        values["setup_s"] = setup_s
        log(f"set-up {setup_s:.4f} s")
    attempted = calls.next - first

    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kept = dict(plan.kept)
    plan.kept.clear()
    entry.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        log(f"card: {_card()} (roofline peaks assume {roofline.POWER_W:.0f} W)")
    gaps = entry.check(kept)
    checks, failed_calls = {}, set()
    for number, by_call in gaps.items():
        limit = float(config["limits"][number])
        checks[number] = {"value": max(by_call.values()), "limit": limit}
        failed_calls.update(c for c, v in by_call.items() if not v <= limit)
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for m in for_cell(bench["per_layer"] if trace_on else bench["end_to_end"], name):
        # An end-to-end metric is the window's quantity that its name, or
        # the part of it before the first dot, names (``samples_per_s.fft``).
        key = next((k for k in (m["name"], m["name"].split(".")[0]) if k in values), None)
        if key is None:
            raise KeyError(f"cell {name} reports {m['name']}, which its run does not measure")
        if values[key] is not None:
            metrics[m["name"]] = {"value": values[key], "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name() if on_card else "cpu",
                   "count": int(cell["chips"]), "memory_peak_bytes": int(peak), **extra}
    result = {"correct": correct, "attempted": attempted, "failed": len(failed_calls), "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    lines = [f"check {k}: {c['value']!r} (limit {c['limit']!r}, over {len(gaps[k])} calls)"
             for k, c in checks.items()]
    return result, lines
