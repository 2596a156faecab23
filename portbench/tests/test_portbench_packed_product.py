"""``packed_product_kernel_device_ms`` on made-up host-ops windows of a
long-IR call: it reads the ops launched in the packed product's launch
span, and nothing where the program has no such span (the plain-torch
product of earlier commits); and its entry in ``BENCHMARK.json``."""

import json

import pytest

from portbench import harness
from portbench.tests.conftest import ROOT
from portbench.tests.test_portbench_spans import _readings, _write, _x, trace_dir  # noqa: F401

NAME = "packed_product_kernel_device_ms"
LAUNCH = "ops._cuda.launch.packed_product_kernel"


def _call_events(t, corr, kernel=True):
    """One ``fir_filter_ols`` call from ``t`` (us): a forward transform,
    the product (its kernel in its launch span, or three plain-torch
    elementwise ops in the product's span alone), an inverse transform."""
    ann = "user_annotation"
    events = [
        _x("portbench.call", ann, t, 1000),
        _x("stream.ols.fir_filter_ols", ann, t + 5, 900),
        _x("api.rfft_packed_unordered", ann, t + 10, 90),
        _x("cudaLaunchKernel", "cuda_runtime", t + 20, 5, corr=corr),
        _x("void (anonymous namespace)::rfft_col_passes_kernel<1>(float const*)", "kernel", t + 100, 80, tid=7,
           corr=corr),
        _x("ops.convolve.accumulate_packed", ann, t + 200, 200),
        _x("api.irfft_packed_unordered", ann, t + 500, 90),
        _x("cudaLaunchKernel", "cuda_runtime", t + 510, 5, corr=corr + 1),
        _x("void (anonymous namespace)::irfft_col_passes_kernel<1>(float const*)", "kernel", t + 600, 70, tid=7,
           corr=corr + 1),
    ]
    if kernel:
        events += [_x(LAUNCH, ann, t + 250, 40),
                   _x("cudaLaunchKernel", "cuda_runtime", t + 260, 10, corr=corr + 2),
                   _x("void (anonymous namespace)::packed_product_kernel<4>(float const*)", "kernel", t + 300, 230,
                      tid=7, corr=corr + 2)]
    else:
        for j in range(3):
            events += [_x("aten::mul", "cpu_op", t + 210 + 50 * j, 30),
                       _x("cudaLaunchKernel", "cuda_runtime", t + 220 + 50 * j, 5, corr=corr + 2 + j),
                       _x("void at::native::vectorized_elementwise_kernel<mul>()", "kernel", t + 300 + 100 * j, 90,
                          tid=7, corr=corr + 2 + j)]
    return events


def test_reads_the_kernels_launch_span(trace_dir):  # noqa: F811
    _write(trace_dir / "trace_cell.host.json", _call_events(0, 1) + _call_events(2000, 11))
    assert harness.metric_reader(NAME)(_readings(calls=2)) == pytest.approx(0.230)


@pytest.mark.parametrize("case", ["the plain-torch product", "no program span", "no window"])
def test_reads_nothing_without_the_span(trace_dir, case):  # noqa: F811
    """The parent's product (plain-torch ops, no launch span), a program
    without spans, or no host-ops window: ``None``."""
    events = _call_events(0, 1, kernel=case != "the plain-torch product")
    if case == "no program span":
        events = [e for e in events if e["cat"] != "user_annotation" or e["name"] == "portbench.call"]
    if case != "no window":
        _write(trace_dir / "trace_cell.host.json", events)
    assert harness.metric_reader(NAME)(_readings()) is None


def test_the_benchmark_lists_the_metric():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    [m] = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert m["workloads"] == ["longir64.offline"] and m["moves"] == "samples_per_s.convolve"
    assert m["source"] == "device_trace" and m["unit"] == "ms" and m["better"] == "lower"
    assert m["layer"].startswith("stream and convolve glue")
