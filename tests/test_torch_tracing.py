"""The port's spans (``utils/tracing.py``): none fires without a profiler;
under one, each layer boundary writes its span into the Chrome trace,
nested by containment, every name in ``tracing.SPANS``; the outputs are
the same either way. On the card (marked ``cuda``), each port kernel's
runtime call lies inside the launch span of its own kernel."""

import json
import pathlib
import re

import pytest
import torch

import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu_torch import api, models, stream
from chowdsp_fft_tpu_torch.ops import convolve, hopper_fft
from chowdsp_fft_tpu_torch.utils import profiling, tracing

CHANNELS, BLOCK, TAPS, T = 2, 256, 1000, 4096
P = -(-TAPS // BLOCK)


@pytest.fixture(scope="module")
def case():
    gen = torch.Generator().manual_seed(16)
    ir = torch.randn(CHANNELS, TAPS, generator=gen) / 32
    x = torch.randn(CHANNELS, T, generator=gen)
    conv = models.MultichannelConvolver(ir, models.ConvolverConfig(channels=CHANNELS, block=BLOCK), device="cpu")
    return conv, x


def _spans(log_dir) -> list[dict]:
    """The trace's record_function ranges, sorted by start."""
    [path] = list(pathlib.Path(log_dir).glob("trace_*.json"))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return sorted(spans, key=lambda e: (e["ts"], -e["dur"]))


def _idents(name: str) -> set[str]:
    return set(re.findall(r"[A-Za-z_][A-Za-z0-9_]*", name))


def _parent(spans: list[dict], child: dict) -> str | None:
    """The innermost other span that contains ``child``."""
    outer = [s for s in spans if s is not child and s["ts"] <= child["ts"]
             and child["ts"] + child["dur"] <= s["ts"] + s["dur"]]
    return min(outer, key=lambda s: s["dur"])["name"] if outer else None


def _traced(tmp_path, fn):
    with profiling.trace(tmp_path / "tr") as log_dir:
        out = fn()
    return out, _spans(log_dir)


def test_no_span_fires_without_a_profiler(case, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(tracing, "record_function", refuse)
    conv, x = case
    assert conv.apply(x).shape == (CHANNELS, T)
    spec_re, _ = api.rfft_packed_unordered(x)
    assert spec_re.shape == (CHANNELS, T // 2)


def test_the_offline_apply_nests_its_spans(case, tmp_path):
    conv, x = case
    _, spans = _traced(tmp_path, lambda: (conv.apply(x), api.rfft_packed_unordered(x)))
    names = [s["name"] for s in spans]
    assert set(names) <= set(tracing.SPANS)
    [apply] = [s for s in spans if s["name"] == "models.convolver.apply"]
    [offline] = [s for s in spans if s["name"] == "stream.ols.apply_offline"]
    assert _parent(spans, offline) == "models.convolver.apply" and _parent(spans, apply) is None
    inside = sorted(s["name"] for s in spans if _parent(spans, s) == "stream.ols.apply_offline")
    assert inside == sorted(["stream.ols.frame", "stream.ols.trim", "api.rfft_packed_unordered",
                             "api.irfft_packed_unordered", "ops.convolve.accumulate_partitioned"])
    assert "stream.ols.fdl_shift" not in names
    # the direct call's own span, outside the apply
    assert [_parent(spans, s) for s in spans if s["name"] == "api.rfft_packed_unordered"] == \
        ["stream.ols.apply_offline", None]


@pytest.mark.parametrize("chunk", [1, 3])
def test_the_streaming_forms_write_their_spans(case, tmp_path, chunk):
    conv, x = case
    h = conv.fir
    fir = stream.PartitionedFIR.from_spectra(h.h_re, h.h_im, BLOCK)
    nblocks = 6
    xs = x[..., : nblocks * BLOCK].reshape(CHANNELS, nblocks // chunk, chunk, BLOCK)

    def run():
        state = fir.init_state((CHANNELS,))
        for c in range(nblocks // chunk):
            state, _ = fir.step(state, xs[:, c, 0]) if chunk == 1 else fir.step_k(state, xs[:, c])

    _, spans = _traced(tmp_path, run)
    entry = "stream.ols.step" if chunk == 1 else "stream.ols.step_k"
    assert set(s["name"] for s in spans) <= set(tracing.SPANS)
    inside = [s["name"] for s in spans if _parent(spans, s) == entry]
    calls = nblocks // chunk
    assert sum(s["name"] == entry for s in spans) == calls
    assert inside.count("stream.ols.frame") == calls
    assert inside.count("ops.convolve.accumulate_packed") == calls * P
    assert inside.count("stream.ols.fdl_shift") == calls * (1 if chunk == 1 else 2)


def test_fir_filter_ols_writes_its_spans(tmp_path):
    gen = torch.Generator().manual_seed(3)
    x, h = torch.randn(2, 3000, generator=gen), torch.randn(33, generator=gen)
    y, spans = _traced(tmp_path, lambda: stream.fir_filter_ols(x, h))
    assert y.shape == (2, 3000) and set(s["name"] for s in spans) <= set(tracing.SPANS)
    inside = sorted(s["name"] for s in spans if _parent(spans, s) == "stream.ols.fir_filter_ols")
    assert inside == sorted(["api.rfft_packed_unordered", "stream.ols.frame", "api.rfft_packed_unordered",
                             "api.convolve_irfft_packed", "stream.ols.trim"])


def test_outputs_are_the_same_under_a_profiler(case, tmp_path):
    conv, x = case
    calls = (lambda: conv.apply(x), lambda: api.rfft_packed_unordered(x), lambda: ct.irfft_packed(*ct.rfft_packed(x)),
             lambda: stream.fir_filter_ols(x, conv.fir.h_re[0, 0, :64]))
    plain = [fn() for fn in calls]
    profiled, _ = _traced(tmp_path, lambda: [fn() for fn in calls])
    for a, b in zip(plain, profiled):
        for ta, tb in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(ta, tb)


def test_every_kernel_has_its_launch_span():
    launch_spans = {s for s in tracing.SPANS if s.startswith(tracing.LAUNCH_SPAN)}
    kernels = hopper_fft.KERNELS + convolve.KERNELS
    assert {k.span for k in kernels} == launch_spans
    assert all(k.span == tracing.LAUNCH_SPAN + k.name for k in kernels)
    assert len(set(tracing.SPANS)) == len(tracing.SPANS)
    public = {n for n in api.__all__ if callable(getattr(api, n))}
    assert {s[len("api."):] for s in tracing.SPANS if s.startswith("api.")} <= public


@pytest.mark.cuda
def test_port_kernels_launch_inside_their_spans(tmp_path):
    """On the card: each port kernel's runtime call (by ``correlation``)
    lies inside its kernel's launch span, on the trace's one clock, and
    there are as many launch spans as the counters rose."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    x = torch.randn(64, 4096, device="cuda")
    ct.irfft_packed(*ct.rfft_packed(x))  # build and warm
    torch.cuda.synchronize()
    before = {k.name: k.launches for k in hopper_fft.KERNELS}
    with profiling.trace(tmp_path / "tr"):
        ct.irfft_packed(*ct.rfft_packed(x))
        ct.irfft_packed_unordered(*ct.rfft_packed_unordered(x))
    rose = {k.name: k.launches - before[k.name] for k in hopper_fft.KERNELS if k.launches > before[k.name]}
    [path] = list((tmp_path / "tr").glob("trace_*.json"))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    launches = [e for e in events if e.get("cat") == "user_annotation"
                and e["name"].startswith(tracing.LAUNCH_SPAN)]
    assert sorted(e["name"] for e in launches) == sorted(
        tracing.LAUNCH_SPAN + name for name, n in rose.items() for _ in range(n))
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat", "").startswith("cuda_") and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel" and _idents(e["name"]) & set(rose)]
    assert len(kernels) == sum(rose.values())
    for k in kernels:
        call = runtime[k["args"]["correlation"]]
        around = [s for s in launches if s["ts"] <= call["ts"] and call["ts"] + call["dur"] <= s["ts"] + s["dur"]
                  and s.get("tid") == call.get("tid")]
        assert len(around) == 1, (k["name"], call)
        assert around[0]["name"][len(tracing.LAUNCH_SPAN):] in _idents(k["name"])
