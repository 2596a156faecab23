"""The port's spans (``utils/tracing.py``): none fires without a profiler;
under one, each layer boundary writes its span into the Chrome trace,
nested by containment, every name in ``tracing.SPANS``; the outputs are
the same either way. On the card (marked ``cuda``), each port kernel's
runtime call lies inside the launch span of its own kernel, and the
SDR chain's and the long-IR reverb's device ops lie in the spans their
benchmark metrics read."""

import json
import pathlib
import re

import pytest
import torch

import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu_torch import api, models, stream
from chowdsp_fft_tpu_torch.ops import convolve, demod, hopper_fft, polyphase
from chowdsp_fft_tpu_torch.utils import profiling, tracing

CHANNELS, BLOCK, TAPS, T = 2, 256, 1000, 4096
P = -(-TAPS // BLOCK)
SDR_CHANNELS, SDR_T = 16, 16384  # the front end frames its input above 2 x 4096 samples
LONGIR_T, LONGIR_TAPS = 48_000, 40_000  # fir_filter_ols's default block: N = 2^18, the real composite


@pytest.fixture(scope="module")
def case():
    gen = torch.Generator().manual_seed(16)
    ir = torch.randn(CHANNELS, TAPS, generator=gen) / 32
    x = torch.randn(CHANNELS, T, generator=gen)
    conv = models.MultichannelConvolver(ir, models.ConvolverConfig(channels=CHANNELS, block=BLOCK), device="cpu")
    return conv, x


@pytest.fixture(scope="module")
def sdr_case():
    gen = torch.Generator().manual_seed(5)
    iq = torch.complex(torch.randn(SDR_T, generator=gen), torch.randn(SDR_T, generator=gen))
    return models.SDRChain(models.SDRChainConfig(channels=SDR_CHANNELS), device="cpu"), iq


@pytest.fixture(scope="module")
def longir_case():
    gen = torch.Generator().manual_seed(22)
    x = torch.randn(CHANNELS, LONGIR_T, generator=gen)
    h = torch.randn(CHANNELS, LONGIR_TAPS, generator=gen) * torch.exp(-torch.linspace(0.0, 8.0, LONGIR_TAPS)) / 100
    return x, h


def _calls(model, case, sdr_case, longir_case):
    """The calls of each model's case: its entry, and a transform entry."""
    if model == "sdr":
        chain, iq = sdr_case
        return (lambda: chain(iq), lambda: api.ifft(iq.reshape(-1, SDR_CHANNELS)))
    if model == "longir":
        x, h = longir_case
        padded = torch.nn.functional.pad(h, (0, (1 << 18) - LONGIR_TAPS))
        return (lambda: stream.fir_filter_ols(x, h), lambda: api.irfft_packed(*api.rfft_packed(padded)))
    conv, x = case
    return (lambda: conv.apply(x), lambda: api.rfft_packed_unordered(x), lambda: ct.irfft_packed(*ct.rfft_packed(x)),
            lambda: stream.fir_filter_ols(x, conv.fir.h_re[0, 0, :64]))


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


@pytest.mark.parametrize("model", ["convolver", "sdr", "longir"])
def test_no_span_fires_without_a_profiler(case, sdr_case, longir_case, monkeypatch, model):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(tracing, "record_function", refuse)
    out = [fn() for fn in _calls(model, case, sdr_case, longir_case)]
    if model == "sdr":
        assert out[0].shape == (SDR_CHANNELS, SDR_T // (2 * SDR_CHANNELS * 4))
    elif model == "longir":
        assert out[0].shape == (CHANNELS, LONGIR_T)
        assert out[1].shape == (CHANNELS, 1 << 18)
    else:
        assert out[0].shape == (CHANNELS, T)
        spec_re, _ = out[1]
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


def test_fir_filter_ols_on_the_composite_writes_its_spans(longir_case, tmp_path):
    """Per-channel IRs at N = 2^18: the real composite's two functions in
    their spans inside the transform entries of ``stream.ols.fir_filter_ols``,
    each with its kernels' launch spans (none on the CPU) and no other
    span inside."""
    x, h = longir_case
    _, spans = _traced(tmp_path, lambda: stream.fir_filter_ols(x, h))
    assert {s["name"] for s in spans} <= set(tracing.SPANS)
    parents = sorted((s["name"], _parent(spans, s)) for s in spans)
    assert parents == sorted([
        ("stream.ols.fir_filter_ols", None),
        ("api.rfft_packed_unordered", "stream.ols.fir_filter_ols"),
        ("ops.hopper_composite.rfft_composite", "api.rfft_packed_unordered"),
        ("stream.ols.frame", "stream.ols.fir_filter_ols"),
        ("api.rfft_packed_unordered", "stream.ols.fir_filter_ols"),
        ("ops.hopper_composite.rfft_composite", "api.rfft_packed_unordered"),
        ("ops.convolve.accumulate_packed", "stream.ols.fir_filter_ols"),
        ("api.irfft_packed_unordered", "stream.ols.fir_filter_ols"),
        ("ops.hopper_composite.irfft_composite", "api.irfft_packed_unordered"),
        ("stream.ols.trim", "stream.ols.fir_filter_ols"),
    ])


@pytest.mark.parametrize("model", ["convolver", "sdr", "longir"])
def test_outputs_are_the_same_under_a_profiler(case, sdr_case, longir_case, tmp_path, model):
    calls = _calls(model, case, sdr_case, longir_case)
    plain = [fn() for fn in calls]
    profiled, _ = _traced(tmp_path, lambda: [fn() for fn in calls])
    for a, b in zip(plain, profiled):
        for ta, tb in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(ta, tb)


# The spans each SDR span metric reads (portbench/metrics/): every op a
# chain call launches lies innermost in one of them.
SDR_METRIC_SPANS = {
    "sdr_fir_device_ms": {"stream.polyphase.decimate", "stream.channelizer.branch_fir"},
    "sdr_layout_device_ms": {"stream.ols.frame", "stream.channelizer.commutate", "stream.channelizer.forward",
                             "models.sdr.front_end", "models.sdr.back_end", "models.sdr.forward"},
    "channel_fft_device_ms": {"api.ifft", "ops._cuda.launch.small_cfft_kernel"},
    "demod_device_ms": {"stream.demod.fm"},
    "decimate_kernel_device_ms": {"ops._cuda.launch.polyphase_decimate_kernel"},
    "demod_kernel_device_ms": {"ops._cuda.launch.fm_demod_kernel"},
}


def test_the_sdr_chain_nests_its_spans(sdr_case, tmp_path):
    """Each stage's span inside its parent's, as the chain calls them, and
    every op of the call innermost in a span that one of the six span
    metrics reads, each span in one metric alone."""
    from portbench.metrics import (channel_fft_device_ms, decimate_kernel_device_ms, demod_device_ms,
                                   demod_kernel_device_ms, sdr_fir_device_ms, sdr_layout_device_ms)

    readers = {"sdr_fir_device_ms": sdr_fir_device_ms, "sdr_layout_device_ms": sdr_layout_device_ms,
               "channel_fft_device_ms": channel_fft_device_ms, "demod_device_ms": demod_device_ms,
               "decimate_kernel_device_ms": decimate_kernel_device_ms,
               "demod_kernel_device_ms": demod_kernel_device_ms}
    assert {name: set(m.SPANS) for name, m in readers.items()} == SDR_METRIC_SPANS
    chain, iq = sdr_case
    with profiling.trace(tmp_path / "tr") as log_dir:
        chain(iq)
    [path] = list(pathlib.Path(log_dir).glob("trace_*.json"))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"), key=lambda e: (e["ts"], -e["dur"]))
    assert {s["name"] for s in spans} <= set(tracing.SPANS)
    parents = sorted((s["name"], _parent(spans, s)) for s in spans if s["name"] != "utils.tracing.import")
    assert parents == sorted([
        ("models.sdr.forward", None),
        ("models.sdr.front_end", "models.sdr.forward"),
        ("stream.polyphase.decimate", "models.sdr.front_end"),
        ("stream.ols.frame", "stream.polyphase.decimate"),
        ("stream.channelizer.forward", "models.sdr.forward"),
        ("stream.channelizer.commutate", "stream.channelizer.forward"),
        ("stream.channelizer.branch_fir", "stream.channelizer.forward"),
        ("api.ifft", "stream.channelizer.forward"),
        ("models.sdr.back_end", "models.sdr.forward"),
        ("stream.demod.fm", "models.sdr.back_end"),
        ("stream.polyphase.decimate", "models.sdr.back_end"),
    ])
    read = set().union(*SDR_METRIC_SPANS.values())
    assert sum(len(v) for v in SDR_METRIC_SPANS.values()) == len(read)
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert ops
    for op in ops:
        assert _parent(spans, op) in read, op["name"]


def test_every_kernel_has_its_launch_span():
    launch_spans = {s for s in tracing.SPANS if s.startswith(tracing.LAUNCH_SPAN)}
    kernels = hopper_fft.KERNELS + convolve.KERNELS + polyphase.KERNELS + demod.KERNELS
    assert {k.span for k in kernels} == launch_spans
    assert all(k.span == tracing.LAUNCH_SPAN + k.name for k in kernels)
    assert len(set(tracing.SPANS)) == len(tracing.SPANS)
    public = {n for n in api.__all__ if callable(getattr(api, n))}
    assert {s[len("api."):] for s in tracing.SPANS if s.startswith("api.")} <= public


@pytest.mark.cuda
def test_sdr_device_ops_have_their_spans(tmp_path):
    """On the card: every device op of a chain call at config 5's widths
    (C = 256) is launched, by ``correlation``, innermost in a span that
    one of the six SDR span metrics reads, the decimators' and the
    discriminator's in their kernels' launch spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    chain = models.SDRChain(models.SDRChainConfig(), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    iq = torch.complex(torch.randn(1 << 20, generator=gen, device="cuda"),
                       torch.randn(1 << 20, generator=gen, device="cuda"))
    chain(iq)  # build and warm
    torch.cuda.synchronize()
    with profiling.trace(tmp_path / "tr"):
        chain(iq)
    [path] = list((tmp_path / "tr").glob("trace_*.json"))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"), key=lambda e: (e["ts"], -e["dur"]))
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat", "").startswith("cuda_") and "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    assert any("small_cfft_kernel" in _idents(e["name"]) for e in device)
    assert sum("polyphase_decimate_kernel" in _idents(e["name"]) for e in device) == 2
    assert sum("fm_demod_kernel" in _idents(e["name"]) for e in device) == 1
    read = set().union(*SDR_METRIC_SPANS.values())
    for op in device:
        call = runtime[op["args"]["correlation"]]
        same_thread = [s for s in spans if s.get("tid") == call.get("tid")]
        assert _parent(same_thread, call) in read, op["name"]


@pytest.mark.cuda
def test_longir_device_ops_have_their_spans(tmp_path):
    """On the card, at the long-IR cell's widths (64 channels of 480,000
    samples by 96,000-tap IRs, N = 2^19): every device op of a
    ``fir_filter_ols`` call is launched, by ``correlation``, inside a
    program span, and the ops innermost in the spans that the composite's
    kernel and glue metrics read, the per-channel product (its kernel's
    launch span on the card), the framing,
    the trim and the entry's own (the IRs' zero pad) add up to the call's
    busy time within 0.05%."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    from portbench.metrics import composite_glue_device_ms, composite_kernel_device_ms, packed_product_kernel_device_ms

    read = {*composite_kernel_device_ms.SPANS, *composite_glue_device_ms.SPANS, "ops.convolve.accumulate_packed",
            *packed_product_kernel_device_ms.SPANS, "stream.ols.frame", "stream.ols.trim", "stream.ols.fir_filter_ols"}
    gen = torch.Generator(device="cuda").manual_seed(22)
    x = torch.randn(64, 480_000, generator=gen, device="cuda")
    h = torch.randn(64, 96_000, generator=gen, device="cuda") * torch.exp(
        -torch.linspace(0.0, 8.0, 96_000, device="cuda")) / 100
    stream.fir_filter_ols(x, h)  # build and warm
    torch.cuda.synchronize()
    with profiling.trace(tmp_path / "tr"):
        stream.fir_filter_ols(x, h)
    [path] = list((tmp_path / "tr").glob("trace_*.json"))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"), key=lambda e: (e["ts"], -e["dur"]))
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat", "").startswith("cuda_") and "correlation" in e.get("args", {})}
    device = sorted((e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                    key=lambda e: e["ts"])
    launched = {k: sum(k in _idents(e["name"]) for e in device)
                for k in ("rfft_col_passes_kernel", "column_passes_kernel", "irfft_col_passes_kernel", "cfft_kernel")}
    assert launched == {"rfft_col_passes_kernel": 2, "column_passes_kernel": 3, "irfft_col_passes_kernel": 1,
                        "cfft_kernel": 4}
    in_read = 0.0
    for op in device:
        call = runtime[op["args"]["correlation"]]
        owner = _parent([s for s in spans if s.get("tid") == call.get("tid")], call)
        assert owner is not None, op["name"]
        in_read += op["dur"] if owner in read else 0.0
    busy, end = 0.0, float("-inf")
    for op in device:  # the union of the ops' intervals
        a, b = max(op["ts"], end), op["ts"] + op["dur"]
        busy, end = busy + max(0.0, b - a), max(end, b)
    assert in_read == pytest.approx(busy, rel=5e-4)


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
