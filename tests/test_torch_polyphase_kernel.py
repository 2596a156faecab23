"""The polyphase decimator (``ops.polyphase``, ``csrc/polyphase.cu``).

On the CPU: the plain version against ``scipy.signal.lfilter`` followed
by ``[::f]`` and, bit for bit, against the framed cuDNN-style path that
``stream.polyphase_decimate`` ran before the kernel (inlined here); the
autograd Function's adjoint against ``torch.autograd`` through the plain
version; the domain checks on every device; the record and its launch
span; the launch geometry; and a numpy model of the kernel's walk
(16-byte chunks of the span, phase-major staging with its pad floats,
the register windows) against the plain version. Marked ``cuda``: the
kernel against the plain version on the card at the SDR chain's shapes
and ragged ones, one launch a call, no cuDNN convolution and no framing
under ``stream.polyphase.decimate``, and the gradients. Run on the card
with

    python -m pytest -m cuda tests/test_torch_polyphase_kernel.py
"""

import json
import pathlib
import re

import numpy as np
import pytest
import scipy.signal as sig
import torch
import torch.nn.functional as F

from chowdsp_fft_tpu_torch import models, stream
from chowdsp_fft_tpu_torch.ops import _cuda, autodiff, polyphase
from chowdsp_fft_tpu_torch.ops import hopper_fft as hf
from chowdsp_fft_tpu_torch.stream.ols import _frame_overlap
from chowdsp_fft_tpu_torch.utils import profiling, tracing

SOURCE = pathlib.Path(polyphase.__file__).resolve().parents[1] / "csrc" / "polyphase.cu"

# (rows, T, factor, taps): odd T, T not a multiple of f, taps > T, one
# row and a batch of rows, f = 1, the framed plain path (T > 2 * 4096),
# and the chain's two filters at small T.
CASES = [
    (1, 1001, 3, 21),
    (4, 999, 2, 64),
    (3, 1000, 7, 33),
    (2, 50, 4, 64),
    (1, 77, 5, 100),
    (5, 640, 1, 9),
    (2, 9001, 3, 48),
    (2, 16384, 2, 64),
    (8, 2048, 4, 64),
]


def rows(shape, seed, device="cpu"):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32)).to(device)


def taps(n, seed, device="cpu"):
    return rows((n,), seed, device) / np.sqrt(n)


def gap(got, want) -> float:
    """max |got - want| / rms(want)."""
    g, w = got.double(), want.double()
    return float((g - w).abs().max() / w.pow(2).mean().sqrt())


def framed_conv_reference(x, h, factor, block=4096):
    """``stream.polyphase_decimate``'s rows as they ran before the kernel:
    a strided ``conv1d`` on the zero-padded rows, or on overlapped
    frames above ``2 * block`` samples."""
    n = h.shape[-1]
    b, t = x.shape
    w = torch.flip(h, (-1,))[None, None, :]
    if t <= 2 * block:
        return F.conv1d(F.pad(x, (n - 1, 0))[:, None, :], w, stride=factor)[:, 0, : t // factor]
    blk = block - block % factor
    frames = _frame_overlap(x, blk, n - 1)
    y = F.conv1d(frames.reshape(b * frames.shape[-2], 1, -1), w, stride=factor)[:, 0]
    return y.reshape(b, -1)[..., : t // factor]


@pytest.mark.parametrize("b,t,f,n", CASES)
def test_plain_matches_lfilter_then_downsample(b, t, f, n):
    x, h = rows((b, t), t + f), taps(n, n)
    y = polyphase.decimate_plain(x, h, f)
    want = sig.lfilter(h.double().numpy(), [1.0], x.double().numpy(), axis=-1)[:, ::f][:, : t // f]
    assert y.shape == (b, t // f)
    np.testing.assert_allclose(y.numpy(), want, atol=2e-6 * np.sqrt(n), rtol=0)


@pytest.mark.parametrize("b,t,f,n", CASES)
@pytest.mark.parametrize("block", [256, 4096])
def test_cpu_path_is_bit_for_bit_the_framed_convolution(b, t, f, n, block):
    x, h = rows((b, t), 2 * t + f), taps(n, n + 1)
    want = framed_conv_reference(x, h, f, block)
    assert torch.equal(polyphase.decimate(x, h, f, block), want)
    assert torch.equal(stream.polyphase_decimate(x, h, f, block=block), want)
    one = framed_conv_reference(x[:1], h, f, block)[0]  # a row alone: the batch of 1 it ran as
    assert torch.equal(stream.polyphase_decimate(x[0], h, f, block=block), one)


@pytest.mark.parametrize("b,t,f,n", [(2, 999, 2, 64), (3, 1000, 4, 64), (1, 77, 5, 100), (2, 300, 3, 7)])
@pytest.mark.parametrize("wrt", ["both", "x", "h"])
def test_adjoint_matches_autograd_through_plain(b, t, f, n, wrt):
    x, h = rows((b, t), 7 * t).double(), taps(n, 3 * n).double()
    g = rows((b, t // f), 11).double()
    grads_of = {"both": (True, True), "x": (True, False), "h": (False, True)}[wrt]
    leaves = [v.clone().requires_grad_(r) for v, r in zip((x, h), grads_of)]
    ref_leaves = [v.clone().requires_grad_(r) for v, r in zip((x, h), grads_of)]
    out = autodiff.PolyphaseDecimate.apply(*leaves, f)
    ref = polyphase.decimate_plain(*ref_leaves, f)
    assert torch.equal(out, ref)
    (out * g).sum().backward()
    (ref * g).sum().backward()
    for a, r, need in zip(leaves, ref_leaves, grads_of):
        if need:
            torch.testing.assert_close(a.grad, r.grad, rtol=1e-12, atol=1e-12)
        else:
            assert a.grad is None


def test_adjoint_identity_in_float64():
    """<dec(x), g> = <x, dx(g)> and <dec_h(x), g> = <h, dh(g)>: the
    backward is the transpose of the forward in both inputs."""
    b, t, f, n = 3, 1003, 3, 40
    x, h, g = rows((b, t), 1).double(), taps(n, 2).double(), rows((b, t // f), 3).double()
    xl, hl = x.clone().requires_grad_(), h.clone().requires_grad_()
    (autodiff.PolyphaseDecimate.apply(xl, hl, f) * g).sum().backward()
    lhs = float((polyphase.decimate_plain(x, h, f) * g).sum())
    assert abs(lhs - float((x * xl.grad).sum())) <= 1e-10 * abs(lhs)
    assert abs(lhs - float((h * hl.grad).sum())) <= 1e-10 * abs(lhs)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("f,n", [(0, 8), (_cuda.MAX_DECIM_FACTOR + 1, 8), (2, 0), (2, _cuda.MAX_DECIM_TAPS + 1)])
def test_domain_checks_raise_on_any_device(device, f, n):
    x = torch.zeros(2, 4096, device=device)
    h = torch.zeros(n, device=device)
    with pytest.raises(ValueError, match="outside the kernel domain"):
        polyphase.decimate_kernel(x, h, f)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_kernel_wrapper_refuses_a_tensor_off_the_card(device):
    with pytest.raises(ValueError, match="CUDA tensors"):
        polyphase.decimate_kernel(torch.zeros(2, 4096, device=device), torch.zeros(64, device=device), 2)


def test_meta_tensors_give_shapes():
    y = stream.polyphase_decimate(torch.empty(256, 32768, device="meta"), torch.empty(64, device="meta"), 4)
    assert y.shape == (256, 8192) and y.device.type == "meta"


def test_records():
    assert polyphase.KERNELS == (polyphase.DECIMATE,)
    assert polyphase.DECIMATE not in hf.KERNELS
    assert polyphase.DECIMATE.name == "polyphase_decimate_kernel"
    assert polyphase.DECIMATE.source.endswith("csrc/polyphase.cu")
    assert polyphase.DECIMATE.span == "ops._cuda.launch.polyphase_decimate_kernel"
    assert polyphase.DECIMATE.span in tracing.SPANS


def _source_int(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+)", SOURCE.read_text()).group(1))


def test_geometry():
    assert polyphase.OUTPUTS_PER_THREAD == _source_int("kOut")
    assert max(polyphase.THREADS) == _source_int("kMaxThreads")
    assert polyphase.MAX_ROWS_PER_BLOCK == _source_int("kMaxRowsPerBlock")
    assert polyphase.SMEM_LIMIT == 48 * 1024
    # the chain's two filters take the largest block: the front end's two
    # planes of consecutive samples a row at a time in tiles of 1024, or
    # read from the interleaved capture (sample stride 2) two rows a block
    # in tiles of 512; the audio filter, channel-fastest (sample stride
    # 256), 8 channels a block in tiles of 128
    assert polyphase.decimate_geometry(2, 64) == (128, 1, 32, 4 * 2 * (32 + 1056 + 4 * 33))
    assert polyphase.decimate_geometry(2, 64, False, 2)[:3] == (128, 2, 32)
    assert polyphase.decimate_geometry(4, 64, False, 256)[:3] == (128, 8, 16)
    assert polyphase.decimate_geometry(4, 64, True, 256)[:3] == (128, 1, 16)
    # every factor of the domain fits its longest filter (the source's
    # static_assert), the block shrinking only where the spans would not
    for consecutive, rows in ((True, 1), (False, 1), (False, 3), (False, 1000)):
        for f in range(1, _cuda.MAX_DECIM_FACTOR + 1):
            for n in (1, 7, 64, 255, _cuda.MAX_DECIM_TAPS):
                threads, rb, q, smem = polyphase.decimate_geometry(f, n, consecutive, rows)
                assert smem <= polyphase.SMEM_LIMIT and q % 8 == 0 and q * f >= n
                assert rb == 1 if consecutive else rb <= min(8, 1 << (rows - 1).bit_length())
                # a block of twice the threads would not fit
                assert threads == 128 or 4 * f * (q + rb * padded(16 * threads // rb + q)) > polyphase.SMEM_LIMIT
    assert polyphase.decimate_geometry(16, 1024)[0] == 64


def padded(i):
    return i + 4 * (i // 32)


def kernel_model(x: np.ndarray, h: np.ndarray, f: int, strides: tuple[int, int], lead0: int = 0) -> np.ndarray:
    """The kernel's walk in numpy, block by block, for rows (B, T) that lie
    at ``strides`` (row, sample; ``lead0``: the data's offset in floats
    from a 16-byte boundary): the reversed, phase-major taps; the block's
    spans staged into phase-major rows with 4 pad floats after every 32,
    unwritten slots NaN, either as one dense run in 16-byte chunks (one
    row of consecutive samples, or rows interleaved sample by sample) or
    as items (rows, phase, index) with the index fastest, 4 rows a load
    where they lie next to each other; each thread's float4 windows (lo,
    hi) read as contiguous runs of 8; 8 outputs a thread."""
    b, t = x.shape
    n = h.shape[-1]
    rs, ss = strides
    threads, rb, q, _ = polyphase.decimate_geometry(f, n, ss == 1, b)
    row_threads = threads // rb
    tile, j_len = 8 * row_threads, q * f
    seg = tile + q
    stride, span = padded(seg), seg * f
    row_floats = f * stride
    assert stride % 4 == 0 and q % 8 == 0
    hp = np.zeros(f * q)
    for i in range(j_len):
        k = j_len - 1 - i
        hp[(i % f) * q + i // f] = h[k] if k < n else 0.0
    m_out = t // f
    y = np.zeros((b, m_out))
    base = 8 * np.arange(row_threads)
    assert all(padded(a) % 4 == 0 for a in base)
    dense = ss == rb and (rb == 1 or rs == 1) and b % rb == 0
    vec = 4 if rs == 1 and rb % 4 == 0 and ss % 4 == 0 and lead0 == 0 else 1

    def sample(row, nn):
        return x[row, nn] if row < b and 0 <= nn < t else 0.0

    for row0 in range(0, b, rb):
        for tile_i in range(-(-m_out // tile)):
            m0 = tile_i * tile
            n0 = m0 * f - (j_len - 1)
            s = np.full(rb * row_floats, np.nan)
            if dense:
                first, run = n0 * rb, span * rb
                lead = (lead0 + row0 * (rs if rb == 1 else 1) + first) % 4
                for c in range(-(-(run + lead) // 4)):
                    o = 4 * c - lead
                    r, i = o % rb, o // rb + 4 * f
                    p, k = i % f, i // f - 4
                    for e in range(4):
                        if 0 <= o + e < run:
                            g = first + o + e
                            s[r * row_floats + p * stride + padded(k)] = x[row0 + g % rb, g // rb] if 0 <= g < t * rb \
                                else 0.0
                        r += 1
                        if r == rb:
                            r, p = 0, p + 1
                            p, k = (0, k + 1) if p == f else (p, k)
            else:
                for it in range(rb // vec * f * seg):
                    k, pg = it % seg, it // seg
                    p, r = pg % f, pg // f * vec
                    for e in range(vec):
                        s[(r + e) * row_floats + p * stride + padded(k)] = sample(row0 + r + e, n0 + k * f + p)
            for r in range(min(rb, b - row0)):
                acc = np.zeros((row_threads, 8))
                for p in range(f):
                    sp = r * row_floats + p * stride
                    run_of = lambda at: s[sp + np.array([padded(a) for a in at])[:, None] + np.arange(8)]  # noqa: E731
                    lo = run_of(base)
                    for w in range(0, q, 8):
                        hi = run_of(base + w + 8)
                        win = np.concatenate([lo, hi], axis=1)
                        for u in range(8):
                            acc += hp[p * q + w + u] * win[:, u : u + 8]
                        lo = hi
                keep = min(tile, m_out - m0)
                y[row0 + r, m0 : m0 + keep] = acc.reshape(-1)[:keep]
    return y


# (rows, T, factor, taps, strides as a function of (rows, T), lead0)
WALKS = {
    "rows": [(2, 3001, 2, 64, 0), (1, 4099, 4, 64, 1), (2, 2500, 3, 21, 3), (1, 77, 5, 100, 2),
             (1, 5000, 16, 200, 1), (1, 3000, 1, 9, 0)],  # (16, 200): a 64-thread block
    "interleaved": [(2, 3001, 2, 64, 0), (2, 2001, 2, 64, 1), (4, 999, 3, 21, 2)],  # the I/Q capture
    "channels": [(16, 1000, 4, 64, 0), (12, 700, 4, 64, 0), (11, 1000, 4, 64, 0)],  # 12: a ragged group; 11: a float a time
    "strided": [(3, 700, 3, 21, 0), (1, 5000, 16, 200, 0)],
}
STRIDES = {"rows": lambda b, t: (t, 1), "interleaved": lambda b, t: (1, b), "channels": lambda b, t: (1, b),
           "strided": lambda b, t: (2 * t, 2)}


@pytest.mark.parametrize("layout,case", [(k, c) for k, cases in WALKS.items() for c in cases])
def test_kernel_walk_matches_plain(layout, case):
    b, t, f, n, lead0 = case
    x, h = rows((b, t), t), taps(n, n)
    got = kernel_model(x.double().numpy(), h.double().numpy(), f, STRIDES[layout](b, t), lead0)
    want = polyphase.decimate_plain(x.double(), h.double(), f).numpy()
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _on(dev, shape, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,f,n", [
    (2, 1 << 24, 2, 64),  # the front end
    (256, 32768, 4, 64),  # the audio filter
    *CASES,
    (3, 4099, 2, 64),  # rows off 16-byte boundaries
    (2, 10000, 16, 1024),  # the domain's corner: 64-thread blocks
    (1, 3, 4, 8),  # no whole output tile
])
def test_kernel_matches_plain(dev, b, t, f, n):
    x, h = _on(dev, (b, t), t + f), _on(dev, (n,), n) / n**0.5
    before = polyphase.DECIMATE.launches
    got = polyphase.decimate(x, h, f)
    torch.cuda.synchronize()
    assert polyphase.DECIMATE.launches == before + (1 if t // f else 0)
    want = polyphase.decimate_plain(x, h, f)
    assert got.shape == want.shape
    if want.numel():
        # float32 sums of the same taps in another order
        assert gap(got, want) <= 1e-5
        assert gap(torch.zeros_like(got), want) > 1e-5


@pytest.mark.cuda
def test_kernel_takes_a_view_at_any_float_offset(dev):
    x, h = _on(dev, (1, 20003), 1), _on(dev, (64,), 2) / 8
    for off in range(4):
        xv = x[:, off : off + 20000]
        assert xv.is_contiguous() and (xv.data_ptr() // 4) % 4 == off % 4
        assert gap(polyphase.decimate_kernel(xv, h, 2), polyphase.decimate_plain(xv, h, 2)) <= 1e-5


# Rows where they lie: (what, x of shape (rows, T) as a view, factor)
LAYOUTS = {
    "channel-fastest (the audio filter's input)": (lambda dev: _on(dev, (32768, 256), 8).T, 4),
    "the interleaved I/Q capture": (lambda dev: torch.view_as_real(torch.complex(
        _on(dev, (1 << 20,), 9), _on(dev, (1 << 20,), 10))).T, 2),
    "rows with a gap between them": (lambda dev: _on(dev, (5, 10001), 11)[:, 1:], 3),
    "every other sample of 3 rows": (lambda dev: _on(dev, (3, 20000), 12)[:, ::2], 2),
    "11 channel-fastest rows, the last group ragged": (lambda dev: _on(dev, (4099, 11), 13).T, 4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_kernel_reads_rows_where_they_lie(dev, layout):
    make, f = LAYOUTS[layout]
    x, h = make(dev), _on(dev, (64,), 14) / 8
    keep = x.clone()
    got = polyphase.decimate_kernel(x, h, f)
    assert got.is_contiguous() and torch.equal(x, keep)
    want = polyphase.decimate_plain(x.contiguous(), h, f)
    assert gap(got, want) <= 1e-5


@pytest.mark.cuda
def test_the_chain_runs_one_launch_a_decimator_and_no_cudnn(dev, tmp_path):
    chain = models.SDRChain(models.SDRChainConfig(), device=dev)
    iq = torch.complex(_on(dev, (1 << 20,), 3), _on(dev, (1 << 20,), 4))
    chain(iq)  # build and warm
    torch.cuda.synchronize()
    before = polyphase.DECIMATE.launches
    with profiling.trace(tmp_path / "tr") as log_dir:
        chain(iq)
    assert polyphase.DECIMATE.launches == before + 2
    [path] = list(pathlib.Path(log_dir).glob("trace_*.json"))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat", "").startswith("cuda_") and "correlation" in e.get("args", {})}
    decimate = [s for s in spans if s["name"] == "stream.polyphase.decimate"]
    assert len(decimate) == 2

    def inside(e, s):
        return s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"] and s.get("tid") == e.get("tid")

    assert not any(s["name"] == "stream.ols.frame" and any(inside(s, d) for d in decimate) for s in spans)
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    under = [e["name"] for e in device if any(inside(runtime[e["args"]["correlation"]], d) for d in decimate)]
    # the two kernels and nothing else: no cuDNN convolution, no framing copy
    assert len(under) == 2 and all("polyphase_decimate_kernel" in name for name in under), under


@pytest.mark.cuda
def test_gradients_on_the_card(dev):
    b, t, f, n = 4, 50000, 4, 64
    x, h, g = _on(dev, (b, t), 5), _on(dev, (n,), 6) / 8, _on(dev, (b, t // f), 7)
    xl, hl = x.clone().requires_grad_(), h.clone().requires_grad_()
    xr, hr = x.clone().requires_grad_(), h.clone().requires_grad_()
    before = polyphase.DECIMATE.launches
    out = stream.polyphase_decimate(xl, hl, f)
    assert polyphase.DECIMATE.launches == before + 1
    (out * g).sum().backward()
    with polyphase.fp32_convolutions():  # cuDNN's backward too
        ref = polyphase.decimate_plain(xr, hr, f)
        (ref * g).sum().backward()
    assert gap(out.detach(), ref.detach()) <= 1e-5
    assert gap(xl.grad, xr.grad) <= 1e-5
    assert gap(hl.grad, hr.grad) <= 1e-4  # sums of 50,000 products in another order
