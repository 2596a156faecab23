"""The FM discriminator (``ops.demod``, ``csrc/demod.cu``).

On the CPU: ``stream.fm_demod`` bit for bit the torch ops it ran before
the kernel (inlined here), on every layout; the routing (the plain ops on
the CPU, ``autodiff.FMDemod`` only where a CUDA input needs grad); the
Function's backward against ``torch.autograd`` through the plain version;
the kernel wrapper's refusals on every device; the record and its launch
span; the layout rule and the folding of leading dimensions; and a numpy
model of the kernel's walk (the rows-fast runs with their carried
predecessor, the time-fast warp segments with their shuffles) against the
plain version. Marked ``cuda``: the kernel against the plain version on
the card at the chain's layout and others, gains 1 and 1/kf, branch-cut
noise; one launch and no other op under ``stream.demod.fm``; the
gradients. Run on the card with

    python -m pytest -m cuda tests/test_torch_demod_kernel.py

The plain version's sample 0 is atan2 of signed zeros (0 or +-gain*pi);
the kernel writes 0 there, so the two are compared from sample 1.
"""

import json
import pathlib
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chowdsp_fft_tpu_torch import models, stream
from chowdsp_fft_tpu_torch.ops import _cuda, autodiff, demod
from chowdsp_fft_tpu_torch.ops import hopper_fft as hf
from chowdsp_fft_tpu_torch.utils import profiling, tracing

SOURCE = pathlib.Path(demod.__file__).resolve().parents[1] / "csrc" / "demod.cu"
KF = 2 * np.pi * 75e3 / 200e3  # a broadcast FM deviation at the chain's channel rate
GAINS = [1.0, 1.0 / KF]
GAP = 5e-7  # times max(1, |gain|): 2 ulp of pi


def noise(shape, seed, dtype=torch.complex64, device="cpu"):
    g = np.random.default_rng(seed)
    z = g.standard_normal(shape) + 1j * g.standard_normal(shape)
    return torch.from_numpy(z).to(dtype).to(device)


def old_fm_demod(z, gain):
    """``stream.fm_demod`` as it ran before the kernel."""
    z = torch.as_tensor(z).to(torch.complex64)
    zr, zi = z.real, z.imag
    pr = F.pad(zr[..., :-1], (1, 0))
    pi = F.pad(zi[..., :-1], (1, 0))
    dr = zr * pr + zi * pi
    di = zi * pr - zr * pi
    return (gain * torch.atan2(di, dr)).to(torch.float32)


# Where the rows lie: (what, a function of (make (shape) -> contiguous
# complex tensor) giving the input view).
VIEWS = {
    "channel-fastest (the channelizer's output)": lambda make: make((300, 24)).T,
    "contiguous rows": lambda make: make((5, 1100)),
    "batched (2, C, T) from a transposed buffer": lambda make: make((2, 700, 16)).transpose(-1, -2),
    "four dims that fold": lambda make: make((2, 3, 4, 130)),
    "a sample stride of 3": lambda make: make((3, 1500))[:, ::3],
    "channel-fastest, every other step": lambda make: make((400, 10)).T[:, ::2],
    "every other channel": lambda make: make((200, 12)).T[::2],
    "leading dims that do not fold": lambda make: make((3, 2, 4, 90)).transpose(0, 1),
    "one row": lambda make: make((777,)),
    "T = 1": lambda make: make((6, 1)),
    "T = 2": lambda make: make((2, 6)).T,
    "odd rows, odd T": lambda make: make((333, 7)).T,
}


@pytest.mark.parametrize("view", sorted(VIEWS))
@pytest.mark.parametrize("gain", GAINS + [-2.5])
def test_cpu_path_is_bit_for_bit_the_old_ops(view, gain):
    z = VIEWS[view](lambda shape: noise(shape, len(view)))
    want = old_fm_demod(z, gain)
    for got in (stream.fm_demod(z, gain=gain), demod.fm_demod(z, gain), demod.fm_demod_plain(z, gain)):
        assert got.dtype == torch.float32 and torch.equal(got, want)


def test_cpu_path_casts_to_complex64():
    z = noise((4, 300), 1, torch.complex128)
    assert torch.equal(stream.fm_demod(z, 0.5), old_fm_demod(z.to(torch.complex64), 0.5))


def test_routing(monkeypatch):
    """The CPU takes the plain ops, with or without grad: ``FMDemod`` is for
    CUDA inputs that need grad (``tests`` marked ``cuda`` check that)."""
    calls = []
    monkeypatch.setattr(autodiff.FMDemod, "apply", lambda *a: calls.append("FMDemod"))
    plain = demod.fm_demod_plain
    monkeypatch.setattr(demod, "fm_demod_plain", lambda *a: calls.append("plain") or plain(*a))
    z = noise((3, 200), 2)
    stream.fm_demod(z)
    zl = z.clone().requires_grad_()
    y = stream.fm_demod(zl, 0.3)
    assert calls == ["plain", "plain"] and y.grad_fn is not None
    g = noise((3, 200), 3).real.float()
    (y * g).sum().backward()
    zr = z.clone().requires_grad_()
    (old_fm_demod(zr, 0.3) * g).sum().backward()
    assert torch.equal(zl.grad, zr.grad)


def grad_gap(a, b) -> float:
    """max |a - b| / max |b| (0 where both are 0)."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("gain", GAINS + [-2.5])
@pytest.mark.parametrize("view", ["contiguous rows", "channel-fastest (the channelizer's output)", "T = 1", "T = 2",
                                  "one row", "batched (2, C, T) from a transposed buffer"])
def test_backward_matches_autograd_through_plain(dtype, gain, view):
    z = VIEWS[view](lambda shape: noise(shape, 7, dtype))
    g = noise(tuple(z.shape), 8).real.float()
    zl, zr = z.clone().requires_grad_(), z.clone().requires_grad_()
    out = autodiff.FMDemod.apply(zl, gain)
    ref = demod.fm_demod_plain(zr, gain)
    assert torch.equal(out, ref)
    (out * g).sum().backward()
    (ref * g).sum().backward()
    assert zl.grad.dtype == dtype
    assert grad_gap(zl.grad, zr.grad) <= (1e-6 if dtype == torch.complex64 else 1e-12)


def test_backward_at_zero_samples_matches_autograd():
    """A zero sample (silence, padding) has no phase: no term of its two
    steps, as the plain version's autograd gives it, and no NaN."""
    z = noise((3, 50), 9)
    z[0, 0] = z[1, 7] = z[1, 8] = z[2, -1] = 0
    g = noise((3, 50), 10).real.float()
    zl, zr = z.clone().requires_grad_(), z.clone().requires_grad_()
    (autodiff.FMDemod.apply(zl, 1.0) * g).sum().backward()
    (demod.fm_demod_plain(zr, 1.0) * g).sum().backward()
    assert bool(torch.isfinite(zl.grad).all())
    assert grad_gap(zl.grad, zr.grad) <= 1e-6


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_kernel_wrapper_refusals_on_any_device(device):
    z = torch.zeros(4, 64, dtype=torch.complex64, device=device)
    with pytest.raises(ValueError, match="CUDA tensors"):
        demod.fm_demod_kernel(z)
    with pytest.raises(TypeError, match="complex64"):
        demod.fm_demod_kernel(z.to(torch.complex128))
    with pytest.raises(TypeError, match="complex64"):
        demod.fm_demod_kernel(z.real.contiguous())
    with pytest.raises(RuntimeError, match="requires grad|takes no input that requires grad"):
        demod.fm_demod_kernel(z.clone().requires_grad_())
    with pytest.raises(ValueError, match="0-d"):
        demod.fm_demod_kernel(z[0, 0])


def test_meta_tensors_give_shapes():
    y = stream.fm_demod(torch.empty(256, 32768, dtype=torch.complex64, device="meta"))
    assert y.shape == (256, 32768) and y.dtype == torch.float32 and y.device.type == "meta"


def test_records():
    assert demod.KERNELS == (demod.FM_DEMOD,)
    assert demod.FM_DEMOD not in hf.KERNELS
    assert demod.FM_DEMOD.name == "fm_demod_kernel"
    assert demod.FM_DEMOD.source.endswith("csrc/demod.cu")
    assert demod.FM_DEMOD.span == "ops._cuda.launch.fm_demod_kernel"
    assert demod.FM_DEMOD.span in tracing.SPANS
    assert "fm_demod" in _cuda._SIGNATURES


def _source_ints() -> dict[str, int]:
    """The source's ``constexpr int`` constants, each evaluated from those
    before it."""
    values = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", SOURCE.read_text()):
        values[name] = eval(expr, {}, dict(values))
    return values


def test_constants_match_the_source():
    c = _source_ints()
    assert (demod.RUN, demod.SEGMENT) == (c["kRun"], c["kSegment"])
    assert (demod.ROWS_FAST, demod.TIME_FAST) == (c["kRowsFast"], c["kTimeFast"])
    assert "__fmul_rn" in SOURCE.read_text() and "atan2f" in SOURCE.read_text()


@pytest.mark.parametrize("view,layout,folds", [
    ("channel-fastest (the channelizer's output)", demod.ROWS_FAST, True),
    ("contiguous rows", demod.TIME_FAST, True),
    ("batched (2, C, T) from a transposed buffer", demod.ROWS_FAST, True),
    ("four dims that fold", demod.TIME_FAST, True),
    ("a sample stride of 3", demod.TIME_FAST, True),
    ("channel-fastest, every other step", demod.ROWS_FAST, True),
    ("every other channel", demod.ROWS_FAST, True),
    ("leading dims that do not fold", demod.TIME_FAST, False),
    ("one row", demod.TIME_FAST, True),
])
def test_layout_and_folding(view, layout, folds):
    z = VIEWS[view](lambda shape: noise(shape, 0))
    assert (demod._batch(z) is not None) == folds
    if not folds:
        z = z.contiguous()
    batch, rows, t, *strides = demod._dims(z)
    assert demod.demod_layout(rows, strides[1], strides[2]) == layout
    z3 = torch.as_strided(z, (batch, rows, t), strides)
    assert torch.equal(z3, z.reshape(batch, rows, t))


def kernel_model(z: np.ndarray, layout: int) -> np.ndarray:
    """The kernel's walk in numpy over z (batch, rows, T), complex128:
    which thread (rows-fast: a pair of rows and a run of RUN steps,
    carrying the step before; time-fast: a warp's segment of SEGMENT
    samples, 2 a lane an iteration, each lane's predecessor shuffled up
    from lane l - 1, lane 0's carried from lane 31 or read before the
    segment) computes which output from which pair of samples. Unwritten
    outputs stay NaN; an output written twice fails."""
    batch, rows, t = z.shape
    y = np.full(z.shape, np.nan)

    def put(b, r, n, c, p):
        assert np.isnan(y[b, r, n]), (b, r, n)
        y[b, r, n] = 0.0 if n == 0 else np.angle(c * np.conj(p))

    if layout == demod.ROWS_FAST:
        pairs, runs = (rows + 1) // 2, -(-t // demod.RUN)
        for unit in range(batch * pairs * runs):
            r, rest = 2 * (unit % pairs), unit // pairs
            n0, b = rest % runs * demod.RUN, rest // runs
            for e in range(2 if r + 1 < rows else 1):
                prev = z[b, r + e, n0 - 1] if n0 > 0 else 0j
                for n in range(n0, min(n0 + demod.RUN, t)):
                    put(b, r + e, n, z[b, r + e, n], prev)
                    prev = z[b, r + e, n]
        return y
    iters, segments = demod.SEGMENT // 64, -(-t // demod.SEGMENT)
    for warp in range(batch * rows * segments):
        s0, rest = warp % segments * demod.SEGMENT, warp // segments
        r, b = rest % rows, rest // rows
        at = [[s0 + 2 * (32 * i + lane) for lane in range(32)] for i in range(iters)]
        cur = [[(z[b, r, n] if n < t else 0j, z[b, r, n + 1] if n + 1 < t else 0j) for n in row] for row in at]
        carry = z[b, r, s0 - 1] if s0 > 0 else 0j
        for i in range(iters):
            up = [carry] + [cur[i][lane - 1][1] for lane in range(1, 32)]
            carry = cur[i][31][1]
            for lane, n in enumerate(at[i]):
                if n < t:
                    put(b, r, n, cur[i][lane][0], up[lane])
                if n + 1 < t:
                    put(b, r, n + 1, cur[i][lane][1], cur[i][lane][0])
    return y


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_kernel_walk_matches_plain(view):
    z = VIEWS[view](lambda shape: noise(shape, 21, torch.complex128))
    if demod._batch(z) is None:
        z = z.contiguous()
    batch, rows, t, *strides = demod._dims(z)
    layout = demod.demod_layout(rows, strides[1], strides[2])
    got = kernel_model(torch.as_strided(z, (batch, rows, t), strides).numpy(), layout)
    want = demod.fm_demod_plain(z.reshape(batch, rows, t), 1.0).double().numpy()
    assert not np.isnan(got).any()
    assert (got[..., 0] == 0).all()
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], atol=1e-6, rtol=0)


def test_kernel_walk_crosses_runs_and_segments():
    """Rows-fast runs and time-fast segments end inside the row, at a
    ragged end and exactly at it."""
    for t in (demod.RUN - 1, demod.RUN, 3 * demod.RUN + 5, demod.SEGMENT, 2 * demod.SEGMENT + 3):
        for layout in (demod.ROWS_FAST, demod.TIME_FAST):
            z = noise((2, 3, t), t, torch.complex128).numpy()
            got = kernel_model(z, layout)
            want = np.angle(z[..., 1:] * np.conj(z[..., :-1]))
            assert (got[..., 0] == 0).all()
            np.testing.assert_allclose(got[..., 1:], want, atol=1e-12, rtol=0)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def branch_cut(shape, seed, device):
    """Complex noise whose every step turns by nearly pi: z[n] conj(z[n-1])
    lies on the negative real axis within rounding, so that Im of the
    product is a few ulp either side of 0."""
    g = torch.Generator().manual_seed(seed)
    z = torch.randn(*shape, dtype=torch.complex64, generator=g)
    sign = torch.ones(shape[-1])
    sign[1::2] = -1
    z = z[..., :1] * sign * (1 + 1e-7 * torch.randn(*shape, dtype=torch.complex64, generator=g))
    return z.to(device)


def chain_channels(dev) -> torch.Tensor:
    """The channelizer's output as the chain hands it to the discriminator:
    (256, 32768) complex64, channel-fastest, from 2^24 IQ samples."""
    chain = models.SDRChain(models.SDRChainConfig(), device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    iq = torch.complex(torch.randn(1 << 24, generator=g, device=dev), torch.randn(1 << 24, generator=g, device=dev))
    with torch.no_grad():
        return chain.channelizer(chain.front_end(iq))


CARD_VIEWS = {**VIEWS, "branch-cut noise, contiguous rows": None, "branch-cut noise, channel-fastest": None}


def card_input(view, dev):
    if view == "branch-cut noise, contiguous rows":
        return branch_cut((8, 3000), 1, dev)
    if view == "branch-cut noise, channel-fastest":
        return branch_cut((256, 3000), 2, dev).T.contiguous().T
    return VIEWS[view](lambda shape: noise(shape, 31, device=dev))


def dense(t) -> bool:
    """Whether t's elements fill its memory without gaps or overlaps (so
    that ``empty_like`` keeps its strides)."""
    want = 1
    for stride, n in sorted((s, n) for n, s in zip(t.shape, t.stride()) if n > 1):
        if stride != want:
            return False
        want *= n
    return True


def check_against_plain(z, gain):
    before = demod.FM_DEMOD.launches
    y = demod.fm_demod_kernel(z, gain)
    torch.cuda.synchronize()
    assert demod.FM_DEMOD.launches == before + 1
    want = demod.fm_demod_plain(z, gain)
    assert y.shape == z.shape and y.dtype == torch.float32
    if demod._batch(z) is None:  # made contiguous first
        assert y.is_contiguous()
    elif dense(z):
        assert y.stride() == z.stride()
    else:  # dense, its dimensions in z's order
        assert dense(y)
        big = [i for i, n in enumerate(z.shape) if n > 1]
        assert sorted(big, key=z.stride) == sorted(big, key=y.stride)
    assert bool((y[..., 0] == 0).all())
    err = float((y[..., 1:] - want[..., 1:]).abs().max()) if z.shape[-1] > 1 else 0.0
    assert err <= GAP * max(1.0, abs(gain)), err


@pytest.mark.cuda
@pytest.mark.parametrize("view", sorted(CARD_VIEWS))
@pytest.mark.parametrize("gain", GAINS)
def test_kernel_matches_plain(dev, view, gain):
    check_against_plain(card_input(view, dev), gain)


@pytest.mark.cuda
@pytest.mark.parametrize("gain", GAINS)
def test_kernel_at_the_chains_layout(dev, gain):
    z = chain_channels(dev)
    assert z.shape == (256, 32768) and z.stride() == (1, 256)
    check_against_plain(z, gain)


@pytest.mark.cuda
def test_kernel_takes_views_at_any_offset(dev):
    """Rows that start off 16-byte boundaries take the narrow loads."""
    z = noise((1001, 9), 3, device=dev)
    for view in (z[1:].T, z.T[:, 1:], z.T[1:], z.reshape(-1)[1:]):
        check_against_plain(view, 1.0)


@pytest.mark.cuda
def test_the_chain_runs_one_launch_and_nothing_else_under_the_discriminator(dev, tmp_path):
    chain = models.SDRChain(models.SDRChainConfig(), device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    iq = torch.complex(torch.randn(1 << 20, generator=g, device=dev), torch.randn(1 << 20, generator=g, device=dev))
    chain(iq)  # build and warm
    torch.cuda.synchronize()
    before = demod.FM_DEMOD.launches
    with profiling.trace(tmp_path / "tr") as log_dir:
        chain(iq)
    assert demod.FM_DEMOD.launches == before + 1
    [path] = list(pathlib.Path(log_dir).glob("trace_*.json"))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat", "").startswith("cuda_") and "correlation" in e.get("args", {})}
    [fm] = [s for s in spans if s["name"] == "stream.demod.fm"]

    def inside(e, s):
        return s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"] and s.get("tid") == e.get("tid")

    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    under = [e["name"] for e in device if inside(runtime[e["args"]["correlation"]], fm)]
    assert len(under) == 1 and "fm_demod_kernel" in under[0], under


@pytest.mark.cuda
def test_gradients_on_the_card(dev):
    z = noise((256, 4000), 4, device=dev).T.contiguous().T  # channel-fastest
    g = noise((256, 4000), 5, device=dev).real.float()
    zl, zr, zc = z.clone().requires_grad_(), z.clone().requires_grad_(), z.cpu().requires_grad_()
    before = demod.FM_DEMOD.launches
    out = stream.fm_demod(zl, gain=1.0 / KF)
    assert demod.FM_DEMOD.launches == before + 1 and type(out.grad_fn).__name__ == "FMDemodBackward"
    (out * g).sum().backward()
    ref = demod.fm_demod_plain(zr, 1.0 / KF)
    (ref * g).sum().backward()
    (demod.fm_demod_plain(zc, 1.0 / KF) * g.cpu()).sum().backward()
    assert float((out[:, 1:] - ref[:, 1:]).detach().abs().max()) <= GAP
    assert grad_gap(zl.grad, zr.grad) <= 1e-6
    assert grad_gap(zl.grad.cpu(), zc.grad) <= 1e-6
