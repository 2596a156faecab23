"""The Hopper kernels on the card, against their plain twins on the same
CUDA tensors (bound 2e-7*N, max abs error). Marked ``cuda``: each test
skips without a CUDA device. Run on the card with

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu_torch import models, stream
from chowdsp_fft_tpu_torch.ops import hopper_cfft, hopper_small, tables
from chowdsp_fft_tpu_torch.ops import hopper_composite as hc
from chowdsp_fft_tpu_torch.ops import hopper_fft as hf

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def rand(shape, dev, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32)).to(dev)


def on_cpu(fn):
    """``fn`` on CPU copies of its tensor arguments, where the same call
    takes the plain versions, its result moved back to the card."""
    def move(x, where):
        if isinstance(x, torch.Tensor):
            return x.to(where)
        return type(x)(move(t, where) for t in x) if isinstance(x, (tuple, list)) else x

    return lambda *args: move(fn(*move(args, "cpu")), "cuda")


def maxerr(a, b):
    if not a.numel():  # no rows: nothing to differ
        return 0.0
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    return float((a.double() - b.double()).abs().max())


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("n,rows", [(384, 5), (640, 3), (1920, 2), (4096, 33), (16384, 4)])
def test_kernels_match_twins(dev, n, rows, ordered):
    plan = ct.cached_plan(n, ct.FFT_REAL)
    x = rand((rows, n), dev, n)
    hf.reset_launch_counts()
    yre, yim = hf.rfft_packed_kernel(x, plan, ordered)
    pre, pim = hf.rfft_packed_plain(x, plan, ordered)
    assert max(maxerr(yre, pre), maxerr(yim, pim)) <= 2e-7 * n
    back = hf.irfft_packed_kernel(yre, yim, plan, ordered)
    assert maxerr(back / n, hf.irfft_packed_plain(yre, yim, plan, ordered) / n) <= 2e-7 * n
    assert maxerr(back / n, x) <= 2e-7 * n
    hre, him = hf.rfft_packed_plain(rand((rows, n), dev, n + 1) / n**0.5, plan, ordered)
    for b_rows in (1, rows):
        b = (hre[:b_rows].contiguous(), him[:b_rows].contiguous())
        y = hf.convolve_irfft_packed_kernel(yre, yim, *b, 1.0 / n, plan, ordered)
        assert maxerr(y, hf.convolve_irfft_packed_plain(yre, yim, *b, 1.0 / n, plan, ordered)) <= 2e-7 * n
    torch.cuda.synchronize()
    assert {k.name: k.launches for k in hf.KERNELS} == {
        k.name: {hf.K1.name: 1, hf.K2.name: 1, hf.K3.name: 2}.get(k.name, 0) for k in hf.KERNELS
    }


def test_engine_path_launches_kernels(dev):
    hf.reset_launch_counts()
    x = rand((2, 20000), dev, 1)
    h = rand((1000,), dev, 2) / 32
    y = stream.fir_filter_ols(x, h)
    yp = stream.partitioned_fir_apply(x, h, block=512)
    assert y.device == dev and yp.device == dev
    assert maxerr(y, yp) <= 1e-3
    assert all(k.launches > 0 for k in (hf.K1, hf.K2, hf.K3))


def test_kernel_wrappers_refuse_bad_input(dev):
    plan = ct.cached_plan(1024, ct.FFT_REAL)
    x = rand((2, 1024), dev, 3)
    with pytest.raises(RuntimeError, match="autograd"):
        hf.rfft_packed_kernel(x.clone().requires_grad_(), plan)
    with pytest.raises(ValueError, match="contiguous"):
        hf.rfft_packed_kernel(rand((1024, 2), dev, 4).t(), plan)
    s = rand((3, 512), dev, 5)
    with pytest.raises(ValueError, match="B batch"):
        hf.convolve_irfft_packed_kernel(s, s, s[:2], s[:2], 1.0, plan)
    with pytest.raises(ValueError, match="domain"):
        hf.rfft_packed_kernel(rand((2, 32768), dev, 6), ct.cached_plan(32768, ct.FFT_REAL))


def crand(shape, dev, seed):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return torch.from_numpy(z).to(dev)


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n,rows", [(384, 7), (640, 5), (1024, 65), (1920, 3), (4096, 33), (hopper_cfft.MAX_CN, 4)])
def test_k4_matches_plain(dev, n, rows, forward, ordered):
    plan = ct.cached_plan(n, ct.FFT_COMPLEX)
    z = crand((rows, n), dev, n)
    hf.reset_launch_counts()
    y = hopper_cfft.cfft_kernel(z, plan, forward, ordered)
    assert maxerr(torch.view_as_real(y), torch.view_as_real(hopper_cfft.cfft_plain(z, plan, forward, ordered))) <= 2e-7 * n
    planes = (z.real.contiguous(), z.imag.contiguous())
    yr, yi = hopper_cfft.cfft_kernel(planes, plan, forward, ordered)
    assert maxerr(torch.complex(yr, yi), y) == 0.0
    back = hopper_cfft.cfft_kernel(y, plan, not forward, ordered)
    assert maxerr(torch.view_as_real(back / n), torch.view_as_real(z)) <= 2e-7 * n
    torch.cuda.synchronize()
    assert hopper_cfft.K4.launches == 3


K1_SIZES = [n for n in range(257, hf.MAX_N + 1) if hf._in_domain(n)]
K4_SIZES = [n for n in range(257, hopper_cfft.MAX_CN + 1) if hopper_cfft.in_domain(n)]


def view8(t):
    """``t``'s values in a tensor whose data is 8 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() * t.element_size() // 4 + 4, dtype=torch.float32, device=t.device)
    base = (16 - flat.data_ptr() % 16) % 16 // 4 + 2
    v = flat[base : base + t.numel() * t.element_size() // 4].view(t.dtype).reshape(t.shape)
    v.copy_(t)
    assert v.data_ptr() % 16 == 8
    return v


@pytest.mark.parametrize("n", K1_SIZES)
def test_k1_at_every_size(dev, n):
    """K1's pass engine at every size of its domain, 1, 7 and 300 rows,
    both orders: within 2e-7*N of its plain version and of float64; the
    joint form equals the planes, also on an 8-byte aligned view."""
    plan = ct.cached_plan(n, ct.FFT_REAL)
    for rows in (1, 7, 300):
        x = rand((rows, n), dev, n + rows)
        spec = np.fft.rfft(x.double().cpu().numpy(), axis=-1)
        want = np.concatenate([spec[:, : n // 2].real, spec[:, : n // 2].imag], -1)
        want[:, n // 2] = spec[:, n // 2].real
        for ordered in (True, False):
            sel = np.arange(n // 2) if ordered else tables.unordered_perm(n)
            yre, yim = hf.rfft_packed_kernel(x, plan, ordered)
            y = torch.cat([yre, yim], -1)
            assert maxerr(y, torch.cat(hf.rfft_packed_plain(x, plan, ordered), -1)) <= 2e-7 * n
            assert float(np.abs(y.double().cpu().numpy() - want[:, np.concatenate([sel, sel + n // 2])]).max()) <= 2e-7 * n
            assert torch.equal(hf.rfft_packed_joint_kernel(x, plan, ordered), y)
            assert torch.equal(hf.rfft_packed_joint_kernel(view8(x), plan, ordered), y)


@pytest.mark.parametrize("n", K1_SIZES)
def test_k2_k3_at_every_size(dev, n):
    """K2 and K3 on the row engine at every size of their domain, 1, 7 and
    300 rows, both orders: within 2e-7*N of their plain versions and of
    float64 (K3 with a shared and a batched B), bit-equal on 8-byte
    aligned views; 300 rows without their Nyquist bins fail."""
    plan = ct.cached_plan(n, ct.FFT_REAL)
    for rows in (1, 7, 300):
        x = rand((rows, n), dev, n + rows)
        h = rand((rows, n), dev, n - rows) / n**0.5
        x64, h64 = x.double().cpu().numpy(), h.double().cpu().numpy()
        for ordered in (True, False):
            re, im = hf.rfft_packed_plain(x, plan, ordered)
            back = hf.irfft_packed_kernel(re, im, plan, ordered)
            assert maxerr(back / n, hf.irfft_packed_plain(re, im, plan, ordered) / n) <= 2e-7 * n
            assert float(np.abs(back.double().cpu().numpy() / n - x64).max()) <= 2e-7 * n
            assert torch.equal(hf.irfft_packed_kernel(view8(re), view8(im), plan, ordered), back)
            if rows == 300:  # a row's Nyquist bin may be small: many rows make the check certain
                no_nyq = im.clone()
                no_nyq[:, 0] = 0
                assert maxerr(hf.irfft_packed_kernel(re, no_nyq, plan, ordered) / n, x) > 2e-7 * n
            hre, him = hf.rfft_packed_plain(h, plan, ordered)
            for b_rows in (1, rows):
                b = (hre[:b_rows].contiguous(), him[:b_rows].contiguous())
                y = hf.convolve_irfft_packed_kernel(re, im, *b, 1.0 / n, plan, ordered)
                assert maxerr(y, hf.convolve_irfft_packed_plain(re, im, *b, 1.0 / n, plan, ordered)) <= 2e-7 * n
                want = np.fft.irfft(np.fft.rfft(x64) * np.fft.rfft(h64[:b_rows]), n=n)
                assert float(np.abs(y.double().cpu().numpy() - want).max()) <= 2e-7 * n
                assert torch.equal(hf.convolve_irfft_packed_kernel(view8(re), view8(im), *map(view8, b), 1.0 / n,
                                                                   plan, ordered), y)


@pytest.mark.parametrize("n", K4_SIZES)
def test_k4_at_every_size(dev, n):
    """K4's pass engine at every size of its domain, 1, 7 and 130 rows,
    both directions and orders, complex64 and planes: within 2e-7*N of
    its plain version (and of float64 forward); planes and an 8-byte
    aligned complex64 view give the same bits."""
    plan = ct.cached_plan(n, ct.FFT_COMPLEX)
    for rows in (1, 7, 130):
        z = crand((rows, n), dev, n + rows)
        spec = np.fft.fft(z.cpu().numpy().astype(np.complex128), axis=-1)
        for forward in (True, False):
            for ordered in (True, False):
                y = hopper_cfft.cfft_kernel(z, plan, forward, ordered)
                p = hopper_cfft.cfft_plain(z, plan, forward, ordered)
                scale = 1.0 if forward else 1.0 / n
                assert maxerr(y * scale, p * scale) <= 2e-7 * n
                if forward:
                    sel = slice(None) if ordered else tables.cfft_unordered_perm(n)
                    assert float(np.abs(y.cpu().numpy() - spec[:, sel]).max()) <= 2e-7 * n
                yr, yi = hopper_cfft.cfft_kernel((z.real.contiguous(), z.imag.contiguous()), plan, forward, ordered)
                assert torch.equal(torch.complex(yr, yi), y)
                assert torch.equal(hopper_cfft.cfft_kernel(view8(z), plan, forward, ordered), y)


K5_SIZES = [n for n in range(hopper_small.MIN_SMALL, hopper_small.MAX_SMALL_N + 1)
            if hopper_small.in_domain(n) and ct.is_valid_size(n)]


@pytest.mark.parametrize("n", K5_SIZES)
def test_k5_matches_plain(dev, n):
    """Every size of K5's domain, at 1 row, ragged rows around the
    kernel's tile of rows (T - 1 and T + 1) and 1000 rows; complex64 and
    planes alike; real bodies at even N."""
    cplan = ct.cached_plan(n, ct.FFT_COMPLEX)
    tile = hopper_small.launch_geometry(n, "complex", 1).tile_rows
    for rows in (1, tile - 1, tile + 1, 1000):
        z = crand((rows, n), dev, n + rows)
        for forward in (True, False):
            y = hopper_small.small_cfft_kernel(z, cplan, forward)
            p = hopper_small.small_cfft_plain(z, cplan, forward)
            assert maxerr(torch.view_as_real(y), torch.view_as_real(p)) <= 2e-7 * n
            yr, yi = hopper_small.small_cfft_kernel((z.real.contiguous(), z.imag.contiguous()), cplan, forward)
            assert torch.equal(torch.complex(yr, yi), y)
    if n % 2:
        return
    rplan = ct.cached_plan(n, ct.FFT_REAL)
    tile = hopper_small.launch_geometry(n, "real", 1).tile_rows
    for rows in (1, tile - 1, tile + 1, 1000):
        x = rand((rows, n), dev, n + rows)
        re, im = hopper_small.small_rfft_kernel(x, rplan)
        pre, pim = hopper_small.small_rfft_plain(x, rplan)
        assert max(maxerr(re, pre), maxerr(im, pim)) <= 2e-7 * n
        back = hopper_small.small_irfft_kernel(re, im, rplan)
        assert maxerr(back / n, hopper_small.small_irfft_plain(re, im, rplan) / n) <= 2e-7 * n
        assert maxerr(back / n, x) <= 2e-7 * n


@pytest.mark.parametrize("n", [8, 96, 256, 480])
def test_k5_takes_8_byte_aligned_views(dev, n):
    """The JAX functions take any array, so K5 takes views 8 bytes past a
    16-byte boundary, with the result of an aligned copy."""
    rows = 37
    cplan, rplan = ct.cached_plan(n, ct.FFT_COMPLEX), ct.cached_plan(n, ct.FFT_REAL)
    z = torch.empty(rows * n + 1, dtype=torch.complex64, device=dev)[1:].view(rows, n)
    z.copy_(crand((rows, n), dev, n))
    assert z.data_ptr() % 16 == 8
    for forward in (True, False):
        assert torch.equal(hopper_small.small_cfft_kernel(z, cplan, forward),
                           hopper_small.small_cfft_kernel(z.clone(), cplan, forward))

    def offset(t):
        v = torch.empty(t.numel() + 2, device=dev)[2:].view(t.shape)
        v.copy_(t)
        assert v.data_ptr() % 16 == 8
        return v

    planes = (offset(z.real.contiguous()), offset(z.imag.contiguous()))
    yr, yi = hopper_small.small_cfft_kernel(planes, cplan, True)
    assert torch.equal(torch.complex(yr, yi), hopper_small.small_cfft_kernel(z.clone(), cplan, True))
    x = rand((rows, n), dev, n + 1)
    re, im = hopper_small.small_rfft_kernel(offset(x), rplan)
    re0, im0 = hopper_small.small_rfft_kernel(x, rplan)
    assert torch.equal(re, re0) and torch.equal(im, im0)
    assert torch.equal(hopper_small.small_irfft_kernel(offset(re0), offset(im0), rplan),
                       hopper_small.small_irfft_kernel(re0, im0, rplan))


def test_sdr_chain_launches_k5(dev):
    chain = models.SDRChain(models.SDRChainConfig(channels=256), device=dev)
    iq = crand((2 * 256 * 4 * 64,), dev, 9)
    hf.reset_launch_counts()
    audio = chain(iq)
    torch.cuda.synchronize()
    assert audio.shape == (256, 64) and bool(torch.isfinite(audio).all())
    assert hopper_small.K5_COMPLEX.launches == 1


@pytest.mark.parametrize("n,rows", [(16384, 3), (65536, 2), (576, 5), (279936, 2), (1 << 20, 2)])
def test_complex_composite_matches_plain(dev, n, rows):
    """K6's four roles through the complex composite, against the same
    composite on the plain versions, planes and complex64 alike."""
    from chowdsp_fft_tpu_torch.ops import hopper_composite as hc

    plan = ct.cached_plan(n, ct.FFT_COMPLEX)
    z = crand((rows, n), dev, n)
    hf.reset_launch_counts()
    y = hc.cfft_composite(z, plan, True)
    assert maxerr(y, on_cpu(hc.cfft_composite)(z, plan, True)) <= 2e-7 * n
    back = hc.cfft_composite(y, plan, False)
    assert maxerr(back / n, on_cpu(hc.cfft_composite)(y, plan, False) / n) <= 2e-7 * n
    assert maxerr(back / n, z) <= 2e-7 * n
    yr, yi = hc.cfft_composite((z.real.contiguous(), z.imag.contiguous()), plan, True)
    assert maxerr(torch.complex(yr, yi), y) == 0.0
    torch.cuda.synchronize()
    assert all(k.launches > 0 for k in (hc.K6_L1, hc.K6_L2, hc.K6_L2_REV, hc.K6_L1_REV))


@pytest.mark.parametrize("n,rows", [(20480, 3), (32768, 4), (576, 2), (3 << 18, 2), (1 << 20, 1)])
def test_real_composite_matches_plain(dev, n, rows):
    from chowdsp_fft_tpu_torch.ops import hopper_composite as hc

    plan = ct.cached_plan(n, ct.FFT_REAL)
    x = rand((rows, n), dev, n)
    hf.reset_launch_counts()
    re, im = hc.rfft_composite(x, plan)
    pre, pim = on_cpu(hc.rfft_composite)(x, plan)
    assert max(maxerr(re, pre), maxerr(im, pim)) <= 2e-7 * n
    back = hc.irfft_composite(re, im, plan)
    assert maxerr(back / n, on_cpu(hc.irfft_composite)(re, im, plan) / n) <= 2e-7 * n
    assert maxerr(back / n, x) <= 2e-7 * n
    torch.cuda.synchronize()
    assert all(k.launches > 0 for k in (hc.K7A, hc.K7B, hc.K6_L2, hc.K6_L2_REV))


def unpacked_level2(monkeypatch):
    """The real composite as it stood before K6 level 2 took over the
    Hermitian assembly: the unpacked level-2 kernels on the card, with
    the torch assembly (``hermitian_assembly``, ``hermitian_grid``) on
    the same device."""
    monkeypatch.setattr(hc, "level2_packed", lambda pre, pim, tw, plan, lines: hc.hermitian_assembly(
        *hc.level2((pre, pim), tw, plan, True), lines))
    monkeypatch.setattr(hc, "level2_rev_packed", lambda yre, yim, col0, tw, plan: hc.level2(
        hc.hermitian_grid(yre, yim, col0), tw, plan, False))


def bits_equal(got, want) -> bool:
    """``torch.equal`` on each float32 tensor's bits: signs of zeros too."""
    return all(g.shape == w.shape and torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, want))


@pytest.mark.parametrize("n,rows", [(1 << 18, 1), (1 << 18, 7), (1 << 19, 1), (1 << 19, 7), (1 << 19, 64),
                                    (1 << 19, 128), (3 << 18, 1), (3 << 18, 7)])
def test_packed_level2_equals_the_torch_assembly(dev, n, rows, monkeypatch):
    """K6 level 2 storing the ordered packed planes, and l2_rev gathering
    them, bit for bit the unpacked kernels with the torch assembly on the
    card, through ``rfft_composite`` and ``irfft_composite``; a packed
    plane with its conjugate half unnegated differs."""
    plan = ct.cached_plan(n, ct.FFT_REAL)
    x = rand((rows, n), dev, n + rows)
    hf.reset_launch_counts()
    re, im = hc.rfft_composite(x, plan)
    back = hc.irfft_composite(re, im, plan)
    torch.cuda.synchronize()
    assert hc.K6_L2.launches == 1 and hc.K6_L2_REV.launches == 1
    with monkeypatch.context() as m:
        unpacked_level2(m)
        want = hc.rfft_composite(x, plan)
        want_back = hc.irfft_composite(*want, plan)
    assert bits_equal((re, im, back), (*want, want_back))
    a, c = hc.split_large(n, real=True)
    flipped = im.reshape(rows, c // 2, a).clone()
    flipped[:, :, a // 2 + 1:] *= -1
    assert not bits_equal((flipped.reshape(rows, -1),), (want[1],))


def test_packed_level2_at_every_real_split(dev, monkeypatch):
    """The packed forms at every split (A, C) the real composite runs, 3
    rows: ``level2_packed`` and ``level2_rev_packed`` bit for bit the
    unpacked kernels with the torch assembly on the card."""
    for a, c in hc.real_splits():
        plan = ct.cached_plan(c, ct.FFT_COMPLEX)
        tw, twb = hc.real_twiddle(a * c, True, dev), hc.real_twiddle(a * c, False, dev)
        pre, pim = rand((3, c, a // 2), dev, a + c), rand((3, c, a // 2), dev, a + c + 1)
        lines = crand((6, c), dev, a * c)
        got = hc.level2_packed(pre, pim, tw, plan, lines)
        assert bits_equal(got, hc.hermitian_assembly(*hc.level2((pre, pim), tw, plan, True), lines)), (a, c)
        col0 = crand((3, c), dev, a * c + 1)
        back = hc.level2_rev_packed(*got, col0, twb, plan)
        assert bits_equal(back, hc.level2(hc.hermitian_grid(*got, col0), twb, plan, False)), (a, c)


def _shapes(dims):
    """The tensor shapes in a Chrome trace's "Input Dims" (lists of ints,
    nested for tensor lists)."""
    if isinstance(dims, list) and all(isinstance(d, int) for d in dims):
        yield dims
    elif isinstance(dims, list):
        for d in dims:
            yield from _shapes(d)


# Profiles one warm real composite round trip of (rows, n) samples on the
# card, recording the ops' input shapes, into a Chrome trace:
#     python -c GLUE_PROFILE n rows trace.json
GLUE_PROFILE = """
import sys
import torch
import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu_torch.ops import hopper_composite as hc

n, rows, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
plan = ct.cached_plan(n, ct.FFT_REAL)
x = torch.randn(rows, n, generator=torch.Generator(device="cuda").manual_seed(23), device="cuda")
hc.irfft_composite(*hc.rfft_composite(x, plan), plan)  # build and warm
torch.cuda.synchronize()
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
    hc.irfft_composite(*hc.rfft_composite(x, plan), plan)
    torch.cuda.synchronize()
prof.export_chrome_trace(out)
"""


def test_real_composite_glue_has_no_plane_sized_op(dev, tmp_path):
    """At N = 2^19, 16 rows: every device op that ``rfft_composite`` and
    ``irfft_composite`` launch innermost in their own spans (their glue)
    comes from an op whose inputs are at most the (2B, C) lines, far
    below a packed plane (B, N/2). The profile (``GLUE_PROFILE``) runs in
    a process of its own: run in the card tests' process, it was followed
    by device events missing from three later tests' profiles."""
    import json
    import pathlib
    import subprocess
    import sys

    n, rows = 1 << 19, 16
    c = hc.split_large(n, real=True)[1]
    trace = tmp_path / "trace.json"
    subprocess.run([sys.executable, "-c", GLUE_PROFILE, str(n), str(rows), str(trace)], check=True, timeout=600,
                   cwd=pathlib.Path(__file__).resolve().parents[1])
    events = [e for e in json.loads(trace.read_text())["traceEvents"] if e.get("ph") == "X"]

    def innermost(among, call):
        around = [e for e in among if e.get("tid") == call.get("tid") and e["ts"] <= call["ts"]
                  and call["ts"] + call["dur"] <= e["ts"] + e["dur"]]
        return min(around, key=lambda e: e["dur"]) if around else None

    spans = [e for e in events if e.get("cat") == "user_annotation"]
    cpu_ops = [e for e in events if e.get("cat") == "cpu_op"]
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat", "").startswith("cuda_") and "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    glue = {"ops.hopper_composite.rfft_composite", "ops.hopper_composite.irfft_composite"}
    seen = 0
    for op in device:
        call = runtime[op["args"]["correlation"]]
        span = innermost(spans, call)
        if span is None or span["name"] not in glue:
            continue
        owner = innermost(cpu_ops, call)
        assert owner is not None, op["name"]
        largest = max((int(np.prod(s)) for s in _shapes(owner["args"].get("Input Dims", []))), default=0)
        assert largest <= 2 * rows * c, (owner["name"], owner["args"].get("Input Dims"), op["name"])
        seen += 1
    assert seen > 0


def test_long_filter_ols_launches_composite(dev):
    """A 6000-tap filter takes N = 2^15, a composite size."""
    from chowdsp_fft_tpu_torch.ops import hopper_composite as hc

    x = rand((2, 60000), dev, 11)
    h = rand((6000,), dev, 12) / 80
    hf.reset_launch_counts()
    y = stream.fir_filter_ols(x, h)
    yp = stream.fir_filter_ols(x, h, engine="stockham")
    torch.cuda.synchronize()
    assert maxerr(y, yp) <= 1e-4
    assert all(k.launches > 0 for k in (hc.K7A, hc.K7B, hc.K6_L2, hc.K6_L2_REV))


COLUMN_LENGTHS, REAL_COLUMN_LENGTHS = hc.column_lengths()


def held_bound(want: torch.Tensor, length: int) -> float:
    """The bound for a kernel of transform length ``length`` on its own:
    2e-7 * length * rms of the reference, so that an output far below
    unit scale is held below its own size."""
    return 2e-7 * length * float(want.abs().double().pow(2).mean().sqrt())


def aligned8(z: torch.Tensor) -> torch.Tensor:
    """A copy of complex64 ``z`` whose data sit 8 bytes past a 16-byte
    boundary."""
    base = torch.empty(z.numel() + 1, dtype=torch.complex64, device=z.device)
    view = base[1:].view(z.shape)
    view.copy_(z)
    assert view.data_ptr() % 16 == 8
    return view


@pytest.mark.parametrize("length", COLUMN_LENGTHS)
def test_k6_roles_at_every_length(dev, length):
    """K6 in its four roles at every column length the composite's splits
    produce, 1 and 7 batch rows of a ragged M = 37 columns: complex64, an
    8-byte aligned complex64 view and planes, each within ``held_bound`` of
    its plain version (which a zeroed output fails)."""
    plan = ct.cached_plan(length, ct.FFT_COMPLEX)
    m = 37
    tw = torch.polar(torch.ones(length, m, device=dev), torch.rand(length, m, device=dev) * 6.2832)
    for rows in (1, 7):
        cols = crand((rows, length, m), dev, length + rows)
        trans = crand((rows, m, length), dev, length + rows + 1)
        for form in ("complex64", "view", "planes"):
            def f(z, form=form):
                if form == "view":
                    return aligned8(z)
                return z if form == "complex64" else (z.real.contiguous(), z.imag.contiguous())

            def cx(v):
                return v if isinstance(v, torch.Tensor) else torch.complex(*v)

            cases = {
                "l1": (hc.level1(f(cols), plan, True), hc.level1_plain(cols, plan, True)),
                "l1_rev": (hc.level1(f(trans), plan, False), hc.level1_plain(trans, plan, False)),
                "l2": (hc.level2(f(cols), tw, plan, True), hc.level2_plain(cols, tw, plan, True)),
                "l2_rev": (hc.level2(f(cols), tw, plan, False), hc.level2_plain(cols, tw, plan, False)),
            }
            for role, (got, want) in cases.items():
                bound = held_bound(want, length)
                assert maxerr(cx(got), want) <= bound, (role, form, rows)
                assert maxerr(torch.zeros_like(want), want) > bound


def packed_cols64(x: torch.Tensor, a: int) -> torch.Tensor:
    """The float64 packed planes of the length-A real DFT of every column
    of (B, A, C) ``x``, as (B, C, A) [re | im]: bins 0..A/2-1, the
    Nyquist bin in im's slot 0."""
    spec = np.fft.rfft(x.double().cpu().numpy(), axis=1).transpose(0, 2, 1)  # (B, C, A/2 + 1)
    im = spec.imag[..., : a // 2].copy()
    im[..., 0] = spec[..., a // 2].real
    return torch.from_numpy(np.concatenate([spec.real[..., : a // 2], im], -1)).to(x.device)


@pytest.mark.parametrize("a", REAL_COLUMN_LENGTHS)
def test_k7a_at_every_length(dev, a):
    """K7a at every real column length A, 1 and 7 batch rows of a ragged
    C = 37 columns of unit-scale samples: within ``held_bound`` of its plain
    version and of float64 (which a zeroed output and one whose Nyquist
    slot, im[..., 0], is zeroed fail)."""
    plan = ct.cached_plan(a, ct.FFT_REAL)
    for rows in (1, 7):
        x = rand((rows, a, 37), dev, a + rows + 2)
        got = torch.cat(hc.rfft_cols(x, plan), -1)
        want = torch.cat(hc.rfft_cols_plain(x, plan), -1)
        ref = packed_cols64(x, a)
        bound = held_bound(want, a)
        assert maxerr(got, want) <= bound and maxerr(got, ref) <= held_bound(ref, a)
        no_nyq = got.clone()
        no_nyq[..., a // 2] = 0  # im[..., 0]
        assert maxerr(torch.zeros_like(want), want) > bound
        assert maxerr(no_nyq, want) > bound


@pytest.mark.parametrize("a", REAL_COLUMN_LENGTHS)
def test_k7b_at_every_length(dev, a):
    """K7b at every real column length A, 1 and 7 batch rows of a ragged
    C = 37 columns, on the packed spectrum of unit-scale columns: within
    ``held_bound`` of its plain version and of A x (which a zeroed output
    and a dropped Nyquist slot fail)."""
    plan = ct.cached_plan(a, ct.FFT_REAL)
    for rows in (1, 7):
        x = rand((rows, a, 37), dev, a + rows)
        pre, pim = hc.rfft_cols_plain(x, plan)
        got = hc.irfft_cols(pre, pim, plan)
        want = hc.irfft_cols_plain(pre, pim, plan)
        bound = held_bound(want, a)
        assert maxerr(got, want) <= bound and maxerr(got / a, x) <= held_bound(x, a)
        no_nyq = pim.clone()
        no_nyq[..., 0] = 0
        assert maxerr(torch.zeros_like(want), want) > bound
        assert maxerr(hc.irfft_cols(pre, no_nyq, plan), want) > bound


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("n,rows", [(384, 5), (1920, 133), (4096, 1000), (4096, 1), (8192, 531), (16384, 300)])
def test_real_db_kernels_equal_grid(dev, n, rows, ordered):
    """K1-db and K2-db run K1's and K2's row bodies on the same tables:
    torch.equal to the grid kernels, ragged batches and a single row."""
    plan = ct.cached_plan(n, ct.FFT_REAL)
    x = rand((rows, n), dev, n)
    hf.reset_launch_counts()
    joint = hf.rfft_packed_joint_kernel(x, plan, ordered)
    joint_db = hf.rfft_packed_joint_db_kernel(x, plan, ordered)
    re, im = hf.rfft_packed_kernel(x, plan, ordered)
    assert torch.equal(joint_db, joint)
    assert torch.equal(joint, torch.cat([re, im], -1))
    assert maxerr(joint_db, hf.rfft_packed_joint_plain(x, plan, ordered)) <= 2e-7 * n
    back_db = hf.irfft_packed_db_kernel(re, im, plan, ordered)
    assert torch.equal(back_db, hf.irfft_packed_kernel(re, im, plan, ordered))
    assert maxerr(back_db / n, x) <= 2e-7 * n
    torch.cuda.synchronize()
    assert (hf.K1.launches, hf.K1_DB.launches, hf.K2.launches, hf.K2_DB.launches) == (2, 1, 1, 1)


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n,rows", [(384, 7), (1024, 1000), (4096, 1), (9216, 140), (10240, 3),
                                    (hopper_cfft.MAX_CN, 133)])
def test_k4_db_equals_grid(dev, n, rows, forward, ordered):
    """K4-db in both input forms, both directions and orders, up to MAX_CN
    (the landing buffer fits beside one work buffer at every size)."""
    plan = ct.cached_plan(n, ct.FFT_COMPLEX)
    z = crand((rows, n), dev, n)
    hf.reset_launch_counts()
    y = hopper_cfft.cfft_kernel(z, plan, forward, ordered)
    y_db = hopper_cfft.cfft_db_kernel(z, plan, forward, ordered)
    assert torch.equal(y_db, y)
    planes = (z.real.contiguous(), z.imag.contiguous())
    yr, yi = hopper_cfft.cfft_db_kernel(planes, plan, forward, ordered)
    assert torch.equal(torch.complex(yr, yi), y)
    plain = hopper_cfft.cfft_plain(z, plan, forward, ordered)
    assert maxerr(torch.view_as_real(y_db), torch.view_as_real(plain)) <= 2e-7 * n
    torch.cuda.synchronize()
    assert hopper_cfft.K4_DB.launches == 2


def test_db_kernels_refuse_misaligned_input(dev):
    """The pipelined kernels copy rows 16 bytes at a time."""
    plan = ct.cached_plan(1024, ct.FFT_REAL)
    x = rand((2 * 1024 + 2,), dev, 7)[2:].reshape(2, 1024)
    assert x.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="16-byte"):
        hf.rfft_packed_joint_db_kernel(x, plan)
    hf.rfft_packed_joint_kernel(x, plan)  # the grid kernel takes 8-byte alignment
    s = x[:, :512]
    with pytest.raises(ValueError, match="contiguous|16-byte"):
        hf.irfft_packed_db_kernel(s, s, plan)


# ---------------------------------------------------------------------------
# Gradients on the card: each autograd Function (ops/autodiff.py) against
# the same Function on CPU copies (the plain versions), the backward's
# launches counted
# ---------------------------------------------------------------------------


def vjp_on_card(fn, inputs, cotangents, backward_kernels):
    """Gradients of ``fn`` at ``inputs`` along ``cotangents``; the launch
    counts are reset after the forward, so they count the backward, and
    each of ``backward_kernels`` must have launched."""
    args = [t.clone().requires_grad_() for t in inputs]
    out = fn(*args)
    torch.cuda.synchronize()
    hf.reset_launch_counts()
    grads = torch.autograd.grad(out if isinstance(out, tuple) else (out,), args, cotangents)
    torch.cuda.synchronize()
    assert all(k.launches > 0 for k in backward_kernels), {k.name: k.launches for k in backward_kernels}
    return grads


def real_backward_kernels(n: int, inverse_rule: bool):
    """The kernels the backward of RfftPacked (``inverse_rule``: the
    inverse transform) or IrfftPacked (the forward) launches at N."""
    if hopper_small.in_domain(n):
        return [hopper_small.K5_REAL_INVERSE if inverse_rule else hopper_small.K5_REAL]
    if hf._in_domain(n):
        return [hf.K2 if inverse_rule else hf.K1]
    return [hc.K7B, hc.K6_L2_REV] if inverse_rule else [hc.K7A, hc.K6_L2]


GRAD_REAL = [(64, 33), (480, 5), (4096, 33), (16384, 4), (576, 5), (32768, 3), (1 << 20, 2)]


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("n,rows", GRAD_REAL)
def test_real_gradients_match_plain(dev, n, rows, ordered):
    """RfftPacked's and IrfftPacked's gradients (K5, K2/K1, the composite
    in backward) within 2e-7*N times the cotangent's largest value (twice
    that for IrfftPacked's weight 2) of the plain route's."""
    from chowdsp_fft_tpu_torch.ops import autodiff

    plan = ct.cached_plan(n, ct.FFT_REAL)
    x = rand((rows, n), dev, n)
    u = (rand((rows, n // 2), dev, n + 1), rand((rows, n // 2), dev, n + 2))
    fn = lambda v: autodiff.RfftPacked.apply(v, plan, ordered)  # noqa: E731
    g_kernel = vjp_on_card(fn, [x], u, real_backward_kernels(n, True))[0]
    g = vjp_on_card(on_cpu(fn), [x], u, [])[0]
    assert maxerr(g, g_kernel) <= 2e-7 * n * float(torch.cat(u).abs().max())
    spec = hf.rfft_rows(x, plan, ordered)
    w = rand((rows, n), dev, n + 3)
    fn = lambda a, b: autodiff.IrfftPacked.apply(a, b, plan, ordered)  # noqa: E731
    g_kernel = vjp_on_card(fn, list(spec), (w,), real_backward_kernels(n, False))
    g = vjp_on_card(on_cpu(fn), list(spec), (w,), [])
    assert max(maxerr(a, b) for a, b in zip(g, g_kernel)) <= 2 * 2e-7 * n * float(w.abs().max())


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("n,rows", [(4096, 33), (16384, 4)])
def test_convolve_gradients_match_plain(dev, n, rows, ordered):
    """ConvolveIrfftPacked's gradients (K1 in backward) for all four
    arguments, a shared and a batched B, against the plain route's, 2e-7*N
    times the plain gradient's largest value."""
    from chowdsp_fft_tpu_torch.ops import autodiff

    plan = ct.cached_plan(n, ct.FFT_REAL)
    a = hf.rfft_rows(rand((rows, n), dev, n), plan, ordered)
    w = rand((rows, n), dev, n + 1)
    for b_rows in (1, rows):
        b = hf.rfft_rows(rand((b_rows, n), dev, n + 2) / n ** 0.5, plan, ordered)
        fn = lambda *t: autodiff.ConvolveIrfftPacked.apply(*t, plan, 1.0 / n, ordered)  # noqa: E731
        got = vjp_on_card(fn, [*a, *b], (w,), [hf.K1])
        want = vjp_on_card(on_cpu(fn), [*a, *b], (w,), [])
        for p, q in zip(got, want):
            assert p.shape == q.shape and maxerr(p, q) <= 2e-7 * n * float(q.abs().max())


@pytest.mark.parametrize("planes", [True, False])
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("n,rows", [(64, 33), (4096, 33), (16384, 3), (1 << 20, 2)])
def test_complex_gradients_match_plain(dev, n, rows, ordered, forward, planes):
    """CfftPair's gradient (K5, K4 or K6 in the opposite direction) on
    planes and complex64, against the plain route's, 2e-7*N times the
    cotangent's largest value."""
    from chowdsp_fft_tpu_torch.ops import autodiff

    plan = ct.cached_plan(n, ct.FFT_COMPLEX)
    z = crand((rows, n), dev, n)
    u = crand((rows, n), dev, n + 1)
    if hopper_small.in_domain(n):
        kernels = [hopper_small.K5_COMPLEX]
    elif hopper_cfft.in_domain(n):
        kernels = [hopper_cfft.K4]
    else:
        kernels = [hc.K6_L2_REV, hc.K6_L1_REV] if forward else [hc.K6_L1, hc.K6_L2]
    if planes:
        inputs, cot = [z.real.contiguous(), z.imag.contiguous()], (u.real.contiguous(), u.imag.contiguous())
    else:
        inputs, cot = [z], (u,)

    def fn(*t):
        return autodiff.CfftPair.apply(t[0], t[1] if planes else None, plan, forward, ordered)

    got = vjp_on_card(fn, inputs, cot, kernels)
    want = vjp_on_card(on_cpu(fn), inputs, cot, [])
    bound = 2e-7 * n * float(torch.view_as_real(u).abs().max())
    assert max(maxerr(p, q) for p, q in zip(got, want)) <= bound


def test_engine_entries_differentiate_on_card(dev):
    """loss.backward() through the engine entries on CUDA tensors, against
    the Stockham engine's native gradient, and a conjugate view read as
    its values."""
    x = rand((3, 4096), dev, 21)
    z = crand((3, 4096), dev, 22)
    grads = {}
    for engine in ("hopper", "stockham"):
        v = x.clone().requires_grad_()
        zz = z.clone().requires_grad_()
        re, im = ct.rfft_packed_unordered(v, engine=engine)
        y = ct.irfft_packed_unordered(re * re, im, engine=engine)
        loss = (y ** 2).sum() / 4096 ** 3 + (ct.fft(zz, engine=engine).abs() ** 2).sum() / 4096
        hf.reset_launch_counts()
        loss.backward()
        torch.cuda.synchronize()
        if engine == "hopper":
            assert all(k.launches > 0 for k in (hf.K1, hf.K2, hopper_cfft.K4))
        grads[engine] = (v.grad, zz.grad)
    for p, q in zip(grads["hopper"], grads["stockham"]):
        assert maxerr(p, q) <= 1e-4 * float(q.abs().max())
    assert maxerr(ct.fft(z.conj()), ct.fft(z.conj().resolve_conj())) == 0.0


# ---------------------------------------------------------------------------
# The benchmark's complex round trip (cfft1048576.b64) at its own shape
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cfft_cell():
    """64 seeded complex64 unit-variance rows of 2^20, the shape of the
    benchmark's cell ``cfft1048576.b64``, and the cell's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    import json
    import pathlib

    config = pathlib.Path(__file__).resolve().parents[1] / "portbench" / "configs" / "cfft1048576.json"
    gen = torch.Generator(device="cuda").manual_seed(24)
    x = torch.randn(64, 1 << 20, dtype=torch.complex64, generator=gen, device="cuda")
    ct.ifft(ct.fft(x))  # build and warm
    torch.cuda.synchronize()
    return x, json.loads(config.read_text())["limits"]


def _port_launches():
    from chowdsp_fft_tpu_torch.ops import convolve, demod, polyphase

    return {k.name: k.launches for k in hf.KERNELS + convolve.KERNELS + polyphase.KERNELS + demod.KERNELS}


def test_cfft_cell_launches_the_four_k6_roles(cfft_cell):
    """``api.fft`` then ``api.ifft`` on 2^20 x 64 complex64 launch K6 l1,
    l2, l2_rev and l1_rev once each, and nothing else of the port."""
    x, _ = cfft_cell
    before = _port_launches()
    ct.ifft(ct.fft(x, engine="auto"), engine="auto")
    torch.cuda.synchronize()
    rose = {k: n - before[k] for k, n in _port_launches().items() if n != before[k]}
    assert rose == {"composite_l1_kernel": 1, "composite_l2_kernel": 1, "composite_l2_rev_kernel": 1,
                    "composite_l1_rev_kernel": 1}


def test_cfft_cell_against_float64(cfft_cell):
    """The spectrum against the benchmark's float64 reference and the
    round trip against N x, within the cell's limits; a zeroed row of the
    spectrum fails them."""
    from portbench.reference import compare, complex_fft

    x, limits = cfft_cell
    n = x.shape[-1]

    def gap(out, ref):
        return compare.gap(torch.view_as_real(out), torch.view_as_real(ref))

    spec = ct.fft(x)
    y = ct.ifft(spec)
    ref = complex_fft.fft(x)
    assert gap(spec, ref) <= limits["spectrum_gap"]
    assert gap(y, x.to(torch.complex128) * n) <= limits["roundtrip_gap"]
    spec[5] = 0
    assert not gap(spec, ref) <= limits["spectrum_gap"]


# Profiles one warm complex round trip of 64 rows of 2^20 (the cell
# ``cfft1048576.b64``'s call) in the benchmark's call span, through the
# port's tracer, into a directory:
#     python -c CFFT_PROFILE trace_dir
CFFT_PROFILE = """
import sys
import torch
import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu_torch.utils import profiling
from portbench import spans

gen = torch.Generator(device="cuda").manual_seed(24)
x = torch.randn(64, 1 << 20, dtype=torch.complex64, generator=gen, device="cuda")
ct.ifft(ct.fft(x))  # build and warm
torch.cuda.synchronize()
with profiling.trace(sys.argv[1]):
    with torch.profiler.record_function(spans.CALL):
        ct.ifft(ct.fft(x))
"""


def test_cfft_cell_levels_cover_the_busy_time(dev, tmp_path):
    """In a profiled call, every device op lies in a K6 launch span (four
    kernels, no copy or fill), and the cell's two level metrics' spans
    add up to the call's busy time within 1%. The profile
    (``CFFT_PROFILE``) runs in a process of its own, as ``GLUE_PROFILE``
    does."""
    import pathlib
    import subprocess
    import sys

    from portbench import harness, spans, trace
    from portbench.metrics import cfft_level1_device_ms, cfft_level2_device_ms

    subprocess.run([sys.executable, "-c", CFFT_PROFILE, str(tmp_path / "tr")], check=True, timeout=600,
                   cwd=pathlib.Path(__file__).resolve().parents[1])
    [path] = list((tmp_path / "tr").glob("trace_*.json"))
    device, host = spans.read_events(path)
    w = spans.HostWindow(device, host, harness.port_kernel_names())
    assert len(w.calls) == 1 and len(device) == 4
    assert all(op.cat == "kernel" and "column_passes_kernel" in op.name for op in device)
    level1, level2 = w.device_ms(cfft_level1_device_ms.SPANS), w.device_ms(cfft_level2_device_ms.SPANS)
    busy_ms = 1e3 * sum(b - a for a, b in trace.busy_intervals(device))
    assert level1 > 0 and level2 > 0
    assert level1 + level2 == pytest.approx(busy_ms, rel=1e-2)


# ---------------------------------------------------------------------------
# The parallel layer on a one-rank NCCL group (chowdsp_fft_tpu_torch/parallel)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nccl_mesh():
    """A dsp_mesh(1) on card 0 over a one-rank NCCL group: the sharded
    entries' local work on the card, their collectives copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    import torch.distributed as dist
    from chowdsp_fft_tpu_torch import parallel

    parallel.init_local_group("cuda")
    try:
        yield parallel.dsp_mesh(1)
    finally:
        dist.destroy_process_group()


def test_one_rank_sharded_filters_match_unsharded(nccl_mesh):
    from chowdsp_fft_tpu_torch import parallel

    dev = torch.device("cuda", 0)
    x = rand((3, 1 << 16), dev, 31)
    h = rand((1000,), dev, 32) / 32
    hf.reset_launch_counts()
    y = parallel.sharded_fir_ols(x, h, nccl_mesh)
    yp = parallel.sharded_partitioned_fir(x, h, nccl_mesh, block=512)
    assert isinstance(y, parallel.DTensor) and y.to_local().device == dev
    assert maxerr(y.to_local(), stream.fir_filter_ols(x, h)) <= 1e-5
    assert maxerr(yp.to_local(), stream.partitioned_fir_apply(x, h, block=512)) <= 1e-5
    assert all(k.launches > 0 for k in (hf.K1, hf.K2, hf.K3))
    with pytest.raises(ValueError, match="mesh on cuda"):
        parallel.sharded_fir_ols(x.cpu(), h, nccl_mesh)


@pytest.mark.parametrize("n,rows,kernels", [
    (1 << 16, 3, ("small_cfft_kernel", "small_rfft_kernel", "small_irfft_kernel")),  # split 256 x 256: K5
    (1 << 20, 2, ("rfft_packed_kernel", "irfft_packed_kernel", "cfft_kernel")),  # 1024 x 1024: K1, K2, K4
])
def test_one_rank_distributed_fft_matches_engine(nccl_mesh, n, rows, kernels):
    """Forward and inverse, complex and real, against the engine's own
    transform through spectrum_order / rspectrum_order (2e-7*N), and the
    two circular convolutions against float64; the local transforms ran
    on the split's kernels."""
    from chowdsp_fft_tpu_torch import parallel

    dev = torch.device("cuda", 0)
    re, im, x, h = (rand((rows, n), dev, n + k) for k in range(4))
    hf.reset_launch_counts()
    fr, fi = (t.to_local() for t in parallel.sharded_fft_planes(re, im, nccl_mesh))
    perm = torch.from_numpy(parallel.spectrum_order(n, 1)).to(dev)
    assert maxerr(torch.complex(fr, fi), ct.fft(torch.complex(re, im))[:, perm]) <= 2e-7 * n
    br, bi = (t.to_local() for t in parallel.sharded_ifft_planes(fr, fi, nccl_mesh))
    assert maxerr(torch.complex(br, bi) / n, torch.complex(re, im)) <= 2e-7 * n
    rr, ri = (t.to_local() for t in parallel.sharded_rfft_planes(x, nccl_mesh))
    rperm = torch.from_numpy(parallel.rspectrum_order(n, 1)).to(dev)
    valid = rperm >= 0
    full = torch.fft.fft(x.double())
    assert maxerr(torch.complex(rr, ri)[:, valid], full[:, rperm[valid]]) <= 2e-7 * n
    assert maxerr(parallel.sharded_irfft_planes(rr, ri, nccl_mesh, n).to_local() / n, x) <= 2e-7 * n
    assert all(k.launches > 0 for k in hf.KERNELS if k.name in kernels)
    y = parallel.sharded_rfft_convolve(x, h, nccl_mesh).to_local()
    ref = torch.fft.irfft(torch.fft.rfft(x.double()) * torch.fft.rfft(h.double()), n=n)
    assert maxerr(y, ref) <= 4e-6 * float(ref.abs().max())
    cr, ci = (t.to_local() for t in parallel.sharded_fft_convolve(x, re, h, im, nccl_mesh))
    refc = torch.fft.ifft(torch.fft.fft(torch.complex(x.double(), re.double()))
                          * torch.fft.fft(torch.complex(h.double(), im.double())))
    assert maxerr(torch.complex(cr, ci), refc) <= 1e-4 * float(refc.abs().max())


def test_one_rank_sharded_models_match_unsharded(nccl_mesh):
    from chowdsp_fft_tpu_torch import parallel

    dev = torch.device("cuda", 0)
    conv = models.MultichannelConvolver(rand((4, 3000), dev, 41) / 64, models.ConvolverConfig(channels=4, block=512))
    x = rand((4, 20000), dev, 42)
    wet = conv.apply(x)
    cmesh = parallel.dsp_mesh(1, axis=parallel.CHANNEL_AXIS)
    assert maxerr(conv.time_sharded_apply(nccl_mesh, parallel.TIME_AXIS)(x).to_local(), wet) <= 1e-4
    assert maxerr(conv.channel_sharded_apply(cmesh)(x).to_local(), wet) <= 1e-4
    from torch_parallel_cases import fm_carriers  # a carrier in every channel: the demod is defined everywhere

    chain = models.SDRChain(models.SDRChainConfig(channels=16))
    iq = torch.from_numpy(fm_carriers(16, 2, 16 * 2 * 4 * 256, seed=43)).to(dev)
    hf.reset_launch_counts()
    out = chain.sharded_step(nccl_mesh)(iq).to_local()
    assert maxerr(out, chain(iq)) <= 1e-4
    assert hopper_small.K5_COMPLEX.launches > 0
