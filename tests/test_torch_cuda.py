"""The Hopper kernels on the card, against their plain twins on the same
CUDA tensors (bound 2e-7*N, max abs error). Marked ``cuda``: each test
skips without a CUDA device. Run on the card with

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu_torch import stream
from chowdsp_fft_tpu_torch.ops import hopper_fft as hf

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def rand(shape, dev, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32)).to(dev)


def maxerr(a, b):
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
    assert [k.launches for k in hf.KERNELS] == [1, 1, 2]


def test_engine_path_launches_kernels(dev):
    hf.reset_launch_counts()
    x = rand((2, 20000), dev, 1)
    h = rand((1000,), dev, 2) / 32
    y = stream.fir_filter_ols(x, h)
    yp = stream.partitioned_fir_apply(x, h, block=512)
    assert y.device == dev and yp.device == dev
    assert maxerr(y, yp) <= 1e-3
    assert all(k.launches > 0 for k in hf.KERNELS)


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
